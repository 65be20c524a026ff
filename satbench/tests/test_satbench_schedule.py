"""The serving cell's open-loop schedule."""

import pytest

from satbench.drivers.client import schedule


def test_schedule_for_a_seed():
    plan = schedule(2 ** 31 + 11, 272.0, 20.0, 512)
    assert plan == schedule(2 ** 31 + 11, 272.0, 20.0, 512)
    assert len(plan) == 5440
    dues = [d for d, _ in plan]
    assert dues == sorted(dues) and dues[0] > 0
    assert dues[-1] == pytest.approx(20.0, rel=0.01)
    assert all(0 <= row < 512 for _, row in plan)


def test_seeds_send_the_same_gaps_in_another_order():
    a, b = schedule(1, 50.0, 4.0, 8), schedule(2, 50.0, 4.0, 8)

    def gaps(plan):
        dues = [0.0] + [d for d, _ in plan]
        return [y - x for x, y in zip(dues, dues[1:])]
    assert sorted(gaps(a)) == pytest.approx(sorted(gaps(b)))
    assert gaps(a) != gaps(b)
    assert a[-1][0] == pytest.approx(b[-1][0])
