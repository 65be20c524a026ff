"""The comparison's control on the card: the reference put in the
program's place with TF32 on, at sizes a test run holds, has to come
out not correct against each caption and training cell's limits (the
readings at the cells' own sizes are in PERF.md). The tests decide
inside themselves whether a card is there."""

import pytest

from satbench import run, spec


def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


CASES = {
    "caption.vgg19-att-ado.b128": {"batch": 32, "pool": 64},
    "caption.bert-att.b128": {"batch": 32, "pool": 64},
    "train.vgg19-att-ado.bank-b64-k8": {"bank_images": 600},
    "serve.vgg19-att-ado.poisson": {"check_requests": 64},
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_control_is_not_correct(name):
    card()
    cell = spec.load(name)
    cell.traffic.update(CASES[name])
    got = {}
    for seed in (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23):
        out = run.execute(run.Context(cell, seed, 1.0, False), "tf32")
        got[seed] = (out["correct"], out["compared"])
    assert not any(correct for correct, _ in got.values()), got
