"""Runs of the harness past its look for a card, on the CPU at tiny sizes:
a sound program is judged correct, and with each fault that a cell can
have planted under the timed path, `correct` comes out false. And the
command itself: no card, no result."""

import functools
import json
import math
import subprocess
import sys

import pytest

from satbench import run, spec


def execute(cell, fault=None, seconds=0.5, seed=2 ** 31 + 3):
    return run.execute(run.Context(cell, seed, seconds, False,
                                   device="cpu", fault=fault))


@pytest.mark.parametrize("fault", [None, "token", "rank", "half_batch"])
def test_caption_run(tiny_caption, fault):
    out = execute(tiny_caption, fault)
    assert out["correct"] is (fault is None), out["numbers"]
    assert out["attempted"] > 0 and out["e2e"]["captions_per_s"] > 0
    assert out["numbers"]["found_share"] > 0 or fault == "token"
    # each slice of the pool that the window ran is checked, with the
    # beam's steps on it
    assert len(out["numbers"]["beam_steps"]) == min(out["attempted"] // 4,
                                                    2)


def test_rank_fault_is_seen_by_the_search_check(tiny_caption):
    """Ranks 2..k+1 with their own values: captions, scores and attention
    weights agree with one another, and only beam_mismatch sees the
    search go wrong."""
    got = execute(tiny_caption, "rank")["numbers"]
    assert got["beam_mismatch"] > tiny_caption.limits["beam_mismatch"]
    assert got["alpha_gap"] <= tiny_caption.limits["alpha_gap"]


@pytest.mark.parametrize("fault", [None, "token", "half_batch", "frozen"])
def test_train_run(tiny_train, fault):
    out = execute(tiny_train, fault)
    assert out["correct"] is (fault is None), out["numbers"]
    assert out["e2e"]["train_rows_per_s"] > 0
    if fault == "frozen":      # no leaf moves: the worst reads 1
        assert out["numbers"]["update_worst"] == 1.0
        assert out["numbers"]["update_gap"] >= 0.5


@pytest.mark.parametrize("fault", [None, "token", "rank"])
def test_serve_run(tiny_serve, fault):
    out = execute(tiny_serve, fault, seconds=1.0)
    assert out["correct"] is (fault is None), out["numbers"]
    assert out["attempted"] == 20 and out["failed"] == 0
    assert math.isfinite(out["e2e"]["caption_p95_ms"])


def test_result_line_keys(tiny_caption, monkeypatch):
    out = execute(tiny_caption)
    ctx = run.Context(tiny_caption, 1, 0.5, False, device="cpu")
    tiny_caption.end_to_end = spec.load(
        "caption.vgg19-att-ado.b128").end_to_end
    monkeypatch.setattr(run, "device_info", lambda cell, peak: {
        "platform": "gpu", "kind": "test", "count": 1,
        "memory_peak_bytes": peak})
    res = run.result(ctx, out)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert set(res["metrics"]) == {"captions_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert set(res["compared"]) == set(tiny_caption.limits)
    json.loads(json.dumps(run.finite(res), allow_nan=False))


def on_a_fake_card(monkeypatch, cell):
    """run.main on the CPU: one card reported, the tiny cell loaded for
    any name, and the device's readings stubbed."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(spec, "load", lambda name: cell)
    monkeypatch.setattr(run, "Context", functools.partial(run.Context,
                                                          device="cpu"))
    monkeypatch.setattr(run, "device_info", lambda cell, peak: {
        "platform": "gpu", "kind": "test", "count": 1,
        "memory_peak_bytes": peak})


def test_main_prints_the_result_line(tiny_caption, monkeypatch, capsys):
    tiny_caption.end_to_end = spec.load(
        "caption.vgg19-att-ado.b128").end_to_end
    on_a_fake_card(monkeypatch, tiny_caption)
    assert run.main(["--workload", "x", "--seconds", "0.5"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert line["correct"] is True
    assert err.strip().splitlines()[-1].startswith("compared ")


def test_main_judges_the_control(tiny_caption, monkeypatch, capsys):
    """--control runs in place of the program and prints its compared
    numbers, judged by the cell's limits, in place of a result."""
    on_a_fake_card(monkeypatch, tiny_caption)
    assert run.main(["--workload", "x", "--seconds", "0.5",
                     "--control", "tf32"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["control", "correct", "compared"]
    assert set(line["compared"]) == set(tiny_caption.limits)
    assert "metrics" not in line


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "satbench", "--workload",
                          "caption.vgg19-att-ado.b128", "--seed",
                          str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 2:
        pytest.skip("this host has a CUDA card")
    assert out.stdout == ""


def test_benchmark_alone_gives_no_result(bench_copy):
    out = subprocess.run([sys.executable, "-m", "satbench", "--workload",
                          "train.vgg19-att-ado.bank-b64-k8", "--seed", "7",
                          "--seconds", "1", "--trace", "0"],
                         cwd=bench_copy, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
