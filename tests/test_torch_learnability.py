"""The port's learnability demo (sat_tpu_torch/demo_learnability.py).

- Its colour corpus is sat_tpu's byte for byte: every image and
  dataset.json that `build_dataset` writes equal the files of
  tools/demo_learnability.py::build_dataset (which trains nothing).
- A two-epoch run on the CPU through `main`: sat_tpu's summary keys, a
  history of two epochs, and summary.json with the seconds and the
  kernels' host launch counts (0 here: the plain forms run).
- The twelve-epoch bars of tests/test_learnability.py, unchanged, on the
  CPU: marked slow, as that file is (chip_smoke.py's phase `learn` holds
  the port to them on the card).
"""

import json
import os
import sys

import pytest

from sat_tpu_torch import demo_learnability

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _files(root) -> dict:
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("image_size", [64, 32])
def test_corpus_is_sat_tpus_byte_for_byte(tmp_path, image_size):
    sys.path.insert(0, _TOOLS)
    try:
        import demo_learnability as jax_demo
    finally:
        sys.path.remove(_TOOLS)
    jax_demo.build_dataset(str(tmp_path / "jax"), image_size=image_size)
    demo_learnability.build_dataset(str(tmp_path / "port"),
                                    image_size=image_size)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(want) == 8 * 6 + 1
    assert sorted(got) == sorted(want)
    for name, data in want.items():
        assert got[name] == data, name


def test_two_epochs_on_the_cpu(tmp_path):
    out = str(tmp_path / "c")
    summary = demo_learnability.main(["--epochs", "2", "--out-dir", out,
                                      "--device", "cpu"])
    assert sorted(summary) == ["beam_color_accuracy", "final_val_bleu1",
                               "history"]
    assert [e for e, _ in summary["history"]] == [1, 2]
    assert 0.0 <= summary["final_val_bleu1"] <= 1.0
    assert summary["final_val_bleu1"] == summary["history"][-1][1]
    assert summary["beam_color_accuracy"] * 8 == round(
        summary["beam_color_accuracy"] * 8)
    with open(os.path.join(out, "summary.json")) as f:
        written = json.load(f)
    assert written["launches"] == {"topk": 0, "attention_fwd": 0,
                                   "attention_bwd": 0}
    assert written["seconds"] > 0
    assert written["history"] == [list(h) for h in summary["history"]]
    assert os.path.exists(os.path.join(out, "model", "model_vgg19_2.npz"))


@pytest.mark.slow
def test_system_learns_color_captioning(tmp_path):
    """tests/test_learnability.py's bars, on the port."""
    summary = demo_learnability.run(epochs=12, out_dir=str(tmp_path / "c"),
                                    device="cpu")
    assert summary["final_val_bleu1"] >= 0.9, summary["history"]
    assert summary["beam_color_accuracy"] >= 0.85, summary
    first, last = summary["history"][0][1], summary["history"][-1][1]
    assert last >= first - 0.05, summary["history"]
