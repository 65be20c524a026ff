"""The benchmark's own tests: `python -m pytest satbench/tests -q` on any
host; those marked `cuda` run only where a card is (`-m cuda` on the
card)."""

import json
import shutil
from pathlib import Path

import pytest

from satbench import spec


@pytest.fixture
def tiny_caption():
    """The flagship's configuration at 32 px and 64 words, the caption
    mix at 4 images and beam 3: small enough for the CPU."""
    cfg = json.loads((spec.HERE / "configs" / "vgg19-att-ado.json")
                     .read_text())
    cfg.update(image_size=32, grid=[2, 2], vocab_size=64,
               word_ids=[4, 64])
    traffic = {"driver": "caption", "batch": 4, "beam": 3, "pool": 8,
               "contrast": [0.25, 4.0, 8], "stop_boost": 0.5}
    limits = json.loads((spec.HERE / "workloads"
                         / "caption.vgg19-att-ado.b128.json").read_text())
    return spec.Cell("tiny.caption", 1, cfg, traffic, limits["limits"])


@pytest.fixture
def tiny_train(tiny_caption):
    traffic = {"driver": "train", "batch": 4, "block": 2, "bank_images": 20,
               "captions_per_image": 5, "caption_tokens": 8,
               "words": [2, 6], "checked_steps": 3}
    limits = json.loads((spec.HERE / "workloads"
                         / "train.vgg19-att-ado.bank-b64-k8.json")
                        .read_text())
    return spec.Cell("tiny.train", 1, tiny_caption.config, traffic,
                     limits["limits"])


@pytest.fixture
def tiny_serve(tiny_caption):
    traffic = {"driver": "serve", "rate": 20.0, "max_batch": 4,
               "window_ms": 5, "beam": 3, "pool": 8,
               "contrast": [0.25, 4.0, 8], "stop_boost": 0.5, "warm": 2,
               "drain_s": 30, "check_requests": 12, "trace_s": 0.5}
    limits = json.loads((spec.HERE / "workloads"
                         / "serve.vgg19-att-ado.poisson.json").read_text())
    return spec.Cell("tiny.serve", 1, tiny_caption.config, traffic,
                     limits["limits"])


@pytest.fixture
def bench_copy(tmp_path) -> Path:
    """A directory holding only BENCHMARK.json and the benchmark's
    folder."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "satbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path
