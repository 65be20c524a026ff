"""The port stands alone: it imports neither jax nor sat_tpu, nor the
packages that only sat_tpu uses and the card's machine lacks (nltk,
matplotlib, orbax, wandb, skimage), and its entry points refuse to run on
the CPU unless asked to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.test_torch_common import to_np  # noqa: F401  (one torch thread)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "sat_tpu", "nltk", "matplotlib", "orbax",
             "wandb", "skimage"}

# The CPU slice at toy size, in a fresh interpreter: tests/conftest.py has
# already imported jax into this one.
_SLICE = r"""
import sys
import numpy as np
import torch
import sat_tpu_torch.serve  # noqa: F401
from sat_tpu_torch.compat.jax_params import decoder_from_jax, encoder_from_jax
from sat_tpu_torch.engine.serving import build_caption_step
from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
from sat_tpu_torch.models.encoder import init_encoder_params

torch.set_num_threads(1)
gen = torch.Generator().manual_seed(0)
dcfg = DecoderConfig(vocab_size=30, encoder_dim=512, use_ado=True,
                     use_attention=True)
dec = decoder_from_jax(init_decoder_params(dcfg, gen), dcfg, device="cpu")
enc = encoder_from_jax(init_encoder_params("vgg19", gen), "vgg19",
                       device="cpu")
images = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
    np.float32)
out = build_caption_step("vgg19", dcfg, 3, device="cpu")(enc, dec, images)
assert out["tokens"].shape == (2, 52), out["tokens"].shape
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "sat_tpu"))
assert not bad, bad
print("ISOLATED")
"""


def test_cpu_slice_runs_without_jax_or_sat_tpu():
    proc = subprocess.run([sys.executable, "-c", _SLICE], cwd=REPO,
                          env=_subprocess_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED" in proc.stdout


# The training CLI at toy size, in a fresh interpreter in which the
# forbidden packages cannot be imported, on a dataset made beforehand:
# one epoch with the test pass; the same run preempted by SIGUSR1 after its
# first step and finished by --resume, which must end with the same
# decoder. argv[1] is the dataset, argv[2] the output directory, argv[3:]
# the forbidden packages.
_TRAIN = r"""
import importlib.abc
import os
import signal
import sys


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in sys.argv[3:]:
            raise ImportError(f"{name} is not importable here")


sys.meta_path.insert(0, Refuse())
import numpy as np
import torch
import sat_tpu_torch.engine.loop as loop
from sat_tpu_torch.train import main

torch.set_num_threads(1)
data, out = sys.argv[1], sys.argv[2]


def train(ckpt_dir, *extra):
    return main(["--data", data, "--checkpoint-dir", ckpt_dir,
                 "--image-size", "32", "--batch-size", "4", "--epochs", "1",
                 "--log-interval", "1", "--tf", "--ado", "--attention",
                 "--cache-features", "--device", "cpu", *extra])


full = os.path.join(out, "full")
res = train(full)
assert 0 <= res["bleu1"] <= 1 and res["loss"] > 0, res
plots = os.listdir(os.path.join(full, "attention_viz_epoch1"))
assert plots and all(p.endswith(".png") for p in plots), plots
assert os.listdir(os.path.join(full, "train_state")) == ["2.pt"]

make_step = loop.make_bank_train_step


def preempting_step(*args, **kw):
    step, calls = make_step(*args, **kw), []

    def first_call_signals(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            os.kill(os.getpid(), signal.SIGUSR1)
        return step(*a, **k)
    return first_call_signals


cut = os.path.join(out, "cut")
loop.make_bank_train_step = preempting_step
assert train(cut) == {"preempted": True, "epoch": 1}
loop.make_bank_train_step = make_step
assert os.listdir(os.path.join(cut, "train_state")) == ["1.pt"]
res = train(cut, "--resume")
assert "bleu4" in res, res
with np.load(os.path.join(full, "model_vgg19_1.npz")) as a, \
        np.load(os.path.join(cut, "model_vgg19_1.npz")) as b:
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k
bad = sorted(m for m in sys.modules if m.split(".")[0] in sys.argv[3:])
assert not bad, bad
print("ISOLATED")
"""


def _subprocess_env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))


def test_training_cli_runs_without_jax_or_sat_tpu(tmp_path):
    from sat_tpu.data import generate_json_data
    from tests._synth import build_synth_dataset

    data = str(tmp_path / "data")
    build_synth_dataset(data, n_train=4, n_val=2, n_test=2, caps_per_img=2,
                        image_size=32)
    generate_json_data(f"{data}/dataset.json", data, 2, 1, 10)
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN, data, str(tmp_path),
         *sorted(FORBIDDEN)],
        cwd=REPO, env=_subprocess_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED" in proc.stdout
    assert "Train Batch: [1/2]" in proc.stdout   # 8 rows, 4 a batch
    for line in ("EvalMode.VALIDATION Epoch: 1\tBLEU-1 (",
                 "EvalMode.TEST Epoch: 1\tBLEU-1 (",
                 "Preempted at epoch 1 batch 1",
                 "Resuming epoch 1 at batch offset 1"):
        assert line in proc.stdout, line


def _port_files():
    files = sorted((REPO / "sat_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py", REPO / "time_train_step.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_sat_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not FORBIDDEN & set(roots), f"{path}:{node.lineno} {roots}"


def test_entry_points_default_to_cuda():
    """Without device=, an entry point on a host with no CUDA raises instead
    of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    from sat_tpu_torch.compat.jax_params import decoder_from_jax
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.models.decoder import (DecoderConfig,
                                              init_decoder_params)
    from sat_tpu_torch.serve import build_parser

    dcfg = DecoderConfig(vocab_size=10, encoder_dim=512)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_caption_step("vgg19", dcfg, 3)
    flat = init_decoder_params(dcfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        decoder_from_jax(flat, dcfg)
    assert build_parser().parse_args(["--model", "m.npz"]).device == "cuda"
    from sat_tpu_torch.engine.loop import Trainer
    from sat_tpu_torch.train import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--data", "nowhere"])
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(Config(data="nowhere"))
