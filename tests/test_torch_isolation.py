"""The port stands alone: it imports neither jax nor sat_tpu, nor the
packages that only sat_tpu uses and the card's machine lacks (nltk,
matplotlib, orbax, wandb, skimage, transformers), and its entry points
refuse to run on the CPU unless asked to. The one exception is wandb,
which the port imports as sat_tpu does, lazily, inside its two W&B
branches (`WANDB_BRANCHES`: the logger's backend and generate_caption's
restore), and only when asked for: a run without --wandb never imports
it."""

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
             "wandb", "skimage", "transformers"}
# (file, function) of the only imports of wandb in the port
WANDB_BRANCHES = {("sat_tpu_torch/utils/logging.py", "__init__"),
                  ("sat_tpu_torch/generate_caption.py", "restore_from_wandb")}

# The CPU slice at toy size, in a fresh interpreter: tests/conftest.py has
# already imported jax into this one.
_SLICE = r"""
import sys
import numpy as np
import torch
import sat_tpu_torch.caption_split  # noqa: F401
import sat_tpu_torch.compat.torch_decoder  # noqa: F401
import sat_tpu_torch.compat.torch_encoder  # noqa: F401
import sat_tpu_torch.data.bert_prep  # noqa: F401
import sat_tpu_torch.data.bert_vocab  # noqa: F401
import sat_tpu_torch.data.vocab  # noqa: F401
import sat_tpu_torch.demo_learnability  # noqa: F401
import sat_tpu_torch.evaluate  # noqa: F401
import sat_tpu_torch.export_reference_pth  # noqa: F401
import sat_tpu_torch.generate_caption  # noqa: F401
import sat_tpu_torch.generate_json_data  # noqa: F401
import sat_tpu_torch.generate_json_data_bert  # noqa: F401
import sat_tpu_torch.parallel.distributed  # noqa: F401
import sat_tpu_torch.parallel.mesh  # noqa: F401
import sat_tpu_torch.port_torchvision  # noqa: F401
import sat_tpu_torch.serve  # noqa: F401
import sat_tpu_torch.train_models  # noqa: F401
import sat_tpu_torch.utils.tables  # noqa: F401
from sat_tpu_torch.data import native
from sat_tpu_torch.data.transforms import load_and_preprocess_image
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
if native.available():
    import tempfile
    from PIL import Image
    with tempfile.TemporaryDirectory() as tmp:
        png = tmp + "/a.png"
        Image.fromarray(np.zeros((40, 48, 3), np.uint8)).save(png)
        native_img = load_and_preprocess_image(png, 32, use_native=True)
        assert np.array_equal(native_img, native.load_image(png, 32))
out = build_caption_step("vgg19", dcfg, 3, device="cpu")(enc, dec, images)
assert out["tokens"].shape == (2, 52), out["tokens"].shape
mesh = build_caption_step("vgg19", dcfg, 3, device="cpu", mesh_data=2,
                          devices=["cpu", "cpu"], pallas_topk=False)(
    enc, dec, images[:1])
assert mesh["tokens"].shape == (1, 52), mesh["tokens"].shape
out = build_caption_step("vgg19", dcfg, 3, decode="sample", top_k=5,
                         device="cpu")(enc, dec, images,
                                       torch.Generator().manual_seed(0))
assert out["tokens"].shape == (2, 52), out["tokens"].shape
dcfg = DecoderConfig(vocab_size=30, encoder_dim=2208, use_ado=True,
                     use_attention=True)
dec = decoder_from_jax(init_decoder_params(dcfg, gen), dcfg, device="cpu")
enc = encoder_from_jax(init_encoder_params("densenet161", gen), "densenet161",
                       device="cpu")
out = build_caption_step("densenet161", dcfg, 3, device="cpu")(
    enc, dec, np.zeros((1, 64, 64, 3), np.float32))
assert out["alphas"].shape == (1, 52, 4), out["alphas"].shape
dcfg = DecoderConfig(vocab_size=30, encoder_dim=512, use_ado=True,
                     use_bert=True, use_attention=True)
dec = decoder_from_jax(init_decoder_params(dcfg, gen), dcfg, device="cpu")
enc = encoder_from_jax(init_encoder_params("vgg19", gen), "vgg19",
                       device="cpu")
out = build_caption_step("vgg19", dcfg, 3, decode="greedy", device="cpu")(
    enc, dec, images)
assert out["tokens"].shape == (2, 52) and out["tokens"][0, 0] == 101
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "sat_tpu",
                                    "transformers", "wandb"))
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


def _strings(tree):
    """A module's string constants, less its docstrings and the values of
    `"replaces"` keys (chip_smoke.py's kernel rows name the TPU kernel
    each kernel replaces, as its output contract asks)."""
    skip = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)):
            skip.add(id(body[0].value))
        if isinstance(node, ast.Dict):
            skip.update(id(v) for k, v in zip(node.keys, node.values)
                        if isinstance(k, ast.Constant)
                        and k.value == "replaces")
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in skip]


def _port_files():
    files = sorted((REPO / "sat_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py", REPO / "time_train_step.py",
                    REPO / "time_op_dispatch.py", REPO / "profile_loss.py"]


def _imports(tree):
    """(node, root package names, enclosing function name or None) of
    every absolute import in a module."""
    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            inner = (child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func)
            if isinstance(child, ast.Import):
                yield child, [a.name.split(".")[0] for a in child.names], func
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child, [(child.module or "").split(".")[0]], func
            yield from walk(child, inner)
    yield from walk(tree, None)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_sat_tpu_imports(path):
    """No forbidden import, but wandb's inside its two W&B branches."""
    tree = ast.parse(path.read_text(), filename=str(path))
    rel = str(path.relative_to(REPO))
    for node, roots, func in _imports(tree):
        allowed = {"wandb"} if (rel, func) in WANDB_BRANCHES else set()
        assert not (FORBIDDEN - allowed) & set(roots), \
            f"{path}:{node.lineno} {roots}"


def test_wandb_branches_import_it(tmp_path):
    """The two W&B branches do import wandb (the rule above names real
    code), and a training run without --wandb never tries to import it,
    while one with --wandb does (and trains on without it)."""
    for rel, func in WANDB_BRANCHES:
        tree = ast.parse((REPO / rel).read_text())
        assert any(f == func and "wandb" in roots
                   for _, roots, f in _imports(tree)), (rel, func)

    import importlib.abc
    from sat_tpu.data import generate_json_data
    from tests._synth import build_synth_dataset

    from sat_tpu_torch.train import main

    data = str(tmp_path / "data")
    build_synth_dataset(data, n_train=4, n_val=2, n_test=2, caps_per_img=2,
                        image_size=32)
    generate_json_data(f"{data}/dataset.json", data, 2, 1, 10)
    tried = []

    class Record(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] == "wandb":
                tried.append(name)
                raise ImportError(f"{name} is not importable here")

    saved = sys.modules.pop("wandb", None)
    sys.meta_path.insert(0, Record())
    try:
        for run, flags in (("plain", []), ("wandb", ["--wandb"])):
            res = main(["--data", data, "--checkpoint-dir",
                        str(tmp_path / run), "--image-size", "32",
                        "--batch-size", "4", "--epochs", "1", "--tf",
                        "--attention", "--cache-features", "--device", "cpu",
                        *flags])
            assert "bleu4" in res
            assert tried == ([] if run == "plain" else ["wandb"]), run
    finally:
        sys.meta_path[:] = [f for f in sys.meta_path
                            if not isinstance(f, Record)]
        if saved is not None:
            sys.modules["wandb"] = saved


def test_entry_points_default_to_cuda(tmp_path):
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
    from sat_tpu_torch.demo_learnability import main as demo
    with pytest.raises(RuntimeError, match="CUDA"):
        demo(["--epochs", "1", "--out-dir", str(tmp_path)])


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_path_into_the_jax_package(path):
    """No port file names a file of the JAX package in its code: not
    `native/preproc.cpp` (the port builds its own copy) and nothing under
    `sat_tpu/`."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for s in _strings(tree):
        assert "native/preproc" not in s and "sat_tpu/" not in s, (path, s)
    joined = [tuple(c.value for c in node.args
                    if isinstance(c, ast.Constant))
              for node in ast.walk(tree) if isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "join"]
    assert not any(("native", "preproc.cpp") == parts[:2]
                   and path.name != "native.py" for parts in joined), path
    if path.name == "native.py":
        from sat_tpu_torch.data import native
        assert native._SRC_PATH == str(REPO / "sat_tpu_torch" / "native"
                                       / "preproc.cpp")
