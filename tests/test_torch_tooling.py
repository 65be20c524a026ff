"""train.py's tooling in the port: the parameter tables of
utils/tables.py against sat_tpu's (vanilla and BERT, row for row),
`--debug-nans` (a FloatingPointError naming the epoch and step, per batch
and in K-step blocks, and the same bits as a run without it while
everything is finite) and `--profile-dir` (a torch.profiler trace on the
CPU). On the synthetic dataset of tests/test_torch_trainer.py."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax

from sat_tpu.engine.checkpoint import _keypath_name
from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from sat_tpu.models.decoder import init_decoder_params as jax_init_decoder
from sat_tpu.models.encoder import init_encoder_params as jax_init_encoder
from sat_tpu.utils.tables import count_parameters as jax_count_parameters

from sat_tpu_torch.config import Config
from sat_tpu_torch.engine.loop import Trainer
from sat_tpu_torch.utils.tables import count_parameters
from tests.test_torch_trainer import _config_kwargs, data  # noqa: F401


def _shapes(init, *args):
    """The shapes of an initializer's param tree, and the same as sat_tpu's
    flat `/`-named dict (no weights are made)."""
    tree = jax.eval_shape(lambda key: init(key, *args),
                          jax.random.PRNGKey(0))
    return tree, {_keypath_name(path): leaf for path, leaf
                  in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _printed(fn, *args, **kw):
    lines = []
    total = fn(*args, print_fn=lines.append, **kw)
    return total, "\n".join(lines)


@pytest.mark.parametrize("bert", [False, True], ids=["vanilla", "bert"])
def test_decoder_table_matches_sat_tpu(bert):
    """The same rows, names, counts and total; BERT's frozen table left out
    by the filter sat_tpu's Trainer passes."""
    jcfg = JaxDecoderConfig(vocab_size=30522 if bert else 40,
                            encoder_dim=512, use_tf=True, use_ado=True,
                            use_bert=bert, use_attention=True)
    tree, flat = _shapes(jax_init_decoder, jcfg)

    def keep(n):
        return not n.startswith("embedding") if bert else True

    want = _printed(jax_count_parameters, tree, trainable_filter=keep)
    got = _printed(count_parameters, flat, trainable_filter=keep)
    assert got == want
    rows = [ln for ln in got[1].splitlines() if ln.startswith("| ")][1:]
    assert len(rows) == 25 - bert
    assert ("| embedding " in got[1]) != bert


def test_encoder_table_matches_sat_tpu():
    """sat_tpu prints the frozen encoder's table with no trainable row."""
    tree, flat = _shapes(lambda key: jax_init_encoder(key, "vgg19"))
    want = _printed(jax_count_parameters, tree,
                    trainable_filter=lambda n: False)
    assert _printed(count_parameters, flat,
                    trainable_filter=lambda n: False) == want
    assert want[0] == 0


def test_trainer_prints_sat_tpus_tables(data, tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        Trainer(Config(**_config_kwargs(data, str(tmp_path), epochs=0)),
                device="cpu")
    log = out.getvalue()
    enc_part = log.split("Encoder parameters (frozen):\n")[1].split(
        "Decoder parameters:\n")
    with np.load(data["model"]) as arc:
        dec = {k: arc[k] for k in arc.files}
    _, want = _printed(count_parameters, dec)
    assert enc_part[1].startswith(want + "\n")
    assert enc_part[0].endswith("Total Trainable Params: 0\n")
    jax_total, _ = _printed(jax_count_parameters, _shapes(
        jax_init_decoder, JaxDecoderConfig(
            vocab_size=dec["deep_output/w"].shape[1], encoder_dim=512,
            use_tf=True, use_ado=True, use_attention=True))[0])
    assert f"Total Trainable Params: {jax_total}" in enc_part[1]


def _run(data, out, **kw):
    cfg = Config(**_config_kwargs(data, out, cache_features=True, epochs=1,
                                  **kw))
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = Trainer(cfg, device="cpu")
        res = trainer.fit()
    return trainer, res


@pytest.mark.parametrize("k", [1, 2], ids=["per_batch", "blocked"])
def test_debug_nans_keeps_the_bits(data, tmp_path, k):
    """While everything is finite the flag changes nothing: the same
    parameters, Adam moments and metrics as the run without it."""
    plain, plain_res = _run(data, str(tmp_path / "plain"),
                            steps_per_dispatch=k)
    checked, checked_res = _run(data, str(tmp_path / "checked"),
                                steps_per_dispatch=k, debug_nans=True)
    assert (checked.train_block is None) == (k == 1)
    assert checked_res == plain_res
    for name, t in plain.state.decoder.state_dict().items():
        torch.testing.assert_close(checked.state.decoder.state_dict()[name],
                                   t, rtol=0, atol=0, msg=name)
    sa = plain.state.optimizer.state_dict()["state"]
    sb = checked.state.optimizer.state_dict()["state"]
    for i in sa:
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(sb[i][key], sa[i][key], rtol=0,
                                       atol=0)


@pytest.mark.parametrize("k", [1, 2], ids=["per_batch", "blocked"])
def test_debug_nans_raises_naming_epoch_and_step(data, tmp_path, k):
    """At lr 1e37 the first update leaves finite parameters of about 1e37
    (Adam's first step moves each by lr / (1 - beta1)), and the second
    step's loss is not finite: the run stops there. (At 1e38 the CPU's
    uncaptured Adam refuses the step size, 1e39, before any NaN.)"""
    with pytest.raises(FloatingPointError,
                       match="stopped being finite at epoch 1, step 1$"):
        _run(data, str(tmp_path / "nan"), steps_per_dispatch=k,
             debug_nans=True, lr=1e37)
    # without the flag the same run goes on to its end
    _, res = _run(data, str(tmp_path / "on"), steps_per_dispatch=k, lr=1e37)
    assert not np.isfinite(res["loss"])


@pytest.mark.parametrize("k", [1, 2], ids=["per_batch", "blocked"])
def test_finite_flag_only_with_debug_nans(k):
    """The step's metrics gain `finite` under the option and nothing
    without it."""
    from sat_tpu_torch.compat.jax_params import decoder_from_jax
    from sat_tpu_torch.models.decoder import (DecoderConfig,
                                              init_decoder_params)
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_train_block,
                                                   make_bank_train_step)

    dcfg = DecoderConfig(vocab_size=20, encoder_dim=8, use_tf=True,
                         use_ado=True, use_attention=True, dropout_rate=0.0)
    gen = torch.Generator().manual_seed(0)
    flat_params = init_decoder_params(dcfg, gen)
    bank = torch.randn((3, 4, 8), generator=gen)
    caps = torch.randint(4, 20, (5, 6), generator=gen)
    keys = {}
    for debug in (False, True):
        state = init_train_state(decoder_from_jax(flat_params, dcfg, "cpu",
                                                  trainable=True))
        if k == 1:
            _, metrics = make_bank_train_step(dcfg, 1.0, debug_nans=debug)(
                state, bank, caps, torch.tensor([0, 2]),
                torch.tensor([1, 4]), 1e-3, None)
        else:
            _, metrics = make_bank_train_block(dcfg, 1.0, debug_nans=debug)(
                state, bank, caps, torch.tensor([[0, 2], [1, 1]]),
                torch.tensor([[1, 4], [0, 3]]), 1e-3, None)
        keys[debug] = set(metrics)
    assert keys[True] - keys[False] == {"finite"}
    assert bool(metrics["finite"].all())
    assert metrics["finite"].shape == (() if k == 1 else (2,))


def test_profile_dir_writes_a_trace(data, tmp_path):
    """`python -m sat_tpu_torch.train --profile-dir` on the CPU: one Chrome
    trace of the run in the directory, holding the step's operators."""
    from sat_tpu_torch.train import main

    prof = tmp_path / "prof"
    args = ["--data", data["root"], "--image-size", "32", "--batch-size",
            "4", "--epochs", "1", "--tf", "--ado", "--attention",
            "--cache-features", "--checkpoint-dir", str(tmp_path / "model"),
            "--encoder-weights", data["enc"], "--profile-dir", str(prof),
            "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        res = main(args)
    assert "bleu4" in res
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(prof / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert "aten::tanh" in names     # the attention's plain form
