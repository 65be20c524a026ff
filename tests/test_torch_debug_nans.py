"""`--debug-nans` against sat_tpu's `jax_debug_nans`, on the CPU.

sat_tpu's flag raises FloatingPointError when a jitted program outputs a
NaN, and never for an inf. The port's flag tests the same outputs for NaN
(parallel/train_step.py, engine/loop.py). On the synthetic dataset of
tests/test_torch_trainer.py, with one decoder and one encoder archive for
both packages:

- at lr 1e37 both stop in epoch 1, at the same step per batch and in the
  same block blocked (sat_tpu's step: the calls its Trainer made of its
  train step or block); the port's message names the pass, epoch and step;
- a NaN grid in the validation bank: both train the epoch and stop in
  `validate`, at the same batch (per batch and blocked);
- NaN encoder weights: both stop in the train split's precompute;
- a unit case of the bank train step and block: a parameter holding inf
  (init_h's bias: tanh(inf) = 1, so the loss and the gradients stay
  finite) sets no flag, and sat_tpu's step under jax_debug_nans goes on;
  the same parameter holding NaN sets it, and sat_tpu's step raises.

sat_tpu's Trainer turns jax_debug_nans on for the whole process; each case
turns it off again.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sat_tpu.config import Config as JaxConfig
from sat_tpu.engine.loop import Trainer as JaxTrainer

from sat_tpu_torch.config import Config
from sat_tpu_torch.engine.loop import Trainer
from tests.test_torch_trainer import _config_kwargs, data  # noqa: F401

STEP = re.compile(r"at epoch (\d+), step (\d+)$")


@contextlib.contextmanager
def jax_nans_reset():
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", False)


def _kwargs(data, out, k, **kw):
    kw = dict(dict(cache_features=True, epochs=1, debug_nans=True,
                   steps_per_dispatch=k), **kw)
    return _config_kwargs(data, out, **kw)


def _calls(obj, name: str) -> list:
    """Count the calls of obj.<name> into the returned list's length."""
    calls, fn = [], getattr(obj, name)

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    setattr(obj, name, counted)
    return calls


def _port_step(err) -> tuple:
    m = STEP.search(str(err.value))
    assert m, str(err.value)
    return int(m.group(1)), int(m.group(2))


@pytest.mark.parametrize("k", [1, 2], ids=["per_batch", "blocked"])
def test_lr_1e37_stops_where_sat_tpu_does(data, tmp_path, k):
    with jax_nans_reset(), contextlib.redirect_stdout(io.StringIO()):
        jt = JaxTrainer(JaxConfig(**_kwargs(data, str(tmp_path / "jax"), k,
                                            lr=1e37)))
        calls = _calls(jt, "train_step" if k == 1 else "train_block")
        with pytest.raises(FloatingPointError):
            jt.fit()
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = Trainer(Config(**_kwargs(data, str(tmp_path / "port"), k,
                                           lr=1e37)), device="cpu")
        with pytest.raises(FloatingPointError,
                           match="^--debug-nans: a NaN in the output of the "
                                 "train step at epoch 1, step") as err:
            trainer.fit()
    epoch, step = _port_step(err)
    assert epoch == 1
    # sat_tpu raised in its last call: per batch, step calls - 1; blocked,
    # the block of that index
    assert step // k == len(calls) - 1, (step, len(calls))


@pytest.mark.parametrize("k", [1, 2], ids=["per_batch", "blocked"])
def test_nan_grid_in_the_val_bank_stops_validation(data, tmp_path, k):
    """Grid 0 of the validation bank NaN: the train epoch is clean, and
    both packages stop at the same validation batch."""
    with jax_nans_reset(), contextlib.redirect_stdout(io.StringIO()):
        jt = JaxTrainer(JaxConfig(**_kwargs(data, str(tmp_path / "jax"), k)))
        b = jt.bank["val"]
        feats = np.asarray(b["feats"]).copy()
        feats[0] = np.nan
        b["feats"] = jax.device_put(feats, b["feats"].sharding)
        jt.train_epoch(1)
        calls = _calls(jt, "eval_step" if k == 1 else "eval_block")
        with pytest.raises(FloatingPointError):
            jt.validate(1)
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = Trainer(Config(**_kwargs(data, str(tmp_path / "port"), k)),
                          device="cpu")
        trainer.bank["val"]["feats"][0] = float("nan")
        trainer.train_epoch(1)
        with pytest.raises(FloatingPointError,
                           match="^--debug-nans: a NaN in the output of the "
                                 "val step at epoch 1, step") as err:
            trainer.validate(1)
    _, step = _port_step(err)
    assert step // k == len(calls) - 1, (step, len(calls))


def test_nan_encoder_stops_the_precompute(data, tmp_path):
    """NaN weights in the encoder archive: both stop while encoding the
    train split, before any step."""
    with np.load(data["enc"]) as arc:
        enc = {name: arc[name] for name in arc.files}
    first = sorted(n for n in enc if n.endswith("/b"))[0]
    enc[first] = np.full_like(enc[first], np.nan)
    path = str(tmp_path / "nan_vgg19.npz")
    np.savez(path, **enc)
    kw = dict(encoder_weights=path)
    with jax_nans_reset(), contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(FloatingPointError):
            JaxTrainer(JaxConfig(**_kwargs(data, str(tmp_path / "jax"), 1,
                                           **kw)))
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(FloatingPointError,
                           match="^--debug-nans: a NaN in the output of the "
                                 "train feature precompute at step 0$"):
            Trainer(Config(**_kwargs(data, str(tmp_path / "port"), 1, **kw)),
                    device="cpu")
    # without the flag the port trains on NaN features
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = Trainer(Config(**_kwargs(data, str(tmp_path / "off"), 1,
                                           debug_nans=False, **kw)),
                          device="cpu")
    assert np.isnan(trainer.bank["train"]["feats"].numpy()).all()


def _unit_inputs(value: float):
    """A small flagship decoder (sat_tpu's flat weights) with init_h's
    bias[0] set to `value`, a bank and two batches."""
    from sat_tpu_torch.models.decoder import (DecoderConfig,
                                              init_decoder_params)
    dcfg = DecoderConfig(vocab_size=20, encoder_dim=8, use_tf=True,
                         use_ado=True, use_attention=True, dropout_rate=0.0)
    gen = torch.Generator().manual_seed(0)
    flat = init_decoder_params(dcfg, gen)
    flat["init_h/b"] = flat["init_h/b"].copy()
    flat["init_h/b"][0] = value
    bank = torch.randn((3, 4, 8), generator=gen)
    caps = torch.randint(4, 20, (5, 6), generator=gen)
    caps[:, 0] = 1
    return dcfg, flat, bank, caps, torch.tensor([[0, 2], [1, 1]]), \
        torch.tensor([[1, 4], [0, 3]])


@pytest.mark.parametrize("value", [float("inf"), float("nan")],
                         ids=["inf", "nan"])
def test_step_flags_nan_not_inf(value):
    """The bank train step and block: an inf parameter with every output
    otherwise finite sets no flag, where sat_tpu's step goes on under
    jax_debug_nans; a NaN parameter sets it, where sat_tpu's raises."""
    from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
    from sat_tpu.parallel import (init_train_state as jax_init_state,
                                  make_bank_train_step as jax_bank_step)

    from sat_tpu_torch.compat.jax_params import decoder_from_jax
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_train_block,
                                                   make_bank_train_step)
    from tests.test_torch_tensor_parallel import _tree

    dcfg, flat, bank, caps, img_idx, row_idx = _unit_inputs(value)
    flags = []
    for blocked in (False, True):
        state = init_train_state(decoder_from_jax(flat, dcfg, "cpu",
                                                  trainable=True))
        if blocked:
            state, m = make_bank_train_block(dcfg, 1.0, debug_nans=True)(
                state, bank, caps, img_idx, row_idx, 1e-3, None)
            flags += m["nan"].tolist()
        else:
            for i in range(2):
                state, m = make_bank_train_step(dcfg, 1.0, debug_nans=True)(
                    state, bank, caps, img_idx[i], row_idx[i], 1e-3, None)
                flags.append(bool(m["nan"]))
        h0 = state.decoder.init_h.bias[0]
        assert bool(h0.isinf() if value == float("inf") else h0.isnan())
        if value == float("inf"):
            assert np.isfinite(float(m["loss"][-1] if blocked
                                     else m["loss"]))
    assert flags == [value != value] * 4

    jcfg = JaxDecoderConfig(vocab_size=20, encoder_dim=8, use_tf=True,
                            use_ado=True, use_attention=True,
                            dropout_rate=0.0)
    params = jax.tree_util.tree_map(jnp.asarray, _tree(flat))
    step = jax_bank_step(jcfg, 1.0)
    with jax_nans_reset():
        jax.config.update("jax_debug_nans", True)
        with (pytest.raises(FloatingPointError) if value != value
              else contextlib.nullcontext()):
            state, m = step(jax_init_state(params), jnp.asarray(bank.numpy()),
                            jnp.asarray(caps.numpy()),
                            jnp.asarray(img_idx[0].numpy(), jnp.int32),
                            jnp.asarray(row_idx[0].numpy(), jnp.int32),
                            jnp.float32(1e-3), jax.random.PRNGKey(0))
            jax.block_until_ready(m)
