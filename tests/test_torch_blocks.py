"""--steps-per-dispatch K: the port's K-step blocks and the Trainer's
blocked epochs, on the CPU (the counterparts of
tests/test_feature_cache.py's steps-per-dispatch tests of sat_tpu).

A blocked run computes what the per-batch run does, bit for bit, dropout
on: parameters, Adam moments and step counts, the dropout generator's
state, the printed meter rows, validation's BLEU and its table. On the
CPU a block is K eager steps, which is what the card's graph replays must
equal (tests/test_torch_cuda.py, chip_smoke.py). The block functions are
also held against sat_tpu's at dropout 0, at the tolerances of
tests/test_torch_train_step.py."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sat_tpu.parallel import init_train_state as jax_init_state
from sat_tpu.parallel import make_bank_eval_block as jax_eval_block
from sat_tpu.parallel import make_bank_train_block as jax_train_block

from sat_tpu_torch.compat.jax_params import decoder_to_jax
from sat_tpu_torch.config import Config
from sat_tpu_torch.engine import checkpoint as ckpt
from sat_tpu_torch.engine.loop import Trainer, TrainingPreempted
from sat_tpu_torch.parallel.train_step import (init_train_state,
                                               make_bank_eval_block,
                                               make_bank_train_block)
from tests.test_torch_common import flat, to_np
from tests.test_torch_resume import _assert_states_equal, _preempt_on_call
from tests.test_torch_train_step import ALPHA_C, LR, _bank, _pair
from tests.test_torch_trainer import (_config_kwargs, _rows,  # noqa: F401
                                      data)  # (fixture)


def _cfg(data, out, **kw):
    base = dict(cache_features=True, dropout_rate=0.5, epochs=1)
    base.update(kw)
    return Config(**_config_kwargs(data, out, **base))


def _trainer(data, out, **kw):
    return Trainer(_cfg(data, out, **kw), device="cpu")


def _lines(out, prefix):
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def _assert_same_run(a: Trainer, b: Trainer):
    _assert_states_equal(a, b)
    assert torch.equal(a.dropout_gen.get_state(), b.dropout_gen.get_state())


# 12 train rows: batch 4 -> 3 full batches, K = 2 -> blocks of 2 and 1;
# batch 5 -> [5, 5, 2], one block of 2 and the short tail per batch
@pytest.mark.parametrize("batch,K", [(4, 2), (4, 3), (5, 2)],
                         ids=["remainder-block", "one-block", "tail-batch"])
def test_blocked_training_is_bit_identical(data, tmp_path, capsys, batch, K):
    runs, lines = {}, {}
    for k in (1, K):
        tr = _trainer(data, str(tmp_path / f"k{k}"), batch_size=batch,
                      steps_per_dispatch=k)
        assert (tr.train_block is not None) == (k > 1)
        capsys.readouterr()
        tr.train_epoch(1)
        lines[k] = _lines(capsys.readouterr().out, "Train Batch")
        runs[k] = tr
    assert runs[K].state.step == runs[1].state.step == 3
    assert lines[K] == lines[1] and len(lines[1]) == 3
    _assert_same_run(runs[1], runs[K])
    rows = [_rows(t.cfg.log_jsonl) for t in (runs[1], runs[K])]
    assert [{k: v for k, v in r.items() if k != "time"} for r in rows[0]] \
        == [{k: v for k, v in r.items() if k != "time"} for r in rows[1]]


def test_preempt_at_a_block_boundary_then_resume(data, tmp_path):
    """batch 2 -> 6 batches, K = 4 -> blocks of 4 and 2. A preemption in
    the first block saves after it (offset 4); the resumed run ends where
    the uninterrupted blocked run does."""
    kw = dict(batch_size=2, steps_per_dispatch=4)
    whole = _trainer(data, str(tmp_path / "whole"), **kw)
    whole.fit()
    assert whole.state.step == 6

    out = str(tmp_path / "cut")
    cut = _trainer(data, out, **kw)
    calls = _preempt_on_call(cut, 1, attr="train_block")
    assert cut.fit() == {"preempted": True, "epoch": 1}
    assert calls["n"] == 1 and cut.state.step == 4
    tree = ckpt.restore_train_state(cut.cfg.checkpoint_dir, 4)
    assert (tree["epoch"], tree["batch_offset"]) == (1, 4)

    resumed = _trainer(data, out, resume=True, **kw)
    assert resumed._resume_batch_offset == 4
    resumed.fit()
    assert resumed.state.step == 6
    _assert_same_run(whole, resumed)


@pytest.mark.parametrize("first,second", [(1, 3), (3, 1)],
                         ids=["per-batch-then-blocked",
                              "blocked-then-per-batch"])
def test_train_state_resumes_across_paths(data, tmp_path, first, second):
    """A state saved by a per-batch run resumes in a blocked run and the
    other way round, and ends where a run never stopped does."""
    whole = _trainer(data, str(tmp_path / "whole"), batch_size=2, epochs=2)
    whole.fit()
    out = str(tmp_path / "cut")
    cut = _trainer(data, out, batch_size=2, epochs=2,
                   steps_per_dispatch=first)
    _preempt_on_call(cut, 1,
                     attr="train_block" if first > 1 else "train_step")
    assert cut.fit() == {"preempted": True, "epoch": 1}
    assert cut.state.step == (first if first > 1 else 1)
    resumed = _trainer(data, out, batch_size=2, epochs=2, resume=True,
                       steps_per_dispatch=second)
    resumed.fit()
    assert resumed.state.step == whole.state.step == 12
    _assert_same_run(whole, resumed)


# 6 val rows: batch 4 -> [4, 2], one block of 1 and the tail; batch 1 -> 6
# batches, K = 2 -> 3 blocks, with a block pending while the next runs
@pytest.mark.parametrize("batch", [4, 1], ids=["block-and-tail",
                                              "three-blocks"])
def test_blocked_validation_is_bit_identical(data, tmp_path, capsys, batch):
    runs = {}
    for k in (1, 2):
        tr = _trainer(data, str(tmp_path / f"v{k}"), batch_size=batch,
                      steps_per_dispatch=k)
        assert (tr.eval_block is not None) == (k > 1)
        capsys.readouterr()
        res = tr.validate(1)
        out = capsys.readouterr().out
        table = [{key: v for key, v in r.items() if key != "time"}
                 for r in _rows(tr.cfg.log_jsonl) if "table" in r]
        runs[k] = (res, _lines(out, "EvalMode"), table)
    assert runs[2][1] == runs[1][1] and len(runs[1][1]) > 1
    assert runs[2][0] == runs[1][0] and "bleu4" in runs[1][0]
    assert runs[2][2] == runs[1][2] and len(runs[1][2]) == 1


def test_blocked_validation_preempt_counts_the_epoch(data, tmp_path):
    tr = _trainer(data, str(tmp_path), batch_size=2, steps_per_dispatch=2)
    tr.request_preempt()
    with pytest.raises(TrainingPreempted):
        tr.validate(1)
    step = ckpt.latest_train_state_step(tr.cfg.checkpoint_dir)
    assert step == 0
    assert ckpt.restore_train_state(tr.cfg.checkpoint_dir,
                                    step)["batch_offset"] == 0


def test_test_pass_stays_per_batch(data, tmp_path):
    """TEST needs each batch's alphas for its plots: the eval block never
    runs there."""
    tr = _trainer(data, str(tmp_path), steps_per_dispatch=2)
    _preempt_on_call(tr, 1, attr="eval_block",
                     request=lambda: pytest.fail("eval block in TEST"))
    res = tr.test(1)
    assert "bleu4" in res
    assert os.listdir(os.path.join(tr.cfg.checkpoint_dir,
                                   "attention_viz_epoch1"))


def test_without_the_bank_it_warns_and_runs_per_batch(data, tmp_path,
                                                      capsys):
    tr = _trainer(data, str(tmp_path), cache_features=False,
                  steps_per_dispatch=8)
    assert "falling back to per-batch dispatch" in capsys.readouterr().out
    assert tr.train_block is None and tr.eval_block is None
    tr.train_epoch(1)
    assert tr.state.step == 3
    assert np.isfinite(tr.validate(1)["loss"])


def test_training_cli_takes_steps_per_dispatch(data, tmp_path):
    from sat_tpu_torch.train import main
    res = main(["--data", data["root"], "--image-size", "32",
                "--batch-size", "4", "--epochs", "1", "--log-interval", "1",
                "--tf", "--ado", "--attention", "--cache-features",
                "--steps-per-dispatch", "2", "--device", "cpu",
                "--checkpoint-dir", str(tmp_path / "model")])
    assert "bleu4" in res and np.isfinite(res["loss"])


# ------------------------------------------------- the blocks vs sat_tpu

def test_train_block_matches_sat_tpu():
    """Three steps, one padded batch, at dropout 0."""
    jcfg, cfg, params, dec = _pair(True, True, True, seed=6)
    feat_bank, caps_bank, batches = _bank(7)
    img_idx = np.stack([b[0] for b in batches])
    row_idx = np.stack([b[1] for b in batches])
    mask = np.ones(img_idx.shape, bool)
    mask[1, -1] = False
    jstate = jax_init_state(jax.tree_util.tree_map(jnp.asarray, params))
    jstate, jm = jax_train_block(jcfg, ALPHA_C)(
        jstate, jnp.asarray(feat_bank), jnp.asarray(caps_bank),
        jnp.asarray(img_idx), jnp.asarray(row_idx), jnp.float32(LR),
        jax.random.PRNGKey(0), jnp.int32(0), jnp.asarray(mask))
    state = init_train_state(dec)
    state, m = make_bank_train_block(cfg, ALPHA_C)(
        state, torch.from_numpy(feat_bank), torch.from_numpy(caps_bank),
        torch.from_numpy(img_idx).long(), torch.from_numpy(row_idx).long(),
        LR, None, torch.from_numpy(mask))
    assert state.step == 3 and m["loss"].shape == (3,)
    np.testing.assert_allclose(to_np(m["loss"]), np.asarray(jm["loss"]),
                               atol=5e-5, rtol=1e-5)
    for k in ("acc1", "acc5"):
        np.testing.assert_allclose(to_np(m[k]), np.asarray(jm[k]), atol=1e-4)
    np.testing.assert_array_equal(to_np(m["caption_length"]),
                                  np.asarray(jm["caption_length"]))
    got, want = decoder_to_jax(state.decoder), flat(jstate.params)
    for name, r in want.items():
        if name == "attention/v/b":   # zero true gradient (train_step test)
            assert np.abs(got[name] - r).max() <= 2.05 * LR * 3, name
            continue
        np.testing.assert_allclose(got[name], r, atol=3e-4, err_msg=name)


def test_eval_block_matches_sat_tpu():
    jcfg, cfg, params, dec = _pair(True, True, True, seed=8)
    feat_bank, caps_bank, batches = _bank(9)
    img_idx = np.stack([b[0] for b in batches])
    row_idx = np.stack([b[1] for b in batches])
    mask = np.ones(img_idx.shape, bool)
    jm, jtok = jax_eval_block(jcfg, ALPHA_C)(
        params, jnp.asarray(feat_bank), jnp.asarray(caps_bank),
        jnp.asarray(img_idx), jnp.asarray(row_idx), jnp.asarray(mask))
    m, tok = make_bank_eval_block(cfg, ALPHA_C)(
        dec, torch.from_numpy(feat_bank), torch.from_numpy(caps_bank),
        torch.from_numpy(img_idx).long(), torch.from_numpy(row_idx).long())
    np.testing.assert_allclose(to_np(m["loss"]), np.asarray(jm["loss"]),
                               atol=5e-5, rtol=1e-5)
    np.testing.assert_array_equal(to_np(tok), np.asarray(jtok))
    assert tok.shape == (3, 4, caps_bank.shape[1] - 1)
