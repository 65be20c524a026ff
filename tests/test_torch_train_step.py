"""The training path against sat_tpu: `decoder_forward` (teacher-forced and
autoregressive, each flag), the bank train step over three Adam steps, the
eval step, remat, dropout and the decoder checkpoint, all on the CPU with
the kernels' plain forms. Parameters come from sat_tpu's initializers.

Tolerances: preds and alphas atol 1e-5 (f32, other summation orders);
losses atol 5e-5, rtol 1e-5 and updated params atol 3e-4 from
tests/test_train_parity.py, whose reasons hold here too (Adam normalizes
each gradient entry, so a near-zero gradient's rounding can flip a
±lr step; the attention score bias's true gradient is exactly zero)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sat_tpu.engine.checkpoint import load_decoder_checkpoint
from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from sat_tpu.models.decoder import decoder_forward as jax_decoder_forward
from sat_tpu.models.decoder import init_decoder_params as jax_init_decoder
from sat_tpu.parallel import init_train_state as jax_init_state
from sat_tpu.parallel import make_bank_eval_step as jax_bank_eval
from sat_tpu.parallel import make_bank_train_step as jax_bank_step

from sat_tpu_torch.compat.jax_params import decoder_from_jax, decoder_to_jax
from sat_tpu_torch.engine.checkpoint import save_decoder_checkpoint
from sat_tpu_torch.models.decoder import (Decoder, DecoderConfig, _dropout,
                                          decoder_forward)
from sat_tpu_torch.parallel.train_step import (init_train_state,
                                               make_bank_eval_step,
                                               make_bank_train_step)
from sat_tpu_torch.utils.metrics import (attention_regularization,
                                         reference_packed_cross_entropy)
from tests.test_torch_common import flat, to_np

V, D, L, B, CAP = 40, 32, 6, 4, 7
U, N = 5, 9          # bank: unique images, caption rows
LR, ALPHA_C, STEPS = 1e-3, 1.0, 3
FLAGS = [(tf, ado, att) for tf in (True, False) for ado in (False, True)
         for att in (False, True)]


def _configs(tf, ado, att, **kw):
    args = dict(vocab_size=V, encoder_dim=D, use_tf=tf, use_ado=ado,
                use_attention=att, dropout_rate=0.0, **kw)
    return JaxDecoderConfig(**args), DecoderConfig(**args)


def _pair(tf, ado, att, seed=0, **kw):
    jcfg, cfg = _configs(tf, ado, att, **kw)
    params = jax_init_decoder(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, params, decoder_from_jax(flat(params), cfg, "cpu",
                                               trainable=True)


def _captions(seed, rows):
    caps = np.random.default_rng(seed).integers(4, V, size=(rows, CAP))
    caps[:, 0] = 0
    caps[:, -1] = 1
    caps[0, -3:-1] = 3            # some padding
    return caps.astype(np.int32)


def _features(seed, rows):
    return np.random.default_rng(seed).normal(size=(rows, L, D)).astype(
        np.float32)


@pytest.mark.parametrize("tf,ado,att", FLAGS)
def test_decoder_forward_matches_sat_tpu(tf, ado, att):
    jcfg, cfg, params, dec = _pair(tf, ado, att)
    feats, caps = _features(1, B), _captions(2, B)
    ref_p, ref_a = jax_decoder_forward(params, jcfg, jnp.asarray(feats),
                                       jnp.asarray(caps))
    with torch.no_grad():
        preds, alphas = decoder_forward(dec, cfg, torch.from_numpy(feats),
                                        torch.from_numpy(caps))
    assert preds.shape == (B, CAP - 1, V) and alphas.shape == (B, CAP - 1, L)
    np.testing.assert_allclose(to_np(preds), np.asarray(ref_p), atol=1e-5)
    np.testing.assert_allclose(to_np(alphas), np.asarray(ref_a), atol=1e-5)


def _grads(dec, cfg, feats, caps):
    dec.zero_grad(set_to_none=True)
    preds, alphas = decoder_forward(dec, cfg, feats, caps)
    loss = (reference_packed_cross_entropy(preds, caps[:, 1:].long())
            + attention_regularization(alphas, ALPHA_C))
    loss.backward()
    return {n: p.grad.clone() for n, p in dec.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("tf", [True, False], ids=["tf", "autoregressive"])
def test_remat_gives_identical_grads(tf):
    _, cfg, _, dec = _pair(tf, True, True, seed=3)
    feats = torch.from_numpy(_features(4, B))
    caps = torch.from_numpy(_captions(5, B))
    on = _grads(dec, cfg, feats, caps)
    off = _grads(dec, dataclasses.replace(cfg, remat_scan=False), feats, caps)
    assert on.keys() == off.keys() and "attention.U.weight" in on
    for name in on:
        torch.testing.assert_close(on[name], off[name], rtol=0, atol=0,
                                   msg=name)


def _bank(seed):
    rng = np.random.default_rng(seed)
    return (_features(seed, U), _captions(seed + 1, N),
            [(rng.integers(0, U, B).astype(np.int32),
              rng.integers(0, N, B).astype(np.int32)) for _ in range(STEPS)])


@pytest.mark.parametrize("tf,ado,att", [(True, True, True),
                                        (True, False, False),
                                        (False, True, True)],
                         ids=["flagship", "tf-plain", "autoregressive"])
def test_bank_train_steps_match_sat_tpu(tf, ado, att):
    jcfg, cfg, params, dec = _pair(tf, ado, att, seed=6)
    feat_bank, caps_bank, batches = _bank(7)
    mask = np.array([True, True, True, False])

    jstate = jax_init_state(jax.tree_util.tree_map(jnp.asarray, params))
    jstep = jax_bank_step(jcfg, ALPHA_C)
    state = init_train_state(dec)
    step = make_bank_train_step(cfg, ALPHA_C)
    ref_losses, losses = [], []
    for i, (img_idx, row_idx) in enumerate(batches):
        row_mask = mask if i == 1 else None      # one padded batch
        jstate, jm = jstep(jstate, jnp.asarray(feat_bank),
                           jnp.asarray(caps_bank), jnp.asarray(img_idx),
                           jnp.asarray(row_idx), jnp.float32(LR),
                           jax.random.PRNGKey(i),
                           None if row_mask is None else jnp.asarray(row_mask))
        state, m = step(state, torch.from_numpy(feat_bank),
                        torch.from_numpy(caps_bank),
                        torch.from_numpy(img_idx).long(),
                        torch.from_numpy(row_idx).long(), LR, None,
                        None if row_mask is None
                        else torch.from_numpy(row_mask))
        ref_losses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
        for k in ("acc1", "acc5"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-4,
                                       err_msg=k)
        assert int(m["caption_length"]) == int(jm["caption_length"])
    assert state.step == STEPS
    np.testing.assert_allclose(losses, ref_losses, atol=5e-5, rtol=1e-5)

    got = decoder_to_jax(state.decoder)
    want = flat(jstate.params)
    assert sorted(got) == sorted(want)
    for name, r in want.items():
        if name == "attention/v/b":
            # zero true gradient: Adam turns rounding noise into ±lr steps
            # of framework-dependent sign (tests/test_train_parity.py)
            assert np.abs(got[name] - r).max() <= 2.05 * LR * STEPS, name
            continue
        np.testing.assert_allclose(got[name], r, atol=3e-4, err_msg=name)


def test_bank_eval_step_matches_sat_tpu():
    jcfg, cfg, params, dec = _pair(True, True, True, seed=8)
    feat_bank, caps_bank, batches = _bank(9)
    img_idx, row_idx = batches[0]
    jm, jtok, jal = jax_bank_eval(jcfg, ALPHA_C)(
        params, jnp.asarray(feat_bank), jnp.asarray(caps_bank),
        jnp.asarray(img_idx), jnp.asarray(row_idx))
    m, tok, al = make_bank_eval_step(cfg, ALPHA_C)(
        dec, torch.from_numpy(feat_bank), torch.from_numpy(caps_bank),
        torch.from_numpy(img_idx).long(), torch.from_numpy(row_idx).long())
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=5e-5, rtol=1e-5)
    np.testing.assert_array_equal(to_np(tok), np.asarray(jtok))
    np.testing.assert_allclose(to_np(al), np.asarray(jal), atol=1e-5)
    assert all(p.grad is None for p in dec.parameters())


def test_dropout_masks():
    """Masks keep about 1 - rate, scale kept entries by 1 / (1 - rate), and
    repeat under one seed; off without a generator."""
    x = torch.ones((64, 256))
    rate = 0.3
    a = _dropout(x, rate, torch.Generator().manual_seed(5))
    b = _dropout(x, rate, torch.Generator().manual_seed(5))
    c = _dropout(x, rate, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.02
    torch.testing.assert_close(a[kept], torch.full_like(a[kept],
                                                        1 / (1 - rate)))
    assert _dropout(x, rate, None) is x


def test_dropout_acts_only_in_training():
    _, cfg, _, dec = _pair(True, True, True, seed=10)
    cfg = dataclasses.replace(cfg, dropout_rate=0.5)
    feats = torch.from_numpy(_features(11, B))
    caps = torch.from_numpy(_captions(12, B))
    with torch.no_grad():
        p0, _ = decoder_forward(dec, cfg, feats, caps)
        p1, _ = decoder_forward(dec, cfg, feats, caps,
                                generator=torch.Generator().manual_seed(0))
        p2, _ = decoder_forward(dec, cfg, feats, caps, train=True,
                                generator=torch.Generator().manual_seed(0))
    assert torch.equal(p0, p1) and not torch.equal(p0, p2)


@pytest.mark.parametrize("ado", [False, True])
def test_checkpoint_loads_strictly_in_sat_tpu(tmp_path, ado):
    jcfg, cfg, params, dec = _pair(True, ado, True, seed=13)
    with torch.no_grad():
        dec.embedding.weight.add_(1.0)          # differs from the init
    path = save_decoder_checkpoint(str(tmp_path), "vgg19", 3, dec)
    assert path.endswith("model_vgg19_3.npz")
    loaded = load_decoder_checkpoint(path, params, strict=True)
    got = flat(loaded)
    want = decoder_to_jax(dec)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_array_equal(got["embedding"],
                                  np.asarray(params["embedding"]) + 1.0)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="BERT"):
        Decoder(DecoderConfig(vocab_size=V, encoder_dim=D, use_bert=True))
