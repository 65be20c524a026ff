"""The port's bf16 options against sat_tpu's, on the CPU with the kernels'
plain forms: bf16 keys and features through the attention middle (forward
and backward), `bf16_attention` in the decoder, the bf16 beam (dedup and
flat), the bf16 encoder, `build_caption_step(bf16=True)`, and the Trainer
with `--bank-dtype bfloat16`, `--bf16-encoder` and `--bf16-attention`.

What is held to what, and why:
  - The port computes the attention middle in f32 from bf16 keys and
    features, which is what sat_tpu's Pallas kernels do on bf16 inputs
    (bf16 + f32 promotes). So the middle, the decoder's forward and the
    beam are held to sat_tpu's fused path at f32 rounding: ctx, alpha,
    logits and scores atol 1e-5 (alpha 1e-6), as the f32 tests.
  - sat_tpu's plain path (its default, `fused_attention=False`) rounds the
    tanh and the scores to bf16 as well. Against it the port is held at
    the looser bounds stated in each test.
  - sat_tpu's fused VJP cannot take bf16 keys (its backward returns f32
    dkeys for them and jax.grad fails), so training gradients are held to
    sat_tpu's plain bf16 path, normwise, as tests/test_decoder.py holds
    that path to f32.
  - The backward's dkeys and dfeats are bf16 in the port and f32 in
    sat_tpu's kernel: the port's are held to sat_tpu's rounded to bf16,
    within one bf16 unit in the last place (2^-7 of the value) where the
    two f32 values straddle a rounding point.
  - XLA and PyTorch round bf16 convolutions at other places, so the bf16
    encoders agree to a stated mean relative difference; the decode is
    then held exactly given the same bf16 grid.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sat_tpu.models.beam import beam_search_batched as jax_beam
from sat_tpu.models.beam import greedy_caption as jax_greedy
from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from sat_tpu.models.decoder import decoder_forward as jax_decoder_forward
from sat_tpu.models.decoder import init_decoder_params as jax_init_decoder
from sat_tpu.models.encoder import encoder_forward as jax_encoder
from sat_tpu.ops.fused_attention import (_fused_attention_bwd,
                                         fused_attention_block)

from sat_tpu_torch.compat.jax_params import decoder_from_jax, encoder_from_jax
from sat_tpu_torch.config import Config, unported_options
from sat_tpu_torch.engine.serving import build_caption_step
from sat_tpu_torch.models.beam import beam_search_batched as port_beam
from sat_tpu_torch.models.beam import greedy_caption as port_greedy
from sat_tpu_torch.models.decoder import DecoderConfig, decoder_forward
from sat_tpu_torch.models.encoder import encoder_forward as port_encoder
from sat_tpu_torch.models.encoder import \
    init_encoder_params as port_init_encoder
from sat_tpu_torch.ops.fused_attention import (_check_layout, attention_bwd,
                                               attention_bwd_plain,
                                               attention_fwd, attention_plain)
from sat_tpu_torch.utils.graphs import GraphCache
from sat_tpu_torch.utils.metrics import (attention_regularization,
                                         reference_packed_cross_entropy)
from tests.test_torch_common import flat, to_np

BF16 = torch.bfloat16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, L, B, CAP = 40, 32, 6, 3, 7     # the decoder's E is 512
MAX_STEPS = 8


def _bf16(a: np.ndarray) -> torch.Tensor:
    """An f32 array rounded to bf16 (to nearest even) as a torch tensor."""
    return torch.from_numpy(a).to(BF16)


def _jnp(t: torch.Tensor):
    """A bf16 torch tensor as the same bf16 values in JAX."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _middle_inputs(Bx, Lx, E, Dx, seed, R=1):
    rng = np.random.default_rng(seed)
    keys = _bf16(rng.normal(size=(Bx, Lx, E)).astype(np.float32))
    feats = _bf16(rng.normal(size=(Bx, Lx, Dx)).astype(np.float32))
    u_h = rng.normal(size=(Bx * R, E)).astype(np.float32)
    v = (rng.normal(size=(E,)) / np.sqrt(E)).astype(np.float32)
    b_v = rng.normal(size=(1,)).astype(np.float32)
    return keys, feats, u_h, v, b_v


# ----------------------------------------------------------- the middle

@pytest.mark.parametrize("R", [1, 3])
def test_bf16_forward_plain_matches_pallas_block(R):
    """attention_plain on bf16 keys and features against sat_tpu's Pallas
    block (interpret mode) on the same bf16 values; at R = K the Pallas
    block sees each image's grid repeated for its K rows. ctx atol 1e-5,
    alpha atol 1e-6: f32 math on both sides."""
    keys, feats, u_h, v, b_v = _middle_inputs(2, 9, 16, 24, R, R)
    rep = lambda t: _jnp(t.repeat_interleave(R, dim=0))  # noqa: E731
    ref_ctx, ref_alpha = fused_attention_block(
        rep(keys), rep(feats), jnp.asarray(u_h), jnp.asarray(v[:, None]),
        jnp.asarray(b_v), interpret=True)
    assert ref_ctx.dtype == jnp.float32
    args = (keys, feats, torch.from_numpy(u_h), torch.from_numpy(v),
            torch.from_numpy(b_v), R)
    for fn in (attention_plain, attention_fwd):
        ctx, alpha = fn(*args)
        assert ctx.dtype == alpha.dtype == torch.float32
        np.testing.assert_allclose(to_np(ctx), np.asarray(ref_ctx),
                                   atol=1e-5)
        np.testing.assert_allclose(to_np(alpha), np.asarray(ref_alpha),
                                   atol=1e-6)


def _assert_bf16_close(got: torch.Tensor, ref_f32: np.ndarray, name: str):
    """got (bf16) is ref_f32 rounded to bf16, but for values where the
    port's f32 value (within 1e-5 of ref_f32) rounds to the neighbour: one
    bf16 unit in the last place, 2^-7 of the value, plus that 1e-5."""
    assert got.dtype == BF16, name
    want = torch.tensor(np.asarray(ref_f32, np.float32)).to(BF16).float()
    err = (got.float() - want).abs()
    assert bool((err <= 2 ** -7 * want.abs() + 1e-5).all()), name
    assert float((err > 0).float().mean()) < 0.01, name   # rare flips only


@pytest.mark.parametrize("want_dfeats", [True, False])
def test_bf16_backward_plain_matches_pallas_backward(want_dfeats):
    """All five outputs of attention_bwd_plain on bf16 keys and features
    against sat_tpu's Pallas backward (interpret mode) on the same values:
    du_h atol 1e-5; dv and db_v, sums over B·L terms, as in
    tests/test_torch_attention_bwd.py; dkeys and dfeats bf16 against
    sat_tpu's f32 rounded to bf16."""
    Bx, Lx, E, Dx = 3, 9, 16, 24
    keys, feats, u_h, v, b_v = _middle_inputs(Bx, Lx, E, Dx, 11)
    rng = np.random.default_rng(12)
    dctx = rng.normal(size=(Bx, Dx)).astype(np.float32)
    dalpha = rng.normal(size=(Bx, Lx)).astype(np.float32)
    _, alpha = attention_plain(keys, feats, torch.from_numpy(u_h),
                               torch.from_numpy(v), torch.from_numpy(b_v))
    alpha = to_np(alpha)
    ref = _fused_attention_bwd(_jnp(keys), _jnp(feats), jnp.asarray(u_h),
                               jnp.asarray(v[:, None]), jnp.asarray(alpha),
                               jnp.asarray(dctx), jnp.asarray(dalpha),
                               interpret=True)
    assert all(r.dtype == jnp.float32 for r in ref)
    args = (keys, feats, torch.from_numpy(u_h), torch.from_numpy(v),
            torch.from_numpy(alpha), torch.from_numpy(dctx),
            torch.from_numpy(dalpha))
    for fn in (attention_bwd_plain, attention_bwd):
        dkeys, dfeats, du_h, dv, db_v = fn(*args, want_dfeats=want_dfeats)
        _assert_bf16_close(dkeys, ref[0], "dkeys")
        if want_dfeats:
            _assert_bf16_close(dfeats, ref[1], "dfeats")
        else:
            assert dfeats is None
        np.testing.assert_allclose(to_np(du_h), np.asarray(ref[2]),
                                   atol=1e-5)
        np.testing.assert_allclose(to_np(dv), np.asarray(ref[3])[:, 0],
                                   atol=1e-4 * np.abs(ref[3]).max())
        g = np.einsum("bld,bd->bl", feats.float().numpy(), dctx) + dalpha
        de = alpha * (g - (alpha * g).sum(axis=1, keepdims=True))
        np.testing.assert_allclose(to_np(db_v), np.asarray(ref[4]),
                                   atol=1e-5 * float(np.abs(de).sum()))


@pytest.mark.parametrize("case", ["keys-bf16-feats-f32", "u_h-bf16",
                                  "f16", "bwd-alpha-bf16"])
def test_wrappers_raise_on_mixed_dtypes(case):
    keys, feats, u_h, v, b_v = _middle_inputs(2, 4, 8, 8, 0)
    u_h, v, b_v = map(torch.from_numpy, (u_h, v, b_v))
    fwd = {"keys-bf16-feats-f32": (keys, feats.float(), u_h, v, b_v),
           "u_h-bf16": (keys, feats, u_h.to(BF16), v, b_v),
           "f16": (keys.half(), feats.half(), u_h, v, b_v)}
    before = (attention_fwd.launches_bf16, attention_bwd.launches_bf16)
    with pytest.raises(TypeError):
        if case in fwd:
            attention_fwd(*fwd[case])
        else:
            alpha = torch.full((2, 4), 0.25)
            attention_bwd(keys, feats, u_h, v, alpha.to(BF16),
                          torch.zeros(2, 8), torch.zeros(2, 4))
    assert (attention_fwd.launches_bf16,
            attention_bwd.launches_bf16) == before


@pytest.mark.parametrize("case", ["E-not-multiple-of-8", "start-off-16"])
def test_layout_check_refuses_misaligned_bf16_rows(case):
    """What the card's wrappers check before a bf16 launch: rows that are
    whole 16-byte units (E and D multiples of 8) from 16-byte aligned
    starts. A width of 4 is enough for f32 rows and too little for bf16."""
    if case == "E-not-multiple-of-8":
        keys, feats = torch.zeros(2, 3, 12, dtype=BF16), torch.zeros(
            2, 3, 16, dtype=BF16)
        _check_layout("attention_fwd", keys.float(), feats.float())
        match = "multiples of 8"
    else:
        base = torch.zeros(2 * 3 * 16 + 1, dtype=BF16)
        keys = base[1:].view(2, 3, 16)         # starts 2 bytes in
        feats = torch.zeros(2, 3, 16, dtype=BF16)
        match = "16-byte aligned"
    with pytest.raises(ValueError, match=match):
        _check_layout("attention_fwd", keys, feats)


# ------------------------------------------------------------ decoder

def _pair(tf=True, ado=True, att=True, seed=0, **kw):
    args = dict(vocab_size=V, encoder_dim=D, use_tf=tf, use_ado=ado,
                use_attention=att, dropout_rate=0.0)
    jcfg = JaxDecoderConfig(**args, **kw)
    params = jax_init_decoder(jax.random.PRNGKey(seed), jcfg)
    cfg = DecoderConfig(**args, bf16_attention=True)
    return jcfg, params, cfg, decoder_from_jax(flat(params), cfg, "cpu",
                                               trainable=True)


def _decoder_inputs(seed, rows=B):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(rows, L, D)).astype(np.float32)
    caps = rng.integers(4, V, size=(rows, CAP))
    caps[:, 0], caps[:, -1] = 0, 1
    caps[0, -3:-1] = 3
    return feats, caps.astype(np.int32)


@pytest.mark.parametrize("tf", [True, False], ids=["tf", "autoregressive"])
def test_bf16_decoder_forward_matches_sat_tpu(tf):
    """Against sat_tpu's fused bf16 path (the same function): logits and
    alphas atol 1e-5. Against sat_tpu's default bf16 path, which rounds
    the tanh and the scores to bf16: logits atol 2e-2, alphas 2e-3 (the
    bf16 rounding of scores of size ~1, through the softmax)."""
    jcfg, params, cfg, dec = _pair(tf=tf, seed=1,
                                   fused_attention=True, bf16_attention=True)
    feats, caps = _decoder_inputs(2)
    with torch.no_grad():
        preds, alphas = decoder_forward(dec, cfg, torch.from_numpy(feats),
                                        torch.from_numpy(caps))
    fused_p, fused_a = jax_decoder_forward(params, jcfg, jnp.asarray(feats),
                                           jnp.asarray(caps))
    np.testing.assert_allclose(to_np(preds), np.asarray(fused_p), atol=1e-5)
    np.testing.assert_allclose(to_np(alphas), np.asarray(fused_a), atol=1e-5)
    plain_cfg = dataclasses.replace(jcfg, fused_attention=False)
    plain_p, plain_a = jax_decoder_forward(params, plain_cfg,
                                           jnp.asarray(feats),
                                           jnp.asarray(caps))
    np.testing.assert_allclose(to_np(preds), np.asarray(plain_p), atol=2e-2)
    np.testing.assert_allclose(to_np(alphas), np.asarray(plain_a), atol=2e-3)


def _loss(preds, alphas, caps):
    return (reference_packed_cross_entropy(preds, caps[:, 1:].long())
            + attention_regularization(alphas, 1.0))


def _port_grads(dec, cfg, feats, caps):
    dec.zero_grad(set_to_none=True)
    loss = _loss(*decoder_forward(dec, cfg, feats, caps), caps)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in dec.named_parameters()
                         if p.grad is not None}


def test_bf16_decoder_gradients_match_sat_tpu_plain_path():
    """Loss and gradients of the reference loss against jax.grad of
    sat_tpu's default bf16 path, compared as tests/test_decoder.py compares
    that path with f32: the loss to rtol 1e-3, each gradient normwise
    within 5 %. (sat_tpu's fused VJP cannot take bf16 keys.)"""
    from sat_tpu.utils.metrics import (attention_regularization as jreg,
                                       reference_packed_cross_entropy as jce)
    from sat_tpu_torch.compat.jax_params import decoder_to_jax

    jcfg, params, cfg, dec = _pair(seed=3, bf16_attention=True)
    feats, caps = _decoder_inputs(4)

    def jloss(p):
        preds, alphas = jax_decoder_forward(p, jcfg, jnp.asarray(feats),
                                            jnp.asarray(caps))
        return (jce(preds, jnp.asarray(caps)[:, 1:])
                + jreg(alphas, 1.0))

    ref_loss, ref_grads = jax.value_and_grad(jloss)(params)
    loss, grads = _port_grads(dec, cfg, torch.from_numpy(feats),
                              torch.from_numpy(caps))
    assert loss == pytest.approx(float(ref_loss), rel=1e-3)
    ref = flat(ref_grads)
    holder = copy.deepcopy(dec)      # the gradients in sat_tpu's layout
    with torch.no_grad():
        for n, p in holder.named_parameters():
            p.copy_(grads.get(n, torch.zeros_like(p)))
    got = decoder_to_jax(holder)
    checked = 0
    for name, r in ref.items():
        if name == "attention/v/b":   # true gradient exactly 0: noise
            continue
        a, b = np.asarray(r, np.float64), np.asarray(got[name], np.float64)
        if not np.abs(a).max():
            continue                  # e.g. embedding rows never used
        rel = np.linalg.norm(b - a) / np.linalg.norm(a)
        assert rel < 0.05, f"{name}: normwise grad error {rel:.4f}"
        checked += 1
    assert checked >= 10


@pytest.mark.parametrize("tf", [True, False], ids=["tf", "autoregressive"])
def test_bf16_remat_gives_identical_grads(tf):
    _, _, cfg, dec = _pair(tf=tf, seed=5)
    feats, caps = map(torch.from_numpy, _decoder_inputs(6))
    _, on = _port_grads(dec, cfg, feats, caps)
    _, off = _port_grads(dec, dataclasses.replace(cfg, remat_scan=False),
                         feats, caps)
    assert on.keys() == off.keys() and "attention.W.weight" in on
    for name in on:
        torch.testing.assert_close(on[name], off[name], rtol=0, atol=0,
                                   msg=name)


# --------------------------------------------------------------- beam

def _beam_pair(seed, attention=True):
    jcfg = JaxDecoderConfig(vocab_size=V, encoder_dim=D, use_ado=True,
                            use_attention=attention, fused_attention=True)
    params = jax_init_decoder(jax.random.PRNGKey(seed), jcfg)
    cfg = DecoderConfig(vocab_size=V, encoder_dim=D, use_ado=True,
                        use_attention=attention)
    return jcfg, params, decoder_from_jax(flat(params), cfg, "cpu")


def _beam_features(seed):
    return np.random.default_rng(seed).normal(size=(B, L, D)).astype(
        np.float32)


@pytest.mark.parametrize("dedup", [True, False], ids=["dedup", "flat"])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_beam_matches_sat_tpu_fused_flat_beam(seed, dedup):
    """The port's bf16 beam against sat_tpu's flat bf16 beam through its
    fused kernel (the same function), given the same f32 grid: tokens,
    lengths and found equal, scores and alphas atol 1e-5."""
    jcfg, params, dec = _beam_pair(seed)
    feats = _beam_features(10 + seed)
    ref = jax_beam(params, jcfg, jnp.asarray(feats), 3, max_steps=MAX_STEPS,
                   dedup=False, bf16=True)
    got = port_beam(dec, torch.from_numpy(feats), 3, max_steps=MAX_STEPS,
                    dedup=dedup, bf16=True)
    for name in ("tokens", "length", "found"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("score", "alphas", "fallback_alpha"):
        np.testing.assert_allclose(to_np(getattr(got, name)),
                                   np.asarray(getattr(ref, name)), atol=1e-5,
                                   err_msg=name)


def test_bf16_beam_near_sat_tpu_default_dedup_beam():
    """Against sat_tpu's default (dedup) bf16 beam, whose tanh and scores
    are rounded to bf16: the same tokens on these seeds, scores (sums of
    up to 8 logits of size ~1) within atol 5e-3."""
    for seed in (0, 1):
        jcfg, params, dec = _beam_pair(seed)
        jcfg = dataclasses.replace(jcfg, fused_attention=False)
        feats = _beam_features(10 + seed)
        ref = jax_beam(params, jcfg, jnp.asarray(feats), 3,
                       max_steps=MAX_STEPS, bf16=True)
        got = port_beam(dec, torch.from_numpy(feats), 3,
                        max_steps=MAX_STEPS, bf16=True)
        np.testing.assert_array_equal(to_np(got.tokens),
                                      np.asarray(ref.tokens))
        np.testing.assert_allclose(to_np(got.score), np.asarray(ref.score),
                                   atol=5e-3)


def test_bf16_beam_without_attention_matches_sat_tpu():
    """No attention: the bf16 grid's mean is the context, in bf16 and
    widened, as JAX promotes it."""
    jcfg, params, dec = _beam_pair(2, attention=False)
    feats = _beam_features(12)
    ref = jax_beam(params, jcfg, jnp.asarray(feats), 3, max_steps=MAX_STEPS,
                   dedup=False, bf16=True)
    got = port_beam(dec, torch.from_numpy(feats), 3, max_steps=MAX_STEPS,
                    bf16=True)
    np.testing.assert_array_equal(to_np(got.tokens), np.asarray(ref.tokens))
    np.testing.assert_allclose(to_np(got.score), np.asarray(ref.score),
                               atol=1e-5)


def test_bf16_and_f32_beams_in_turns_through_one_graph_cache():
    """f32 and bf16 decodes in turns through one GraphCache each give what
    they give alone, and differ from each other (on the card the cache
    captures them apart: tests/test_torch_cuda.py)."""
    _, _, dec = _beam_pair(3)
    feats = torch.from_numpy(_beam_features(13))
    alone = {bf: port_beam(dec, feats, 3, max_steps=MAX_STEPS, bf16=bf)
             for bf in (False, True)}
    cache = GraphCache()
    for bf in (False, True, False):
        got = port_beam(dec, feats, 3, max_steps=MAX_STEPS, bf16=bf,
                        graphs=cache)
        for a, b in zip(alone[bf], got):
            assert torch.equal(a, b)
    assert not torch.equal(alone[False].fallback_alpha,
                           alone[True].fallback_alpha)


# ------------------------------------------------------------ encoder

@pytest.fixture(scope="module")
def vgg_pair():
    """sat_tpu's VGG19 param tree and the port's encoder, from one set of
    weights drawn by the port's initializer (sat_tpu's takes seconds)."""
    weights = port_init_encoder("vgg19", torch.Generator().manual_seed(0))
    params = {}
    for name, arr in weights.items():
        layer, part = name.split("/")
        params.setdefault(layer, {})[part] = jnp.asarray(arr)
    return params, encoder_from_jax(weights, "vgg19", device="cpu")


def test_bf16_encoder_matches_sat_tpu(vgg_pair):
    """f32 out, contiguous; the mean relative difference to sat_tpu's bf16
    grid under 1e-2 (bf16 rounds at other places in XLA's and PyTorch's
    convs, 16 layers deep); both within sat_tpu's own 0.1 of the f32 grid
    (tests/test_encoder.py::test_bf16_compute_path)."""
    params, enc = vgg_pair
    images = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    ref = np.asarray(jax_encoder(params, "vgg19", jnp.asarray(images),
                                 jnp.bfloat16))
    # the f32 grid, which tests/test_torch_encoder.py holds to sat_tpu's
    f32 = to_np(port_encoder(enc, "vgg19", images))
    got = port_encoder(enc, "vgg19", images, torch.bfloat16)
    assert got.dtype == torch.float32 and got.is_contiguous()
    got = to_np(got)

    def rel(a, b):
        return np.abs(a - b).mean() / (np.abs(b).mean() + 1e-8)

    assert rel(got, ref) < 1e-2
    assert rel(got, f32) < 0.1 and rel(ref, f32) < 0.1


def test_bf16_weights_are_cast_once_per_encoder(vgg_pair):
    """One bf16 copy of the weights, made at the first bf16 call, reused
    by the next, and made anew after the weights change."""
    _, enc = vgg_pair
    images = np.zeros((1, 16, 16, 3), np.float32)
    port_encoder(enc, "vgg19", images, torch.bfloat16)
    first = enc._cast_weights
    port_encoder(enc, "vgg19", images, torch.bfloat16)
    assert enc._cast_weights is first
    w = enc.features["0"].weight
    assert first[1]["features.0.weight"].dtype == BF16
    assert torch.equal(first[1]["features.0.weight"], w.detach().to(BF16))
    with torch.no_grad():
        saved = w.clone()
        w.add_(1.0)
        try:
            port_encoder(enc, "vgg19", images, torch.bfloat16)
            assert enc._cast_weights is not first
            assert torch.equal(enc._cast_weights[1]["features.0.weight"],
                               w.to(BF16))
        finally:
            w.copy_(saved)


# ------------------------------------------------------------ serving

def test_bf16_caption_step_decodes_the_bf16_grid_as_sat_tpu(vgg_pair):
    """build_caption_step(bf16=True): the bf16 encoder for beam and greedy;
    given that grid, the beam decodes as sat_tpu's fused flat bf16 beam and
    greedy as sat_tpu's (f32) greedy: tokens, lengths and found equal,
    scores and alphas atol 1e-5."""
    params, enc = vgg_pair
    jcfg = JaxDecoderConfig(vocab_size=V, encoder_dim=512, use_ado=True,
                            use_attention=True, fused_attention=True)
    dparams = jax_init_decoder(jax.random.PRNGKey(6), jcfg)
    dcfg = DecoderConfig(vocab_size=V, encoder_dim=512, use_ado=True,
                         use_attention=True)
    dec = decoder_from_jax(flat(dparams), dcfg, "cpu")
    images = np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    grid = port_encoder(enc, "vgg19", images, torch.bfloat16)
    beam = build_caption_step("vgg19", dcfg, 3, bf16=True, device="cpu")(
        enc, dec, images)
    ref = jax_beam(dparams, jcfg, jnp.asarray(to_np(grid)), 3, dedup=False,
                   bf16=True)
    for name in ("tokens", "length", "found"):
        np.testing.assert_array_equal(to_np(beam[name]),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(to_np(beam["score"]), np.asarray(ref.score),
                               atol=1e-5)
    greedy = build_caption_step("vgg19", dcfg, 3, bf16=True, decode="greedy",
                                device="cpu")(enc, dec, images)
    toks, lens = jax_greedy(dparams, jcfg, jnp.asarray(to_np(grid)))
    np.testing.assert_array_equal(to_np(greedy["tokens"])[:, 1:],
                                  np.asarray(toks))
    got_toks, got_lens = port_greedy(dec, grid)
    np.testing.assert_array_equal(to_np(got_lens), np.asarray(lens))
    np.testing.assert_array_equal(to_np(got_toks), np.asarray(toks))


def test_serve_bf16_decode_flag_runs_the_bf16_step(tmp_path):
    """`serve --bf16-decode` builds the server on the bf16 caption step: its
    caption function gives build_caption_step(bf16=True)'s result."""
    from sat_tpu_torch.models.decoder import init_decoder_params
    from sat_tpu_torch.models.encoder import init_encoder_params
    from sat_tpu_torch.serve import build_parser, build_server, load_model

    gen = torch.Generator().manual_seed(0)
    dcfg = DecoderConfig(vocab_size=V, encoder_dim=512, use_ado=True,
                         use_attention=True)
    words = ["<start>", "<eos>", "<unk>", "<pad>"] + [
        f"w{i}" for i in range(4, V)]
    with open(tmp_path / "word_dict.json", "w") as f:
        json.dump({w: i for i, w in enumerate(words)}, f)
    with open(tmp_path / "model_config.json", "w") as f:
        json.dump({"data": str(tmp_path), "network": "vgg19", "ado": True,
                   "attention": True, "bert": False, "tf": False,
                   "image_size": 32}, f)
    model, enc_path = tmp_path / "model_vgg19_0.npz", tmp_path / "vgg19.npz"
    params = init_decoder_params(dcfg, gen)
    params["ado/f_out/b"][1] += 3.0    # <eos>: beams complete, scores finite
    np.savez(model, **params)
    np.savez(enc_path, **init_encoder_params("vgg19", gen))
    args = build_parser().parse_args([
        "--model", str(model), "--encoder-weights", str(enc_path),
        "--device", "cpu", "--bf16-decode", "--port", "0"])
    server = build_server(args)
    images = np.random.default_rng(8).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    got = server._caption_fn(images)
    _, dcfg2, enc, dec, _ = load_model(str(model), None,
                                       encoder_weights=str(enc_path),
                                       device="cpu")
    want = build_caption_step("vgg19", dcfg2, 5, bf16=True, device="cpu")(
        enc, dec, images)
    f32 = build_caption_step("vgg19", dcfg2, 5, device="cpu")(
        enc, dec, images)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert bool(got["found"].all())
    assert not torch.equal(got["score"], f32["score"])


# ------------------------------------------------------------ trainer

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from sat_tpu.data import generate_json_data
    from tests._synth import build_synth_dataset
    root = str(tmp_path_factory.mktemp("bf16_data"))
    build_synth_dataset(root, n_train=4, n_val=2, n_test=2, caps_per_img=2,
                        image_size=32)
    generate_json_data(f"{root}/dataset.json", root, 2, 1, 10)
    return root


def _trainer_cfg(data, out, **kw):
    args = dict(data=data, image_size=32, batch_size=4, epochs=1, tf=True,
                ado=True, attention=True, log_interval=1, seed=7, lr=1e-3,
                perform_test=False, dropout_rate=0.0, cache_features=True,
                checkpoint_dir=os.path.join(out, "model"))
    args.update(kw)
    return Config(**args)


def test_bf16_options_are_ported():
    cfg = Config(bf16_attention=True, bf16_encoder=True,
                 bank_dtype="bfloat16")
    assert unported_options(cfg) == []


def test_bf16_bank_halves_residency_close_numerics(data, tmp_path):
    """--bank-dtype bfloat16: the bank's bytes halve and its rows are the
    f32 features rounded to bf16; training and validation stay within bf16
    feature rounding of the f32 bank (tests/test_feature_cache.py's bounds:
    params atol 5e-3, validation loss rel 5e-2)."""
    from sat_tpu_torch.engine.loop import Trainer
    runs = {}
    for dt in ("float32", "bfloat16"):
        tr = Trainer(_trainer_cfg(data, str(tmp_path / dt), bank_dtype=dt),
                     device="cpu")
        assert tr.use_bank
        feats = tr.bank["train"]["feats"]
        assert feats.dtype == getattr(torch, dt)
        tr.train_epoch(1)
        runs[dt] = {"feats": feats,
                    "params": tr.state.decoder.deep_output.bias.detach(),
                    "val": tr.validate(1)}
    f32, bf = runs["float32"], runs["bfloat16"]
    assert bf["feats"].nbytes * 2 == f32["feats"].nbytes
    assert torch.equal(bf["feats"], f32["feats"].to(BF16))
    assert np.isfinite(bf["val"]["loss"])
    np.testing.assert_allclose(to_np(bf["params"]), to_np(f32["params"]),
                               atol=5e-3)
    assert bf["val"]["loss"] == pytest.approx(f32["val"]["loss"], rel=5e-2)


def test_bf16_encoder_runs_the_precompute_and_the_image_path(data, tmp_path):
    """--bf16-encoder: the feature precompute and the per-batch image path
    (no --cache-features) both run the bf16 encoder, whose grid differs
    from the f32 encoder's within bf16 rounding."""
    from sat_tpu_torch.engine.loop import Trainer
    tr32 = Trainer(_trainer_cfg(data, str(tmp_path / "f32")), device="cpu")
    tr16 = Trainer(_trainer_cfg(data, str(tmp_path / "bf"),
                                bf16_encoder=True), device="cpu")
    a = tr32.bank["train"]["feats"]
    b = tr16.bank["train"]["feats"]
    assert b.dtype == torch.float32 and not torch.equal(a, b)
    assert float((a - b).abs().mean() / a.abs().mean()) < 0.1
    direct = port_encoder(tr16.encoder, "vgg19",
                          np.stack([tr16.train_loader.dataset.load_image(0)]),
                          torch.bfloat16)
    row = int(tr16.row_map["train"][0])
    assert torch.equal(direct[0], b[row])
    # the image path: the Trainer's step on images computes what a step on
    # the bf16 encoder's grid computes, and not what the f32 grid gives
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_train_step)
    per_batch = Trainer(_trainer_cfg(data, str(tmp_path / "imgs"),
                                     bf16_encoder=True, cache_features=False),
                        device="cpu")
    ds = per_batch.train_loader.dataset
    imgs = np.stack([ds.load_image(i) for i in range(4)])
    caps = np.asarray(ds.captions[:4])
    from_grid = make_train_step(per_batch.dcfg, "vgg19", 1.0,
                                from_features=True)
    losses = []
    for fn, x in ((per_batch.train_step, imgs),
                  (from_grid, port_encoder(per_batch.encoder, "vgg19", imgs,
                                           torch.bfloat16).numpy()),
                  (from_grid, port_encoder(per_batch.encoder, "vgg19",
                                           imgs).numpy())):
        state = init_train_state(copy.deepcopy(per_batch.state.decoder))
        _, m = fn(state, per_batch.encoder, x, caps, 1e-3, None)
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1] != losses[2]


TRAIN_FLAGS = ["--image-size", "32", "--batch-size", "4", "--epochs", "1",
               "--log-interval", "1", "--tf", "--ado", "--attention",
               "--cache-features", "--device", "cpu", "--bf16-attention",
               "--bank-dtype", "bfloat16", "--dropout-rate", "0.5"]


def test_bf16_training_cli_resumes_bit_exactly(data, tmp_path):
    """`python -m sat_tpu_torch.train --bf16-attention --bank-dtype
    bfloat16` runs an epoch and its test pass; the same run preempted
    after its first step (in process, through the CLI's main) and resumed
    with --resume ends with the same decoder bit for bit."""
    import signal
    import sat_tpu_torch.engine.loop as loop
    from sat_tpu_torch.train import main

    full = str(tmp_path / "full")
    proc = subprocess.run(
        [sys.executable, "-m", "sat_tpu_torch.train", "--data", data,
         "--checkpoint-dir", full, *TRAIN_FLAGS], cwd=REPO,
        # one thread, as this process runs (tests/test_torch_common.py):
        # the CPU's matrix products split their sums by thread count
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "EvalMode.TEST Epoch: 1\tBLEU-1 (" in proc.stdout
    assert "bfloat16)" in proc.stdout     # the bank's dtype, printed

    cut = str(tmp_path / "cut")
    make_step = loop.make_bank_train_step

    def preempting_step(*args, **kw):
        step, calls = make_step(*args, **kw), []

        def first_call_signals(*a, **k):
            calls.append(1)
            if len(calls) == 1:
                os.kill(os.getpid(), signal.SIGUSR1)
            return step(*a, **k)
        return first_call_signals

    loop.make_bank_train_step = preempting_step
    try:
        assert main(["--data", data, "--checkpoint-dir", cut,
                     *TRAIN_FLAGS]) == {"preempted": True, "epoch": 1}
    finally:
        loop.make_bank_train_step = make_step
    res = main(["--data", data, "--checkpoint-dir", cut, "--resume",
                *TRAIN_FLAGS])
    assert "bleu4" in res
    with np.load(os.path.join(full, "model_vgg19_1.npz")) as a, \
            np.load(os.path.join(cut, "model_vgg19_1.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
