"""The attention backward: the plain form of the CUDA kernel against
sat_tpu's Pallas backward (interpret mode), and the port's `FusedAttention`
gradients against `jax.grad` of sat_tpu's soft_attention and of its fused
custom VJP, through both outputs (ctx and alpha: the doubly-stochastic
regularizer differentiates alpha). Tolerances: 1e-5 on the kernel's
outputs (f32, other summation orders; dv and db_v are sums over B·L
terms, so they are held at rtol 1e-4 of their size), and
tests/test_pallas_grad.py's atol 2e-4, rtol 1e-4 on the gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sat_tpu.models.attention import (init_attention_params,
                                      precompute_attention_keys,
                                      soft_attention)
from sat_tpu.ops.fused_attention import (_fused_attention_bwd,
                                         fused_soft_attention)

from sat_tpu_torch.models.attention import Attention
from sat_tpu_torch.models.attention import soft_attention as port_attention
from sat_tpu_torch.ops.fused_attention import (FusedAttention, attention_bwd,
                                               attention_bwd_plain,
                                               attention_plain)
from tests.test_torch_common import features, flat, to_np

# B = 3 and 5 are not multiples of the Pallas block (8): JAX pads them
SHAPES = [(3, 9, 64, 48), (5, 16, 32, 64), (8, 12, 64, 32)]


def _inputs(B, L, E, D, seed):
    rng = np.random.default_rng(seed)
    keys = rng.normal(size=(B, L, E)).astype(np.float32)
    feats = rng.normal(size=(B, L, D)).astype(np.float32)
    u_h = rng.normal(size=(B, E)).astype(np.float32)
    v = (rng.normal(size=(E,)) / np.sqrt(E)).astype(np.float32)
    b_v = rng.normal(size=(1,)).astype(np.float32)
    dctx = rng.normal(size=(B, D)).astype(np.float32)
    dalpha = rng.normal(size=(B, L)).astype(np.float32)
    return keys, feats, u_h, v, b_v, dctx, dalpha


def _de_size(feats, alpha, dctx, dalpha) -> float:
    """sum_{b,l} |de|: the size of the terms that db_v sums."""
    g = np.einsum("bld,bd->bl", feats, dctx) + dalpha
    de = alpha * (g - (alpha * g).sum(axis=1, keepdims=True))
    return float(np.abs(de).sum())


@pytest.mark.parametrize("B,L,E,D", SHAPES)
def test_plain_backward_matches_pallas_backward(B, L, E, D):
    keys, feats, u_h, v, b_v, dctx, dalpha = _inputs(B, L, E, D, B * L)
    t = [torch.from_numpy(a) for a in (keys, feats, u_h, v, b_v)]
    _, alpha = attention_plain(*t)
    alpha = to_np(alpha)
    ref = _fused_attention_bwd(
        *(jnp.asarray(a) for a in (keys, feats, u_h, v[:, None], alpha,
                                   dctx, dalpha)), interpret=True)
    args = [torch.from_numpy(a) for a in (keys, feats, u_h, v, alpha, dctx,
                                          dalpha)]
    for fn in (attention_bwd_plain, attention_bwd):
        got = fn(*args)
        for name, g, r in zip(("dkeys", "dfeats", "du_h"), got, ref):
            np.testing.assert_allclose(to_np(g), np.asarray(r), atol=1e-5,
                                       err_msg=name)
        # dv and db_v: sums over B*L terms in another order; db_v is zero
        # in exact arithmetic (softmax is shift-invariant), so it is held
        # against the size of its terms
        np.testing.assert_allclose(to_np(got[3]), np.asarray(ref[3])[:, 0],
                                   atol=1e-4 * np.abs(ref[3]).max())
        np.testing.assert_allclose(to_np(got[4]), np.asarray(ref[4]),
                                   atol=1e-5 * _de_size(feats, alpha, dctx,
                                                        dalpha))
    assert attention_bwd.launches == 0


def test_dfeats_skipped_when_not_asked():
    keys, feats, u_h, v, _, dctx, dalpha = _inputs(4, 6, 16, 8, 0)
    alpha = np.full((4, 6), 1 / 6, np.float32)
    args = [torch.from_numpy(a) for a in (keys, feats, u_h, v, alpha, dctx,
                                          dalpha)]
    full = attention_bwd(*args)
    lean = attention_bwd(*args, want_dfeats=False)
    assert lean[1] is None and full[1] is not None
    for i in (0, 2, 3, 4):
        assert torch.equal(full[i], lean[i])


def _attention_pair(B, L, E, D, seed=0):
    params = init_attention_params(jax.random.PRNGKey(seed), D, E)
    attn = Attention(D, E)
    p = flat(params)
    attn.load_state_dict({
        f"{n}.{part}": torch.from_numpy(
            np.array(p[f"{n}/w"].T if part == "weight" else p[f"{n}/b"]))
        for n in ("U", "W", "v") for part in ("weight", "bias")})
    return params, attn


@pytest.mark.parametrize("B,L,E,D", [(5, 9, 64, 48), (8, 12, 128, 96)])
def test_fused_attention_grads_match_jax(B, L, E, D):
    """The gradients of a loss of ctx and alpha, in the attention params,
    the features and the hidden state: the port's FusedAttention (plain
    forms on the CPU) against jax.grad of sat_tpu's soft_attention and of
    its Pallas custom VJP."""
    params, attn = _attention_pair(B, L, E, D)
    feats = features(B, (B, L, D))
    h = features(B + 1, (B, E))
    w1 = features(9, (D,))
    w2 = features(10, (L,))

    def loss(fn):
        def inner(p, f, hh):
            keys = precompute_attention_keys(p, f)
            ctx, alpha = fn(p, f, hh, keys)
            return (ctx @ w1).sum() + ((alpha * w2) ** 2).sum()
        return inner

    refs = [jax.grad(loss(fn), argnums=(0, 1, 2))(
        params, jnp.asarray(feats), jnp.asarray(h))
        for fn in (soft_attention,
                   lambda p, f, hh, k: fused_soft_attention(
                       p, f, hh, k, interpret=True))]

    tf = torch.from_numpy(feats).requires_grad_(True)
    th = torch.from_numpy(h).requires_grad_(True)
    ctx, alpha = port_attention(attn, tf, th)
    out = (ctx @ torch.from_numpy(w1)).sum() \
        + ((alpha * torch.from_numpy(w2)) ** 2).sum()
    out.backward()
    got = {f"{n}/{k}": getattr(getattr(attn, n),
                               "weight" if k == "w" else "bias").grad
           for n in ("U", "W", "v") for k in ("w", "b")}
    for ref_params, ref_f, ref_h in refs:
        ref = flat(ref_params)
        for name, g in got.items():
            r = ref[name]
            g = to_np(g).T if name.endswith("/w") else to_np(g)
            np.testing.assert_allclose(g.reshape(r.shape), r, atol=2e-4,
                                       rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(to_np(tf.grad), np.asarray(ref_f),
                                   atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(to_np(th.grad), np.asarray(ref_h),
                                   atol=2e-4, rtol=1e-4)


def test_fused_attention_matches_autograd_of_plain_form():
    """FusedAttention's backward equals PyTorch autograd through the plain
    forward, including d features when they need a gradient."""
    keys, feats, u_h, v, b_v, dctx, dalpha = _inputs(3, 7, 16, 12, 5)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (keys, feats, u_h, v, b_v)]
    cot = [torch.from_numpy(a) for a in (dctx, dalpha)]
    ref = torch.autograd.grad(attention_plain(*leaves), leaves, cot)
    got = torch.autograd.grad(FusedAttention.apply(*leaves), leaves, cot)
    for name, g, r in zip(("keys", "feats", "u_h", "v", "b_v"), got, ref):
        np.testing.assert_allclose(to_np(g), to_np(r), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("bad", ["alpha-shape", "dctx-shape", "f64"])
def test_backward_wrapper_rejects_bad_input(bad):
    B, L, E, D = 2, 4, 8, 6
    args = {"keys": torch.zeros(B, L, E), "feats": torch.zeros(B, L, D),
            "u_h": torch.zeros(B, E), "v": torch.zeros(E),
            "alpha": torch.zeros(B, L), "dctx": torch.zeros(B, D),
            "dalpha": torch.zeros(B, L)}
    if bad == "alpha-shape":
        args["alpha"] = torch.zeros(B, L + 1)
    elif bad == "dctx-shape":
        args["dctx"] = torch.zeros(B + 1, D)
    else:
        args["keys"] = args["keys"].double()
    with pytest.raises((ValueError, TypeError)):
        attention_bwd(**args)
    assert attention_bwd.launches == 0


def test_inference_path_keeps_the_forward_wrapper():
    """Without autograd soft attention calls attention_fwd directly; with
    autograd at R = 1 it goes through FusedAttention, to the same
    numbers."""
    _, attn = _attention_pair(2, 5, 16, 8)
    feats = torch.from_numpy(features(1, (2, 5, 8)))
    h = torch.from_numpy(features(2, (2, 16)))
    with torch.no_grad():
        ctx0, _ = port_attention(attn, feats, h)
    ctx1, _ = port_attention(attn, feats, h)
    assert ctx0.grad_fn is None
    assert type(ctx1.grad_fn).__name__ == "FusedAttentionBackward"
    np.testing.assert_array_equal(to_np(ctx0), to_np(ctx1))
