"""The port's soft attention and the plain form of the fused attention
kernel against sat_tpu's soft_attention and its Pallas fused_attention_block
(interpret mode), on the shapes of tests/test_pallas.py. ctx atol 1e-5 and
alpha atol 1e-6, as there: the two differ only in f32 summation order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sat_tpu.models.attention import (init_attention_params,
                                      precompute_attention_keys,
                                      soft_attention)
from sat_tpu.ops.fused_attention import fused_attention_block

from sat_tpu_torch.models.attention import Attention
from sat_tpu_torch.models.attention import \
    precompute_attention_keys as port_keys
from sat_tpu_torch.models.attention import soft_attention as port_attention
from sat_tpu_torch.ops.fused_attention import attention_fwd, attention_plain
from tests.test_torch_common import features, flat, to_np

SHAPES = [(5, 9, 64, 48), (8, 196, 128, 96), (1, 49, 64, 64)]


def _setup(B, L, E, D, seed=0):
    """sat_tpu attention params and the port's module holding the same
    weights: (in, out) linears become nn.Linear's (out, in)."""
    params = init_attention_params(jax.random.PRNGKey(seed), D, E)
    attn = Attention(D, E)
    p = flat(params)
    attn.load_state_dict({
        f"{n}.{part}": torch.from_numpy(
            np.array(p[f"{n}/w"].T if part == "weight" else p[f"{n}/b"]))
        for n in ("U", "W", "v") for part in ("weight", "bias")})
    return params, attn, features(seed, (B, L, D)), features(seed + 1, (B, E))


@pytest.mark.parametrize("B,L,E,D", SHAPES)
def test_soft_attention_matches_sat_tpu(B, L, E, D):
    params, attn, feats, h = _setup(B, L, E, D)
    keys = precompute_attention_keys(params, jnp.asarray(feats))
    ctx_ref, alpha_ref = soft_attention(params, jnp.asarray(feats),
                                        jnp.asarray(h), keys)
    with torch.no_grad():
        tf = torch.from_numpy(feats)
        np.testing.assert_allclose(to_np(port_keys(attn, tf)),
                                   np.asarray(keys), atol=1e-5)
        ctx, alpha = port_attention(attn, tf, torch.from_numpy(h))
    np.testing.assert_allclose(to_np(ctx), np.asarray(ctx_ref), atol=1e-5)
    np.testing.assert_allclose(to_np(alpha), np.asarray(alpha_ref),
                               atol=1e-6)


@pytest.mark.parametrize("B,L,E,D", SHAPES)
def test_plain_kernel_form_matches_pallas_block(B, L, E, D):
    """R = 1: the plain form of the CUDA kernel against the Pallas kernel
    it replaces, fed the same keys, features, u_h, v and b_v."""
    rng = np.random.default_rng(B * L)
    keys = rng.normal(size=(B, L, E)).astype(np.float32)
    feats = rng.normal(size=(B, L, D)).astype(np.float32)
    u_h = rng.normal(size=(B, E)).astype(np.float32)
    v = (rng.normal(size=(E, 1)) / np.sqrt(E)).astype(np.float32)
    b_v = rng.normal(size=(1,)).astype(np.float32)
    ctx_ref, alpha_ref = fused_attention_block(
        *(jnp.asarray(a) for a in (keys, feats, u_h, v, b_v)),
        interpret=True)
    args = [torch.from_numpy(a) for a in (keys, feats, u_h, v[:, 0], b_v)]
    for fn in (attention_plain, attention_fwd):
        ctx, alpha = fn(*args)
        np.testing.assert_allclose(to_np(ctx), np.asarray(ctx_ref),
                                   atol=1e-5)
        np.testing.assert_allclose(to_np(alpha), np.asarray(alpha_ref),
                                   atol=1e-6)


@pytest.mark.parametrize("R", [3, 5])
def test_rows_per_image_matches_repeated_grid(R):
    """R hidden rows per image against one image's grid equal the R = 1
    kernel run on the grid repeated R times (the flat beam layout), and
    sat_tpu's Pallas block on that repeated grid."""
    B, L, E, D = 4, 16, 64, 32
    rng = np.random.default_rng(R)
    keys = rng.normal(size=(B, L, E)).astype(np.float32)
    feats = rng.normal(size=(B, L, D)).astype(np.float32)
    u_h = rng.normal(size=(B * R, E)).astype(np.float32)
    v = (rng.normal(size=(E,)) / np.sqrt(E)).astype(np.float32)
    b_v = np.float32([0.3])
    ctx, alpha = attention_fwd(*(torch.from_numpy(a) for a in
                                 (keys, feats, u_h, v, b_v)), R)
    keys_r, feats_r = np.repeat(keys, R, 0), np.repeat(feats, R, 0)
    ctx_ref, alpha_ref = fused_attention_block(
        jnp.asarray(keys_r), jnp.asarray(feats_r), jnp.asarray(u_h),
        jnp.asarray(v[:, None]), jnp.asarray(b_v), interpret=True)
    np.testing.assert_allclose(to_np(ctx), np.asarray(ctx_ref), atol=1e-5)
    np.testing.assert_allclose(to_np(alpha), np.asarray(alpha_ref),
                               atol=1e-6)
    ctx1, alpha1 = attention_plain(*(torch.from_numpy(a) for a in
                                     (keys_r, feats_r, u_h, v, b_v)))
    np.testing.assert_allclose(to_np(ctx), to_np(ctx1), atol=1e-5)
    np.testing.assert_allclose(to_np(alpha), to_np(alpha1), atol=1e-6)


@pytest.mark.parametrize("bad", ["u_h-rows", "v-shape", "f64", "R0"])
def test_wrapper_rejects_bad_input(bad):
    B, L, E, D = 2, 4, 8, 6
    keys, feats = torch.zeros(B, L, E), torch.zeros(B, L, D)
    u_h, v, b_v = torch.zeros(B, E), torch.zeros(E), torch.zeros(1)
    args = {"u_h-rows": (keys, feats, torch.zeros(B + 1, E), v, b_v, 1),
            "v-shape": (keys, feats, u_h, torch.zeros(E, 1), b_v, 1),
            "f64": (keys.double(), feats, u_h, v, b_v, 1),
            "R0": (keys, feats, u_h, v, b_v, 0)}[bad]
    with pytest.raises((ValueError, TypeError)):
        attention_fwd(*args)
    assert attention_fwd.launches == 0
