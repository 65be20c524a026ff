"""The port's sample decode against sat_tpu's.

sat_tpu samples with `jax.random.categorical`, which is
argmax(logits + jax.random.gumbel(key, logits.shape)); step t of its
`sample_caption(..., key)` draws with `jax.random.split(key, max_steps)[t]`.
The port takes argmax(filter_logits(logits) + noise[t]) and can be given
the noise: fed sat_tpu's, its tokens and lengths must be sat_tpu's exactly,
its alphas within atol 1e-5 (f32, other summation orders).

sat_tpu's filter is an inner function of its `sample_caption`; it is read
by running one step under `jax.disable_jit()` with chosen logits in place
of the decoder's and `categorical` replaced by a probe that records what
it is given. The nucleus's cumulative sum may round the last bit
differently in the two packages, so a token whose exclusive prefix mass
lies within an ulp of top_p could be kept by one and dropped by the
other: the inputs here are checked to have no boundary within 1e-6 of
top_p, and on them the filtered logits must be equal bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sat_tpu.models.beam as jax_beam
from sat_tpu.engine.serving import build_caption_step as jax_step
from sat_tpu.models.encoder import init_encoder_params as jax_init_encoder

import sat_tpu_torch.models.beam as port_beam
from sat_tpu_torch.compat.jax_params import encoder_from_jax
from sat_tpu_torch.engine.serving import build_caption_step
from sat_tpu_torch.models.beam import (Sampling, filter_logits,
                                       greedy_caption, sample_caption,
                                       validate_sampling_params)
from tests.test_torch_common import decoder_pair, features, flat, to_np

V, D, L, B = 50, 32, 6, 4
MAX_STEPS = 12
KNOBS = [(1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.9), (0.8, 10, 0.9),
         (1.0, V, 1.0), (1.0, V + 5, 0.5), (0.5, 20, 0.3), (0.0, 0, 1.0)]


def sat_tpu_filter(logits: np.ndarray, knobs) -> np.ndarray:
    """sat_tpu's filter_logits applied to `logits` (B, V)."""
    jcfg, params, _ = decoder_pair(logits.shape[1], D, True, True)
    seen = []
    plain = jax_beam.decode_step

    def decode_step(*args, **kw):
        h, c, _, alpha, x = plain(*args, **kw)
        return h, c, jnp.asarray(logits), alpha, x

    def categorical(key, filtered, axis=-1):
        seen.append(np.asarray(filtered))
        return jnp.argmax(filtered, axis=axis)

    jax_beam.decode_step = decode_step
    jax_categorical, jax.random.categorical = jax.random.categorical, \
        categorical
    try:
        with jax.disable_jit():
            jax_beam.sample_caption(
                params, jcfg, jnp.zeros((logits.shape[0], L, D)),
                jax.random.PRNGKey(0), *knobs, max_steps=1)
    finally:
        jax_beam.decode_step = plain
        jax.random.categorical = jax_categorical
    return seen[0]


def boundary_gap(logits: np.ndarray, knobs) -> float:
    """The least distance between top_p and an exclusive prefix mass of the
    filtered, sorted row (inf when the nucleus is off)."""
    temperature, _, top_p = knobs
    if top_p >= 1.0:
        return float("inf")
    x = torch.from_numpy(logits) / max(temperature, 1e-6)
    probs = torch.softmax(torch.sort(x, dim=-1, descending=True).values, -1)
    prefix = (torch.cumsum(probs.double(), -1) - probs.double()).numpy()
    return float(np.abs(prefix - top_p).min())


@pytest.mark.parametrize("knobs", KNOBS, ids=str)
def test_filter_logits_matches_sat_tpu(knobs):
    logits = features(30, (B, V)) * 3.0
    assert boundary_gap(logits, knobs) > 1e-6
    ref = sat_tpu_filter(logits, knobs)
    got = to_np(filter_logits(torch.from_numpy(logits), Sampling(*knobs)))
    np.testing.assert_array_equal(got, ref)
    assert np.isfinite(got).sum(axis=1).min() >= 1


def sat_tpu_noise(key, max_steps: int) -> torch.Tensor:
    """The Gumbel noise sat_tpu's sample_caption(..., key) draws."""
    rngs = jax.random.split(key, max_steps)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.gumbel(rngs[t], (B, V)))
        for t in range(max_steps)]))


@pytest.mark.parametrize("knobs", KNOBS[:4] + KNOBS[6:7], ids=str)
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_caption_matches_sat_tpu(seed, knobs):
    jcfg, params, dec = decoder_pair(V, D, True, True, seed=seed)
    feats = features(40 + seed, (B, L, D))
    key = jax.random.PRNGKey(seed)
    toks, lens, alphas = jax_beam.sample_caption(
        params, jcfg, jnp.asarray(feats), key, *knobs, max_steps=MAX_STEPS,
        with_alphas=True)
    gt, gl, ga = sample_caption(
        dec, torch.from_numpy(feats), None, *knobs, max_steps=MAX_STEPS,
        with_alphas=True, noise=sat_tpu_noise(key, MAX_STEPS))
    np.testing.assert_array_equal(to_np(gt), np.asarray(toks))
    np.testing.assert_array_equal(to_np(gl), np.asarray(lens))
    np.testing.assert_allclose(to_np(ga), np.asarray(alphas), atol=1e-5)


@pytest.mark.parametrize("knobs", [(1.0, 0, 0.0), (1.0, 0, 1.5),
                                   (1.0, 0, -0.1), (1.0, -1, 1.0),
                                   (-0.5, 0, 1.0)], ids=str)
def test_validate_sampling_params_raises_as_sat_tpu(knobs):
    with pytest.raises(ValueError) as ref:
        jax_beam.validate_sampling_params(*knobs)
    with pytest.raises(ValueError) as got:
        validate_sampling_params(*knobs)
    assert str(got.value) == str(ref.value)
    _, _, dec = decoder_pair(V, D, True, True)
    with pytest.raises(ValueError):
        sample_caption(dec, torch.zeros(1, L, D), None, *knobs)
    with pytest.raises(ValueError):
        build_caption_step("vgg19", dec.cfg, 3, decode="sample",
                           device="cpu", temperature=knobs[0],
                           top_k=knobs[1], top_p=knobs[2])


@pytest.mark.parametrize("knobs", [(1.0, 1, 1.0), (0.0, 0, 1.0)], ids=str)
def test_top_k_one_and_cold_temperature_are_greedy(knobs):
    _, _, dec = decoder_pair(V, D, True, True, seed=3)
    feats = torch.from_numpy(features(50, (B, L, D)))
    gen = torch.Generator().manual_seed(0)
    got = sample_caption(dec, feats, gen, *knobs, max_steps=MAX_STEPS,
                         with_alphas=True)
    want = greedy_caption(dec, feats, max_steps=MAX_STEPS, with_alphas=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_generator_seed_gives_the_draw():
    """One seed, one draw; another seed, other captions; the noise is a
    Gumbel sample (mean near the Euler-Mascheroni constant)."""
    _, _, dec = decoder_pair(V, D, True, True, seed=4)
    feats = torch.from_numpy(features(60, (8, L, D)))

    def run(seed):
        return sample_caption(dec, feats, torch.Generator().manual_seed(seed),
                              2.0, max_steps=MAX_STEPS)[0]

    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    noise = port_beam.gumbel_noise_(torch.empty(20000),
                                    torch.Generator().manual_seed(0))
    assert abs(noise.mean().item() - 0.5772) < 0.03
    assert bool(torch.isfinite(noise).all())


def test_batch_generators_are_pairs():
    draws = {(s, i): torch.rand(4, generator=port_beam.batch_generator(
        s, i, "cpu")) for s in (0, 3) for i in (0, 1)}
    assert torch.equal(draws[3, 1], torch.rand(
        4, generator=port_beam.batch_generator(3, 1, "cpu")))
    assert len({tuple(v.tolist()) for v in draws.values()}) == 4


def test_sample_caption_step_matches_sat_tpu(monkeypatch):
    """build_caption_step(decode="sample") on VGG19 at 32 px: sat_tpu's
    result layout and values, given sat_tpu's noise through the module's
    draw function."""
    jcfg, params, dec = decoder_pair(V, 512, True, True, seed=5)
    enc_params = jax_init_encoder(jax.random.PRNGKey(6), "vgg19")
    enc = encoder_from_jax(flat(enc_params), "vgg19", device="cpu")
    images = np.random.default_rng(7).normal(size=(B, 32, 32, 3)).astype(
        np.float32)
    knobs = dict(temperature=0.8, top_k=10, top_p=0.9)
    key = jax.random.PRNGKey(8)
    ref = jax_step("vgg19", jcfg, 3, decode="sample", **knobs)(
        enc_params, params, jnp.asarray(images), key)
    noise = sat_tpu_noise(key, 51)
    monkeypatch.setattr(port_beam, "gumbel_noise_",
                        lambda out, gen: out.copy_(noise))
    got = build_caption_step("vgg19", dec.cfg, 3, decode="sample",
                             device="cpu", **knobs)(enc, dec, images, None)
    assert sorted(got) == sorted(ref)
    for k in ("tokens", "length", "found"):
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(ref[k]), k)
    for k in ("score", "alphas"):
        np.testing.assert_allclose(to_np(got[k]), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)
