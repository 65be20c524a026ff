"""The port's batched beam search and greedy decode against sat_tpu's.

Both get the same parameters (sat_tpu's init, carried over) and the same
features. tokens, length and found must be exactly equal; score and alphas
agree within atol 1e-5 (f32 with other summation orders). sat_tpu runs its
default path, the exact Pallas top-k in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sat_tpu.models.beam import beam_search_batched, greedy_caption

from sat_tpu_torch.models.beam import beam_search_batched as port_beam
from sat_tpu_torch.models.beam import extract_caption
from sat_tpu_torch.models.beam import greedy_caption as port_greedy
from tests.test_torch_common import decoder_pair, features, to_np

V, D, L, B = 50, 32, 6, 3
MAX_STEPS = 12
ARMS = [(True, True), (True, False), (False, True), (False, False)]


def _compare(ref, got):
    np.testing.assert_array_equal(to_np(got.tokens), np.asarray(ref.tokens))
    np.testing.assert_array_equal(to_np(got.length), np.asarray(ref.length))
    np.testing.assert_array_equal(to_np(got.found), np.asarray(ref.found))
    np.testing.assert_allclose(to_np(got.score), np.asarray(ref.score),
                               atol=1e-5)
    np.testing.assert_allclose(to_np(got.alphas), np.asarray(ref.alphas),
                               atol=1e-5)
    np.testing.assert_allclose(to_np(got.fallback_alpha),
                               np.asarray(ref.fallback_alpha), atol=1e-5)


@pytest.mark.parametrize("dedup,backtrack", ARMS)
@pytest.mark.parametrize("beam_size", [1, 3, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_matches_sat_tpu(seed, beam_size, dedup, backtrack):
    # the flagship's flags: attention + ado
    jcfg, params, dec = decoder_pair(V, D, True, True, seed=seed)
    feats = features(10 + seed, (B, L, D))
    ref = beam_search_batched(params, jcfg, jnp.asarray(feats), beam_size,
                              max_steps=MAX_STEPS, dedup=dedup,
                              backtrack=backtrack)
    got = port_beam(dec, torch.from_numpy(feats), beam_size,
                    max_steps=MAX_STEPS, dedup=dedup, backtrack=backtrack)
    _compare(ref, got)


@pytest.mark.parametrize("ado,attention", [(False, True), (True, False),
                                           (False, False)])
def test_beam_matches_sat_tpu_other_flags(ado, attention):
    jcfg, params, dec = decoder_pair(V, D, ado, attention, seed=7)
    feats = features(17, (B, L, D))
    ref = beam_search_batched(params, jcfg, jnp.asarray(feats), 3,
                              max_steps=MAX_STEPS)
    _compare(ref, port_beam(dec, torch.from_numpy(feats), 3,
                            max_steps=MAX_STEPS))


@pytest.mark.parametrize("backtrack", [True, False])
def test_never_completed_images(backtrack):
    """max_steps short enough that some images never complete: their rows
    are masked (tokens and alphas zero, found False, score -inf) and the
    rest still agree; extract_caption falls back to [0]."""
    for seed in range(6):
        jcfg, params, dec = decoder_pair(V, D, True, True, seed=seed)
        feats = features(30 + seed, (4, L, D))
        ref = beam_search_batched(params, jcfg, jnp.asarray(feats), 3,
                                  max_steps=2, backtrack=backtrack)
        if not np.asarray(ref.found).all():
            break
    else:
        pytest.fail("no seed left an image incomplete in 2 steps")
    got = port_beam(dec, torch.from_numpy(feats), 3, max_steps=2,
                    backtrack=backtrack)
    _compare(ref, got)
    i = int(np.flatnonzero(~np.asarray(ref.found))[0])
    row = type(got)(*(f[i] for f in got))
    tokens, alphas = extract_caption(row)
    assert tokens == [0] and alphas.shape == (1, L)


def test_chunked_batch_equals_whole():
    _, _, dec = decoder_pair(V, D, True, True, seed=3)
    feats = torch.from_numpy(features(40, (5, L, D)))
    whole = port_beam(dec, feats, 3, max_steps=MAX_STEPS, chunk=None)
    chunked = port_beam(dec, feats, 3, max_steps=MAX_STEPS, chunk=2)
    for a, b in zip(whole, chunked):
        if a.is_floating_point():   # matmul blocking follows the batch size
            np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-6)
        else:
            np.testing.assert_array_equal(to_np(a), to_np(b))


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_matches_sat_tpu(seed):
    jcfg, params, dec = decoder_pair(V, D, True, True, seed=seed)
    feats = features(20 + seed, (B, L, D))
    toks, lens, alphas = greedy_caption(params, jcfg, jnp.asarray(feats),
                                        max_steps=MAX_STEPS, with_alphas=True)
    gt, gl, ga = port_greedy(dec, torch.from_numpy(feats),
                             max_steps=MAX_STEPS, with_alphas=True)
    np.testing.assert_array_equal(to_np(gt), np.asarray(toks))
    np.testing.assert_array_equal(to_np(gl), np.asarray(lens))
    np.testing.assert_allclose(to_np(ga), np.asarray(alphas), atol=1e-5)


@pytest.mark.parametrize("option", ["fast_topk", "mesh_data"])
def test_unported_options_raise(option):
    """The two options that once raised: fast_topk takes the library
    top-k route (exact, as sat_tpu's approx_max_k is off the TPU), and
    mesh_data=2 chunks at `chunk` images a card. Each gives sat_tpu's
    beam with the same option, and the tokens of the default beam."""
    jcfg, params, dec = decoder_pair(V, D, True, True, seed=4)
    feats = features(44, (5, L, D))
    kwargs = {option: {"fast_topk": True, "mesh_data": 2}[option]}
    ref = beam_search_batched(params, jcfg, jnp.asarray(feats), 3,
                              max_steps=MAX_STEPS, chunk=2, **kwargs)
    got = port_beam(dec, torch.from_numpy(feats), 3, max_steps=MAX_STEPS,
                    chunk=2, **kwargs)
    _compare(ref, got)
    plain = port_beam(dec, torch.from_numpy(feats), 3, max_steps=MAX_STEPS,
                      chunk=2)
    np.testing.assert_array_equal(to_np(got.tokens), to_np(plain.tokens))
