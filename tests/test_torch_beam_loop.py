"""The device-resident beam loop against sat_tpu's `lax.while_loop`, on the
CPU: the port's `beam_search_batched` reads its exit test on the host once
every S steps, and the steps after every image has finished, or past
max_steps, must change nothing. So every S gives sat_tpu's result: tokens,
lengths and found exactly, scores and alphas within atol 1e-5 (f32 with
other summation orders, as tests/test_torch_beam.py). Greedy runs all its
steps as sat_tpu's scan does. The server pads each batch to a power-of-two
bucket with copies of its last image, and each request gets the result it
gets alone."""

import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sat_tpu.models.beam import beam_search_batched, greedy_caption
from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from sat_tpu.models.decoder import init_decoder_params as jax_init_decoder

from sat_tpu_torch.compat.jax_params import decoder_from_jax
from sat_tpu_torch.models.beam import beam_search_batched as port_beam
from sat_tpu_torch.models.beam import greedy_caption as port_greedy
from sat_tpu_torch.models.decoder import DecoderConfig
from sat_tpu_torch.utils.graphs import GraphCache
from tests.test_torch_beam import _compare
from tests.test_torch_common import decoder_pair, features, flat, to_np

V, D, L = 50, 32, 6
MAX_STEPS = 13          # a multiple of none of S = 3, 8, 51
SYNCS = [1, 3, 8, 51]
ARMS = [(True, True), (True, False), (False, True), (False, False)]
STAGGERED = 2           # decoder seed whose 4 images finish at steps 9, 4,
                        # 4 and never (the first test asserts it)


@pytest.mark.parametrize("dedup,backtrack", ARMS)
@pytest.mark.parametrize("sync_every", SYNCS)
def test_every_sync_interval_matches_sat_tpu(sync_every, dedup, backtrack):
    jcfg, params, dec = decoder_pair(V, D, True, True, seed=STAGGERED)
    feats = features(10 + STAGGERED, (4, L, D))
    ref = beam_search_batched(params, jcfg, jnp.asarray(feats), 3,
                              max_steps=MAX_STEPS, dedup=dedup,
                              backtrack=backtrack)
    lengths = np.asarray(ref.length)[np.asarray(ref.found)]
    assert len(set(lengths.tolist())) > 1 and not np.asarray(ref.found).all()
    got = port_beam(dec, torch.from_numpy(feats), 3, max_steps=MAX_STEPS,
                    dedup=dedup, backtrack=backtrack, sync_every=sync_every)
    _compare(ref, got)


def _pinned_pair(seed):
    """A plain-head decoder whose stop logits are pinned to -1e9: no beam
    ever completes, so every image runs all max_steps (the worst case)."""
    jcfg = JaxDecoderConfig(vocab_size=V, encoder_dim=D, use_attention=True)
    params = jax_init_decoder(jax.random.PRNGKey(seed), jcfg)
    bias = np.asarray(params["deep_output"]["b"]).copy()
    bias[[1, 102 % V]] = -1e9
    params["deep_output"]["b"] = jnp.asarray(bias)
    cfg = DecoderConfig(vocab_size=V, encoder_dim=D, use_attention=True)
    return jcfg, params, decoder_from_jax(flat(params), cfg, "cpu")


@pytest.mark.parametrize("backtrack", [True, False])
@pytest.mark.parametrize("sync_every", [1, 8, 51])
def test_worst_case_runs_every_step(sync_every, backtrack):
    jcfg, params, dec = _pinned_pair(5)
    feats = features(50, (3, L, D))
    ref = beam_search_batched(params, jcfg, jnp.asarray(feats), 3,
                              max_steps=MAX_STEPS, backtrack=backtrack)
    assert not np.asarray(ref.found).any()
    got = port_beam(dec, torch.from_numpy(feats), 3, max_steps=MAX_STEPS,
                    backtrack=backtrack, sync_every=sync_every)
    _compare(ref, got)


def test_sync_intervals_agree_bit_for_bit():
    """S only moves the host's reads: every field of every S is the same
    bits as S = 1's, and a GraphCache on the CPU runs eagerly."""
    _, _, dec = decoder_pair(V, D, True, True, seed=STAGGERED)
    feats = torch.from_numpy(features(10 + STAGGERED, (4, L, D)))
    base = port_beam(dec, feats, 3, max_steps=MAX_STEPS, sync_every=1)
    cache = GraphCache()
    for s in (2, 5, 13, 40):
        got = port_beam(dec, feats, 3, max_steps=MAX_STEPS, sync_every=s,
                        graphs=cache)
        for a, b in zip(base, got):
            assert torch.equal(a, b)
    assert cache.captures == 0
    with pytest.raises(ValueError, match="sync_every"):
        port_beam(dec, feats, 3, sync_every=0)


@pytest.mark.parametrize("pinned", [False, True], ids=["staggered", "worst"])
def test_greedy_matches_sat_tpu(pinned):
    if pinned:
        jcfg, params, dec = _pinned_pair(6)
    else:
        jcfg, params, dec = decoder_pair(V, D, True, True, seed=STAGGERED)
    feats = features(60, (4, L, D))
    toks, lens, alphas = greedy_caption(params, jcfg, jnp.asarray(feats),
                                        max_steps=MAX_STEPS, with_alphas=True)
    gt, gl, ga = port_greedy(dec, torch.from_numpy(feats),
                             max_steps=MAX_STEPS, with_alphas=True)
    np.testing.assert_array_equal(to_np(gt), np.asarray(toks))
    np.testing.assert_array_equal(to_np(gl), np.asarray(lens))
    np.testing.assert_allclose(to_np(ga), np.asarray(alphas), atol=1e-5)
    if pinned:
        assert (to_np(gl) == MAX_STEPS).all()


# ------------------------------------------------------- server buckets

@pytest.mark.parametrize("n,max_batch,bucket", [(1, 32, 1), (3, 32, 4),
                                                (4, 32, 4), (5, 32, 8),
                                                (17, 32, 32), (20, 20, 20),
                                                (13, 12, 13)])
def test_bucket_is_the_next_power_of_two_under_the_cap(n, max_batch, bucket):
    from sat_tpu_torch.serve import CaptionServer
    server = CaptionServer(lambda a: None, 32, None, max_batch=max_batch)
    assert server._bucket(n) == bucket


def test_padded_batch_gives_each_request_its_own_result():
    from sat_tpu_torch.compat.jax_params import encoder_from_jax
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.models.decoder import init_decoder_params
    from sat_tpu_torch.models.encoder import init_encoder_params
    from sat_tpu_torch.serve import CaptionServer

    gen = torch.Generator().manual_seed(0)
    dcfg = DecoderConfig(vocab_size=30, encoder_dim=512, use_ado=True,
                         use_attention=True)
    dec = decoder_from_jax(init_decoder_params(dcfg, gen), dcfg, "cpu")
    enc = encoder_from_jax(init_encoder_params("vgg19", gen), "vgg19", "cpu")
    step = build_caption_step("vgg19", dcfg, 3, device="cpu")
    shapes = []

    def caption_fn(arr):
        shapes.append(arr.shape[0])
        return step(enc, dec, arr)

    pool = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(
        np.float32)
    server = CaptionServer(caption_fn, 32, lambda t, n, f: [str(x) for x in
                                                            t[:n + 1]],
                           max_batch=8, image_pool=pool)

    def serve(rows):
        replies, lock = {}, threading.Lock()

        def reply_to(i):
            def reply(obj):
                with lock:
                    replies[i] = json.loads(json.dumps(obj))
            return reply

        batch = [({"id": i, "cached": i}, pool[i], reply_to(i)) for i in rows]
        server._dispatch_batch(batch)()
        return replies

    together = serve([0, 1, 2])
    assert shapes == [4]                  # 3 requests, a bucket of 4
    for i in range(3):
        alone = serve([i])[i]
        assert together[i]["caption"] == alone["caption"]
        assert together[i]["completed"] == alone["completed"]
        np.testing.assert_allclose(together[i]["score"], alone["score"],
                                   atol=1e-5)
    assert shapes == [4, 1, 1, 1]
    assert server.stats["batches"] == 4 and server.stats["errors"] == 0
