"""Mesh serving on the port: `build_caption_step(mesh_data=2)` over two
replicas on the host (`devices=["cpu", "cpu"]`), against the one-device
step and sat_tpu's step with `mesh_data=2`, on the CPU.

Images decode independently, so at an odd batch (padded to a multiple of
the mesh, the padding cut off) the tokens, lengths and found flags are the
one-device step's and sat_tpu's, exactly; scores and alphas within atol
1e-5 (tests/test_torch_serving.py's). A sampled batch whose size the mesh
divides draws the one-device step's noise, and so its tokens. The server
pads its buckets to multiples of the mesh.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sat_tpu.engine.serving import build_caption_step
from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from sat_tpu.models.decoder import init_decoder_params
from sat_tpu.models.encoder import init_encoder_params

from sat_tpu_torch.compat.jax_params import decoder_from_jax, encoder_from_jax
from sat_tpu_torch.engine.serving import MeshRunner
from sat_tpu_torch.engine.serving import build_caption_step as port_step
from sat_tpu_torch.models.decoder import DecoderConfig
from tests.test_torch_common import flat, to_np

VOCAB, SIZE = 30, 32
TWO = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def models():
    jcfg = JaxDecoderConfig(vocab_size=VOCAB, encoder_dim=512, use_ado=True,
                            use_attention=True)
    enc_rng, dec_rng = jax.random.split(jax.random.PRNGKey(8))
    dec_params = init_decoder_params(dec_rng, jcfg)
    enc_params = init_encoder_params(enc_rng, "vgg19")
    dcfg = DecoderConfig(vocab_size=VOCAB, encoder_dim=512, use_ado=True,
                         use_attention=True)
    return {"jcfg": jcfg, "jdec": dec_params, "jenc": enc_params,
            "dcfg": dcfg,
            "dec": decoder_from_jax(flat(dec_params), dcfg, device="cpu"),
            "enc": encoder_from_jax(flat(enc_params), "vgg19",
                                    device="cpu")}


def _images(n, seed=11):
    return np.random.default_rng(seed).normal(
        size=(n, SIZE, SIZE, 3)).astype(np.float32)


def _same(got, want, exact=("tokens", "length", "found")):
    assert sorted(got) == sorted(want)
    for k in exact:
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("score", "alphas"):
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("decode", ["beam", "greedy"])
def test_two_replicas_give_the_one_device_and_sat_tpu_captions(models,
                                                               decode):
    images = _images(5)
    mesh = port_step("vgg19", models["dcfg"], 3, decode=decode,
                     mesh_data=2, devices=TWO, device="cpu")
    assert mesh.mesh == [torch.device("cpu")] * 2
    got = mesh(models["enc"], models["dec"], images)
    assert got["tokens"].shape[0] == 5
    one = port_step("vgg19", models["dcfg"], 3, decode=decode,
                    device="cpu")(models["enc"], models["dec"], images)
    _same(got, {k: to_np(v) for k, v in one.items()})
    ref = build_caption_step("vgg19", models["jcfg"], 3, decode=decode,
                             mesh_data=2)(models["jenc"], models["jdec"],
                                          jnp.asarray(images))
    _same(got, ref)


def test_sampled_batch_draws_the_one_device_noise(models):
    images = _images(4, seed=12)
    outs = [port_step("vgg19", models["dcfg"], 3, decode="sample",
                      top_k=5, temperature=0.8, device="cpu", **mesh)(
        models["enc"], models["dec"], images,
        torch.Generator().manual_seed(3))
        for mesh in ({}, {"mesh_data": 2, "devices": TWO})]
    _same(outs[1], {k: to_np(v) for k, v in outs[0].items()})


def test_mesh_runner_joins_slices_in_order(models):
    """Each replica holds its own copies, made once; the slices come back
    in order, cut to the batch, whatever the outputs' container."""
    runner = MeshRunner(TWO)
    seen = []

    def fn(i, device, cache, modules, rows, lo, hi):
        seen.append((i, lo, hi, modules[0] is not models["dec"]))
        t = torch.as_tensor(rows)[:, 0, 0, 0]
        return {"rows": t}, (t, t * 2)

    batch = _images(5)
    out = runner.run(fn, batch, (models["dec"],), "cpu")
    again = runner.run(fn, batch, (models["dec"],), "cpu")
    assert sorted(seen) == [(0, 0, 3, True), (0, 0, 3, True),
                            (1, 3, 6, True), (1, 3, 6, True)]
    assert len(runner._copies) == 1
    np.testing.assert_array_equal(to_np(out[0]["rows"]),
                                  batch[:, 0, 0, 0])
    np.testing.assert_array_equal(to_np(again[1][1]),
                                  2 * batch[:, 0, 0, 0])
    assert runner.graphs == [None, None]
