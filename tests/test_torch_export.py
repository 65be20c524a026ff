"""The port's AOT caption artifact (engine/serving.py, engine/artifact.py)
against its live caption step and against sat_tpu's `build_caption_fn`.

At tests/test_serving.py's size (vocab 30, 32 px images, two of them,
beam 2), with the <eos> bias raised so that some beams complete and the
live beam stops before its 51 steps: each exported mode (beam, greedy, the
fast modes, the top-k operator) loads back and gives the live step's
result dict bit for bit (the artifact runs every step; finished images
freeze); its graph holds `sat::attention_fwd`, and `sat::topk` only when
`pallas_topk=True` asks for it; `pallas_topk` defaults to False and
threads through; the tokens equal sat_tpu's; sample decode raises
sat_tpu's ValueError. Each mode is exported once, in a module fixture.
"""

import copy
import os
import tempfile

import numpy as np
import pytest
import torch

import jax

from sat_tpu.engine.serving import build_caption_fn as jax_caption_fn
from sat_tpu.models import DecoderConfig as JaxDecoderConfig
from sat_tpu.models import init_decoder_params
from sat_tpu.models.encoder import init_encoder_params

import sat_tpu_torch.engine.serving as serving
from sat_tpu_torch.compat.jax_params import decoder_from_jax, encoder_from_jax
from sat_tpu_torch.engine.serving import (build_caption_step,
                                          export_caption_artifact,
                                          load_caption_artifact)
from sat_tpu_torch.models.decoder import DecoderConfig
from tests.test_torch_common import flat

VOCAB, SIZE, BATCH, BEAM = 30, 32, 2, 2
MODES = {"beam": {}, "greedy": {"decode": "greedy"},
         "fast-bf16": {"fast_topk": True, "bf16": True},
         "topk-kernel": {"pallas_topk": True}}


@pytest.fixture(scope="module")
def model():
    jcfg = JaxDecoderConfig(vocab_size=VOCAB, encoder_dim=512,
                            use_attention=True)
    enc = init_encoder_params(jax.random.PRNGKey(0), "vgg19")
    dec = init_decoder_params(jax.random.PRNGKey(1), jcfg)
    bias = np.asarray(dec["deep_output"]["b"]).copy()
    bias[1] += 3.0                   # <eos>: some beams complete early
    dec["deep_output"]["b"] = jax.numpy.asarray(bias)
    dcfg = DecoderConfig(vocab_size=VOCAB, encoder_dim=512,
                         use_attention=True)
    images = np.random.default_rng(0).normal(
        size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
    return {"jcfg": jcfg, "jax_enc": enc, "jax_dec": dec, "dcfg": dcfg,
            "enc": encoder_from_jax(flat(enc), "vgg19", device="cpu"),
            "dec": decoder_from_jax(flat(dec), dcfg, device="cpu"),
            "images": images}


@pytest.fixture(scope="module")
def artifacts(model):
    """{mode: (path, the options build_caption_fn saw)}; the files (about
    100 MB each) are removed after the module."""
    real = serving.build_caption_fn
    out = {}
    with tempfile.TemporaryDirectory() as root:
        for mode, options in MODES.items():
            seen = {}

            def spy(*args, **kw):
                seen.update(kw)
                return real(*args, **kw)

            serving.build_caption_fn = spy
            try:
                path = os.path.join(root, f"{mode}.pt2")
                export_caption_artifact(path, "vgg19", model["dcfg"],
                                        model["enc"], model["dec"], BATCH,
                                        SIZE, BEAM, device="cpu", **options)
            finally:
                serving.build_caption_fn = real
            out[mode] = (path, seen)
        yield out


def _live(model, options):
    route = {} if "pallas_topk" in options else {"pallas_topk": False}
    return build_caption_step("vgg19", model["dcfg"], BEAM, device="cpu",
                              **options, **route)(
        model["enc"], model["dec"], model["images"])


def _same(a, b):
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("mode", list(MODES))
def test_artifact_equals_the_live_step(model, artifacts, mode):
    got = load_caption_artifact(artifacts[mode][0])(model["images"])
    live = _live(model, MODES[mode])
    assert sorted(got) == sorted(live)
    for k in live:
        assert _same(got[k], live[k]), k
    assert bool(live["found"].any())          # beams completed
    if mode != "greedy":                      # the live beam stopped early
        assert int(live["length"].max()) < 50


def _graph_ops(path) -> set:
    ep = torch.export.load(path)
    return {str(n.target) for gm in ep.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule)
            for n in gm.graph.nodes if n.op == "call_function"}


@pytest.mark.parametrize("mode", list(MODES))
def test_artifact_graph_holds_the_operators(artifacts, mode):
    ops = _graph_ops(artifacts[mode][0])
    assert "sat.attention_fwd.default" in ops
    assert ("sat.topk.default" in ops) == (mode == "topk-kernel")
    assert "sat.attention_bwd.default" not in ops


def test_pallas_topk_defaults_to_false_and_threads_through(artifacts):
    assert artifacts["beam"][1]["pallas_topk"] is False
    assert artifacts["topk-kernel"][1]["pallas_topk"] is True
    assert load_caption_artifact(
        artifacts["topk-kernel"][0]).meta["pallas_topk"] is True


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_artifact_tokens_equal_sat_tpu(model, artifacts, mode):
    options = MODES[mode]
    beam = 1 if mode == "greedy" else BEAM
    want = jax_caption_fn("vgg19", model["jcfg"], model["jax_enc"],
                          model["jax_dec"], beam, **options)(
        model["images"])
    got = load_caption_artifact(artifacts[mode][0])(model["images"])
    for k in ("tokens", "length", "found"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got["alphas"].numpy(),
                               np.asarray(want["alphas"]), atol=1e-5)


def test_sample_is_not_exportable(model, tmp_path):
    with pytest.raises(ValueError, match="not exportable"):
        export_caption_artifact(str(tmp_path / "s.pt2"), "vgg19",
                                model["dcfg"], model["enc"], model["dec"],
                                BATCH, SIZE, BEAM, decode="sample",
                                device="cpu")
    assert not (tmp_path / "s.pt2").exists()


def test_artifact_refuses_other_shapes_and_devices(model, artifacts,
                                                   tmp_path):
    caption = load_caption_artifact(artifacts["greedy"][0])
    assert caption.meta["batch_size"] == BATCH
    with pytest.raises(ValueError, match="shape"):
        caption(model["images"][:1])
    with pytest.raises(ValueError, match="not on"):
        export_caption_artifact(str(tmp_path / "m.pt2"), "vgg19",
                                model["dcfg"], model["enc"],
                                copy.deepcopy(model["dec"]).to("meta"),
                                BATCH, SIZE, BEAM, device="cpu")
