"""Reading the reference's `.pth` decoder checkpoints: the port's
`load_decoder_checkpoint` against sat_tpu's.

A synthetic decoder state_dict (the reference's key schema, which the
port's Decoder has too) is written with `torch.save`. Read strictly and
non-strictly, whole, with a key missing and with a key added, both
packages must give the same flat arrays, exactly (a transpose is a copy),
and the same errors and messages.
"""

import json

import numpy as np
import pytest
import torch

import jax

from sat_tpu.engine.checkpoint import \
    load_decoder_checkpoint as jax_load_checkpoint
from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from sat_tpu.models.decoder import init_decoder_params as jax_init_decoder

from sat_tpu_torch.compat.jax_params import decoder_from_jax, decoder_to_jax
from sat_tpu_torch.compat.torch_decoder import decoder_params_from_state_dict
from sat_tpu_torch.engine.checkpoint import load_decoder_checkpoint
from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
from tests.test_torch_common import flat, to_np

V, D = 30, 16


def configs(ado: bool):
    return (JaxDecoderConfig(vocab_size=V, encoder_dim=D, use_ado=ado),
            DecoderConfig(vocab_size=V, encoder_dim=D, use_ado=ado))


def synthetic_state_dict(ado: bool, seed: int = 0) -> dict:
    """A reference-schema decoder state_dict of random numbers."""
    _, cfg = configs(ado)
    gen = torch.Generator().manual_seed(seed)
    dec = decoder_from_jax(init_decoder_params(cfg, gen), cfg, device="cpu")
    return {k: torch.randn(v.shape, generator=gen)
            for k, v in dec.state_dict().items()}


def both(path, ado: bool, strict: bool):
    """(sat_tpu's result flattened, the port's), each loading `path` over
    its own template."""
    jcfg, cfg = configs(ado)
    jtemplate = jax_init_decoder(jax.random.PRNGKey(1), jcfg)
    template = flat(jtemplate)       # one template for both packages
    ref = flat(jax_load_checkpoint(str(path), jtemplate, strict=strict))
    got = load_decoder_checkpoint(str(path), template, strict=strict)
    return ref, got, template


def assert_same(ref: dict, got: dict):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("ado", [True, False])
@pytest.mark.parametrize("strict", [True, False])
def test_whole_state_dict_loads_as_sat_tpu(tmp_path, ado, strict, capsys):
    sd = synthetic_state_dict(ado)
    path = tmp_path / "decoder.pth"
    torch.save(sd, path)
    ref, got, _ = both(path, ado, strict)
    assert_same(ref, got)
    assert "Strict loading failed" not in capsys.readouterr().out
    # and the module made from it holds the state_dict's tensors
    _, cfg = configs(ado)
    dec = decoder_from_jax(got, cfg, device="cpu")
    for k, v in sd.items():
        assert torch.equal(dec.state_dict()[k], v), k


@pytest.mark.parametrize("change", ["missing", "unexpected"])
@pytest.mark.parametrize("ado", [True, False])
def test_strict_errors_match_sat_tpu(tmp_path, change, ado):
    sd = synthetic_state_dict(ado)
    if change == "missing":
        del sd["attention.W.bias"]
    else:
        sd["f_extra.weight"] = torch.zeros(2, 2)
    path = tmp_path / "decoder.pt"
    torch.save(sd, path)
    jcfg, cfg = configs(ado)
    with pytest.raises(KeyError) as ref:
        jax_load_checkpoint(str(path), jax_init_decoder(
            jax.random.PRNGKey(1), jcfg), strict=True)
    with pytest.raises(KeyError) as got:
        load_decoder_checkpoint(str(path), init_decoder_params(
            cfg, torch.Generator().manual_seed(0)), strict=True)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("change", ["missing", "unexpected", "ado_keys"])
def test_non_strict_fallback_matches_sat_tpu(tmp_path, change, capsys):
    """strict=False: sat_tpu's line, then missing keys keep the template's
    values and unexpected ones are ignored. `ado_keys`: an ado checkpoint
    read by a decoder without ado, as the reference's fallback allows."""
    ado = change != "ado_keys"
    sd = synthetic_state_dict(True)
    if change == "missing":
        del sd["lstm.bias_hh"]
        del sd["embedding.weight"]
    elif change == "unexpected":
        sd["f_extra.bias"] = torch.zeros(3)
    path = tmp_path / "decoder.pth"
    torch.save(sd, path)
    ref, got, template = both(path, ado, strict=False)
    out = capsys.readouterr().out
    assert out.count("Strict loading failed, loading with strict=False") == 2
    assert_same(ref, got)
    if change == "missing":
        np.testing.assert_array_equal(got["lstm/b_hh"], template["lstm/b_hh"])
        np.testing.assert_array_equal(got["embedding"], template["embedding"])


def test_state_dict_import_leaves_the_template(tmp_path):
    _, cfg = configs(True)
    template = init_decoder_params(cfg, torch.Generator().manual_seed(0))
    before = {k: v.copy() for k, v in template.items()}
    decoder_params_from_state_dict(synthetic_state_dict(True), template)
    for k, v in before.items():
        np.testing.assert_array_equal(template[k], v)


def test_serving_reads_a_pth_model(tmp_path):
    """`load_model` (serve, generate_caption, caption_split) reads a
    `.pth` written by `torch.save(decoder.state_dict())`: the decoder is
    the `.npz` model's."""
    from sat_tpu_torch.engine.checkpoint import tree_save_npz
    from sat_tpu_torch.serve import load_model

    words = ["<start>", "<eos>", "<unk>", "<pad>"] + [
        f"w{i}" for i in range(4, V)]
    (tmp_path / "word_dict.json").write_text(json.dumps(
        {w: i for i, w in enumerate(words)}))
    (tmp_path / "model_config.json").write_text(json.dumps(
        {"data": str(tmp_path), "network": "vgg19", "ado": True,
         "attention": True, "bert": False, "tf": False}))
    cfg = DecoderConfig(vocab_size=V, encoder_dim=512, use_ado=True)
    flat_npz = init_decoder_params(cfg, torch.Generator().manual_seed(2))
    tree_save_npz(str(tmp_path / "model_vgg19_1.npz"), flat_npz)
    dec = decoder_from_jax(flat_npz, cfg, device="cpu")
    torch.save(dec.state_dict(), tmp_path / "model_vgg19_1.pth")
    models = [load_model(str(tmp_path / f"model_vgg19_1.{ext}"),
                         device="cpu")[3] for ext in ("npz", "pth")]
    for k, v in models[0].state_dict().items():
        assert torch.equal(models[1].state_dict()[k], v), k
    assert sorted(decoder_to_jax(models[1])) == sorted(flat_npz)
    assert to_np(models[1].embedding.weight).shape == (V, 512)
