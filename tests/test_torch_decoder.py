"""The port's LSTM cell, decoder init state and decode step against
sat_tpu, from sat_tpu's own parameters carried over by
sat_tpu_torch.compat.jax_params. atol 1e-5: f32 with other summation
orders."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sat_tpu.models.attention import precompute_attention_keys
from sat_tpu.models.decoder import decode_step, embed_tokens, init_lstm_state
from sat_tpu.ops.lstm import init_lstm_params, lstm_cell

from sat_tpu_torch.models.decoder import Decoder, DecoderConfig
from sat_tpu_torch.models.decoder import decode_step as port_step
from sat_tpu_torch.models.decoder import embed_tokens as port_embed
from sat_tpu_torch.models.decoder import init_decoder_params
from sat_tpu_torch.models.decoder import init_lstm_state as port_init_state
from sat_tpu_torch.ops.lstm import lstm_cell as port_lstm_cell
from tests.test_torch_common import decoder_pair, features, flat, to_np

V, D, L, B = 60, 32, 6, 4
FLAGS = [(ado, attention) for ado in (False, True)
         for attention in (False, True)]


def test_lstm_cell_matches_sat_tpu():
    I, H = 24, 16
    params = init_lstm_params(jax.random.PRNGKey(3), I, H)
    cell = torch.nn.LSTMCell(I, H)
    p = flat(params)
    cell.load_state_dict({
        "weight_ih": torch.from_numpy(np.array(p["w_ih"].T)),
        "weight_hh": torch.from_numpy(np.array(p["w_hh"].T)),
        "bias_ih": torch.from_numpy(np.array(p["b_ih"])),
        "bias_hh": torch.from_numpy(np.array(p["b_hh"]))})
    x, h, c = (features(s, (5, n)) for s, n in ((0, I), (1, H), (2, H)))
    h_ref, c_ref = lstm_cell(params, *(jnp.asarray(a) for a in (x, h, c)))
    with torch.no_grad():
        h2, c2 = port_lstm_cell(cell, *(torch.from_numpy(a)
                                        for a in (x, h, c)))
    np.testing.assert_allclose(to_np(h2), np.asarray(h_ref), atol=1e-5)
    np.testing.assert_allclose(to_np(c2), np.asarray(c_ref), atol=1e-5)


@pytest.mark.parametrize("ado,attention", FLAGS)
def test_decode_step_matches_sat_tpu(ado, attention):
    jcfg, params, dec = decoder_pair(V, D, ado, attention, seed=1)
    feats = features(2, (B, L, D))
    ids = np.array([0, 5, 17, 59], np.int64)
    tf = torch.from_numpy(feats)
    jf = jnp.asarray(feats)
    keys = precompute_attention_keys(params["attention"], jf)
    h, c = init_lstm_state(params, jf)
    emb = embed_tokens(params, jcfg, jnp.asarray(ids, jnp.int32))
    ref = decode_step(params, jcfg, jf, keys, h, c, emb, None)

    pkeys = dec.attention.W(tf)
    ph, pc = port_init_state(dec, tf)
    np.testing.assert_allclose(to_np(ph), np.asarray(h), atol=1e-5)
    np.testing.assert_allclose(to_np(pc), np.asarray(c), atol=1e-5)
    pemb = port_embed(dec, torch.from_numpy(ids))
    np.testing.assert_array_equal(to_np(pemb), np.asarray(emb))
    got = port_step(dec, tf, pkeys, ph, pc, pemb)
    for name, g, r in zip(("h", "c", "logits", "alpha", "context"), got, ref):
        np.testing.assert_allclose(to_np(g), np.asarray(r), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("attention", [False, True])
def test_shared_rows_step_equals_flat_step(attention):
    """rows_per_image=K (the de-duplicated beam step) equals the plain step
    on the grid repeated K times (the flat beam layout)."""
    K = 3
    _, _, dec = decoder_pair(V, D, True, attention, seed=4)
    feats = torch.from_numpy(features(5, (B, L, D)))
    h = torch.from_numpy(features(6, (B * K, 512)))
    c = torch.from_numpy(features(7, (B * K, 512)))
    emb = port_embed(dec, torch.arange(B * K) % V)
    keys = dec.attention.W(feats)
    shared = port_step(dec, feats, keys, h, c, emb, rows_per_image=K)
    feats_k = feats.repeat_interleave(K, dim=0)
    flat_ = port_step(dec, feats_k, dec.attention.W(feats_k), h, c, emb)
    for g, r in zip(shared, flat_):
        np.testing.assert_allclose(to_np(g), to_np(r), atol=1e-5)


@pytest.mark.parametrize("ado", [False, True])
def test_init_params_have_sat_tpu_names_and_shapes(ado):
    """The port's random init writes exactly the archive sat_tpu's init
    would: the same names, shapes and dtypes."""
    jcfg, params, _ = decoder_pair(V, D, ado, True)
    cfg = DecoderConfig(vocab_size=V, encoder_dim=D, use_ado=ado,
                        use_attention=True)
    mine = init_decoder_params(cfg, torch.Generator().manual_seed(0))
    ref = flat(params)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].shape == ref[k].shape, k
        assert mine[k].dtype == ref[k].dtype, k


def test_bert_is_not_ported():
    with pytest.raises(NotImplementedError):
        Decoder(DecoderConfig(vocab_size=V, encoder_dim=D, use_bert=True))
