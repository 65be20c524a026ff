"""BERT mode of the port against sat_tpu on the CPU.

- `data/bert_vocab.py` against `transformers.BertTokenizer` over a
  synthetic bert-base-uncased `vocab.txt` (tests/_synth.py) with word
  pieces and punctuation added: `convert_ids_to_tokens`,
  `convert_tokens_to_string` and `decode` equal as strings, and
  `decode_caption_bert` equal to sat_tpu's;
- the BERT decoder (tf + ado + attention, V = 30522 and E = 768 as BERT
  fixes them, small D and L) from sat_tpu's parameters: a decode step and
  `decoder_forward`, teacher-forced and autoregressive, logits and alphas
  within atol 1e-5, each gradient normwise within 1e-5 of `jax.grad`'s, no
  gradient for the frozen table;
- beam (two arms), greedy and sample (fed sat_tpu's Gumbel noise): tokens,
  lengths and completion equal, scores and alphas within atol 1e-5, on
  weights whose raised [PAD] bias makes BERT's stop set {1, 0} fire;
- `CaptionDataset(bert=True)` against sat_tpu's on files that sat_tpu's
  `generate_json_data_bert` wrote;
- an epoch of `python -m sat_tpu_torch.train --bert` on the CPU: the
  table in the `.npz` bit for bit the `.npy` given, the `.npz` read by
  sat_tpu's loader, a `.pth` round trip, `--resume` after a preemption
  bit-exact, the table absent from Adam's state; and the CLIs (serve,
  generate_caption, evaluate, caption_split) with `--bert-vocab`, their
  words those of sat_tpu's decodes of the same tokens.

sat_tpu's side runs eagerly and through its own jitted functions, one
compile each (its decoder at V = 30522 compiles in seconds at these
sizes).
"""

import contextlib
import copy
import dataclasses
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sat_tpu.models.beam as jax_beam
from sat_tpu.data import CaptionDataset as JaxDataset
from sat_tpu.data import generate_json_data
from sat_tpu.data.bert_prep import generate_json_data_bert, get_bert_tokenizer
from sat_tpu.engine.checkpoint import load_decoder_checkpoint as jax_load
from sat_tpu.engine.evaluate import decode_caption_bert as jax_decode_bert
from sat_tpu.models.attention import precompute_attention_keys
from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from sat_tpu.models.decoder import decode_step as jax_decode_step
from sat_tpu.models.decoder import decoder_forward as jax_forward
from sat_tpu.models.decoder import embed_tokens as jax_embed
from sat_tpu.models.decoder import init_decoder_params as jax_init_decoder
from sat_tpu.models.decoder import init_lstm_state as jax_init_state
from sat_tpu.utils.metrics import attention_regularization as jax_reg
from sat_tpu.utils.metrics import reference_packed_cross_entropy as jax_ce

from sat_tpu_torch import constants
from sat_tpu_torch.compat.jax_params import decoder_from_jax, decoder_to_jax
from sat_tpu_torch.data.bert_vocab import BertVocab, load_bert_vocab
from sat_tpu_torch.data.dataset import CaptionDataset
from sat_tpu_torch.engine.checkpoint import load_decoder_checkpoint
from sat_tpu_torch.engine.evaluate import decode_caption_bert
from sat_tpu_torch.models.beam import (beam_search_batched, greedy_caption,
                                       sample_caption, stop_ids)
from sat_tpu_torch.models.decoder import (DecoderConfig, decode_step,
                                          decoder_forward, embed_tokens,
                                          init_lstm_state)
from sat_tpu_torch.utils.metrics import (attention_regularization,
                                         reference_packed_cross_entropy)
from tests._synth import WORDS, build_synth_dataset, write_synthetic_bert_vocab
from tests.test_torch_common import flat, to_np

V, E = constants.BERT_VOCAB_SIZE, constants.BERT_HIDDEN_SIZE
D, L, B, CAP = 16, 5, 2, 7
MAX_STEPS = 8
# Word pieces, punctuation and contractions for the decode's joins and
# clean-up
PIECES = ["##s", "##ing", "##ed", ".", ",", "?", "!", "'", "n't", "'s",
          "'m", "'ve", "'re", "don", "it"]
PAD_BOOST = 2.0     # added to [PAD]'s output bias: the stop set fires


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("bertvocab") / "vocab.txt"
    return write_synthetic_bert_vocab(str(path), WORDS + PIECES)


@pytest.fixture(scope="module")
def tokenizer(vocab_file):
    return get_bert_tokenizer(vocab_file)


def _id_rows(tok, seed, n=12, width=16):
    """Rows of ids drawn from the words, the pieces, the special tokens,
    [unused*] and ids outside the vocabulary."""
    rng = np.random.default_rng(seed)
    pool = ([tok.vocab[w] for w in WORDS + PIECES] * 3
            + [0, 1, 100, 101, 102, 103, V + 7])
    rows = [rng.choice(pool, size=width).tolist() for _ in range(n)]
    # a caption in sat_tpu's layout: [CLS] ids [PAD]* [SEP]
    rows.append([101] + rows[0][:5] + [0, 0, 102])
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vocab_matches_transformers(vocab_file, tokenizer, seed):
    vocab = load_bert_vocab(vocab_file)
    for row in _id_rows(tokenizer, seed):
        tokens = tokenizer.convert_ids_to_tokens(row)
        assert vocab.convert_ids_to_tokens(row) == tokens
        assert (vocab.convert_tokens_to_string(tokens)
                == tokenizer.convert_tokens_to_string(tokens))
        assert (vocab.decode(row)
                == tokenizer.decode(row, skip_special_tokens=False)), row
        assert decode_caption_bert(row, vocab) == jax_decode_bert(row,
                                                                  tokenizer)


def test_decode_joins_pieces_and_cleans_up(vocab_file, tokenizer):
    """The cases the random rows may miss: a piece after a special token
    joins it, and each of the clean-up's replacements."""
    vocab = load_bert_vocab(vocab_file)
    v = tokenizer.vocab
    rows = [[101, v["##s"], v["dog"], v["##s"], 102, v["##ing"]],
            [v["dog"], v["."], v["?"], v["!"], v[","], v["'"], v["cat"]],
            [v["don"], v["n't"], v["it"], v["'s"], v["it"], v["'m"],
             v["it"], v["'ve"], v["it"], v["'re"], 0, 0]]
    for row in rows:
        want = tokenizer.decode(row, skip_special_tokens=False)
        assert vocab.decode(row) == want
    assert vocab.decode(rows[0]) == "[CLS]s dogs [SEP]ing"


def test_vocab_layout_is_checked(tmp_path, vocab_file):
    """A vocabulary whose special ids are not bert-base-uncased's is
    refused, and BERT mode without one names --bert-vocab."""
    with open(vocab_file) as f:
        lines = f.read().splitlines()
    lines[101], lines[102] = lines[102], lines[101]
    bad = tmp_path / "bad.txt"
    bad.write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match=r"\[CLS\]"):
        BertVocab(str(bad))
    with pytest.raises(ValueError, match="--bert-vocab"):
        load_bert_vocab(None)


# ------------------------------------------------------------ the decoder

@pytest.fixture(scope="module")
def models():
    """sat_tpu's BERT decoder (tf + ado + attention, dropout 0) and its
    port, with the [PAD] bias raised in a second copy."""
    jcfg = JaxDecoderConfig(vocab_size=V, encoder_dim=D, use_tf=True,
                            use_ado=True, use_bert=True, use_attention=True,
                            dropout_rate=0.0)
    cfg = DecoderConfig(vocab_size=V, encoder_dim=D, use_tf=True,
                        use_ado=True, use_bert=True, use_attention=True,
                        dropout_rate=0.0)
    params = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    stop = jax.tree_util.tree_map(lambda x: x, params)
    stop["ado"] = dict(stop["ado"])
    stop["ado"]["f_out"] = dict(stop["ado"]["f_out"],
                                b=stop["ado"]["f_out"]["b"].at[
                                    constants.BERT_PAD].add(PAD_BOOST))
    return {"jcfg": jcfg, "cfg": cfg, "params": params, "stop": stop,
            "dec": decoder_from_jax(flat(params), cfg, "cpu",
                                    trainable=True),
            "dec_stop": decoder_from_jax(flat(stop), cfg, "cpu")}


def _features(seed, rows=B):
    return np.random.default_rng(seed).normal(size=(rows, L, D)).astype(
        np.float32)


def _captions(seed):
    caps = np.random.default_rng(seed).integers(1000, V, size=(B, CAP))
    caps[:, 0] = constants.BERT_CLS
    caps[0, -3:-1] = constants.BERT_PAD       # the quirk's padding
    caps[:, -1] = constants.BERT_SEP
    return caps.astype(np.int32)


def test_bert_decoder_shapes_and_frozen_table(models):
    dec = models["dec"]
    assert dec.embedding.weight.shape == (V, E)
    assert dec.lstm.weight_ih.shape == (4 * E, E + D)
    assert not dec.embedding.weight.requires_grad
    assert all(p.requires_grad for n, p in dec.named_parameters()
               if n != "embedding.weight")
    dec.requires_grad_(True)                   # the table stays frozen
    assert not dec.embedding.weight.requires_grad
    assert dec.cfg.start_token == constants.BERT_CLS
    assert stop_ids(dec.cfg) == (1, 0)


def test_decode_step_matches_sat_tpu(models):
    params, jcfg, dec = models["params"], models["jcfg"], models["dec"]
    feats = _features(1)
    ids = np.array([constants.BERT_CLS, 2003], np.int64)
    jf = jnp.asarray(feats)
    keys = precompute_attention_keys(params["attention"], jf)
    h, c = jax_init_state(params, jf)
    emb = jax_embed(params, jcfg, jnp.asarray(ids, jnp.int32))
    ref = jax_decode_step(params, jcfg, jf, keys, h, c, emb, None)
    tf = torch.from_numpy(feats)
    with torch.no_grad():
        ph, pc = init_lstm_state(dec, tf)
        pemb = embed_tokens(dec, torch.from_numpy(ids))
        got = decode_step(dec, tf, dec.attention.W(tf), ph, pc, pemb)
    np.testing.assert_array_equal(to_np(pemb), np.asarray(emb))
    for name, g, r in zip(("h", "c", "logits", "alpha", "context"), got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(to_np(g), np.asarray(r), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("tf", [True, False], ids=["tf", "autoregressive"])
def test_decoder_forward_and_grads_match_sat_tpu(models, tf):
    """Preds and alphas within atol 1e-5; the reference loss's gradients
    normwise within 1e-5 of jax.grad's; the table has none (sat_tpu's is
    all zero, its gradient stopped)."""
    jcfg = dataclasses.replace(models["jcfg"], use_tf=tf)
    cfg = dataclasses.replace(models["cfg"], use_tf=tf)
    params, dec = models["params"], models["dec"]
    feats, caps = _features(2), _captions(3)

    def jloss(p):
        preds, alphas = jax_forward(p, jcfg, jnp.asarray(feats),
                                    jnp.asarray(caps))
        return (jax_ce(preds, jnp.asarray(caps)[:, 1:])
                + jax_reg(alphas, 1.0)), (preds, alphas)

    (ref_loss, (ref_p, ref_a)), ref_grads = jax.value_and_grad(
        jloss, has_aux=True)(params)
    dec.zero_grad(set_to_none=True)
    tcaps = torch.from_numpy(caps)
    preds, alphas = decoder_forward(dec, cfg, torch.from_numpy(feats), tcaps)
    loss = (reference_packed_cross_entropy(preds, tcaps[:, 1:].long())
            + attention_regularization(alphas, 1.0))
    loss.backward()
    assert preds.shape == (B, CAP - 1, V)
    np.testing.assert_allclose(to_np(preds), np.asarray(ref_p), atol=1e-5)
    np.testing.assert_allclose(to_np(alphas), np.asarray(ref_a), atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)

    assert dec.embedding.weight.grad is None
    ref = flat(ref_grads)
    assert not np.asarray(ref["embedding"]).any()
    grads = {n: p.grad for n, p in dec.named_parameters()}
    holder = copy.deepcopy(dec)        # the gradients in sat_tpu's layout
    with torch.no_grad():
        for n, p in holder.named_parameters():
            p.copy_(torch.zeros_like(p) if grads[n] is None else grads[n])
    got = decoder_to_jax(holder)
    checked = 0
    for name, r in ref.items():
        a = np.asarray(r, np.float64)
        if name == "attention/v/b" or not np.abs(a).max():
            continue      # a true gradient of 0 (v's bias, unused weights)
        rel = (np.linalg.norm(np.asarray(got[name], np.float64) - a)
               / np.linalg.norm(a))
        assert rel < 1e-5, f"{name}: normwise gradient error {rel:.2e}"
        checked += 1
    assert checked >= 12


def _compare(ref, got):
    for k in ("tokens", "length", "found"):
        np.testing.assert_array_equal(to_np(getattr(got, k)),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    for k in ("score", "alphas", "fallback_alpha"):
        np.testing.assert_allclose(to_np(getattr(got, k)),
                                   np.asarray(getattr(ref, k)), atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("weights", ["random", "stop"])
@pytest.mark.parametrize("dedup,backtrack", [(True, True), (False, False)])
def test_beam_matches_sat_tpu(models, dedup, backtrack, weights):
    params = models["params" if weights == "random" else "stop"]
    dec = models["dec" if weights == "random" else "dec_stop"]
    feats = _features(4)
    ref = jax_beam.beam_search_batched(params, models["jcfg"],
                                       jnp.asarray(feats), 3,
                                       max_steps=MAX_STEPS, dedup=dedup,
                                       backtrack=backtrack)
    got = beam_search_batched(dec, torch.from_numpy(feats), 3,
                              max_steps=MAX_STEPS, dedup=dedup,
                              backtrack=backtrack)
    _compare(ref, got)
    if weights == "stop":      # BERT's stop set completed the sentences
        assert bool(got.found.all())
        for row, n in zip(to_np(got.tokens), to_np(got.length)):
            assert row[0] == constants.BERT_CLS and row[n] in (0, 1)


def test_greedy_matches_sat_tpu(models):
    feats = _features(5)
    toks, lens, alphas = jax_beam.greedy_caption(
        models["stop"], models["jcfg"], jnp.asarray(feats),
        max_steps=MAX_STEPS, with_alphas=True)
    gt, gl, ga = greedy_caption(models["dec_stop"], torch.from_numpy(feats),
                                max_steps=MAX_STEPS, with_alphas=True)
    np.testing.assert_array_equal(to_np(gt), np.asarray(toks))
    np.testing.assert_array_equal(to_np(gl), np.asarray(lens))
    np.testing.assert_allclose(to_np(ga), np.asarray(alphas), atol=1e-5)
    stopped = to_np(gl) < MAX_STEPS
    assert stopped.any()                           # on 0 or 1
    assert np.isin(to_np(gt)[stopped, to_np(gl)[stopped]], (0, 1)).all()


@pytest.mark.parametrize("knobs", [(0.8, 10, 0.9), (1.0, 5, 1.0)], ids=str)
def test_sample_matches_sat_tpu(models, knobs):
    feats = _features(6)
    key = jax.random.PRNGKey(7)
    toks, lens, alphas = jax_beam.sample_caption(
        models["stop"], models["jcfg"], jnp.asarray(feats), key, *knobs,
        max_steps=MAX_STEPS, with_alphas=True)
    rngs = jax.random.split(key, MAX_STEPS)
    noise = torch.from_numpy(np.stack([
        np.asarray(jax.random.gumbel(rngs[t], (B, V)))
        for t in range(MAX_STEPS)]))
    gt, gl, ga = sample_caption(models["dec_stop"], torch.from_numpy(feats),
                                None, *knobs, max_steps=MAX_STEPS,
                                with_alphas=True, noise=noise)
    np.testing.assert_array_equal(to_np(gt), np.asarray(toks))
    np.testing.assert_array_equal(to_np(gl), np.asarray(lens))
    np.testing.assert_allclose(to_np(ga), np.asarray(alphas), atol=1e-5)
    assert (to_np(gl) < MAX_STEPS).any()


# ------------------------------------------------------- data and training

@pytest.fixture(scope="module")
def bert_data(tmp_path_factory, vocab_file):
    """tests/_synth's dataset with sat_tpu's vanilla and BERT caption files,
    and a frozen table (N(0, 0.02), as tests/test_bert_engine.py)."""
    root = str(tmp_path_factory.mktemp("bertdata"))
    build_synth_dataset(root, n_train=4, n_val=2, n_test=2, caps_per_img=2,
                        image_size=32)
    generate_json_data(f"{root}/dataset.json", root, 2, 1, 10)
    generate_json_data_bert(f"{root}/dataset.json", root, 2, 12,
                            vocab_file=vocab_file)
    table = np.random.default_rng(0).normal(scale=0.02, size=(V, E)).astype(
        np.float32)
    np.save(f"{root}/table.npy", table)
    yield {"root": root, "table": f"{root}/table.npy"}
    shutil.rmtree(root, ignore_errors=True)     # pytest keeps old temp dirs


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_caption_dataset_matches_sat_tpu(bert_data, split):
    root = bert_data["root"]
    ref = JaxDataset(root, split, bert=True, cache_images=False)
    got = CaptionDataset(root, split, bert=True, cache_images=False)
    assert got.img_paths == ref.img_paths
    for k in ("captions", "all_captions"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), k)
        assert getattr(got, k).dtype == getattr(ref, k).dtype
    assert (got.captions[:, 0] == constants.BERT_CLS).all()
    assert (got.captions[:, -1] == constants.BERT_SEP).all()


def _train(data, vocab_file, ckpt_dir, *extra):
    """One epoch of `python -m sat_tpu_torch.train --bert` on the CPU:
    (its result, its stdout)."""
    from sat_tpu_torch.train import main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(["--data", data["root"], "--bert", "--bert-embeddings",
                    data["table"], "--bert-vocab", vocab_file, "--tf",
                    "--ado", "--attention", "--cache-features",
                    "--image-size", "32", "--batch-size", "4", "--epochs",
                    "1", "--log-interval", "1", "--checkpoint-dir",
                    str(ckpt_dir), "--device", "cpu", *extra])
    return res, out.getvalue()


@pytest.fixture(scope="module")
def bert_run(tmp_path_factory, bert_data, vocab_file):
    ckpt = tmp_path_factory.mktemp("bertrun")
    res, log = _train(bert_data, vocab_file, ckpt)
    yield {"dir": str(ckpt), "res": res, "log": log,
           "npz": str(ckpt / "model_vgg19_1.npz")}
    # the .npz and the train state hold about 0.8 GB
    shutil.rmtree(ckpt, ignore_errors=True)


def test_bert_epoch_keeps_the_table_frozen(bert_run, bert_data):
    """The `.npz` holds the table bit for bit as given and reads into
    sat_tpu's decoder template strictly; the train state's Adam has no
    moments for it; validation and test report BLEU; the printed totals
    keep the table apart."""
    res, log = bert_run["res"], bert_run["log"]
    assert np.isfinite(res["loss"]) and 0.0 <= res["bleu1"] <= 1.0
    assert "EvalMode.VALIDATION Epoch: 1\tBLEU-1 (" in log
    assert "EvalMode.TEST Epoch: 1\tBLEU-1 (" in log
    assert f"Frozen BERT embedding table: {V * E}" in log
    table = np.load(bert_data["table"])
    with np.load(bert_run["npz"]) as arc:
        np.testing.assert_array_equal(arc["embedding"], table)
        assert arc["lstm/w_ih"].shape == (E + 512, 4 * E)
    with open(os.path.join(bert_run["dir"], "model_config.json")) as f:
        assert json.load(f)["bert"] is True

    jcfg = JaxDecoderConfig(vocab_size=V, encoder_dim=512, use_ado=True,
                            use_bert=True, use_attention=True)
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda k: jax_init_decoder(k, jcfg),
                       jax.random.PRNGKey(0)))
    loaded = jax_load(bert_run["npz"], template, strict=True)
    np.testing.assert_array_equal(np.asarray(loaded["embedding"]), table)

    state = torch.load(os.path.join(bert_run["dir"], "train_state", "2.pt"),
                       weights_only=True)
    # Adam's i-th parameter is the decoder's i-th but the table (the first)
    trainable = [v.shape for k, v in state["decoder"].items()
                 if k != "embedding.weight"]
    opt = state["optimizer"]
    assert len(opt["param_groups"][0]["params"]) == len(trainable)
    assert opt["state"] and all(s["exp_avg"].shape == trainable[i]
                                for i, s in opt["state"].items())


def test_bert_pth_round_trip(bert_run, tmp_path):
    """The decoder as a reference `.pth` state_dict reads back (strictly)
    to the `.npz`'s arrays, the table included."""
    with np.load(bert_run["npz"]) as arc:
        want = {k: arc[k] for k in arc.files}
    cfg = DecoderConfig(vocab_size=V, encoder_dim=512, use_ado=True,
                        use_bert=True, use_attention=True)
    dec = decoder_from_jax(want, cfg, "cpu")
    pth = str(tmp_path / "decoder.pth")
    torch.save(dec.state_dict(), pth)
    template = {k: np.zeros_like(v) for k, v in want.items()}
    got = load_decoder_checkpoint(pth, template, strict=True)
    os.remove(pth)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bert_resume_is_bit_exact(bert_run, bert_data, vocab_file, tmp_path,
                                  monkeypatch):
    """The run preempted after its first step (SIGUSR1) and finished by
    --resume ends with the uninterrupted run's decoder and Adam moments,
    bit for bit."""
    import signal

    import sat_tpu_torch.engine.loop as loop

    make_step = loop.make_bank_train_step

    def preempting_step(*args, **kw):
        step, calls = make_step(*args, **kw), []

        def first_call_signals(*a, **k):
            calls.append(1)
            if len(calls) == 1:
                os.kill(os.getpid(), signal.SIGUSR1)
            return step(*a, **k)
        return first_call_signals

    monkeypatch.setattr(loop, "make_bank_train_step", preempting_step)
    try:
        res, _ = _train(bert_data, vocab_file, tmp_path)
        assert res == {"preempted": True, "epoch": 1}
        monkeypatch.setattr(loop, "make_bank_train_step", make_step)
        res, log = _train(bert_data, vocab_file, tmp_path, "--resume")
        assert "Resuming epoch 1 at batch offset 1" in log
        assert res["bleu4"] == bert_run["res"]["bleu4"]
        with np.load(bert_run["npz"]) as a, \
                np.load(str(tmp_path / "model_vgg19_1.npz")) as b:
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        ends = [torch.load(os.path.join(d, "train_state", "2.pt"),
                           weights_only=True)["optimizer"]["state"]
                for d in (bert_run["dir"], str(tmp_path))]
        for i, moments in ends[0].items():
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(moments[k], ends[1][i][k]), (i, k)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)    # about 1.3 GB


# ----------------------------------------------------------------- the CLIs

def _images(n, seed=3):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(
        np.float32)


def test_serve_bert_model_words_are_sat_tpus(bert_run, bert_data,
                                             vocab_file, tokenizer):
    """`serve --bert-vocab` builds the BERT decoder from the checkpoint
    directory; each reply's words are sat_tpu's decode_caption_bert of the
    caption step's tokens (transformers' tokenizer)."""
    from sat_tpu_torch.serve import build_parser, build_server
    args = build_parser().parse_args([
        "--model", bert_run["npz"], "--bert-vocab", vocab_file, "--device",
        "cpu", "--beam-size", "3", "--preload-images",
        os.path.join(bert_data["root"], "imgs")])
    server = build_server(args)
    out = server._caption_fn(server._image_pool[:2])
    for i in range(2):
        found = bool(out["found"][i])
        row = (out["tokens"][i, :int(out["length"][i]) + 1].tolist()
               if found else [0])
        words = server._decode_tokens(out["tokens"][i],
                                      int(out["length"][i]), found)
        assert words == jax_decode_bert(row, tokenizer)
        assert not found or row[0] == constants.BERT_CLS


def test_generate_caption_bert_renders_as_sat_tpu(bert_run, bert_data,
                                                  vocab_file, tokenizer,
                                                  tmp_path, capsys):
    """generate_caption --bert-vocab prints transformers' decode of the
    start token, the caption and its stop token, and writes its PNG."""
    from sat_tpu_torch.generate_caption import decode_single_image, main
    from sat_tpu_torch.models.encoder import encoder_forward
    from sat_tpu_torch.serve import load_model

    img = os.path.join(bert_data["root"], "imgs", "img_006.png")
    out = str(tmp_path / "fig.png")
    words, alpha = main(["--img-path", img, "--model", bert_run["npz"],
                         "--bert-vocab", vocab_file, "--decode", "greedy",
                         "--out", out, "--device", "cpu"])
    cfg, dcfg, enc, dec, vocab = load_model(bert_run["npz"], device="cpu",
                                            bert_vocab=vocab_file)
    from sat_tpu_torch.data.transforms import load_and_preprocess_image
    feats = encoder_forward(enc, cfg.network,
                            load_and_preprocess_image(img, 32)[None])[0]
    tokens, _ = decode_single_image(dcfg, dec, feats, decode="greedy")
    assert tokens[0] == constants.BERT_CLS
    want = tokenizer.decode(tokens, skip_special_tokens=False).split()
    assert words == want and words[0] == "[CLS]"
    assert f"Caption: {' '.join(words)}" in capsys.readouterr().out
    assert os.path.getsize(out) > 0 and len(alpha) == len(tokens)


def test_evaluate_and_caption_split_bert(bert_run, bert_data, vocab_file,
                                        tokenizer, tmp_path, capsys):
    """evaluate --split val runs the validation pass of the BERT model;
    caption_split's captions and BLEU are sat_tpu's decode_caption_bert
    and compute_bleu of the greedy decode's tokens."""
    from sat_tpu.engine.evaluate import compute_bleu as jax_bleu

    from sat_tpu_torch.caption_split import main as split_main
    from sat_tpu_torch.data.dataset import BatchLoader
    from sat_tpu_torch.evaluate import main as eval_main
    from sat_tpu_torch.models.encoder import encoder_forward
    from sat_tpu_torch.serve import load_model

    got = eval_main(["--model", bert_run["npz"], "--bert-vocab", vocab_file,
                     "--split", "val", "--cache-features", "--device",
                     "cpu"])
    assert 0.0 <= got["bleu1"] <= 1.0 and np.isfinite(got["loss"])

    jsonl = str(tmp_path / "caps.jsonl")
    summary = split_main(["--model", bert_run["npz"], "--bert-vocab",
                          vocab_file, "--split", "test", "--decode",
                          "greedy", "--batch-size", "2", "--out", jsonl,
                          "--device", "cpu"])
    capsys.readouterr()
    cfg, _, enc, dec, _ = load_model(bert_run["npz"], device="cpu",
                                     bert_vocab=vocab_file)
    ds = CaptionDataset(cfg.data, "test", bert=True, image_size=32)
    hyps, refs = [], []
    for imgs, _, all_caps in BatchLoader(ds, 2, shuffle=False).epoch(0):
        toks, lengths = greedy_caption(dec, encoder_forward(enc, "vgg19",
                                                            imgs))
        for i in range(len(imgs)):
            row = [constants.BERT_CLS] + toks[i, :int(lengths[i]) + 1].tolist()
            hyps.append(jax_decode_bert(row, tokenizer))
            refs.append([jax_decode_bert(c, tokenizer)
                         for c in all_caps[i].tolist()])
    with open(jsonl) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["caption"] for ln in lines] == [" ".join(h) for h in hyps]
    want = jax_bleu(refs, hyps)
    for k, v in want.items():
        assert summary[k] == round(v, 4), k
