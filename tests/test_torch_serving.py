"""The port's caption step and captioning server against sat_tpu.

A checkpoint directory is written the way sat_tpu writes one (decoder
`.npz` by tree_save_npz, model_config.json + sat_config.json, word_dict.json,
encoder `.npz` by save_encoder_npz), and the port loads it. On 32 px images
(a 2 x 2 grid) the port's build_caption_step must give sat_tpu's result
dict: tokens, length and found exactly, score and alphas within atol 1e-5
(f32, other summation orders).
"""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from sat_tpu.compat.torch_encoder import save_encoder_npz
from sat_tpu.config import Config as JaxConfig
from sat_tpu.engine.checkpoint import tree_save_npz
from sat_tpu.engine.serving import build_caption_step
from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from sat_tpu.models.decoder import init_decoder_params
from sat_tpu.models.encoder import init_encoder_params

from sat_tpu_torch.engine.evaluate import decode_caption
from sat_tpu_torch.engine.serving import build_caption_step as port_step
from sat_tpu_torch.serve import CaptionServer, build_parser, build_server
from sat_tpu_torch.serve import load_model
from tests.test_torch_common import to_np  # noqa: F401  (sets threads)

VOCAB, SIZE = 40, 32


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    words = ["<start>", "<eos>", "<unk>", "<pad>"] + [
        f"w{i}" for i in range(4, VOCAB)]
    word_dict = {w: i for i, w in enumerate(words)}
    (root / "word_dict.json").write_text(json.dumps(word_dict))
    JaxConfig(data=str(root), network="vgg19", ado=True, attention=True,
              image_size=SIZE).save_model_config(
        str(root / "model_config.json"))
    jcfg = JaxDecoderConfig(vocab_size=VOCAB, encoder_dim=512, use_ado=True,
                            use_attention=True)
    enc_rng, dec_rng = jax.random.split(jax.random.PRNGKey(5))
    dec_params = init_decoder_params(dec_rng, jcfg)
    enc_params = init_encoder_params(enc_rng, "vgg19")
    tree_save_npz(str(root / "model_vgg19_1.npz"), dec_params)
    save_encoder_npz(str(root / "vgg19.npz"), enc_params)
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (48, 48, 3), np.uint8)).save(
            img_dir / f"img{i}.png")
    return {"root": root, "jcfg": jcfg, "dec": dec_params,
            "enc": enc_params, "word_dict": word_dict,
            "model": str(root / "model_vgg19_1.npz"),
            "encoder": str(root / "vgg19.npz"), "images": str(img_dir)}


def _images(n, seed=3):
    return np.random.default_rng(seed).normal(
        size=(n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("decode", ["beam", "greedy"])
def test_caption_step_matches_sat_tpu(ckpt, decode):
    images = _images(3)
    ref = build_caption_step("vgg19", ckpt["jcfg"], 3, decode=decode)(
        ckpt["enc"], ckpt["dec"], jnp.asarray(images))
    cfg, dcfg, enc, dec, word_dict = load_model(
        ckpt["model"], encoder_weights=ckpt["encoder"], device="cpu")
    assert cfg.image_size == SIZE and word_dict == ckpt["word_dict"]
    got = port_step("vgg19", dcfg, 3, decode=decode, device="cpu")(
        enc, dec, images)
    assert sorted(got) == sorted(ref)
    for k in ("tokens", "length", "found"):
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ("score", "alphas"):
        np.testing.assert_allclose(to_np(got[k]), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)


def _ask(port, line: bytes):
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(line + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf)


def test_server_round_trip(ckpt):
    """Four concurrent cached requests and one bad one: the bad index fails
    alone and the four get the captions of build_caption_step."""
    args = build_parser().parse_args([
        "--model", ckpt["model"], "--encoder-weights", ckpt["encoder"],
        "--device", "cpu", "--port", "0", "--beam-size", "3",
        "--max-batch", "8", "--batch-window-ms", "200",
        "--preload-images", ckpt["images"], "--preload-count", "4"])
    server = build_server(args)
    server.start()
    try:
        lines = [json.dumps({"id": i, "cached": i}).encode()
                 for i in range(4)] + [b'{"id": "bad", "cached": "x"}']
        replies = [None] * len(lines)

        def ask(i):
            replies[i] = _ask(server.port, lines[i])

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(lines))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.stop()

    assert "error" in replies[4] and replies[4]["id"] == "bad"
    _, dcfg, enc, dec, word_dict = load_model(
        ckpt["model"], encoder_weights=ckpt["encoder"], device="cpu")
    res = port_step("vgg19", dcfg, 3, device="cpu")(enc, dec,
                                                    server._image_pool)
    for i in range(4):
        assert replies[i]["id"] == i and "caption" in replies[i], replies[i]
        row = (res["tokens"][i, :int(res["length"][i]) + 1].tolist()
               if bool(res["found"][i]) else [0])
        assert replies[i]["caption"] == " ".join(
            decode_caption(row, word_dict))
        assert replies[i]["completed"] == bool(res["found"][i])
    assert server.stats["captioned"] == 4
    assert server.stats["errors"] == 1
    assert server.stats["batches"] < 4          # coalesced


class _Conn:
    def __init__(self):
        self.sent = []

    def sendall(self, data):
        self.sent.append(json.loads(data))


@pytest.mark.parametrize("pool", [None, np.zeros((2, SIZE, SIZE, 3))])
@pytest.mark.parametrize("cached", ['"1"', "true", "1.5"])
def test_bad_cached_request_is_answered_alone(pool, cached):
    """A bad `cached` value, or one sent to a server without a pool, gets an
    error reply at once and never joins a batch."""
    server = CaptionServer(lambda arr: None, SIZE, lambda *a: [],
                           image_pool=pool)
    conn = _Conn()
    server._handle_line(b'{"id": 7, "cached": %s}' % cached.encode(), conn,
                        threading.Lock())
    assert conn.sent[0]["id"] == 7 and "error" in conn.sent[0]
    assert server.stats["errors"] == 1 and server._requests.empty()


@pytest.mark.parametrize("flag", [["--mesh-data", "0"], ["--fast-topk"],
                                  ["--mesh-data", "2"], ["--no-pallas-topk"]])
def test_unported_server_flags_raise(ckpt, flag):
    """The flags that once raised are ported: --fast-topk and
    --no-pallas-topk take the beam's library top-k route, --mesh-data 2
    serves over two replicas (on the host with --device cpu), its buckets
    multiples of 2, and --mesh-data 0 over every device (the host: one).
    Each server's caption step answers three images as the default
    server's does."""
    base = ["--model", ckpt["model"], "--encoder-weights", ckpt["encoder"],
            "--device", "cpu", "--beam-size", "3"]
    plain, flagged = (build_server(build_parser().parse_args(base + extra))
                      for extra in ([], flag))
    images = _images(3)
    want, got = plain._caption_fn(images), flagged._caption_fn(images)
    for k in ("tokens", "length", "found"):
        np.testing.assert_array_equal(to_np(got[k]), to_np(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(to_np(got["score"]), to_np(want["score"]),
                               atol=1e-5)
    quantum = 2 if flag == ["--mesh-data", "2"] else 1
    assert [flagged._bucket(n) for n in (1, 3, 5)] == [
        max(quantum, 1), 4, 8]


@pytest.mark.parametrize("flag", [["--bert-vocab", "vocab.txt"]])
def test_sampling_and_bert_flags_are_rejected(ckpt, tmp_path, flag):
    """--bert-vocab parses, and the server of a BERT model (model_config's
    "bert": true) reads the vocabulary it names, here a file that is not
    there (tests/test_torch_bert.py serves a BERT model; the sampling
    flags: test_sampling_flags_are_accepted)."""
    args = build_parser().parse_args(
        ["--model", ckpt["model"], "--device", "cpu"] + flag)
    assert args.bert_vocab == flag[1]
    config = json.loads((ckpt["root"] / "model_config.json").read_text())
    (tmp_path / "model_config.json").write_text(
        json.dumps(dict(config, bert=True)))
    args.model_config = str(tmp_path / "model_config.json")
    with pytest.raises(FileNotFoundError, match=flag[1]):
        build_server(args)


@pytest.mark.parametrize("flag", [["--temperature", "0.7"], ["--top-k", "5"],
                                  ["--top-p", "0.9"], ["--seed", "1"]])
def test_sampling_flags_are_accepted(ckpt, monkeypatch, flag):
    """Each sampling flag parses and reaches the sampler of a
    `--decode sample` server, the others at their defaults."""
    import sat_tpu_torch.engine.serving as serving
    seen = []
    plain = serving.sample_caption

    def spy(dec, feats, generator, temperature, top_k, top_p, **kw):
        seen.append((temperature, top_k, top_p, generator))
        return plain(dec, feats, generator, temperature, top_k, top_p, **kw)

    monkeypatch.setattr(serving, "sample_caption", spy)
    args = build_parser().parse_args(
        ["--model", ckpt["model"], "--encoder-weights", ckpt["encoder"],
         "--device", "cpu", "--decode", "sample"] + flag)
    server = build_server(args)
    out = server._caption_fn(_images(2))
    assert out["tokens"].shape == (2, 52)
    want = {"--temperature": (0.7, 0, 1.0), "--top-k": (1.0, 5, 1.0),
            "--top-p": (1.0, 0, 0.9), "--seed": (1.0, 0, 1.0)}[flag[0]]
    assert seen[0][:3] == want
    assert isinstance(seen[0][3], torch.Generator)


def test_seeded_sample_server_replays_its_batches(ckpt):
    """Batch i of a server started with --seed s draws from (s, i): two
    servers answer the same batches alike, and a server's second batch
    draws anew."""
    def caption_fn():
        args = build_parser().parse_args(
            ["--model", ckpt["model"], "--encoder-weights", ckpt["encoder"],
             "--device", "cpu", "--decode", "sample", "--temperature",
             "3.0", "--seed", "3"])
        return build_server(args)._caption_fn

    images = _images(4)
    runs = [[fn(images)["tokens"] for _ in range(2)]
            for fn in (caption_fn(), caption_fn())]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][0], runs[0][1])


# --------------------------------- each batch answered after its own step

def _stub_step(arr, score=None):
    """A caption step on the CPU: token i + 1 for row i; `score` in place
    of the zero scores."""
    n = len(arr)
    tokens = torch.zeros((n, 4), dtype=torch.long)
    tokens[:, 1] = torch.arange(n) + 1
    return {"tokens": tokens, "length": torch.ones(n, dtype=torch.long),
            "score": torch.zeros(n) if score is None else score,
            "found": torch.ones(n, dtype=torch.bool)}


def _token_words(tokens, length, found):
    return [str(int(t)) for t in tokens[:length + 1]]


class _Replies:
    """A connection for `_handle_line` that keeps each reply by its id."""

    def __init__(self):
        self.got = {}
        self.cond = threading.Condition()

    def sendall(self, data):
        reply = json.loads(data)
        with self.cond:
            self.got[reply["id"]] = reply
            self.cond.notify_all()

    def wait(self, ids, timeout=30.0):
        with self.cond:
            assert self.cond.wait_for(
                lambda: set(ids) <= set(self.got), timeout), self.got
        return [self.got[i] for i in ids]


def _server(step, words=_token_words, server_class=CaptionServer, **kw):
    """A server of pool rows, at most 2 requests a batch; the window is
    wide, so that requests sent together fill each batch."""
    kw = {"max_batch": 2, "batch_window_ms": 200} | kw
    return server_class(step, SIZE, words,
                        image_pool=np.zeros((8, SIZE, SIZE, 3), np.float32),
                        **kw)


def _send(server, conn, ids):
    lock = threading.Lock()
    for i in ids:
        server._handle_line(json.dumps({"id": i, "cached": i}).encode(),
                            conn, lock)


def test_a_batch_is_answered_before_the_next_step_returns():
    """The first batch's replies all arrive while the second batch's
    caption step is still blocked; the counters see both batches answered
    before the next step returned."""
    entered, release = threading.Event(), threading.Event()
    calls = []

    def step(arr):
        calls.append(len(arr))
        if len(calls) == 2:
            entered.set()
            release.wait(60)
        return _stub_step(arr)

    server = _server(step)
    conn = _Replies()
    server.start()
    try:
        t0 = time.monotonic()
        _send(server, conn, range(4))
        assert entered.wait(30)
        first = conn.wait([0, 1])
        waited_us = (time.monotonic() - t0) * 1e6
        assert not release.is_set() and len(calls) == 2
        assert [r["caption"] for r in first] == ["0 1", "0 2"]
        stats = server.snapshot()
        assert stats["batches"] == stats["replied_before_next"] == 1
        assert 0 <= stats["hold_us"] <= waited_us
        release.set()
        second = conn.wait([2, 3])
    finally:
        release.set()
        server.stop()
    assert [r["caption"] for r in second] == ["0 1", "0 2"]
    assert server.stats["batches"] == server.stats[
        "replied_before_next"] == 2


def test_stop_answers_every_request_taken_into_a_batch():
    """stop() while the batch loop is answering a batch: every request of
    that batch is answered before stop() returns."""
    replying, gate = threading.Event(), threading.Event()

    def words(tokens, length, found):
        replying.set()
        gate.wait(60)
        return _token_words(tokens, length, found)

    server = _server(_stub_step, words)
    conn = _Replies()
    server.start()
    stopper = threading.Thread(target=server.stop)
    try:
        _send(server, conn, range(2))
        assert replying.wait(30)
        stopper.start()
        time.sleep(0.1)
        assert stopper.is_alive() and not conn.got
    finally:
        gate.set()
    stopper.join(timeout=30)
    assert not stopper.is_alive()
    assert sorted(conn.got) == [0, 1]
    assert all("caption" in r for r in conn.got.values()), conn.got
    assert server.stats["batches"] == 1


def test_a_failed_read_back_answers_its_own_batch():
    """The first batch's scores cannot be read back (a tensor that needs
    its gradient has no numpy view): its requests are answered `decode
    failed`, and the next batch is served."""
    calls = []

    def step(arr):
        calls.append(len(arr))
        return _stub_step(arr, torch.zeros(len(arr), requires_grad=True)
                          if len(calls) == 1 else None)

    server = _server(step)
    conn = _Replies()
    server.start()
    try:
        _send(server, conn, range(4))
        got = conn.wait(range(4))
    finally:
        server.stop()
    assert all(r["error"].startswith("decode failed:") for r in got[:2])
    assert [r["caption"] for r in got[2:]] == ["0 1", "0 2"]
    assert server.stats["errors"] == 2 and server.stats["batches"] == 1


def test_each_batch_is_answered_before_the_next_gather():
    """The batch loop answers a batch before it starts gathering the next:
    gather, step and the batch's replies, in turn."""
    log = []

    class Logged(CaptionServer):
        def _gather_batch(self, batch_id=None):
            log.append("gather")
            batch = super()._gather_batch(batch_id)
            if not batch:
                log.pop()
            return batch

    def step(arr):
        log.append("step")
        return _stub_step(arr)

    def words(tokens, length, found):
        log.append("reply")
        return _token_words(tokens, length, found)

    server = _server(step, words, Logged)
    conn = _Replies()
    server.start()
    try:
        t0 = time.monotonic()
        _send(server, conn, range(6))
        conn.wait(range(6))
        waited_us = (time.monotonic() - t0) * 1e6
    finally:
        server.stop()
    assert log == ["gather", "step", "reply", "reply"] * 3
    stats = server.snapshot()
    assert stats["batches"] == stats["replied_before_next"] == 3
    assert 0 <= stats["hold_us"] <= 3 * waited_us


def test_a_batch_answered_after_the_next_step_is_counted_late():
    """A batch whose finalize is called only after another batch's caption
    step has returned counts as late, and its hold holds the delay; the
    other batch, answered at once, counts as replied before the next."""
    server = _server(_stub_step)
    replies = {}

    def batch(ids):
        return [({"id": i, "cached": i}, server._image_pool[i],
                 lambda obj: replies.__setitem__(obj["id"], obj))
                for i in ids]

    first = server._dispatch_batch(batch([0, 1]))
    time.sleep(0.05)
    second = server._dispatch_batch(batch([2, 3]))
    first()
    second()
    assert [replies[i]["caption"] for i in range(4)] == ["0 1", "0 2"] * 2
    stats = server.snapshot()
    assert stats["batches"] == 2 and stats["replied_before_next"] == 1
    assert stats["hold_us"] >= 50_000


@pytest.mark.parametrize("counters,lag_ms", [
    ({"requests": 64, "batches": 4}, None),              # the parent's
    ({}, None),
    ({"requests": 0, "batches": 0, "hold_us": 0}, None),
    ({"requests": 64, "batches": 4, "hold_us": 10_000}, 2.5)])
def test_serve_reply_lag_reader(counters, lag_ms):
    """satbench's `serve_reply_lag_ms`: hold_us over batches in ms, and
    None where the server has no such counter or answered no batch."""
    from satbench import spec

    read = spec.reader("serve_reply_lag_ms")
    assert read({"counters": counters}) == lag_ms
    assert read({}) is None
