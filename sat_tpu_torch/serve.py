#!/usr/bin/env python
"""Captioning server on the port: dynamic micro-batching over the batched
beam (or greedy) caption step.

Port of serve.py. Requests are newline-delimited JSON over TCP:

    {"id": "r1", "path": "/abs/image.jpg"}\\n
->  {"id": "r1", "caption": "a dog runs", "score": ..., "completed": true}\\n

or `{"id": "r2", "cached": 3}` for row 3 (modulo the pool size) of the
image pool decoded at startup from --preload-images. Concurrent requests
are coalesced into one batch (up to --max-batch, waiting at most
--batch-window-ms for stragglers), padded up to a power-of-two bucket with
copies of its last image, and decoded by one caption step
(sat_tpu_torch.engine.serving.build_caption_step). The step replays CUDA
graphs captured once per batch shape, so the buckets bound the captures to
log2(--max-batch) + 1; the padded rows' results are dropped.

    python -m sat_tpu_torch.serve --model model/model_vgg19_8.npz \\
        --encoder-weights vgg19.npz --port 8765 --max-batch 32

The flags are serve.py's; --device (default cuda) is added. The model's
`model_config.json` names its encoder (vgg19, resnet152, densenet161) and
whether the decoder is BERT's; the decoder may be a sat_tpu `.npz` or a
reference `.pth`. A BERT model decodes its captions with the WordPiece
vocabulary of --bert-vocab, which it needs (the port downloads
nothing). --decode sample samples at --temperature, --top-k and --top-p:
batch i draws its noise
from a generator seeded from (--seed, i), so a restarted server replays
the same captions for the same request order; without --seed a
process-unique value takes its place. The card's and the CPU's generators
give different draws from one seed. --bf16-decode runs the encoder in
bf16 and the beam on a bf16 grid (engine/serving.py). --no-pallas-topk and
--fast-topk take the beam's library top-k route (models/beam.py).
--mesh-data N (0: every card) serves each batch over N cards, one replica
of the weights a card (engine/serving.py), the buckets padded to a
multiple of N; more cards than are visible is refused at start-up (with
--device cpu the N replicas share the host).

Shutdown: SIGTERM/SIGINT, or a client line {"cmd": "shutdown"}.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import os
import queue
import socket
import threading
import time

import numpy as np
import torch

from sat_tpu_torch import constants
from sat_tpu_torch.config import Config
from sat_tpu_torch.data.bert_vocab import load_bert_vocab
from sat_tpu_torch.data.transforms import (load_and_preprocess_image,
                                           native_enabled)
from sat_tpu_torch.device import resolve_device, use_f32_math
from sat_tpu_torch.utils import spans


class CaptionServer:
    """Socket front end + micro-batching loop around one caption fn.

    Testable in-process: `start()` binds an ephemeral port (`.port`),
    `stop()` shuts the loop down. `stats` counts requests/batches/errors so
    tests can assert coalescing happened.

    With tracing on (utils/spans.py) a request is a `serve.request` span,
    from its enqueue to its reply, carrying its sequence number `seq` and
    its `batch`, with a `serve.queue` child until the batch loop takes it;
    each batch is `serve.gather`, `serve.load` (the images and the
    bucket's stack), `serve.dispatch` (the caption step), `serve.hold`
    (the one-behind wait until its finalize) and `serve.finalize`
    (read-back and replies), on the batch loop's thread.
    """

    def __init__(self, caption_fn, image_size: int, decode_tokens,
                 max_batch: int = 32, batch_window_ms: float = 5.0,
                 host: str = "127.0.0.1", port: int = 0,
                 request_ttl_s: float = 60.0, image_pool=None,
                 overlap: bool = True, bucket_quantum: int = 1):
        self._caption_fn = caption_fn     # (B,S,S,3) f32 -> dict of tensors
        self._image_size = image_size
        # Pre-decoded (N, S, S, 3) f32 rows for `{"cached": idx}` requests;
        # None = cached requests are rejected.
        self._image_pool = image_pool
        # One-behind pipelining of the batch loop (see _dispatch_batch).
        self._overlap = overlap
        self._decode_tokens = decode_tokens   # token row -> list of words
        self._max_batch = max(1, max_batch)
        # a mesh's card count: every bucket divides over the mesh
        self._bucket_quantum = max(1, bucket_quantum)
        self._window_s = batch_window_ms / 1e3
        self._ttl_s = request_ttl_s
        self._host, self._port = host, port
        self._requests: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._sock: socket.socket | None = None
        self._t_start = time.monotonic()
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "errors": 0, "expired": 0,
                      "captioned": 0, "native_rows": 0}
        # End-to-end (enqueue -> reply) latencies of recent successful
        # captions, seconds; bounded so a long-lived daemon's stats cost
        # stays O(1).
        self._latencies: "collections.deque[float]" = collections.deque(
            maxlen=1024)

    def _count(self, key: str, n: int = 1) -> int:
        with self._stats_lock:   # += on a dict int is not atomic
            self.stats[key] += n
            return self.stats[key]

    # -- lifecycle -----------------------------------------------------------

    @property
    def port(self) -> int:
        if self._sock is None:
            raise RuntimeError("server not started")
        return self._sock.getsockname()[1]

    def start(self) -> None:
        self._sock = socket.create_server((self._host, self._port))
        self._sock.settimeout(0.2)
        for target in (self._accept_loop, self._batch_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in list(self._threads):
            t.join(timeout=10)
        if self._sock is not None:
            self._sock.close()

    def serve_forever(self) -> None:
        try:
            while not self._stop.is_set():
                time.sleep(0.2)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def snapshot(self) -> dict:
        """stats plus uptime, queue depth and latency percentiles (ms)."""
        with self._stats_lock:   # consistent snapshot vs the batch loop
            snap = dict(self.stats)
            lats = sorted(self._latencies)
        snap["uptime_s"] = round(time.monotonic() - self._t_start, 1)
        snap["queue_depth"] = self._requests.qsize()   # advisory
        if lats:
            def pct(p):
                return round(
                    lats[min(len(lats) - 1, int(p * len(lats)))] * 1e3, 2)
            snap["latency_samples"] = len(lats)
            snap["latency_p50_ms"] = pct(0.50)
            snap["latency_p95_ms"] = pct(0.95)
            snap["latency_p99_ms"] = pct(0.99)
        return snap

    # -- socket side ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # daemon client threads exit on _stop within the socket timeout
            threading.Thread(target=self._client_loop, args=(conn,),
                             daemon=True).start()

    def _client_loop(self, conn: socket.socket) -> None:
        conn.settimeout(0.2)
        send_lock = threading.Lock()
        buf = b""
        with conn:
            while not self._stop.is_set():
                try:
                    chunk = conn.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if line.strip():
                        self._handle_line(line, conn, send_lock)

    def _pool_row(self, req: dict):
        """The pool row a `{"cached": idx}` request names, or an error
        string. Checked per request, so one bad index fails only its own
        request, never the batch it would have joined."""
        if self._image_pool is None:
            return None, ("no image pool (start with --preload-images to "
                          "serve cached requests)")
        idx = req["cached"]
        if isinstance(idx, bool) or not isinstance(idx, int):
            return None, f"'cached' must be an integer, got {idx!r}"
        return self._image_pool[idx % len(self._image_pool)], None

    def _handle_line(self, line: bytes, conn, send_lock) -> None:
        sent = []

        def reply(obj):
            if sent:   # exactly one reply per request line
                return
            sent.append(True)
            data = (json.dumps(obj) + "\n").encode()
            with send_lock:
                try:
                    conn.sendall(data)
                except OSError:
                    pass

        try:
            req = json.loads(line)
        except json.JSONDecodeError:
            self._count("errors")
            reply({"error": "malformed JSON"})
            return
        if not isinstance(req, dict):
            self._count("errors")
            reply({"error": "request must be a JSON object"})
            return
        if req.get("cmd") == "shutdown":
            reply({"ok": "shutting down"})
            self._stop.set()
            return
        if req.get("cmd") == "stats":
            reply(self.snapshot())
            return
        image = None
        if "cached" in req:
            image, err = self._pool_row(req)
            if err is not None:
                self._count("errors")
                reply({"id": req.get("id"), "error": err})
                return
        elif "path" not in req:
            self._count("errors")
            reply({"id": req.get("id"), "error": "missing 'path'"})
            return
        seq = self._count("requests")
        t0 = time.monotonic_ns()
        request = spans.begin("serve.request", at=t0, seq=seq)
        queued = spans.begin("serve.queue", parent=request, at=t0)

        def timed_reply(obj, _reply=reply):
            # successful captions feed the latency ring; its two clock
            # reads are the request span's start and end
            if "caption" in obj:
                t1 = time.monotonic_ns()
                with self._stats_lock:
                    self.stats["captioned"] += 1
                    self._latencies.append((t1 - t0) / 1e9)
                spans.end(request, at=t1)
            else:
                spans.end(request)
            _reply(obj)

        self._requests.put((req, image, timed_reply, t0, (request, queued)))

    # -- device side ---------------------------------------------------------

    def _take(self, deadline, batch_id=None):
        """Pop one queued request before `deadline`, expiring entries older
        than the TTL (their clients have long timed out); the request's
        spans take the id of the batch being gathered."""
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise queue.Empty
            req, image, reply, t, (request, queued) = self._requests.get(
                timeout=remaining)
            spans.end(queued)
            spans.tag(request, batch=batch_id)
            if self._ttl_s and (time.monotonic_ns() - t) / 1e9 > self._ttl_s:
                self._count("expired")
                reply({"id": req.get("id"), "error": "expired in queue"})
                continue
            return req, image, reply

    def _gather_batch(self, first_wait: float = 0.2, batch_id=None):
        """Block for the first request (up to `first_wait`), then coalesce
        stragglers for up to the batching window or until the batch is
        full."""
        try:
            first = self._take(time.monotonic() + first_wait, batch_id)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self._window_s
        while len(batch) < self._max_batch:
            try:
                batch.append(self._take(deadline, batch_id))
            except queue.Empty:
                break
        return batch

    def _bucket(self, n: int) -> int:
        """Smallest quantum * power of two >= n, capped at --max-batch
        (serve.py's bucket): it bounds the batch shapes the step captures,
        and the quantum (the mesh's card count, else 1) keeps every bucket,
        the cap included, divisible over the mesh."""
        q = self._bucket_quantum
        b = q
        while b < n:
            b *= 2
        cap = ((self._max_batch + q - 1) // q) * q
        return min(b, max(cap, ((n + q - 1) // q) * q))

    def _load_images(self, batch):
        """Every request's image; returns (imgs, live) with load failures
        already answered. Under SAT_NATIVE_PREPROC=1 with the native codecs
        built, the `path` requests' files go through one call of the native
        loader's thread pool (counted in stats["native_rows"]); the files
        it rejects, and every file otherwise, through
        load_and_preprocess_image, as CaptionDataset.load_image_batch
        does."""
        images = [image for _, image, _ in batch]
        disk = [i for i, image in enumerate(images) if image is None]
        if disk and native_enabled():
            from sat_tpu_torch.data import native
            if native.decode_support():
                loaded, status = native.load_images(
                    [batch[i][0]["path"] for i in disk], self._image_size)
                ok = [j for j, st in enumerate(status) if st == native.OK]
                for j in ok:
                    images[disk[j]] = loaded[j]
                self._count("native_rows", len(ok))
        out_imgs, live = [], []
        for (req, _, reply), image in zip(batch, images):
            if image is None:
                try:
                    image = load_and_preprocess_image(req["path"],
                                                      self._image_size)
                except Exception as e:
                    self._count("errors")
                    reply({"id": req.get("id"), "error": f"load failed: {e}"})
                    continue
            out_imgs.append(image)
            live.append((req, reply))
        return out_imgs, live

    def _dispatch_batch(self, batch, batch_id=None):
        """Load images and launch the caption step; returns a finalize
        closure that copies the results to the host and answers the
        clients (None when every request failed at load time). CUDA work is
        asynchronous, so the batch loop gathers the next batch before it
        finalizes this one."""
        with spans.span("serve.load", batch=batch_id):
            imgs, live = self._load_images(batch)
            if not live:
                return None
            n = len(live)
            bucket = self._bucket(n)
            arr = np.stack(imgs + [imgs[-1]] * (bucket - n)).astype(
                np.float32)
        try:
            with spans.span("serve.dispatch", batch=batch_id):
                out = self._caption_fn(arr)
        except Exception as e:
            self._count("errors", n)
            for req, reply in live:
                reply({"id": req.get("id"), "error": f"decode failed: {e}"})
            return None
        held = spans.begin("serve.hold", batch=batch_id)

        def finalize() -> None:
            spans.end(held)
            with spans.span("serve.finalize", batch=batch_id):
                try:
                    # only what the replies need (skips the alphas);
                    # errors of asynchronous device work surface here
                    host = {k: out[k].cpu().numpy()
                            for k in ("tokens", "length", "score", "found")}
                except Exception as e:
                    self._count("errors", n)
                    for req, reply in live:
                        reply({"id": req.get("id"),
                               "error": f"decode failed: {e}"})
                    return
                self._count("batches")
                for i, (req, reply) in enumerate(live):
                    try:
                        words = self._decode_tokens(host["tokens"][i],
                                                    int(host["length"][i]),
                                                    bool(host["found"][i]))
                        reply({"id": req.get("id"),
                               "caption": " ".join(words),
                               "score": float(host["score"][i]),
                               "completed": bool(host["found"][i])})
                    except Exception as e:  # one bad row must not kill
                        self._count("errors")           # the loop
                        reply({"id": req.get("id"),
                               "error": f"postproc: {e}"})

        return finalize

    def _batch_loop(self) -> None:
        pending = None   # finalize closure of the batch still in flight
        for batch_id in itertools.count():
            if self._stop.is_set():
                break
            # while a batch is in flight, wait only one batching window for
            # new work before flushing its replies
            with spans.span("serve.gather", batch=batch_id):
                batch = self._gather_batch(
                    self._window_s if pending is not None else 0.2, batch_id)
            nxt = None
            if batch:
                try:
                    nxt = self._dispatch_batch(batch, batch_id)
                    if not self._overlap and nxt is not None:
                        nxt()
                        nxt = None
                except Exception as e:
                    # The batch consumer must never die: answer everyone
                    # still waiting and keep serving.
                    self._count("errors", len(batch))
                    for req, _, reply in batch:
                        reply({"id": req.get("id"),
                               "error": f"server error: {e}"})
            if pending is not None:
                try:
                    pending()   # answers its own errors; guard regardless
                except Exception:
                    pass
            pending = nxt
        if pending is not None:   # drain the in-flight batch on shutdown
            try:
                pending()
            except Exception:
                pass


def load_model(model_path: str, model_config_path: str | None = None,
               encoder_weights: str | None = None, device="cuda",
               bert_vocab: str | None = None):
    """Config, decoder config, encoder and decoder modules on `device`, and
    the vocabulary, from a sat_tpu checkpoint directory (port of
    generate_caption.py::load_model): the decoder `.npz` (or a reference
    `.pth`, read strictly, then non-strictly), `model_config.json` beside
    it (or at `model_config_path`), and the vocabulary: the word dict of
    `<cfg.data>/word_dict.json`, or for a BERT model (`"bert": true`) the
    data.bert_vocab.BertVocab of `bert_vocab`, which it then needs.
    Without `encoder_weights` the encoder is randomly initialized from a
    fixed seed, which is not sat_tpu's random init: captions then mean
    nothing."""
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 encoder_from_jax)
    from sat_tpu_torch.engine.checkpoint import load_decoder_checkpoint
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
    from sat_tpu_torch.models.encoder import init_encoder_params

    dev = resolve_device(device)
    if model_config_path is None:
        candidate = os.path.join(os.path.dirname(model_path) or ".",
                                 "model_config.json")
        if os.path.exists(candidate):
            model_config_path = candidate
    if model_config_path is None:
        raise ValueError("no model_config.json beside the model; pass "
                         "--model-config")
    cfg = Config.from_model_config(model_config_path)
    if cfg.bert:
        vocab = load_bert_vocab(bert_vocab)
        vocabulary_size = constants.BERT_VOCAB_SIZE
    else:
        with open(os.path.join(cfg.data, "word_dict.json")) as f:
            vocab = json.load(f)
        vocabulary_size = len(vocab)
    dcfg = DecoderConfig(vocab_size=vocabulary_size,
                         encoder_dim=cfg.encoder_dim, use_ado=cfg.ado,
                         use_bert=cfg.bert, use_attention=cfg.attention)
    gen = torch.Generator().manual_seed(0)
    if encoder_weights:
        with np.load(encoder_weights) as data:
            enc_flat = {k: data[k] for k in data.files}
    else:
        print("WARNING: no --encoder-weights given; encoder uses random "
              "init — captions will be meaningless")
        enc_flat = init_encoder_params(cfg.network, gen)
    dec_flat = load_decoder_checkpoint(model_path,
                                       init_decoder_params(dcfg, gen),
                                       strict=False)
    encoder = encoder_from_jax(enc_flat, cfg.network, dev)
    decoder = decoder_from_jax(dec_flat, dcfg, dev)
    return cfg, dcfg, encoder, decoder, vocab


def load_image_pool(preload: str, image_size: int, count: int) -> np.ndarray:
    """Decode up to `count` images of a file or directory once, for
    `{"cached": idx}` requests."""
    if os.path.isdir(preload):
        paths = sorted(os.path.join(preload, p) for p in os.listdir(preload))
        paths = [p for p in paths if os.path.isfile(p)]
    else:
        paths = [preload]
    rows = []
    for p in paths:
        if len(rows) >= count:
            break
        try:
            rows.append(load_and_preprocess_image(p, image_size))
        except (OSError, ValueError):
            continue   # non-image files in the dir are fine to skip
    if not rows:
        raise SystemExit(f"--preload-images {preload}: no decodable images "
                         f"found")
    return np.stack(rows).astype(np.float32)


def host_mesh(device, mesh_data: int):
    """The devices a `--device cpu` mesh may use: as many replicas on the
    host as asked for (None on the card: the visible cards)."""
    if resolve_device(device).type == "cpu":
        return ["cpu"] * max(mesh_data, 1)
    return None


def build_server(args) -> CaptionServer:
    from sat_tpu_torch.engine.evaluate import caption_decoder
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.models.beam import batch_generator

    use_f32_math()
    mesh_data = getattr(args, "mesh_data", 1)
    mesh = None
    if mesh_data != 1:
        # refuse more cards than are visible before loading anything
        from sat_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(mesh_data, devices=host_mesh(args.device,
                                                      mesh_data))
    cfg, dcfg, encoder, decoder, vocab = load_model(
        args.model, args.model_config, encoder_weights=args.encoder_weights,
        device=args.device, bert_vocab=args.bert_vocab)
    decode_mode = args.decode
    step = build_caption_step(cfg.network, dcfg, args.beam_size,
                              fast_topk=args.fast_topk, bf16=args.bf16_decode,
                              decode=decode_mode, device=args.device,
                              temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p,
                              pallas_topk=getattr(args, "pallas_topk", None),
                              mesh_data=len(mesh) if mesh else 1,
                              devices=mesh)
    words = caption_decoder(vocab)

    if decode_mode == "sample":
        seed = args.seed
        if seed is None:
            seed = (os.getpid() ^ time.time_ns()) & 0x7FFFFFFF
        batches = itertools.count()
        batches_lock = threading.Lock()

        def caption_fn(arr):
            with batches_lock:
                i = next(batches)
            return step(encoder, decoder, arr,
                        batch_generator(seed, i, args.device))
    else:
        def caption_fn(arr):
            return step(encoder, decoder, arr)

    def decode_tokens(tokens, length, found):
        # Beam keeps the reference fallback: no completed sentence -> [0].
        # Greedy rows carry their (possibly truncated) tokens either way.
        if decode_mode == "beam" and not found:
            row = [0]
        else:
            row = tokens[:length + 1].tolist()
        return words(row)

    image_pool = None
    if args.preload_images:
        image_pool = load_image_pool(args.preload_images, cfg.image_size,
                                     max(1, args.preload_count))
        print(f"preloaded {len(image_pool)} images into the cached-request "
              f"pool")

    return CaptionServer(caption_fn, cfg.image_size, decode_tokens,
                         max_batch=args.max_batch,
                         batch_window_ms=args.batch_window_ms,
                         host=args.host, port=args.port,
                         request_ttl_s=args.request_ttl_s,
                         image_pool=image_pool, overlap=args.overlap,
                         bucket_quantum=len(mesh) if mesh else 1)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Captioning server (PyTorch/CUDA port)")
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--model-config", type=str, default=None)
    parser.add_argument("--encoder-weights", type=str, default=None)
    parser.add_argument("--beam-size", type=int, default=5)
    parser.add_argument("--decode", choices=["beam", "greedy", "sample"],
                        default="beam",
                        help="decoding strategy (greedy = argmax; sample = "
                             "temperature/top-k/top-p, fresh draws per "
                             "batch)")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--top-k", type=int, default=0)
    parser.add_argument("--top-p", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=None,
                        help="base seed of --decode sample: batch i draws "
                             "from (seed, i), so a restarted server replays "
                             "the same captions for the same request order; "
                             "default: a process-unique value")
    parser.add_argument("--fast-topk", action="store_true", default=False)
    parser.add_argument("--pallas-topk", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="the beam's top-k: the kernel (default unless "
                             "--fast-topk); --no-pallas-topk forces the "
                             "library route (a stable sort: lax.top_k's "
                             "order)")
    parser.add_argument("--bf16-decode", action="store_true", default=False)
    parser.add_argument("--bert-vocab", type=str, default=None,
                        help="local bert-base-uncased vocab.txt (a BERT "
                             "model needs it)")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--max-batch", type=int, default=32)
    parser.add_argument("--batch-window-ms", type=float, default=5.0)
    parser.add_argument("--mesh-data", type=int, default=1,
                        help="data-parallel serving over N cards, one "
                             "replica each (0 = every visible card)")
    parser.add_argument("--request-ttl-s", type=float, default=60.0,
                        help="drop queued requests older than this; 0 "
                             "disables")
    parser.add_argument("--preload-images", type=str, default=None,
                        help="image file or directory to pre-decode into "
                             "the cached-request pool at startup")
    parser.add_argument("--preload-count", type=int, default=32,
                        help="max images decoded into the pool")
    parser.add_argument("--no-overlap", action="store_false", dest="overlap",
                        default=True,
                        help="disable one-behind batch pipelining")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    server = build_server(args)
    server.start()
    print(f"captioning server listening on {args.host}:{server.port} "
          f"(max_batch={args.max_batch}, window={args.batch_window_ms}ms, "
          f"device={args.device})")

    import signal

    def _term(signum, frame):
        server._stop.set()

    signal.signal(signal.SIGTERM, _term)
    server.serve_forever()
    print(f"server stopped; stats: {server.stats}")


if __name__ == "__main__":
    main()
