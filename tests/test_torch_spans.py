"""The port's span recorder (sat_tpu_torch/utils/spans.py) and the spans
that the server, the caption step, the graph captures and the train block
record: off, nothing is read or recorded; on, the spans nest, cross
threads, are bounded, give each answered request its stages in order, sum
to the captures' seconds, record no event inside a capture, leave the
beam's bits alone, and land on the profiler's clock by the anchor.

The tests marked `cuda` need a card; on it:

    python -m pytest tests/test_torch_spans.py -q -m cuda --noconftest
"""

import json
import os
import socket
import threading
import time
import types

import numpy as np
import pytest
import torch

from sat_tpu_torch.utils import spans

SIZE = 8


@pytest.fixture
def recorder():
    """Tracing on for the test, off after it."""
    spans.enable()
    yield
    spans.disable()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def counting_clock(monkeypatch) -> list:
    """spans' clock replaced by one that counts its reads."""
    reads = []

    def monotonic_ns():
        reads.append(1)
        return time.monotonic_ns()

    monkeypatch.setattr(spans, "time", types.SimpleNamespace(
        monotonic_ns=monotonic_ns))
    return reads


def test_off_reads_no_clock_and_records_nothing(monkeypatch):
    reads = counting_clock(monkeypatch)
    monkeypatch.setattr(torch.cuda, "Event", None)    # any event would fail
    spans.disable()
    first = spans.span("a", device="cuda", batch=1)
    assert first is spans.span("b")                   # one shared null
    with first as got:
        assert got is None
        handle = spans.begin("c", at=5, seq=2)
        assert handle is None
        spans.tag(handle, batch=3)
        assert spans.end(handle) is None
    spans.anchor()
    assert reads == []
    assert spans.collect() == {"clock": spans.CLOCK, "spans": [],
                               "dropped": 0}
    spans.enable()
    try:
        with spans.span("d"):
            pass
        assert len(reads) == 2 and len(spans.collect()["spans"]) == 1
    finally:
        spans.disable()


def test_nesting_gives_parent_ids(recorder):
    with spans.span("outer", batch=7) as outer:
        with spans.span("inner") as inner:
            child = spans.begin("child")
            spans.end(child)
        with spans.span("second"):
            pass
    spans.end(spans.begin("root"))
    got = {s["name"]: s for s in spans.collect()["spans"]}
    assert got["outer"]["parent"] is None and got["root"]["parent"] is None
    assert got["inner"]["parent"] == outer.id == got["second"]["parent"]
    assert got["child"]["parent"] == inner.id
    assert got["outer"]["attrs"] == {"batch": 7}
    assert (got["outer"]["start"] <= got["inner"]["start"]
            <= got["child"]["start"] <= got["child"]["end"]
            <= got["inner"]["end"] <= got["second"]["start"]
            <= got["second"]["end"] <= got["outer"]["end"])
    assert len({s["id"] for s in got.values()}) == 5
    assert {s["thread"] for s in got.values()} == {threading.get_native_id()}


def test_begin_and_end_on_two_threads(recorder):
    """A span begun on one thread and ended on another, with a child that
    names it as parent across the threads; an end given twice keeps the
    first."""
    request = spans.begin("request", at=time.monotonic_ns(), seq=1)
    ended = []

    def other():
        child = spans.begin("queue", parent=request)
        spans.end(child)
        spans.tag(request, batch=4)
        ended.append(spans.end(request))

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert spans.end(request) == ended[0]
    got = {s["name"]: s for s in spans.collect()["spans"]}
    assert len(spans.collect()["spans"]) == 2
    assert got["request"]["thread"] == threading.get_native_id()
    assert got["queue"]["thread"] != got["request"]["thread"]
    assert got["queue"]["parent"] == got["request"]["id"]
    assert got["request"]["attrs"] == {"seq": 1, "batch": 4}
    assert got["request"]["end"] == ended[0] >= got["queue"]["end"]


def test_dropped_counts_past_the_bound(monkeypatch):
    monkeypatch.setattr(spans, "BOUND", 3)
    spans.enable()
    try:
        for i in range(5):
            with spans.span("s", i=i):
                pass

        def other():
            for i in range(4):
                spans.end(spans.begin("t", i=i))

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        got = spans.collect()
    finally:
        spans.disable()
    assert [s["attrs"]["i"] for s in got["spans"] if s["name"] == "s"] == [
        0, 1, 2]
    assert len([s for s in got["spans"] if s["name"] == "t"]) == 3
    assert got["dropped"] == 2 + 1


# ------------------------------------------------------------ the server

def stub_caption(arr):
    """A caption step on the CPU: token i + 1 for row i, after 2 ms."""
    time.sleep(0.002)
    n = len(arr)
    tokens = torch.zeros((n, 4), dtype=torch.long)
    tokens[:, 1] = torch.arange(n) + 1
    return {"tokens": tokens, "length": torch.ones(n, dtype=torch.long),
            "score": torch.zeros(n), "found": torch.ones(n, dtype=torch.bool)}


def serve_requests(server, rows) -> dict:
    """Send every `{"cached": row}` request at once on one connection and
    read a reply for each."""
    replies = {}
    with socket.create_connection(("127.0.0.1", server.port),
                                  timeout=60) as conn:
        conn.sendall(b"".join(
            (json.dumps({"id": i, "cached": r}) + "\n").encode()
            for i, r in enumerate(rows)))
        buf = b""
        while len(replies) < len(rows):
            chunk = conn.recv(65536)
            assert chunk, "the server closed the connection"
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                reply = json.loads(line)
                replies[reply["id"]] = reply
    return replies


def test_every_answered_request_has_its_stages_in_order(recorder):
    from sat_tpu_torch.serve import CaptionServer

    pool = np.random.default_rng(0).random((6, SIZE, SIZE, 3),
                                           dtype=np.float32)
    server = CaptionServer(stub_caption, SIZE,
                           lambda t, n, f: [str(int(x)) for x in t[:n + 1]],
                           max_batch=4, batch_window_ms=20,
                           image_pool=pool)
    server.start()
    try:
        replies = serve_requests(server, [0, 1, 2, 3, 4, 5, 0, 1, 2, 3])
        replies.update(serve_requests(server, [5]))
    finally:
        server.stop()
    assert all("caption" in r for r in replies.values())
    got = spans.collect()["spans"]
    assert spans.collect()["dropped"] == 0
    requests = [s for s in got if s["name"] == "serve.request"]
    assert len(requests) == 11 == server.stats["captioned"]
    assert sorted(r["attrs"]["seq"] for r in requests) == list(range(1, 12))
    queues = {s["parent"]: s for s in got if s["name"] == "serve.queue"}
    stages = ("serve.gather", "serve.load", "serve.dispatch", "serve.hold",
              "serve.finalize")
    by_batch = {}
    for s in got:
        if s["name"] in stages:
            by_batch.setdefault(s["attrs"]["batch"], {}).setdefault(
                s["name"], []).append(s)
    loop_thread = {s["thread"] for s in got if s["name"] in stages}
    assert len(loop_thread) == 1
    for r in requests:
        assert r["parent"] is None
        q = queues[r["id"]]                       # its one queue child
        assert r["start"] == q["start"] <= q["end"] <= r["end"]
        batch = by_batch[r["attrs"]["batch"]]
        assert {k: len(v) for k, v in batch.items()} == dict.fromkeys(
            stages, 1)
        order = [batch[k][0] for k in stages]
        for a, b in zip(order, order[1:]):
            assert a["start"] <= a["end"] <= b["start"] <= b["end"]
        # taken while its batch gathered; answered inside its finalize
        assert batch["serve.gather"][0]["start"] <= q["end"] \
            <= batch["serve.gather"][0]["end"]
        fin = batch["serve.finalize"][0]
        assert fin["start"] <= r["end"] <= fin["end"]
    assert len({r["attrs"]["batch"] for r in requests}) >= 3


def test_server_off_reads_no_span_clock(monkeypatch):
    from sat_tpu_torch.serve import CaptionServer

    reads = counting_clock(monkeypatch)
    spans.disable()
    pool = np.zeros((2, SIZE, SIZE, 3), np.float32)
    server = CaptionServer(stub_caption, SIZE, lambda t, n, f: ["x"],
                           max_batch=2, batch_window_ms=1, image_pool=pool)
    server.start()
    try:
        replies = serve_requests(server, [0, 1, 1])
    finally:
        server.stop()
    assert len(replies) == 3 and reads == []
    assert server.snapshot()["latency_samples"] == 3


# ------------------------------------------------- the profiler's clock

def test_anchor_maps_a_worker_span_onto_its_op(recorder):
    """A span recorded on a worker thread around a CPU matrix product,
    mapped by the anchors onto the profiler's clock, holds the product's
    host event within 50 us at both ends. The profiler here records every
    thread (`profile_all_threads`), so that it sees the worker's op."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):   # a process's first
        torch.ones(4).sum()                            # profile runs late
    x = torch.randn((256, 256), generator=torch.Generator().manual_seed(0))

    def work():
        with spans.span("work"):
            torch.mm(x, x)

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        spans.anchor()
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
        spans.anchor()
    events = prof.events()
    marks = sorted(e.time_range.start for e in events
                   if e.name == spans.ANCHOR)
    got = spans.collect()["spans"]
    anchors = [s["start"] for s in got if s["name"] == spans.ANCHOR]
    assert len(marks) == len(anchors) == 2
    (mapped,) = spans.to_profiler_clock(
        [s for s in got if s["name"] == "work"], list(zip(anchors, marks)))
    (op,) = [e for e in events if e.name == "aten::mm"]
    assert mapped["ts"] <= op.time_range.start + 50
    assert mapped["ts"] + mapped["dur"] >= op.time_range.end - 50
    assert mapped["ts"] >= op.time_range.start - 5000


def test_profile_dir_trace_holds_the_train_blocks(tmp_path):
    """`python -m sat_tpu_torch.train --profile-dir` with blocks on the
    CPU: the Chrome trace holds one `train.block` "X" event a block, on a
    track of its own, between the run's two anchors, and the recorder is
    off again after it."""
    import contextlib
    import io

    from sat_tpu_torch.data.vocab import generate_json_data
    from sat_tpu_torch.train import main
    from tests._synth import build_synth_dataset

    root = str(tmp_path / "data")
    build_synth_dataset(root, n_train=4, n_val=2, n_test=2, caps_per_img=2,
                        image_size=32)
    generate_json_data(f"{root}/dataset.json", root, 2, 1, 10)
    prof = tmp_path / "prof"
    args = ["--data", root, "--image-size", "32", "--batch-size",
            "4", "--epochs", "1", "--tf", "--ado", "--attention",
            "--cache-features", "--steps-per-dispatch", "2",
            "--checkpoint-dir", str(tmp_path / "model"),
            "--profile-dir", str(prof), "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        main(args)
    assert spans._recorder is None
    (name,) = os.listdir(prof)
    with open(prof / name) as f:
        events = json.load(f)["traceEvents"]
    blocks = [e for e in events if e.get("name") == "train.block"]
    assert blocks and all(e["ph"] == "X" and e["cat"] == "sat_span"
                          and e["tid"] >= spans.TID_BASE for e in blocks)
    anchors = sorted(e["ts"] for e in events
                     if e.get("name") == spans.ANCHOR)
    assert len(anchors) == 2
    assert all(anchors[0] <= e["ts"] <= e["ts"] + e["dur"] <= anchors[1]
               for e in blocks)
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("name") == "thread_name"}
    assert names[blocks[0]["tid"]].startswith("spans of thread")


# ------------------------------------------------------------- the card

@pytest.mark.cuda
def test_capture_spans_sum_to_capture_seconds(cuda, recorder):
    from sat_tpu_torch.models.beam import beam_search_batched
    from sat_tpu_torch.utils.graphs import GraphCache
    from tests.test_torch_cuda import _small_decoder

    dec = _small_decoder(cuda)
    feats = torch.rand((7, 49, 64), generator=torch.Generator()
                       .manual_seed(7)).to(cuda)
    cache = GraphCache()
    for _ in range(2):
        beam_search_batched(dec, feats, 5, graphs=cache)
    got = [s for s in spans.collect()["spans"]
           if s["name"] == "graphs.capture"]
    assert len(got) == cache.captures >= 3
    assert sum((s["end"] - s["start"]) / 1e9 for s in got) == pytest.approx(
        cache.capture_seconds, rel=1e-12)


@pytest.mark.cuda
def test_no_event_inside_a_capture(cuda, monkeypatch):
    """A span with device time opened while a stream captures records no
    event there; outside the capture it records two."""
    spans.enable(device_times=True)
    try:
        x = torch.ones(16, device=cuda)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            x.add_(1)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            with spans.span("inside", device=cuda) as inside:
                x.add_(1)
                assert inside.events is None
        with spans.span("outside", device=cuda) as outside:
            graph.replay()
        assert outside.events is not None and None not in outside.events
        got = {s["name"]: s for s in spans.collect()["spans"]}
    finally:
        spans.disable()
    assert "device_ms" not in got["inside"]
    assert got["outside"]["device_ms"] >= 0.0
    assert float(x[0]) == 3.0


@pytest.mark.cuda
def test_caption_step_with_tracing_keeps_its_bits(cuda):
    """The caption step's graphs replayed with tracing on (device times
    too) give the tokens, scores and alphas of tracing off, bit for bit,
    and its encoder and decode spans hold device times."""
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.models.decoder import Decoder, DecoderConfig
    from sat_tpu_torch.models.encoder import build_encoder

    torch.manual_seed(0)
    dcfg = DecoderConfig(vocab_size=300, encoder_dim=512, use_ado=True,
                         use_attention=True)
    with torch.device(cuda):
        enc = build_encoder("vgg19").eval()
        dec = Decoder(dcfg)
    images = np.random.default_rng(1).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)
    step = build_caption_step("vgg19", dcfg, 5, device=cuda)
    off = [step(enc, dec, images) for _ in range(2)]
    spans.enable(device_times=True)
    try:
        on = step(enc, dec, images)
        got = spans.collect()["spans"]
    finally:
        spans.disable()
    for key in ("tokens", "length", "score", "found", "alphas"):
        a, b = off[1][key], on[key]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), key
    names = [s["name"] for s in got]
    assert names == ["caption.encoder", "caption.decode"]
    assert all(s["device_ms"] > 0 for s in got)

