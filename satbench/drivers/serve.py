"""Online captioning: the port's CaptionServer (serve.py: micro-batches of
up to `max_batch` requests coalesced within `window_ms`, padded to a
power-of-two bucket, one caption step each, one batch in flight behind
the next), in this process on an ephemeral port of 127.0.0.1, serving
`{"cached": row}` requests for a preloaded pool of images, as `python -m
sat_tpu_torch.serve --preload-images` does. Its captions come back as
their token ids (the harness's vocabulary writes each id as its number),
so that the check reads the exact tokens.

Traffic parameters: `rate` requests a second of an open loop from a
client process (drivers/client.py), `max_batch`, `window_ms`, `beam`,
`pool`, `contrast` and `stop_boost` (drivers/common.py), `warm` requests
the client sends one at a time before the window, `drain_s` the longest
wait for replies after the window, `check_requests`, the answered
requests drawn from the seed whose captions are checked (with the one of
the longest caption), and `trace_s`, the seconds that a traced run
profiles.

Set-up captures the step's graphs at every bucket (1, 2, 4, ... up to
`max_batch`), and the client's warm-up requests pass through the socket
path. End-to-end: caption_p95_ms, the 95th percentile over every request
due in the window of the time from when it was due to its reply, an
unanswered request counting as infinitely late. Traced: `trace_s`
seconds in the middle of the window under the profiler, and the server's
counters from the window's opening to the end of that slice.
"""

from __future__ import annotations

import json
import math
import random
import subprocess
import sys
import time

from satbench import checks, faults, program, trace
from satbench.drivers import common
from satbench.reference import model as reference
from satbench.spec import ROOT

def percentile(values, q: float) -> float:
    """Nearest-rank percentile q of values (inf for a missing one)."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def buckets(max_batch: int):
    b, out = 1, []
    while b < max_batch:
        out.append(b)
        b *= 2
    return out + [max_batch]


def parse_reply(reply) -> tuple | None:
    """(tokens, found, score) of a caption reply, None for an error."""
    if not reply or "caption" not in reply:
        return None
    return ([int(t) for t in reply["caption"].split()], reply["completed"],
            reply["score"])


def client(port: int, ctx, rate: float, seconds: float):
    tr = ctx.traffic
    return subprocess.Popen(
        [sys.executable, "-m", "satbench.drivers.client", str(port),
         str(ctx.seed), str(rate), str(seconds), str(tr["pool"]),
         str(tr["warm"]), str(tr["drain_s"])],
        cwd=str(ROOT), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True)


def window(server, ctx, rate: float, seconds: float, traced: dict | None,
           on_ready=lambda: None):
    """One open-loop window against `server`: (requests, the server's
    counters over it). `on_ready` is called once the client has warmed
    up, just before the window opens. With `traced`, the traffic's
    `trace_s` seconds in the window's middle are profiled into
    traced["profile"], and traced["counters"] are the server's counters
    from the window's opening to the slice's end: the profiler's stop
    reads the trace in this process and holds the server's threads for
    about ten seconds a traced second, which grows the queue behind it."""
    proc = client(server.port, ctx, rate, seconds)
    try:
        if proc.stdout.readline().strip() != "ready":
            raise RuntimeError("the serving client did not start")
        on_ready()
        before = dict(server.stats)
        proc.stdin.write("go\n")
        proc.stdin.flush()
        if traced is not None:
            span = min(seconds, ctx.traffic["trace_s"])
            time.sleep((seconds - span) / 2)
            at_end = {}
            traced["profile"] = trace.profile(
                lambda: time.sleep(span),
                then=lambda: at_end.update(server.stats))
            traced["counters"] = {k: at_end[k] - before[k] for k in at_end}
        lines = proc.stdout.read().splitlines()
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    after = dict(server.stats)
    return ([json.loads(x) for x in lines],
            {k: after[k] - before[k] for k in after})


def summary(requests, seconds: float) -> dict:
    lat = [(r["answered"] - r["due"]) * 1e3 if r["answered"] is not None
           and parse_reply(r["reply"]) else math.inf for r in requests]
    late = [(r["sent"] - r["due"]) * 1e3 for r in requests]
    q = len(requests) // 4
    return {"requests": len(requests),
            "answered": sum(x < math.inf for x in lat),
            "offered_per_s": len(requests) / seconds,
            "p50_ms": percentile(lat, 0.5), "p95_ms": percentile(lat, 0.95),
            "p95_first_quarter_ms": percentile(lat[:q] or lat, 0.95),
            "p95_last_quarter_ms": percentile(lat[-q:] or lat, 0.95),
            "generator_late_p99_ms": percentile(late, 0.99),
            "generator_late_max_ms": max(late)}


def start_server(ctx, inputs):
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.serve import CaptionServer

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    enc = program.encoder(cfg, inputs.enc_w, dev)
    dcfg, dec = program.decoder(cfg, inputs.dec_w, dev)
    step = build_caption_step(cfg["network"], dcfg, tr["beam"], device=dev)

    def caption_fn(arr):
        return step(enc, dec, arr)

    def decode_tokens(tokens, length, found):
        return [str(t) for t in ([0] if not found
                                 else tokens[:length + 1].tolist())]

    for b in buckets(tr["max_batch"]):           # capture every bucket
        out = caption_fn(inputs.pool[:b])
        out["tokens"].cpu()
    server = CaptionServer(caption_fn, cfg["image_size"], decode_tokens,
                           max_batch=tr["max_batch"],
                           batch_window_ms=tr["window_ms"],
                           image_pool=inputs.pool)
    server.start()
    return server


def check(ctx, inputs, requests) -> dict:
    """The sampled answered requests' captions against the reference's
    beam over their pool images."""
    import torch
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    answered = [r for r in requests if parse_reply(r["reply"])]
    nums = {"unanswered": len(requests) - len(answered)}
    if not answered:
        return nums | {"score_gap": math.inf, "beam_mismatch": 1.0}
    picks = random.Random(ctx.seed).sample(
        answered, min(tr["check_requests"], len(answered)))
    picks.append(max(answered, key=lambda r: len(r["reply"]["caption"])))
    rows = sorted({r["row"] for r in picks})
    at = {row: i for i, row in enumerate(rows)}
    T = cfg["max_steps"] + 1
    tokens = torch.zeros((len(picks), T), dtype=torch.long, device=dev)
    length = torch.zeros(len(picks), dtype=torch.long, device=dev)
    found = torch.zeros(len(picks), dtype=torch.bool, device=dev)
    score = torch.zeros(len(picks), device=dev)
    for i, r in enumerate(picks):
        toks, done, s = parse_reply(r["reply"])
        if done:
            tokens[i, :len(toks)] = torch.tensor(toks)
            length[i], found[i], score[i] = len(toks) - 1, True, s
        else:
            score[i] = -math.inf
    t0 = time.perf_counter()
    with reference.precision(False):
        grid = reference.encode(inputs.enc_w, inputs.images(rows))
        grid = grid[torch.tensor([at[r["row"]] for r in picks], device=dev)]
        out = {"tokens": tokens, "length": length, "found": found,
               "score": score,
               "alphas": torch.zeros((len(picks), T, grid.shape[1]),
                                     device=dev)}
        got = checks.caption(out, grid, inputs.dec_w, tr["beam"],
                             cfg["stop_ids"], cfg["start_token"], reference)
    common.synchronize(dev)
    got.pop("alpha_gap")        # a reply carries no attention weights
    return nums | got | {"checked": len(picks),
                         "reference_s": time.perf_counter() - t0}


def run(ctx) -> dict:
    import torch
    tr, dev = ctx.traffic, ctx.device
    ctx.mark("imports")
    inputs = common.CaptionInputs(ctx)
    ctx.mark("inputs")
    program.f32_math()
    with faults.planted(ctx.fault):
        server = start_server(ctx, inputs)
        if ctx.trace:
            trace.warm_up()
        ctx.mark("server")
        try:
            common.synchronize(dev)
            traced = {} if ctx.trace else None
            opened = []
            requests, counters = window(
                server, ctx, tr["rate"], ctx.seconds, traced,
                lambda: opened.append(time.perf_counter()))
            setup_s = opened[0] - ctx.t0
            window_s = time.perf_counter() - opened[0]
            peak = (torch.cuda.max_memory_allocated()
                    if dev.startswith("cuda") else 0)
        finally:
            server.stop()
    del server
    common.free(dev)
    stats = summary(requests, ctx.seconds)
    numbers = check(ctx, inputs, requests)
    ctx.log(cell=ctx.cell.name, seed=ctx.seed, setup_s=setup_s,
            window_s=window_s, counters=counters,
            slice_counters=(traced or {}).get("counters"),
            profiler_host_s=(traced or {}).get("profile", {}).get(
                "profiler_host_s"), **stats,
            numbers=numbers)
    return {"setup_s": setup_s, "window_s": window_s,
            "attempted": stats["requests"],
            "failed": stats["requests"] - stats["answered"],
            "e2e": {"caption_p95_ms": stats["p95_ms"]},
            "numbers": numbers, "memory_peak_bytes": peak,
            "trace": traced}


def sweep(ctx, rates) -> list:
    """One set-up, then a window of ctx.seconds at each rate: the knee is
    the highest rate whose requests are all answered with no backlog
    growing over the window."""
    inputs = common.CaptionInputs(ctx)
    program.f32_math()
    server = start_server(ctx, inputs)
    out = []
    try:
        for rate in rates:
            requests, counters = window(server, ctx, rate, ctx.seconds, None)
            row = {"rate": rate, **summary(requests, ctx.seconds),
                   "batch_mean": counters["requests"]
                   / max(1, counters["batches"])}
            print(json.dumps(row), flush=True)
            out.append(row)
    finally:
        server.stop()
    return out


def control(ctx) -> dict:
    """The control: the reference's beam with TF32 on, in the server's
    place, over `check_requests` pool rows drawn from the seed."""
    tr = ctx.traffic
    inputs = common.CaptionInputs(ctx)
    rows = sorted(random.Random(ctx.seed).sample(
        range(tr["pool"]), min(tr["check_requests"], tr["pool"])))
    out = common.control_captions(inputs, ctx, rows)
    requests = []
    for i, row in enumerate(rows):
        n = int(out["length"][i])
        found = bool(out["found"][i])
        toks = out["tokens"][i, :n + 1].tolist() if found else [0]
        requests.append({"row": row, "reply": {
            "caption": " ".join(map(str, toks)), "completed": found,
            "score": float(out["score"][i])}})
    return check(ctx, inputs, requests)
