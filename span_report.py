#!/usr/bin/env python3
"""The port's spans over one cell of its benchmark (satbench), on the card:

    python3 span_report.py --workload CELL --seed N --seconds S --trace 0|1

runs the cell as `python3 -m satbench` does, with the port's span recorder
(sat_tpu_torch/utils/spans.py) on, device times included, from the start
of set-up, and prints one JSON line: the cell's own result line
(`result`: with --trace 0 its end-to-end metrics, so that a plain
`python3 -m satbench` run beside it gives the recorder's cost) and what
the spans read (`spans`):

  capture_s           host seconds of every `graphs.capture` span (set-up)
  encoder_span_ms,    median device ms of `caption.encoder` and
  decode_span_ms      `caption.decode` over the window's calls (caption
                      cells; the two set-up calls and the profiled ones
                      left out), with their host medians beside them
  serve_queue_ms,     p95 of `serve.queue`, and of the `serve.hold` of each
  serve_hold_ms       request's batch, over the window's requests answered
                      before the profiled slice opened (serving cell), and
                      the p95 request's stages (`p95_request`)
  train_launch_ms     median host ms of `train.block` over the window's
                      blocks, and host and device ms and rows/s by quarter
                      of the window (train cells)

With --trace 1 the profiled slice is anchored: `spans.anchor()` opens just
inside the harness's `satbench.traced` record_function and again just
before it closes, and the spans are put on the profiler's clock by the
last anchor's offset (`anchor_offsets_us` gives both: their difference
bounds the error). Then `decode_idle_ms` is the device's idle ms a call
inside the profiled `caption.decode` spans, and `gaps` the slice's idle
stretches named as the harness names them (the innermost host operation
at each stretch's middle), except that a stretch with no host operation
there is named by the innermost span open at its middle, the server's
batch loop's spans first, else "(no host op)".

Only a checkout with a card runs it; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import sys

from satbench import run, spec, trace
from sat_tpu_torch.utils import spans

SERVE_BATCH = ("serve.gather", "serve.load", "serve.dispatch", "serve.hold",
               "serve.finalize")


def anchored_profiler(store: dict) -> None:
    """torch.profiler as the harness calls it, with the anchors inside its
    traced span and the last profile kept in store["prof"]."""
    import torch.profiler as tp
    real_record, real_profile = tp.record_function, tp.profile

    class Profile(real_profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            store["prof"] = self
            return out

    @contextlib.contextmanager
    def record_function(name, *args, **kwargs):
        with real_record(name, *args, **kwargs) as rf:
            if name == trace.SPAN:
                spans.anchor()
            yield rf
            if name == trace.SPAN:
                spans.anchor()

    tp.record_function, tp.profile = record_function, Profile


def ms(s) -> float:
    return (s["end"] - s["start"]) / 1e6


def p95(values):
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)] \
        if ordered else None


def median(values):
    return statistics.median(values) if values else None


def by_name(got, name):
    return sorted((s for s in got if s["name"] == name),
                  key=lambda s: s["start"])


def caption_readings(got, slice_ns) -> dict:
    out = {}
    for part in ("encoder", "decode"):
        calls = [s for s in by_name(got, f"caption.{part}")[2:]
                 if s["start"] < slice_ns]
        out[f"{part}_span_ms"] = median([s["device_ms"] for s in calls
                                         if "device_ms" in s])
        out[f"{part}_host_ms"] = median([ms(s) for s in calls])
        out[f"{part}_calls"] = len(calls)
    return out


def serve_readings(got, slice_ns, warm: int) -> dict:
    batch = {(s["name"], s["attrs"]["batch"]): s for s in got
             if s["name"] in SERVE_BATCH}
    queue = {s["parent"]: s for s in by_name(got, "serve.queue")}
    reqs = [r for r in by_name(got, "serve.request")
            if r["attrs"]["seq"] > warm and r["end"] < slice_ns
            and ("serve.hold", r["attrs"].get("batch")) in batch]
    out = {"requests": len(reqs),
           "serve_queue_ms": p95([ms(queue[r["id"]]) for r in reqs]),
           "serve_hold_ms": p95([ms(batch["serve.hold",
                                          r["attrs"]["batch"]])
                                 for r in reqs]),
           "request_p95_ms": p95([ms(r) for r in reqs])}
    if reqs:
        r = sorted(reqs, key=ms)[max(0, math.ceil(0.95 * len(reqs)) - 1)]
        b = r["attrs"]["batch"]
        split = {"request": ms(r), "queue": ms(queue[r["id"]])}
        split |= {n.split(".")[1]: ms(batch[n, b]) for n in SERVE_BATCH}
        split["in_finalize"] = (r["end"] - batch["serve.finalize", b]
                                ["start"]) / 1e6
        out["p95_request"] = split
        out["batch_median_ms"] = {
            n.split(".")[1]: median([ms(s) for (k, _), s in batch.items()
                                     if k == n]) for n in SERVE_BATCH}
    return out


def train_readings(got, slice_ns, first: int, block_rows: int) -> dict:
    blocks = [s for s in by_name(got, "train.block")[first:]
              if s["start"] < slice_ns]
    out = {"blocks": len(blocks),
           "train_launch_ms": median([ms(s) for s in blocks]),
           "train_device_ms": median([s["device_ms"] for s in blocks
                                      if "device_ms" in s])}
    if len(blocks) >= 8:
        t0, t1 = blocks[0]["start"], blocks[-1]["end"]
        q = (t1 - t0) / 4
        quarters = []
        for i in range(4):
            part = [s for s in blocks
                    if min(3, int((s["start"] - t0) // q)) == i]
            quarters.append({
                "blocks": len(part),
                "host_ms": median([ms(s) for s in part]),
                "device_ms": median([s["device_ms"] for s in part
                                     if "device_ms" in s]),
                "rows_per_s": len(part) * block_rows / (q / 1e9)})
        out["quarters"] = quarters
    return out


def slice_readings(prof, got) -> dict:
    """The profiled slice with the spans on its clock: anchor offsets,
    idle ms a decode call, and the idle stretches named."""
    from torch.autograd import DeviceType

    events = prof.events()
    span_ev = [e for e in events if e.name == trace.SPAN]
    marks = sorted(e.time_range.start for e in events
                   if e.name == spans.ANCHOR)
    anchors = [s["start"] for s in got if s["name"] == spans.ANCHOR]
    if not span_ev or len(marks) != len(anchors) or not marks:
        return {"anchored": False}
    t0, t1 = span_ev[0].time_range.start, span_ev[0].time_range.end
    pairs = list(zip(anchors, marks))
    mapped = spans.to_profiler_clock(
        [s for s in got if s["name"] != spans.ANCHOR], pairs)
    dev = sorted((max(e.time_range.start, t0), min(e.time_range.end, t1))
                 for e in trace._device_events(prof, DeviceType.CUDA)
                 if trace.SPIN not in e.name and e.name != trace.SPAN
                 and e.time_range.end > t0 and e.time_range.start < t1)
    busy = []
    for s, e in dev:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    holes = ([(t0, busy[0][0])] + [(a[1], b[0]) for a, b in
                                   zip(busy, busy[1:])]
             + [(busy[-1][1], t1)]) if busy else [(t0, t1)]
    holes = [(s, e) for s, e in holes if e > s]

    def idle_in(a, b):
        return sum(max(0.0, min(e, b) - max(s, a)) for s, e in holes)

    decodes = [s for s in mapped if s["name"] == "caption.decode"
               and t0 <= s["ts"] and s["ts"] + s["dur"] <= t1]
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in trace._device_events(prof, DeviceType.CPU)
                  if e.name not in (trace.SPAN, spans.ANCHOR))
    starts = [h[0] for h in host]
    loop = {s["thread"] for s in mapped if s["name"] == "serve.gather"}
    ranked = sorted(mapped, key=lambda s: (s["thread"] not in loop,
                                           -s["ts"]))
    gaps = {}
    for s, e in holes:
        mid = (s + e) / 2
        name = trace._host_at(host, starts, mid)
        if name == "(no host op)":
            name = next((f"span {x['name']}" for x in ranked
                         if x["ts"] <= mid <= x["ts"] + x["dur"]), name)
        gaps[name] = gaps.get(name, 0.0) + (e - s) / 1e6
    return {"anchored": True,
            "anchor_offsets_us": [u - n / 1e3 for n, u in pairs],
            "window_s": (t1 - t0) / 1e6,
            "idle_s": sum(e - s for s, e in holes) / 1e6,
            "decode_idle_ms": (sum(idle_in(s["ts"], s["ts"] + s["dur"])
                                   for s in decodes) / 1e3 / len(decodes)
                               if decodes else None),
            "profiled_decodes": len(decodes),
            "gaps": sorted(([k, v] for k, v in gaps.items()),
                           key=lambda r: -r[1])[:12]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    run.use_cache_dirs()
    cell = spec.load(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("span_report: needs a CUDA card", file=sys.stderr)
        return 2
    store = {}
    anchored_profiler(store)
    spans.enable(device_times=True)
    ctx = run.Context(cell, args.seed, args.seconds, bool(args.trace))
    out = run.execute(ctx)
    got = spans.collect()
    closed = got["spans"]
    anchors = [s["start"] for s in closed if s["name"] == spans.ANCHOR]
    slice_ns = anchors[0] if anchors else math.inf
    captures = by_name(closed, "graphs.capture")
    readings = {"spans": len(closed), "dropped": got["dropped"],
                "capture_s": sum(ms(s) for s in captures) / 1e3,
                "captures": len(captures)}
    driver = cell.traffic["driver"]
    if driver == "caption":
        readings |= caption_readings(closed, slice_ns)
    elif driver == "serve":
        readings |= serve_readings(closed, slice_ns, cell.traffic["warm"])
    else:
        first = 1 + (cell.traffic["checked_steps"] - 1) // cell.traffic[
            "block"]
        readings |= train_readings(closed, slice_ns, first,
                                   cell.traffic["block"]
                                   * cell.traffic["batch"])
    if args.trace and "prof" in store:
        readings |= slice_readings(store["prof"], closed)
    line = {"workload": args.workload, "seed": args.seed,
            "result": run.finite(run.result(ctx, out)), "spans": readings}
    print(json.dumps(line, default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
