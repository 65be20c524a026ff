"""Spans of the port's layers: what a request, a server batch, a caption
step, a graph capture or a train block spent, on the host's clock and,
where a span asks for it, on the device's.

    from sat_tpu_torch.utils import spans
    spans.enable(device_times=True)
    with spans.span("caption.decode", device=dev, batch=3):
        ...
    h = spans.begin("serve.queue", parent=request)   # may end elsewhere
    spans.end(h)                                      # on another thread
    got = spans.collect()          # {"clock", "spans", "dropped"}
    spans.disable()

Off by default. While off, `span` returns one shared null context and
`begin` returns None, which `end` and `tag` take and ignore: a hook costs
one test of a flag, reads no clock, allocates nothing and records no CUDA
event.

On, a span records its name, an id, its parent's id (the innermost `span`
open on its thread, or the `parent` given), the native id of the thread
that began it, its start and end on `time.monotonic_ns` (the server's own
clock), and its attributes. Closed spans go into a list of the thread that
closed them, in memory, at most BOUND spans a thread; `dropped` counts the
rest. With `device_times`, a span given a CUDA `device` also records a
timing event on that device's current stream at each of its ends, unless
the stream is capturing a graph (a capture would take the events into the
graph); `collect` waits for the device and turns each pair into
`device_ms`, so that nothing on the hot path synchronizes.

The profiler's clock: `anchor()`, inside a torch.profiler run, opens a span
inside a `record_function` of the same name. Pairs of the two starts tie
the spans' clock to the profiler's (`to_profiler_clock`), and
`write_chrome_trace` adds a run's spans to its Chrome trace as "X" events,
which is what the trainer's `--profile-dir` does. The first events of a
process's first profile have been stamped up to a millisecond late against
the profiler's later stamps (torch 2.13 on the CPU, 2.11 on the H100), so
the mapping takes the last anchor, and a run is anchored at its end.

Spans and what reads them: serve.* (serve.py: request, queue, gather,
load, dispatch, hold, finalize), caption.encoder and caption.decode
(engine/serving.py), graphs.capture (utils/graphs.py) and train.block
(parallel/train_step.py); PERF.md names the metric of each.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import torch

BOUND = 1 << 20                 # spans kept a thread
CLOCK = "time.monotonic_ns"
ANCHOR = "spans.anchor"
TID_BASE = 1_000_000_000        # Chrome-trace tracks of the spans: + thread

_recorder = None                # the Recorder while on; None is off
_NULL = contextlib.nullcontext()


class _Thread:
    """One thread's closed spans, open `span`s and drops."""

    def __init__(self):
        self.spans = []
        self.stack = []
        self.dropped = 0


class Recorder:
    """The spans of one `enable` ... `disable`."""

    def __init__(self, device_times: bool):
        self.device_times = device_times
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.threads = []
        self.lock = threading.Lock()

    def mine(self) -> _Thread:
        state = getattr(self.local, "state", None)
        if state is None:
            state = self.local.state = _Thread()
            with self.lock:
                self.threads.append(state)
        return state

    def event(self, device):
        """A timing event recorded now on `device`'s current stream, or
        None: no device times asked, not a CUDA device, or a capture under
        way there."""
        if not self.device_times or device is None:
            return None
        device = torch.device(device)
        if device.type != "cuda":
            return None
        with torch.cuda.device(device):
            if torch.cuda.is_current_stream_capturing():
                return None
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        return ev


class Span:
    """One span; also the context manager that `span` returns while on."""

    __slots__ = ("name", "id", "parent", "thread", "start", "end", "attrs",
                 "device", "events", "device_ms", "recorder")

    def __init__(self, recorder: Recorder, name: str, parent, device, attrs):
        self.recorder = recorder
        self.name, self.id = name, next(recorder.ids)
        self.parent = parent.id if isinstance(parent, Span) else parent
        self.thread = threading.get_native_id()
        self.start = self.end = None
        self.device, self.attrs = device, attrs
        self.events = None
        self.device_ms = None

    def open(self, at=None) -> "Span":
        ev = self.recorder.event(self.device)
        self.start = time.monotonic_ns() if at is None else at
        self.events = (ev, None) if ev is not None else None
        return self

    def close(self, at=None) -> int:
        if self.end is not None:        # ended already: the first end stands
            return self.end
        if self.events is not None:
            self.events = (self.events[0], self.recorder.event(self.device))
        self.end = time.monotonic_ns() if at is None else at
        state = self.recorder.mine()
        if len(state.spans) < BOUND:
            state.spans.append(self)
        else:
            state.dropped += 1
        return self.end

    def __enter__(self) -> "Span":
        state = self.recorder.mine()
        if self.parent is None and state.stack:
            self.parent = state.stack[-1].id
        state.stack.append(self)
        return self.open()

    def __exit__(self, *exc) -> bool:
        self.close()
        self.recorder.mine().stack.pop()
        return False

    def record(self) -> dict:
        out = {"name": self.name, "id": self.id, "parent": self.parent,
               "thread": self.thread, "start": self.start, "end": self.end,
               "attrs": self.attrs}
        if self.device_ms is not None:
            out["device_ms"] = self.device_ms
        return out


def enable(device_times: bool = False) -> None:
    """Start recording, into a new and empty recorder."""
    global _recorder
    _recorder = Recorder(device_times)


def disable() -> None:
    """Stop recording and drop what was recorded."""
    global _recorder
    _recorder = None


def span(name: str, device=None, **attrs):
    """A context manager timing its block; its `as` target is the Span
    (None while off). With `device` (and `device_times` on), device time
    too."""
    if _recorder is None:
        return _NULL
    return Span(_recorder, name, None, device, attrs)


def begin(name: str, parent=None, at=None, **attrs):
    """Open a span that `end` closes, on this thread or another; None
    while off. Its parent is `parent` (a Span or an id), else the
    innermost `span` open on this thread. `at` is a start already read
    from `time.monotonic_ns`."""
    rec = _recorder
    if rec is None:
        return None
    if parent is None:
        stack = rec.mine().stack
        parent = stack[-1].id if stack else None
    return Span(rec, name, parent, None, attrs).open(at)


def end(handle, at=None):
    """Close the span `begin` gave (None: nothing); `at` is an end already
    read from `time.monotonic_ns`. Returns the end, or None."""
    if handle is None:
        return None
    return handle.close(at)


def tag(handle, **attrs) -> None:
    """Add attributes to an open span (None: nothing)."""
    if handle is not None:
        handle.attrs.update(attrs)


def collect() -> dict:
    """{"clock", "spans" (closed spans as dicts, by start), "dropped"}.
    Waits for the device where spans recorded device times."""
    rec = _recorder
    if rec is None:
        return {"clock": CLOCK, "spans": [], "dropped": 0}
    with rec.lock:
        threads = list(rec.threads)
    closed = [s for t in threads for s in list(t.spans)]
    timed = [s for s in closed if s.events is not None]
    if any(s.events[1] is not None for s in timed):
        torch.cuda.synchronize()
    for s in timed:
        first, last = s.events
        if last is not None:
            s.device_ms = first.elapsed_time(last)
        s.events = None
    return {"clock": CLOCK,
            "spans": sorted((s.record() for s in closed),
                            key=lambda r: r["start"]),
            "dropped": sum(t.dropped for t in threads)}


def anchor() -> None:
    """Inside a torch.profiler run: a `record_function` and a span, both
    named ANCHOR, opened one inside the other, whose starts pair the two
    clocks. A no-op while off."""
    if _recorder is None:
        return
    from torch.profiler import record_function
    with record_function(ANCHOR):
        with span(ANCHOR):
            pass


def to_profiler_clock(spans: list, pairs: list) -> list:
    """Each span with "ts" and "dur", µs on the profiler's clock, shifted
    by the offset of the last of the anchors' `pairs` ((start ns on the
    spans' clock, start µs on the profiler's), in order): the first
    events of a process's first profile may be stamped late."""
    n, u = pairs[-1]
    offset = u - n / 1e3
    return [dict(s, ts=s["start"] / 1e3 + offset,
                 dur=(s["end"] - s["start"]) / 1e3) for s in spans]


def write_chrome_trace(path: str, collected: dict) -> int:
    """Add the spans of `collected` to the Chrome trace at `path` as "X"
    events on the profiler's clock, a track for each thread beside the
    profiler's, paired by the anchors of both (`anchor`). Returns the
    spans written: 0, and the file untouched, when the anchors do not
    pair."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    marks = sorted(e["ts"] for e in events
                   if e.get("name") == ANCHOR and e.get("ph") == "X")
    mine = [s for s in collected["spans"] if s["name"] == ANCHOR]
    rest = [s for s in collected["spans"] if s["name"] != ANCHOR]
    if not marks or len(marks) != len(mine) or not rest:
        return 0
    pid = os.getpid()
    for tid in sorted({s["thread"] for s in rest}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": TID_BASE + tid,
                       "args": {"name": f"spans of thread {tid}"}})
    for s in to_profiler_clock(rest, list(zip((s["start"] for s in mine),
                                              marks))):
        args = dict(s["attrs"], id=s["id"], parent=s["parent"])
        if "device_ms" in s:
            args["device_ms"] = s["device_ms"]
        events.append({"ph": "X", "cat": "sat_span", "name": s["name"],
                       "pid": pid, "tid": TID_BASE + s["thread"],
                       "ts": s["ts"], "dur": s["dur"], "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(rest)
