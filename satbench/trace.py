"""Device time from torch.profiler over a slice of a run.

`profile` is chip_smoke.py::profile_run's method, copied: the card idles
PAD_S before and after the traced call, and LEAD_IN spin kernels are
queued just before it, because the profiler has dropped the first device
events of a run on the H100 (they take the loss instead and count in no
row). What it reads is the benchmark's own:

  busy_s     the union of every device operation's interval (kernels,
             copies, sets) inside the traced call's span, so that
             overlapping streams count once;
  window_s   the traced call's span on the profiler's clock;
  ops        device seconds and calls by operation name, largest first;
  gaps       the idle stretches between device operations inside the
             span, summed by the host operation that was running at each
             stretch's middle (the innermost one), largest first;
  profiler_host_s  the host seconds the profiler's start and its stop
             (which reads the trace) took.

No trace file is written.
"""

from __future__ import annotations

import bisect
import time

PAD_S = 0.2
LEAD_IN = 64
SPAN = "satbench.traced"
SPIN = "spin_kernel"


def _device_events(prof, device_type):
    return [e for e in prof.events() if e.device_type == device_type
            and e.time_range.end > e.time_range.start]


def warm_up() -> None:
    """Start and stop the profiler once over one small kernel. The first
    start in a process takes seconds (the device tracer's set-up), which
    inside a serving window would stall the server; a later start is
    quick."""
    import torch
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def profile(fn, then=None) -> dict:
    """Run `fn` once under the profiler; see the module note. `then`, if
    given, runs just after the traced span, before the profiler's stop,
    which reads the trace and holds the interpreter for seconds a traced
    second (a server's counters are read there, before that stall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    torch.cuda.synchronize()
    t_enter = time.perf_counter()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        started_s = time.perf_counter() - t_enter
        time.sleep(PAD_S)
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1000)
        with record_function(SPAN):
            fn()
            torch.cuda.synchronize()
        if then is not None:
            then()
        time.sleep(PAD_S)
        t_stop = time.perf_counter()
    timing = {"start_s": started_s, "stop_s": time.perf_counter() - t_stop}
    spans = [e for e in prof.events() if e.name == SPAN]
    if not spans:
        return {}
    t0, t1 = spans[0].time_range.start, spans[0].time_range.end
    dev = [e for e in _device_events(prof, DeviceType.CUDA)
           if SPIN not in e.name and e.name != SPAN
           and e.time_range.end > t0
           and e.time_range.start < t1]
    if not dev:
        return {}
    ops = {}
    for e in dev:
        secs, calls = ops.get(e.name, (0.0, 0))
        ops[e.name] = (secs + (e.time_range.end - e.time_range.start) / 1e6,
                       calls + 1)
    intervals = sorted((max(e.time_range.start, t0), min(e.time_range.end,
                                                         t1)) for e in dev)
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_us = sum(e - s for s, e in merged)
    holes = ([(t0, merged[0][0])] + [(a[1], b[0]) for a, b in
                                     zip(merged, merged[1:])]
             + [(merged[-1][1], t1)])
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in _device_events(prof, DeviceType.CPU)
                  if e.name != SPAN)
    starts = [h[0] for h in host]
    gaps = {}
    for s, e in holes:
        if e <= s:
            continue
        name = _host_at(host, starts, (s + e) / 2)
        gaps[name] = gaps.get(name, 0.0) + (e - s) / 1e6
    return {"busy_s": busy_us / 1e6, "window_s": (t1 - t0) / 1e6,
            "profiler_host_s": timing,
            "ops": sorted(([k, s, n] for k, (s, n) in ops.items()),
                          key=lambda r: -r[1]),
            "gaps": sorted(([k, s] for k, s in gaps.items()),
                           key=lambda r: -r[1])}


def _host_at(host, starts, t, look: int = 4096) -> str:
    """The innermost host operation running at time t: of those that
    started by t and had not ended, the one that started last (searched
    among the `look` latest starts)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - look, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "(no host op)"


def kernel(prof: dict, name: str):
    """(seconds a call, calls) of the device operations whose name holds
    `name`, or None when the profile has none."""
    rows = [r for r in prof.get("ops", ()) if name in r[0]]
    calls = sum(r[2] for r in rows)
    if not calls:
        return None
    return sum(r[1] for r in rows) / calls, calls


def spans_ms(fn, reps: int = 3) -> float:
    """Median device time of `fn` in ms, between CUDA events, after one
    warm run."""
    import statistics

    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
