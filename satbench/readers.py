"""Readers that several per-layer metrics share: each metric's file in
metrics/ names its own metric and takes its `read` from here."""

from satbench import trace as tr
from satbench.counts import bounds


def idle_share(trace):
    """The device's idle share of the traced slice, in %: 100 (1 - busy /
    window), busy being the union of the device operations' intervals
    (satbench/trace.py)."""
    prof = trace.get("profile", {})
    if not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def attention_fwd_roofline(trace):
    """The attention forward kernel against its bound, in %: the least
    time of one call at the cell's shapes (satbench/counts/bounds.py) over
    the device time a call of the kernels named "attention_fwd" took in
    the traced slice. Silent when no such kernel ran."""
    got = tr.kernel(trace.get("profile", {}), "attention_fwd")
    if got is None or "attention_fwd" not in trace:
        return None
    a = trace["attention_fwd"]
    return 100.0 * bounds.attention_fwd(a["images"], a["R"], a["L"], a["D"],
                                        a["E"], trace["peaks"]) / got[0]
