"""The beam's top-k kernel against its bound, in %: the least time of one
call at the cell's candidate rows (satbench/counts/bounds.py) over the
device time a call of the kernels named "topk" took in the traced slice.
Silent when no such kernel ran."""

from satbench import trace as tr
from satbench.counts import bounds


def read(trace):
    got = tr.kernel(trace.get("profile", {}), "topk")
    if got is None or "topk" not in trace:
        return None
    t = trace["topk"]
    return 100.0 * bounds.topk(t["rows"], t["n"], t["k"],
                               trace["peaks"]) / got[0]
