"""The attention backward kernel against its bound, in %: the least time
of one call at the train step's shapes, dfeats not asked (satbench/counts/
bounds.py), over the device time a call of the kernels named
"attention_bwd" took in the traced slice. Silent when no such kernel ran."""

from satbench import trace as tr
from satbench.counts import bounds


def read(trace):
    got = tr.kernel(trace.get("profile", {}), "attention_bwd")
    if got is None or "attention_bwd" not in trace:
        return None
    a = trace["attention_bwd"]
    return 100.0 * bounds.attention_bwd(a["images"], a["L"], a["D"], a["E"],
                                        trace["peaks"]) / got[0]
