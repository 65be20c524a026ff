"""Requests a batch in the window: the growth of CaptionServer.stats'
`requests` over that of its `batches` (serve.py's counters)."""


def read(trace):
    c = trace.get("counters", {})
    if not c.get("batches"):
        return None
    return c["requests"] / c["batches"]
