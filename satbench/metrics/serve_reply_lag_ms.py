"""Milliseconds from a batch's caption step to the start of its replies,
a batch in the window: the growth of CaptionServer.stats' `hold_us` over
that of its `batches` (serve.py's counters); None where the server has
no `hold_us`."""


def read(trace):
    c = trace.get("counters", {})
    if "hold_us" not in c or not c.get("batches"):
        return None
    return c["hold_us"] / c["batches"] / 1e3
