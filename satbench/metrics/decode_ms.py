"""Device ms of the beam on the cell's batch: CUDA events around
models/beam.py::beam_search_batched replaying the caption step's graphs
(the caption driver's span)."""


def read(trace):
    return trace.get("spans_ms", {}).get("decode")
