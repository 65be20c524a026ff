"""Device ms of the encoder on the cell's batch: CUDA events around
models/encoder.py::encoder_forward (the caption driver's span)."""


def read(trace):
    return trace.get("spans_ms", {}).get("encoder")
