"""Metric logging: the JSONL backend of sat_tpu/utils/logging.py.

`MetricLogger(jsonl_path)` appends one JSON object per `log()` call, with
a `time` key beside the metrics; without a path it logs nothing. The W&B
backend is not ported (`--wandb` raises in the CLI).
"""

from __future__ import annotations

import json
import time


class MetricLogger:
    def __init__(self, jsonl_path: str | None = None):
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None

    def log(self, metrics: dict) -> None:
        if self._jsonl is None:
            return
        payload = {k: _to_scalar(v) for k, v in metrics.items()}
        self._jsonl.write(json.dumps({"time": time.time(), **payload}) + "\n")
        self._jsonl.flush()

    def finish(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


def _to_scalar(v):
    """A 0-dim tensor or numpy scalar as a Python number."""
    if hasattr(v, "item") and getattr(v, "ndim", 0) == 0:
        return v.item()
    return v
