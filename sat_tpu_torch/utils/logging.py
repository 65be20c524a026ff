"""Metric logging: the JSONL backend of sat_tpu/utils/logging.py.

`MetricLogger(jsonl_path)` appends one JSON object per `log()`,
`log_table()` or `log_image()` call, with a `time` key, in sat_tpu's rows;
without a path it logs nothing. The W&B backend is not ported (`--wandb`
raises in the CLI), so `save_file`, which uploads a file to W&B in
sat_tpu, does nothing.
"""

from __future__ import annotations

import json
import time


class MetricLogger:
    def __init__(self, jsonl_path: str | None = None):
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None

    def _write(self, row: dict) -> None:
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps({"time": time.time(), **row}) + "\n")
        self._jsonl.flush()

    def log(self, metrics: dict) -> None:
        self._write({k: _to_scalar(v) for k, v in metrics.items()})

    def log_table(self, name: str, columns, rows) -> None:
        """A table, e.g. the predictions of an evaluation pass."""
        self._write({"table": name, "columns": list(columns), "rows": rows})

    def log_image(self, name: str, path: str,
                  caption: str | None = None) -> None:
        """An image that the caller rendered to `path`."""
        self._write({"image": name, "path": path, "caption": caption})

    def save_file(self, path: str) -> None:
        """W&B's file upload in sat_tpu; nothing here."""

    def finish(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


def _to_scalar(v):
    """A 0-dim tensor or numpy scalar as a Python number."""
    if hasattr(v, "item") and getattr(v, "ndim", 0) == 0:
        return v.item()
    return v
