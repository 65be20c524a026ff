"""Metric logging: the JSONL and W&B backends of sat_tpu/utils/logging.py.

`MetricLogger(jsonl_path, use_wandb=False, wandb_config=None)` appends one
JSON object per `log()`, `log_table()` or `log_image()` call, with a `time`
key, in sat_tpu's rows; without a path it writes no file. With
`use_wandb` it also makes sat_tpu's W&B calls: `wandb.init` (project
"show-attend-and-tell", the run's config), `wandb.log` of the metrics, of
a `wandb.Table` and of a `wandb.Image`, `wandb.save` and `wandb.finish`.
`wandb` is imported only then, inside the constructor; when it is not
installed the logger prints sat_tpu's message and carries on without it.
"""

from __future__ import annotations

import json
import time


class MetricLogger:
    def __init__(self, jsonl_path: str | None = None, use_wandb: bool = False,
                 wandb_config: dict | None = None):
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._wandb = None
        if use_wandb:
            try:
                import wandb    # optional, and only for --wandb
            except ImportError:
                print("wandb requested but not installed; continuing "
                      "without it")
            else:
                wandb.init(project="show-attend-and-tell",
                           config=wandb_config or {})
                self._wandb = wandb

    def _write(self, row: dict) -> None:
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps({"time": time.time(), **row}) + "\n")
        self._jsonl.flush()

    def log(self, metrics: dict) -> None:
        payload = {k: _to_scalar(v) for k, v in metrics.items()}
        self._write(payload)
        if self._wandb is not None:
            self._wandb.log(payload)

    def log_table(self, name: str, columns, rows) -> None:
        """A table, e.g. the predictions of an evaluation pass."""
        self._write({"table": name, "columns": list(columns), "rows": rows})
        if self._wandb is not None:
            table = self._wandb.Table(columns=list(columns))
            for row in rows:
                table.add_data(*row)
            self._wandb.log({name: table})

    def log_image(self, name: str, path: str,
                  caption: str | None = None) -> None:
        """An image that the caller rendered to `path`."""
        self._write({"image": name, "path": path, "caption": caption})
        if self._wandb is not None:
            self._wandb.log({name: self._wandb.Image(path, caption=caption)})

    def save_file(self, path: str) -> None:
        """Upload a file to the W&B run (nothing without W&B)."""
        if self._wandb is not None:
            self._wandb.save(path)

    def finish(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb is not None:
            self._wandb.finish()


def _to_scalar(v):
    """A 0-dim tensor or numpy scalar as a Python number."""
    if hasattr(v, "item") and getattr(v, "ndim", 0) == 0:
        return v.item()
    return v
