"""time_train_step.py runs on the CPU at a toy batch, against the tree it
is given, and prints its one JSON line."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_time_train_step_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, str(REPO / "time_train_step.py"), "--tree",
         str(REPO), "--device", "cpu", "--batch", "2", "--steps", "1"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["tree"] == str(REPO) and out["card"] is None
    for mode in ("remat", "no_remat"):
        assert len(out["timing"][mode]["ms_per_step"]) == 2
    assert out["last_loss"] > 0
