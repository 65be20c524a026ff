"""profile_loss.py, which profiles greedy decode's CUDA graph replays many
times and counts the kernels the profiler loses, runs only on a CUDA card:
without one it exits non-zero before it builds or profiles anything."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_profile_loss_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "profile_loss.py", "--reps", "2"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert '"case"' not in proc.stdout
