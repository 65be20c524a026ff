"""The benchmark of sat_tpu_torch, the PyTorch and CUDA port: `python -m
satbench --workload NAME --seed N --seconds S --trace 0|1` (satbench/run.py).
It imports nothing of JAX or of the JAX package."""
