"""Training CLI of the port.

    python -m sat_tpu_torch.train [train.py's flags] [--device cpu]

The flags are train.py's (the reference's argparse surface plus sat_tpu's
extensions); `--device` picks the card (cuda, the default) or the CPU,
where every kernel runs its plain PyTorch form. The run computes in float32
(`device.use_f32_math`: no TF32). A flag whose path is not
ported yet raises NotImplementedError naming its ROADMAP.md item.

Data and model parallel, one rank per card (engine/loop.py):

    torchrun --nproc_per_node N*M -m sat_tpu_torch.train --mesh-data N \
        --mesh-model M ...

trains on the global batches that sat_tpu's one process forms with
`--mesh-data N` and the same `--batch-size`, with the vocabulary of the
embedding and the two heads split over M ranks (M must divide it); NCCL
carries the collectives between cards, gloo between CPU ranks (`--device
cpu`). `main`
returns what `Trainer.fit` does: the last evaluation's metrics, or
`{"preempted": True, "epoch": e}` after a SIGTERM or SIGUSR1 (rerun with
--resume to continue).
"""

from __future__ import annotations

import random

import numpy as np
import torch

from sat_tpu_torch.config import (build_arg_parser, config_from_args,
                                  unported_options)
from sat_tpu_torch.device import use_f32_math
from sat_tpu_torch.parallel import distributed as dist


def set_seed(seed: int) -> None:
    """Host-side seeding (reference train.py:37-43); the Trainer seeds its
    own generators from the same value."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def main(argv=None) -> dict:
    args = build_arg_parser().parse_args(argv)
    cfg = config_from_args(args)
    unported = unported_options(cfg)
    if unported:
        raise NotImplementedError(
            "not ported yet (ROADMAP.md, Queue 1): " + ", ".join(
                f"{flag} ({item})" for flag, item in unported))
    device = dist.initialize(args.device)
    use_f32_math()
    set_seed(cfg.seed)
    from sat_tpu_torch.engine.loop import run_training
    try:
        return run_training(cfg, device=device)
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main()
