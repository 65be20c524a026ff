"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a default
`device="cuda"` on a host without CUDA raises instead of quietly running the
plain PyTorch forms on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the plain PyTorch forms on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
