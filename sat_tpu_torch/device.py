"""Device selection and float32 math for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a default
`device="cuda"` on a host without CUDA raises instead of quietly running the
plain PyTorch forms on the CPU.

Entry points also compute in float32, as sat_tpu does. PyTorch lets cuDNN
run float32 convolutions in TF32 unless `torch.backends.cudnn.allow_tf32` is
off, which changes the encoder's grids, and hence the tokens, in the fourth
digit. `use_f32_math` turns TF32 off for cuDNN and for matrix products; the
server, the caption step, the training CLI and the Trainer call it where
they resolve their device.
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


def use_f32_math() -> None:
    """Compute float32 convolutions and matrix products in float32, not
    TF32, for the rest of the process."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
