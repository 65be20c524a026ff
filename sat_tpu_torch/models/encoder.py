"""Frozen VGG19 encoder emitting the annotation grid.

Port of the VGG19 path of sat_tpu/models/encoder.py: torchvision's
vgg19.features without the final max-pool, (B, S, S, 3) NHWC images ->
(B, (S/16)^2, 512), flattened in NHWC row-major order like the reference's
permute(0, 2, 3, 1).view(B, -1, C). The public functions keep the JAX
package's NHWC layout; inside, the convs run on an NCHW view, which is
channels-last in memory. The conv module names are torchvision's
(`features.{idx}`), so a torchvision state_dict loads as it is.

Convolutions are F.conv2d, as sat_tpu left them to XLA. The grid is f32;
on the card cuDNN runs f32 convs in TF32 unless
`torch.backends.cudnn.allow_tf32` is off, and every entry point turns it
off (`device.use_f32_math`), so the grids are sat_tpu's f32 grids.

`compute_dtype=torch.bfloat16` (sat_tpu's `--bf16-encoder` and bf16
decode) runs the network in bf16: the images and the weights are cast,
and the grid comes back in f32. The bf16 weights are one copy per encoder,
made at its first bf16 call and again only when its weights change. XLA
and PyTorch round bf16 at other places, so the two packages' bf16 grids
agree to a stated tolerance, not to f32 rounding.

ResNet152, DenseNet161 and sat_tpu's space-to-depth first conv (a
TPU-lane trick) are not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# torchvision vgg19.features layout; 'M' = maxpool. The final 'M' (feature
# index 36) is dropped per the reference.
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512]


def vgg19_layer_plan():
    """[('conv', torchvision_feature_index, out_ch) | ('pool',)] sequence."""
    plan, idx = [], 0
    for entry in VGG19_CFG:
        if entry == "M":
            plan.append(("pool",))
            idx += 1
        else:
            plan.append(("conv", idx, entry))
            idx += 2  # Conv2d + ReLU
    return plan


class VGG19(nn.Module):
    def __init__(self):
        super().__init__()
        convs, cin = {}, 3
        for op in vgg19_layer_plan():
            if op[0] == "conv":
                _, idx, cout = op
                convs[str(idx)] = nn.Conv2d(cin, cout, 3, padding=1)
                cin = cout
        self.features = nn.ModuleDict(convs)


def _not_ported(network: str):
    return NotImplementedError(
        f"encoder {network!r} is not ported yet (ROADMAP.md, Queue 1: "
        f"ResNet152 and DenseNet161 encoders); only vgg19 is")


def build_encoder(network: str) -> nn.Module:
    if network != "vgg19":
        raise _not_ported(network)
    return VGG19()


def init_encoder_params(network: str,
                        generator: torch.Generator) -> dict[str, np.ndarray]:
    """Random VGG19 parameters in sat_tpu's layout (`conv{idx}/w` HWIO,
    `conv{idx}/b`), drawn like sat_tpu's init (Kaiming normal on fan-out,
    zero bias) from `generator`."""
    if network != "vgg19":
        raise _not_ported(network)
    out, cin = {}, 3
    for op in vgg19_layer_plan():
        if op[0] == "conv":
            _, idx, cout = op
            std = math.sqrt(2.0 / (3 * 3 * cout))
            out[f"conv{idx}/w"] = (torch.randn((3, 3, cin, cout),
                                               generator=generator)
                                   * std).numpy()
            out[f"conv{idx}/b"] = np.zeros((cout,), np.float32)
            cin = cout
    return out


def _conv_weights(enc: VGG19, dtype) -> dict:
    """{torchvision index: (weight, bias)} of the convs in `dtype`: the
    module's own in float32, else the encoder's one cast copy, made anew
    only when a parameter was replaced (`.to()`) or written in place
    (`load_state_dict`)."""
    convs = {idx: (m.weight, m.bias) for idx, m in enc.features.items()}
    if dtype == torch.float32:
        return convs
    key = (dtype, tuple((p.data_ptr(), p._version)
                        for pair in convs.values() for p in pair))
    cached = getattr(enc, "_cast_convs", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, {idx: (w.to(dtype), b.to(dtype))
                            for idx, (w, b) in convs.items()})
        enc._cast_convs = cached
    return cached[1]


def vgg19_forward(enc: VGG19, x: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """x (B, H, W, 3) NHWC -> (B, H/16, W/16, 512) NHWC, computed in
    `dtype`."""
    convs = _conv_weights(enc, dtype)
    x = x.to(dtype).permute(0, 3, 1, 2)
    for op in vgg19_layer_plan():
        if op[0] == "pool":
            x = F.max_pool2d(x, kernel_size=2, stride=2)
        else:
            w, b = convs[str(op[1])]
            x = F.relu(F.conv2d(x, w, b, padding=1))
    return x.permute(0, 2, 3, 1)


@torch.inference_mode()
def encoder_forward(enc: nn.Module, network: str, images,
                    compute_dtype=None) -> torch.Tensor:
    """images (B, S, S, 3) NHWC -> annotation grid (B, L, C) float32,
    contiguous, on the encoder's device. `compute_dtype` (None: float32;
    torch.bfloat16) is the network's dtype (module note).

    The grid is a view of the last conv's output, whose memory format the
    convolution picks (on the card it varied with the batch size), so it is
    made contiguous here: the attention kernels take only contiguous
    features."""
    if network != "vgg19":
        raise _not_ported(network)
    dev = next(enc.parameters()).device
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    x = vgg19_forward(enc, images, compute_dtype or torch.float32)
    B, H, W, C = x.shape
    return x.reshape(B, H * W, C).float().contiguous()
