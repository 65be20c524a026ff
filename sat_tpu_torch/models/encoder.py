"""Frozen CNN encoders emitting the annotation grid.

Port of sat_tpu/models/encoder.py's three networks, (B, S, S, 3) NHWC
images -> (B, L, C) grids, flattened in NHWC row-major order like the
reference's permute(0, 2, 3, 1).view(B, -1, C):

  vgg19       - torchvision's vgg19.features without the final max-pool:
                (B, (S/16)^2, 512);
  resnet152   - the body without avgpool and fc: (B, (S/32)^2, 2048);
  densenet161 - the features without norm5: (B, (S/32)^2, 2208), taken
                before norm5 as sat_tpu does.

The public functions keep the JAX package's NHWC layout; inside, the
network runs on an NCHW view, which is channels-last in memory. Module and
parameter names are torchvision's (`features.{idx}`; `conv1`, `bn1`,
`layer{n}.{i}.conv{1-3}`, `downsample.0/.1`; `features.conv0`,
`denseblock{n}.denselayer{m}.norm1/conv1/norm2/conv2`,
`transition{n}.norm/conv`), so a torchvision state_dict loads as it is.
`encoder_layout` lists every conv and batch norm with its torchvision name,
its name in sat_tpu's flat `.npz` archive and its shape; the modules, the
initializer and the weight maps (compat/) are all made from it.

Batch norm is inference-only, from the running statistics, eps 1e-5, as
sat_tpu's (the encoder is frozen). The stride-2 3x3 conv of a bottleneck
pads (1, 1) on both sides, the 7x7 stem (3, 3), the stem's 3x3 max-pool
(1, 1) with -inf, and DenseNet's transitions end in a 2x2 average pool
without padding, all as sat_tpu's. Its `scan_blocks` (a smaller HLO) and
space-to-depth first conv (a TPU-lane trick) have no counterpart.

Convolutions are F.conv2d, as sat_tpu left them to XLA. The grid is f32;
on the card cuDNN runs f32 convs in TF32 unless
`torch.backends.cudnn.allow_tf32` is off, and every entry point turns it
off (`device.use_f32_math`), so the grids are sat_tpu's f32 grids.

`compute_dtype=torch.bfloat16` (sat_tpu's `--bf16-encoder` and bf16
decode) runs the network in bf16: the images and every parameter and
statistic are rounded to bf16 as sat_tpu casts its whole tree, and the
grid comes back in f32. The batch norms take their bf16-rounded values held
in f32, which every backend accepts beside bf16 activations. The cast
weights are one copy per encoder, made at its first bf16 call and again
only when its weights change. XLA and PyTorch round bf16 at other places,
so the two packages' bf16 grids agree to a stated tolerance, not to f32
rounding.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
NETWORKS = ("vgg19", "resnet152", "densenet161")

# torchvision vgg19.features layout; 'M' = maxpool. The final 'M' (feature
# index 36) is dropped per the reference.
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512]

RESNET152_BLOCKS = (3, 8, 36, 3)
RESNET_EXPANSION = 4

DENSENET161_BLOCKS = (6, 12, 36, 24)
DENSENET_GROWTH = 48
DENSENET_INIT = 96
DENSENET_BN_SIZE = 4


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


class Layer(NamedTuple):
    """One conv or batch norm of an encoder."""
    torch_name: str     # module name in torchvision's state_dict
    flat_name: str      # prefix of its arrays in sat_tpu's flat archive
    kind: str           # "conv", "conv+b" (with bias) or "bn"
    shape: tuple        # HWIO kernel of a conv, (channels,) of a bn


def _conv(t, j, kh, cin, cout, bias=False) -> Layer:
    return Layer(t, j, "conv+b" if bias else "conv", (kh, kh, cin, cout))


def _bn(t, j, ch) -> Layer:
    return Layer(t, j, "bn", (ch,))


def encoder_layout(network: str) -> list[Layer]:
    """Every conv and batch norm of `network`, in forward order."""
    if network == "vgg19":
        out, cin = [], 3
        for op in vgg19_layer_plan():
            if op[0] == "conv":
                _, idx, cout = op
                out.append(_conv(f"features.{idx}", f"conv{idx}", 3, cin,
                                 cout, bias=True))
                cin = cout
        return out
    if network == "resnet152":
        out = [_conv("conv1", "conv1", 7, 3, 64), _bn("bn1", "bn1", 64)]
        cin = 64
        for li, n_blocks in enumerate(RESNET152_BLOCKS, start=1):
            width = 64 * 2 ** (li - 1)
            cout = width * RESNET_EXPANSION
            for bi in range(n_blocks):
                t, j = f"layer{li}.{bi}", f"layer{li}/{bi}"
                out += [_conv(f"{t}.conv1", f"{j}/conv1", 1, cin, width),
                        _bn(f"{t}.bn1", f"{j}/bn1", width),
                        _conv(f"{t}.conv2", f"{j}/conv2", 3, width, width),
                        _bn(f"{t}.bn2", f"{j}/bn2", width),
                        _conv(f"{t}.conv3", f"{j}/conv3", 1, width, cout),
                        _bn(f"{t}.bn3", f"{j}/bn3", cout)]
                if bi == 0:
                    out += [_conv(f"{t}.downsample.0", f"{j}/downsample/conv",
                                  1, cin, cout),
                            _bn(f"{t}.downsample.1", f"{j}/downsample/bn",
                                cout)]
                cin = cout
        return out
    if network == "densenet161":
        out = [_conv("features.conv0", "conv0", 7, 3, DENSENET_INIT),
               _bn("features.norm0", "norm0", DENSENET_INIT)]
        ch, inter = DENSENET_INIT, DENSENET_BN_SIZE * DENSENET_GROWTH
        for bi, n_layers in enumerate(DENSENET161_BLOCKS, start=1):
            for lj in range(n_layers):
                t = f"features.denseblock{bi}.denselayer{lj + 1}"
                j = f"block{bi}/{lj}"
                out += [_bn(f"{t}.norm1", f"{j}/norm1", ch),
                        _conv(f"{t}.conv1", f"{j}/conv1", 1, ch, inter),
                        _bn(f"{t}.norm2", f"{j}/norm2", inter),
                        _conv(f"{t}.conv2", f"{j}/conv2", 3, inter,
                              DENSENET_GROWTH)]
                ch += DENSENET_GROWTH
            if bi < 4:
                t, j = f"features.transition{bi}", f"trans{bi}"
                out += [_bn(f"{t}.norm", f"{j}/norm", ch),
                        _conv(f"{t}.conv", f"{j}/conv", 1, ch, ch // 2)]
                ch //= 2
        return out                                   # ch == 2208
    raise ValueError(f"unknown network {network!r}; use one of {NETWORKS}")


def _module(layer: Layer) -> nn.Module:
    if layer.kind == "bn":
        return nn.BatchNorm2d(layer.shape[0], eps=BN_EPS)
    kh, _, cin, cout = layer.shape
    return nn.Conv2d(cin, cout, kh, bias=layer.kind == "conv+b")


class VGG19(nn.Module):
    def __init__(self):
        super().__init__()
        self.features = nn.ModuleDict({
            layer.torch_name.split(".")[1]: _module(layer)
            for layer in encoder_layout("vgg19")})


class _Layout(nn.Module):
    """A module tree with the layout's names: each dotted name's parents
    are plain containers."""

    def __init__(self, network: str):
        super().__init__()
        for layer in encoder_layout(network):
            *path, leaf = layer.torch_name.split(".")
            parent = self
            for part in path:
                if not hasattr(parent, part):
                    parent.add_module(part, nn.Module())
                parent = getattr(parent, part)
            parent.add_module(leaf, _module(layer))


class ResNet152(_Layout):
    def __init__(self):
        super().__init__("resnet152")


class DenseNet161(_Layout):
    def __init__(self):
        super().__init__("densenet161")


_MODULES = {"vgg19": VGG19, "resnet152": ResNet152,
            "densenet161": DenseNet161}


def build_encoder(network: str) -> nn.Module:
    if network not in _MODULES:
        raise ValueError(f"unknown network {network!r}; use one of "
                         f"{NETWORKS}")
    return _MODULES[network]()


def init_encoder_params(network: str,
                        generator: torch.Generator) -> dict[str, np.ndarray]:
    """Random parameters in sat_tpu's flat layout (`{name}/w` HWIO,
    `{name}/b`; a batch norm's `scale`, `bias`, `mean`, `var`), drawn like
    sat_tpu's init (Kaiming normal on fan-out, zero bias, identity batch
    norms) from `generator`."""
    out = {}
    for layer in encoder_layout(network):
        j = layer.flat_name
        if layer.kind == "bn":
            ch = layer.shape[0]
            out.update({f"{j}/scale": np.ones(ch, np.float32),
                        f"{j}/bias": np.zeros(ch, np.float32),
                        f"{j}/mean": np.zeros(ch, np.float32),
                        f"{j}/var": np.ones(ch, np.float32)})
            continue
        kh, kw, _, cout = layer.shape
        std = math.sqrt(2.0 / (kh * kw * cout))
        out[f"{j}/w"] = (torch.randn(layer.shape, generator=generator)
                         * std).numpy()
        if layer.kind == "conv+b":
            out[f"{j}/b"] = np.zeros((cout,), np.float32)
    return out


def _weights(enc: nn.Module, dtype) -> dict:
    """{state_dict name: tensor} of the encoder's parameters and
    statistics for a forward in `dtype`: the module's own in float32, else
    the encoder's one cast copy, made anew only when a tensor was replaced
    (`.to()`) or written in place (`load_state_dict`). In the copy, convs
    are in `dtype` and batch norms in f32, rounded to `dtype`. Under
    torch.export the casts are traced instead, into the program (the
    tensors have no addresses to key a copy by)."""
    own = dict(enc.named_parameters()) | {
        k: v for k, v in enc.named_buffers() if v.is_floating_point()}
    if dtype == torch.float32:
        return own

    def cast():
        bn = {f"{name}.{part}" for name, m in enc.named_modules()
              if isinstance(m, nn.BatchNorm2d)
              for part in ("weight", "bias", "running_mean", "running_var")}
        with torch.no_grad():
            return {k: v.to(dtype).float() if k in bn else v.to(dtype)
                    for k, v in own.items()}

    if torch.compiler.is_exporting():
        return cast()
    key = (dtype, tuple((t.data_ptr(), t._version) for t in own.values()))
    cached = getattr(enc, "_cast_weights", None)
    if cached is None or cached[0] != key:
        cached = (key, cast())
        enc._cast_weights = cached
    return cached[1]


def _conv2d(w: dict, name: str, x, stride: int = 1, padding: int = 0):
    return F.conv2d(x, w[f"{name}.weight"], w.get(f"{name}.bias"), stride,
                    padding)


def _batch_norm(w: dict, name: str, x):
    return F.batch_norm(x, w[f"{name}.running_mean"],
                        w[f"{name}.running_var"], w[f"{name}.weight"],
                        w[f"{name}.bias"], False, 0.0, BN_EPS)


def vgg19_forward(enc: VGG19, x: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """x (B, H, W, 3) NHWC -> (B, H/16, W/16, 512) NHWC, computed in
    `dtype`."""
    w = _weights(enc, dtype)
    x = x.to(dtype).permute(0, 3, 1, 2)
    for op in vgg19_layer_plan():
        if op[0] == "pool":
            x = F.max_pool2d(x, kernel_size=2, stride=2)
        else:
            x = F.relu(_conv2d(w, f"features.{op[1]}", x, padding=1))
    return x.permute(0, 2, 3, 1)


def resnet152_forward(enc: ResNet152, x: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """x (B, H, W, 3) NHWC -> (B, H/32, W/32, 2048) NHWC."""
    w = _weights(enc, dtype)
    x = x.to(dtype).permute(0, 3, 1, 2)
    x = F.relu(_batch_norm(w, "bn1", _conv2d(w, "conv1", x, 2, 3)))
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    for li, n_blocks in enumerate(RESNET152_BLOCKS, start=1):
        for bi in range(n_blocks):
            p = f"layer{li}.{bi}"
            stride = 2 if li > 1 and bi == 0 else 1
            out = F.relu(_batch_norm(w, f"{p}.bn1",
                                     _conv2d(w, f"{p}.conv1", x)))
            out = F.relu(_batch_norm(w, f"{p}.bn2", _conv2d(
                w, f"{p}.conv2", out, stride, 1)))
            out = _batch_norm(w, f"{p}.bn3", _conv2d(w, f"{p}.conv3", out))
            if bi == 0:
                x = _batch_norm(w, f"{p}.downsample.1",
                                _conv2d(w, f"{p}.downsample.0", x, stride))
            x = F.relu(out + x)
    return x.permute(0, 2, 3, 1)


def densenet161_forward(enc: DenseNet161, x: torch.Tensor,
                        dtype=torch.float32) -> torch.Tensor:
    """x (B, H, W, 3) NHWC -> (B, H/32, W/32, 2208) NHWC, before norm5.
    Each dense layer concatenates its input and its 48 new channels."""
    w = _weights(enc, dtype)
    x = x.to(dtype).permute(0, 3, 1, 2)
    x = F.relu(_batch_norm(w, "features.norm0",
                           _conv2d(w, "features.conv0", x, 2, 3)))
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    for bi, n_layers in enumerate(DENSENET161_BLOCKS, start=1):
        for lj in range(1, n_layers + 1):
            p = f"features.denseblock{bi}.denselayer{lj}"
            out = _conv2d(w, f"{p}.conv1",
                          F.relu(_batch_norm(w, f"{p}.norm1", x)))
            out = _conv2d(w, f"{p}.conv2",
                          F.relu(_batch_norm(w, f"{p}.norm2", out)),
                          padding=1)
            x = torch.cat([x, out], dim=1)
        if bi < 4:
            t = f"features.transition{bi}"
            x = _conv2d(w, f"{t}.conv",
                        F.relu(_batch_norm(w, f"{t}.norm", x)))
            x = F.avg_pool2d(x, kernel_size=2, stride=2)
    return x.permute(0, 2, 3, 1)


_FORWARD = {"vgg19": vgg19_forward, "resnet152": resnet152_forward,
            "densenet161": densenet161_forward}


@torch.inference_mode()
def encoder_forward(enc: nn.Module, network: str, images,
                    compute_dtype=None) -> torch.Tensor:
    """images (B, S, S, 3) NHWC -> annotation grid (B, L, C) float32,
    contiguous, on the encoder's device. `compute_dtype` (None: float32;
    torch.bfloat16) is the network's dtype (module note).

    The grid is a view of the last layer's output, whose memory format the
    convolution picks (on the card it varied with the batch size), so it is
    made contiguous here: the attention kernels take only contiguous
    features."""
    return encoder_grid(enc, network, images, compute_dtype)


def encoder_grid(enc: nn.Module, network: str, images,
                 compute_dtype=None) -> torch.Tensor:
    """`encoder_forward` without inference mode, for a program that
    torch.export traces (engine/serving.py)."""
    if network not in _FORWARD:
        raise ValueError(f"unknown network {network!r}; use one of "
                         f"{NETWORKS}")
    dev = next(enc.parameters()).device
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    x = _FORWARD[network](enc, images, compute_dtype or torch.float32)
    B, H, W, C = x.shape
    return x.reshape(B, H * W, C).float().contiguous()
