"""Fused soft-attention forward: CUDA kernel + plain form.

Port of the forward half of sat_tpu/ops/fused_attention.py. Computes the
middle of the attention block, between the two projections that stay plain
matmuls (keys = W a + b_W, once per image; u_h = U h + b_U, each step):

    att   = tanh(keys + u_h)        (B, R, L, E), never stored by the kernel
    e     = att . v + b_v           (B, R, L)
    alpha = softmax_L(e)
    ctx   = sum_l alpha_l feats_l   (B, R, D)

`rows_per_image` R lets one image's keys and features serve R hidden rows:
R = 1 is sat_tpu's `fused_attention_block`; R = K is the de-duplicated beam
step (sat_tpu/models/beam.py::_decode_step_shared), where u_h row b*K + j
belongs to image b.

The kernel (csrc/attention_fwd.cu) replaces
sat_tpu/ops/fused_attention.py::_attention_kernel; its source note gives the
bound and the design. In sat_tpu the kernel was opt-in because XLA already
fused the plain graph; eager PyTorch fuses nothing, so on the card the
kernel is the default and the plain form writes the whole tanh tensor.
`attention_fwd` runs the plain form for CPU tensors only; for CUDA tensors
it launches the kernel or raises. The backward kernel (training) is not
ported yet.
"""

from __future__ import annotations

import torch

from sat_tpu_torch.ops import _kernels


def _shapes(keys, feats, u_h, v, b_v, rows_per_image):
    if keys.dim() != 3 or feats.dim() != 3 or u_h.dim() != 2:
        raise ValueError("attention_fwd wants keys (B, L, E), feats "
                         "(B, L, D) and u_h (B*R, E)")
    B, L, E = keys.shape
    D = feats.shape[2]
    R = rows_per_image
    if (R < 1 or B < 1 or feats.shape[:2] != (B, L)
            or tuple(u_h.shape) != (B * R, E) or tuple(v.shape) != (E,)
            or tuple(b_v.shape) != (1,)):
        raise ValueError(
            f"attention_fwd shapes do not agree: keys {tuple(keys.shape)}, "
            f"feats {tuple(feats.shape)}, u_h {tuple(u_h.shape)}, "
            f"v {tuple(v.shape)}, b_v {tuple(b_v.shape)}, "
            f"rows_per_image {R}")
    return B, R, L, E, D


def attention_plain(keys, feats, u_h, v, b_v, rows_per_image: int = 1):
    """(ctx (B*R, D), alpha (B*R, L)) by plain tensor ops."""
    B, R, L, E, D = _shapes(keys, feats, u_h, v, b_v, rows_per_image)
    att = torch.tanh(keys[:, None] + u_h.view(B, R, 1, E))     # (B, R, L, E)
    e = att @ v + b_v                                           # (B, R, L)
    alpha = torch.softmax(e, dim=-1)
    ctx = torch.bmm(alpha, feats)                               # (B, R, D)
    return ctx.reshape(B * R, D), alpha.reshape(B * R, L)


def attention_fwd(keys, feats, u_h, v, b_v, rows_per_image: int = 1):
    """keys (B, L, E), feats (B, L, D), u_h (B*R, E), v (E,), b_v (1,), all
    f32 -> (ctx (B*R, D), alpha (B*R, L)), as `attention_plain`."""
    B, R, L, E, D = _shapes(keys, feats, u_h, v, b_v, rows_per_image)
    tensors = (keys, feats, u_h, v, b_v)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("attention_fwd is float32-only")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"attention_fwd inputs on several devices: {devices}")
    dev = keys.device
    if dev.type == "cpu":
        return attention_plain(keys, feats, u_h, v, b_v, rows_per_image)
    if dev.type != "cuda":
        raise ValueError(f"attention_fwd runs on cuda or cpu tensors, "
                         f"got {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("attention_fwd wants contiguous inputs")
    ctx = torch.empty((B * R, D), dtype=torch.float32, device=dev)
    alpha = torch.empty((B * R, L), dtype=torch.float32, device=dev)
    lib = _kernels.library()
    with torch.cuda.device(dev):
        rc = lib.sat_attention_fwd_f32(
            keys.data_ptr(), feats.data_ptr(), u_h.data_ptr(), v.data_ptr(),
            b_v.data_ptr(), ctx.data_ptr(), alpha.data_ptr(),
            B, R, L, E, D, torch.cuda.current_stream().cuda_stream)
    _kernels.check_launch("attention_fwd", rc)
    attention_fwd.launches += 1
    return ctx, alpha


attention_fwd.launches = 0   # kernel launches; CPU calls do not count
