"""Fused soft attention, forward and backward: CUDA kernels + plain forms.

Port of sat_tpu/ops/fused_attention.py. Computes the middle of the
attention block, between the two projections that stay plain matmuls
(keys = W a + b_W, once per image; u_h = U h + b_U, each step):

    att   = tanh(keys + u_h)        (B, R, L, E), never stored by the kernel
    e     = att . v + b_v           (B, R, L)
    alpha = softmax_L(e)
    ctx   = sum_l alpha_l feats_l   (B, R, D)

`rows_per_image` R lets one image's keys and features serve R hidden rows:
R = 1 is sat_tpu's `fused_attention_block`; R = K is the de-duplicated beam
step (sat_tpu/models/beam.py::_decode_step_shared), where u_h row b*K + j
belongs to image b.

The kernel (csrc/attention_fwd.cu) replaces
sat_tpu/ops/fused_attention.py::_attention_kernel. In sat_tpu the kernel
was opt-in because XLA already fused the plain graph; eager PyTorch fuses
nothing, so on the card the kernel is the default and the plain form writes
the whole tanh tensor. `attention_fwd` runs the plain form for CPU tensors
only; for CUDA tensors it launches the kernel or raises.

Training differentiates the block at R = 1 through `FusedAttention`, the
counterpart of sat_tpu's custom VJP (`fused_attention_trainable`): its
forward is `attention_fwd` and saves only the inputs and alpha; its
backward is `attention_bwd` (csrc/attention_bwd.cu, replacing
`_attention_bwd_kernel`), which recomputes the tanh instead of reading a
saved (B, L, E) tensor. `attention_bwd` too runs its plain form for CPU
tensors only, so the CPU tests drive the same autograd wiring.

Both kernels are memory-bound: each must read keys and features once (and
the backward write dkeys), 51 MB at the training shape (B = 64, L = 196,
E = D = 512), 15 us at the H100's 3.35 TB/s; at the beam's R = 5 the
precise tanh is the nearer second limit. Each launches one cluster of 8
thread blocks per image (csrc/attention_common.cuh): a block owns ceil(L/8)
contiguous rows and streams them through a ring of shared-memory tiles
filled by bulk asynchronous copies; the softmax statistics, the context and
the du_h / dv sums cross the cluster through distributed shared memory in
rank order, so a launch needs no device scratch and gives the same bits
every run. The bulk copies need E and D to be multiples of 4 and keys and
features to start on a 16-byte boundary; the wrappers raise otherwise.

In a CUDA graph: both wrappers launch on the current stream and allocate
through PyTorch, so a capture records them. The first launch of each shape
runs the cluster placement check (csrc/cluster.cuh: cudaFuncSetAttribute,
cudaOccupancyMaxActiveClusters), which must happen before a capture:
utils/graphs.py's warm-up run makes it. `attention_fwd.launches` and
`attention_bwd.launches` count on the host, where the wrappers run: a
capture counts once and its replays never, so on a graph path count the
kernels' rows in a profile instead.

bf16: keys and features may both be stored in bfloat16 (sat_tpu's
`--bf16-attention` and bf16 decode), and every other input stays float32.
The middle is computed in float32 on every device: the tanh, the scores,
the softmax and the context, from the keys and features widened exactly,
which is what sat_tpu's Pallas kernels compute on bf16 inputs. On the card
the bf16 variants of the two kernels (sat_attention_{fwd,bwd}_bf16, the
same CUDA templated on the storage type) read half the bytes a row; on the
CPU the plain forms widen first. ctx, alpha, du_h, dv and db_v are float32;
the backward returns dkeys (and dfeats) in the dtype of keys (features),
rounded to nearest even from the float32 value, the bits autograd would
make of a float32 dkeys on its way back through the cast of the keys. A
bf16 call needs E and D multiples of 8 (16-byte rows). Any other mix of
dtypes raises: nothing is widened quietly to run the float32 kernel. The
bf16 launches are counted apart, in `attention_fwd.launches_bf16` and
`attention_bwd.launches_bf16`.
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


GRID_DTYPES = (torch.float32, torch.bfloat16)


def _grid_dtype(name, keys, feats, others):
    """The storage dtype of keys and features: both float32 or both
    bfloat16, with every other tensor float32."""
    if (keys.dtype != feats.dtype or keys.dtype not in GRID_DTYPES
            or any(t.dtype != torch.float32 for t in others)):
        raise TypeError(
            f"{name} takes keys and feats both float32 or both bfloat16 and "
            f"the rest float32, got keys {keys.dtype}, feats {feats.dtype}, "
            f"others {sorted({str(t.dtype) for t in others})}")
    return keys.dtype


def _check_layout(name, keys, feats):
    """What the CUDA kernels' bulk copies need: rows of E and D elements
    that are whole 16-byte units (E and D multiples of 4 in float32, of 8
    in bf16), from 16-byte aligned starts."""
    E, D = keys.shape[2], feats.shape[2]
    group = 16 // keys.element_size()
    if E % group or D % group:
        raise ValueError(f"{name} on CUDA wants E and D multiples of "
                         f"{group} for {keys.dtype}, got E = {E}, D = {D}")
    if keys.data_ptr() % 16 or feats.data_ptr() % 16:
        raise ValueError(f"{name} on CUDA wants keys and feats 16-byte "
                         f"aligned")


def attention_plain(keys, feats, u_h, v, b_v, rows_per_image: int = 1):
    """(ctx (B*R, D), alpha (B*R, L)) by plain tensor ops, in float32 from
    keys and features widened (module note)."""
    B, R, L, E, D = _shapes(keys, feats, u_h, v, b_v, rows_per_image)
    keys, feats = keys.float(), feats.float()
    att = torch.tanh(keys[:, None] + u_h.view(B, R, 1, E))     # (B, R, L, E)
    e = att @ v + b_v                                           # (B, R, L)
    alpha = torch.softmax(e, dim=-1)
    ctx = torch.bmm(alpha, feats)                               # (B, R, D)
    return ctx.reshape(B * R, D), alpha.reshape(B * R, L)


def attention_fwd(keys, feats, u_h, v, b_v, rows_per_image: int = 1):
    """keys (B, L, E), feats (B, L, D) both f32 or both bf16, u_h (B*R, E),
    v (E,), b_v (1,) f32 -> (ctx (B*R, D), alpha (B*R, L)) f32, as
    `attention_plain`. A CUDA graph may capture it once its shape has
    launched outside the capture (module note)."""
    B, R, L, E, D = _shapes(keys, feats, u_h, v, b_v, rows_per_image)
    tensors = (keys, feats, u_h, v, b_v)
    bf16 = _grid_dtype("attention_fwd", keys, feats,
                       (u_h, v, b_v)) == torch.bfloat16
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
    _check_layout("attention_fwd", keys, feats)
    ctx = torch.empty((B * R, D), dtype=torch.float32, device=dev)
    alpha = torch.empty((B * R, L), dtype=torch.float32, device=dev)
    lib = _kernels.library()
    entry = (lib.sat_attention_fwd_bf16 if bf16
             else lib.sat_attention_fwd_f32)
    with torch.cuda.device(dev):
        rc = entry(
            keys.data_ptr(), feats.data_ptr(), u_h.data_ptr(), v.data_ptr(),
            b_v.data_ptr(), ctx.data_ptr(), alpha.data_ptr(),
            B, R, L, E, D, torch.cuda.current_stream().cuda_stream)
    _kernels.check_launch("attention_fwd", rc)
    if bf16:
        _kernels.count(attention_fwd, "launches_bf16")
    else:
        _kernels.count(attention_fwd)
    return ctx, alpha


# host calls that launch the f32 and the bf16 kernel; not CPU, not replays
attention_fwd.launches = 0
attention_fwd.launches_bf16 = 0


def _bwd_check(keys, feats, u_h, v, alpha, dctx, dalpha):
    if keys.dim() != 3 or feats.dim() != 3:
        raise ValueError("attention_bwd wants keys (B, L, E) and feats "
                         "(B, L, D)")
    B, L, E = keys.shape
    D = feats.shape[2]
    want = {"feats": (feats, (B, L, D)), "u_h": (u_h, (B, E)),
            "v": (v, (E,)), "alpha": (alpha, (B, L)),
            "dctx": (dctx, (B, D)), "dalpha": (dalpha, (B, L))}
    bad = {k: tuple(t.shape) for k, (t, shape) in want.items()
           if tuple(t.shape) != shape}
    if B < 1 or bad:
        raise ValueError(f"attention_bwd shapes do not agree with keys "
                         f"{tuple(keys.shape)}: {bad}")
    return B, L, E, D


def attention_bwd_plain(keys, feats, u_h, v, alpha, dctx, dalpha,
                        want_dfeats: bool = True):
    """The VJP of `attention_plain` at R = 1, by plain tensor ops:
    (dkeys (B, L, E), dfeats (B, L, D) or None, du_h (B, E), dv (E,),
    db_v (1,)). The tanh is recomputed from keys and u_h. In float32 from
    keys and features widened; dkeys and dfeats are rounded to their
    dtypes (module note)."""
    _bwd_check(keys, feats, u_h, v, alpha, dctx, dalpha)
    grid_dtype = keys.dtype
    keys, feats = keys.float(), feats.float()
    att = torch.tanh(keys + u_h[:, None, :])                     # (B, L, E)
    dfeats = alpha[:, :, None] * dctx[:, None, :] if want_dfeats else None
    g = torch.bmm(feats, dctx[:, :, None])[:, :, 0] + dalpha       # (B, L)
    de = alpha * (g - (alpha * g).sum(dim=1, keepdim=True))       # (B, L)
    dpre = (de[:, :, None] * v) * (1.0 - att * att)
    dv = (att * de[:, :, None]).sum(dim=(0, 1))
    return (dpre.to(grid_dtype),
            None if dfeats is None else dfeats.to(grid_dtype),
            dpre.sum(dim=1), dv, de.sum().reshape(1))


def attention_bwd(keys, feats, u_h, v, alpha, dctx, dalpha,
                  want_dfeats: bool = True):
    """As `attention_bwd_plain`; on CUDA tensors one kernel launch, with
    dfeats neither computed nor written unless `want_dfeats`. A CUDA graph
    may capture it once its shape has launched outside the capture (module
    note)."""
    B, L, E, D = _bwd_check(keys, feats, u_h, v, alpha, dctx, dalpha)
    tensors = (keys, feats, u_h, v, alpha, dctx, dalpha)
    grid_dtype = _grid_dtype("attention_bwd", keys, feats,
                             (u_h, v, alpha, dctx, dalpha))
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"attention_bwd inputs on several devices: {devices}")
    dev = keys.device
    if dev.type == "cpu":
        return attention_bwd_plain(keys, feats, u_h, v, alpha, dctx, dalpha,
                                   want_dfeats)
    if dev.type != "cuda":
        raise ValueError(f"attention_bwd runs on cuda or cpu tensors, "
                         f"got {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("attention_bwd wants contiguous inputs")
    _check_layout("attention_bwd", keys, feats)
    f32 = {"dtype": torch.float32, "device": dev}
    grid = {"dtype": grid_dtype, "device": dev}
    dkeys = torch.empty((B, L, E), **grid)
    dfeats = torch.empty((B, L, D), **grid) if want_dfeats else None
    du_h = torch.empty((B, E), **f32)
    dv_part = torch.empty((B, E), **f32)      # one partial per image, summed
    dbv_part = torch.empty((B,), **f32)       # below in a fixed order
    lib = _kernels.library()
    bf16 = grid_dtype == torch.bfloat16
    entry = (lib.sat_attention_bwd_bf16 if bf16
             else lib.sat_attention_bwd_f32)
    with torch.cuda.device(dev):
        rc = entry(
            keys.data_ptr(), feats.data_ptr(), u_h.data_ptr(), v.data_ptr(),
            alpha.data_ptr(), dctx.data_ptr(), dalpha.data_ptr(),
            dkeys.data_ptr(), dfeats.data_ptr() if want_dfeats else None,
            du_h.data_ptr(), dv_part.data_ptr(), dbv_part.data_ptr(),
            B, L, E, D, torch.cuda.current_stream().cuda_stream)
    _kernels.check_launch("attention_bwd", rc)
    if bf16:
        _kernels.count(attention_bwd, "launches_bf16")
    else:
        _kernels.count(attention_bwd)
    return dkeys, dfeats, du_h, dv_part.sum(dim=0), dbv_part.sum().reshape(1)


# host calls that launch the f32 and the bf16 kernel; not CPU, not replays
attention_bwd.launches = 0
attention_bwd.launches_bf16 = 0


class FusedAttention(torch.autograd.Function):
    """(ctx (B, D), alpha (B, L)) = attention_fwd(keys, feats, u_h, v, b_v)
    at R = 1, differentiable in all five inputs. Saved for the backward:
    the inputs and alpha (sat_tpu's `_fat_fwd` residuals), never the tanh.
    dfeats is computed only when feats needs a gradient; in bank training
    the features are data and it is skipped."""

    @staticmethod
    def forward(ctx, keys, feats, u_h, v, b_v):
        out, alpha = attention_fwd(keys, feats, u_h, v, b_v, 1)
        ctx.save_for_backward(keys, feats, u_h, v, alpha)
        return out, alpha

    @staticmethod
    def backward(ctx, dctx, dalpha):
        keys, feats, u_h, v, alpha = ctx.saved_tensors
        dkeys, dfeats, du_h, dv, db_v = attention_bwd(
            keys, feats, u_h, v, alpha, dctx.contiguous(),
            dalpha.contiguous(), want_dfeats=ctx.needs_input_grad[1])
        return dkeys, dfeats, du_h, dv, db_v


def fused_soft_attention(attn, features, hidden, keys):
    """Port of sat_tpu's `fused_soft_attention`: u_h = U h + b_U, then the
    differentiable fused block. `attn` is the port's Attention module."""
    u_h = attn.U(hidden)
    return FusedAttention.apply(keys, features, u_h, attn.v.weight.view(-1),
                                attn.v.bias)
