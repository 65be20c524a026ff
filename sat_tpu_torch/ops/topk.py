"""Exact top-k over the flat beam-candidate rows: CUDA kernel + plain form.

Port of sat_tpu/ops/topk.py. The beam's token parity rests on the order of
`lax.top_k`, which the JAX package's Pallas kernel reproduces and so does
this one:
  - entries ordered by value, descending; the lower index wins a tie;
  - NaN ranks as -inf (its value comes back as -inf);
  - an all -inf row gives indices 0..k-1.
`torch.topk` documents no order among equal values, so it is not the plain
form: that is a stable descending sort after NaN -> -inf.

The kernel (csrc/topk.cu) replaces sat_tpu/ops/topk.py::_topk_kernel; its
source note gives the bound and the design. For k <= 16, one pass over each
row, split across a thread-block cluster of `cluster_size(B)` blocks. For
every k > 16, one block a row: the row read once into shared memory (or,
above 53,245 entries, read from device memory in each sweep), a bound below
the k-th largest from the threads' maxima (k <= 1,024), the entries above
it taken in index order (and, when more than 1,024 stay, narrowed by a
radix select in at most three passes whatever k), then a sort of the
survivors: bitonic for k <= 1,024, a stable radix sort of the k indices
above; its bound is the row's bytes read once and the k values and indices
written. Where the radix sort's index buffers do not fit the block's shared
memory (BERT's rows past k = 19,228), they lie in a workspace that `launch`
allocates on the current stream for the call.

`topk` checks its input and calls the operator `sat::topk`, whose CPU
implementation is the plain form and whose CUDA implementation
(`topk_cuda`) launches the kernel or raises; its fake implementation gives
the shapes for tracing (torch.export), so an exported program holds the
operator and runs the kernel on the card.

In a CUDA graph: the wrapper launches on the current stream and allocates
through PyTorch, so a capture records it. The first launch of each shape
(cluster size, shared memory) runs the kernel's placement check
(csrc/cluster.cuh: cudaFuncSetAttribute, cudaOccupancyMaxActiveClusters),
which must happen before a capture: utils/graphs.py's warm-up run makes it.
`topk.launches` counts on the host, where the wrapper runs: a capture counts
once and its replays never, so on a graph path count the kernel's rows in a
profile instead.

`topk_library` is the library route, the counterpart of sat_tpu's
`lax.top_k` (its beam's `pallas_topk=False`, and `fast_topk`, whose
`approx_max_k(aggregate_to_topk=True)` is exact off the TPU): a stable
descending `torch.sort` cut to k, which keeps `lax.top_k`'s order (value
descending, lower index first among equal values, NaN first). It is not a
port of the kernel and launches none; a caller selects it by a flag, and
nothing falls back to it.
"""

from __future__ import annotations

import ctypes

import torch

from sat_tpu_torch.ops import _kernels


def topk_library(x: torch.Tensor, k: int):
    """(values (B, k) f32, indices (B, k) int64) of lax.top_k: a stable
    descending sort of each row of x (B, N), cut to k. `torch.topk`
    documents no order among equal values, so it is not used."""
    values, indices = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k].contiguous(), indices[:, :k].contiguous()


def topk_plain(x: torch.Tensor, k: int):
    """(values (B, k) f32, indices (B, k) int64), in lax.top_k's order."""
    x = torch.where(torch.isnan(x), float("-inf"), x)
    values, indices = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k].contiguous(), indices[:, :k].contiguous()


# Blocks a launch aims for, and the most blocks a row (the kernel's limit:
# rank 0's warp merges one list a lane). On the H100 (chip_smoke.py's
# `ms_by_cluster`), 4 blocks a row were fastest at B = 1 and 32 and 2 at
# B = 128.
TARGET_BLOCKS = 256
MAX_CLUSTER = 4


def cluster_size(rows: int) -> int:
    """Blocks per row of the one-pass kernel: the fewest of 1, 2 and 4 that
    give `rows` rows at least TARGET_BLOCKS blocks."""
    c = 1
    while c < MAX_CLUSTER and rows * c < TARGET_BLOCKS:
        c *= 2
    return c


def topk(x: torch.Tensor, k: int):
    """Exact top-k of each row of x (B, N) f32: (values (B, k) f32,
    indices (B, k) int64), the same values and indices as `topk_plain`,
    through the operator `sat::topk` (module note). A CUDA graph may
    capture it once its shape has launched outside the capture (module
    note)."""
    if x.dim() != 2:
        raise ValueError(f"topk wants (B, N), got shape {tuple(x.shape)}")
    B, N = x.shape
    if not 0 < k <= N or B < 1:
        raise ValueError(f"topk needs B >= 1 and 0 < k <= N, got B={B}, "
                         f"N={N}, k={k}")
    if x.dtype != torch.float32:
        raise TypeError(f"topk is float32-only, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"topk runs on cuda or cpu tensors, got {x.device}")
    return torch.ops.sat.topk(x, k)


def topk_cuda(x: torch.Tensor, k: int):
    """`sat::topk` on a CUDA tensor: one launch of the kernel, with
    `cluster_size(B)` blocks a row."""
    if not x.is_contiguous():
        raise ValueError("topk wants a contiguous input")
    return launch(x, k, cluster_size(x.shape[0]))


def launch(x: torch.Tensor, k: int, cluster: int):
    """One launch of the kernel on a checked CUDA tensor x (B, N), with
    `cluster` (1..MAX_CLUSTER) blocks a row (k <= 16; larger k ignores
    it), and the workspace the kernel asks for at (N, k), if any."""
    B, N = x.shape
    values = torch.empty((B, k), dtype=torch.float32, device=x.device)
    indices = torch.empty((B, k), dtype=torch.int64, device=x.device)
    lib = _kernels.library()
    with torch.cuda.device(x.device):
        row_bytes = ctypes.c_int64(0)
        _kernels.check_launch("topk", lib.sat_topk_workspace_bytes(
            N, k, ctypes.addressof(row_bytes)))
        workspace = (torch.empty(B * row_bytes.value, dtype=torch.uint8,
                                 device=x.device)
                     if row_bytes.value else None)
        rc = lib.sat_topk_f32(x.data_ptr(), values.data_ptr(),
                              indices.data_ptr(), B, N, k, cluster,
                              None if workspace is None
                              else workspace.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    _kernels.check_launch("topk", rc)
    _kernels.count(topk)
    return values, indices


topk.launches = 0   # host calls that launch; not CPU calls, not replays


def topk_fake(x: torch.Tensor, k: int):
    """`sat::topk`'s shapes and dtypes, for tracing (torch.export): no
    launch."""
    B = x.shape[0]
    return x.new_empty((B, k)), x.new_empty((B, k), dtype=torch.int64)


# the operator (ops/__init__.py: the namespace and its rules)
_LIB = torch.library.Library("sat", "FRAGMENT")
_LIB.define("topk(Tensor x, int k) -> (Tensor values, Tensor indices)")
_LIB.impl("topk", topk_plain, "CPU")
_LIB.impl("topk", topk_cuda, "CUDA")
torch.library.register_fake("sat::topk", topk_fake, lib=_LIB)
