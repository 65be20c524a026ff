"""Least times of the port's three kernels, in seconds: each input byte
read once and each output byte written once over the memory rate, or the
float32 operations over the float32 rate, whichever is larger. Copied from
chip_smoke.py (`topk_bound`, `fwd_bound_parts`, the backward's `parts` in
`attention_bwd_row`), which PERF.md's kernel table uses."""

from __future__ import annotations


def topk(rows: int, n: int, k: int, peaks: dict) -> float:
    """Exact top-k of (rows, n) f32: n read, k f32 values and k int64
    indices written a row; or one compare an entry."""
    t_bytes = (4 * rows * n + rows * k * (4 + 8)) / peaks["bytes_s"]
    t_ops = rows * n / peaks["f32_s"]
    return max(t_bytes, t_ops)


def attention_fwd(images: int, R: int, L: int, D: int, E: int,
                  peaks: dict, grid_bytes: int = 4) -> float:
    """The forward: keys (images, L, E) and features (images, L, D) read,
    u_h (images R, E), v and b_v read, context (images R, D) and alpha
    (images R, L) written; the score's add and multiply-add and the
    context's multiply-add."""
    bytes_ = (grid_bytes * images * L * (E + D)
              + 4 * (images * R * (E + D + L) + E + 1))
    flops = 2 * images * R * L * E + 2 * images * R * L * D
    return max(bytes_ / peaks["bytes_s"], flops / peaks["f32_s"])


def attention_bwd(images: int, L: int, D: int, E: int, peaks: dict,
                  grid_bytes: int = 4, with_dfeats: bool = False) -> float:
    """The backward at R = 1: keys read, dkeys written, features read
    (and dfeats written when asked), u_h, v, alpha, dctx, dalpha read, du_h,
    dv and db_v written; per (b, l, e) eight operations, per (b, l, d) two
    (three with dfeats)."""
    n_le, n_ld = images * L * E, images * L * D
    bytes_ = (grid_bytes * (2 * n_le + n_ld + (n_ld if with_dfeats else 0))
              + 4 * (2 * images * E + 2 * images * L + images * D
                     + 2 * E + 1))
    flops = 8 * n_le + (3 if with_dfeats else 2) * n_ld
    return max(bytes_ / peaks["bytes_s"], flops / peaks["f32_s"])
