"""The vocabulary split over a model group: the collectives of the head.

sat_tpu shards the embedding's rows and the output heads' columns over its
`model` axis and lets GSPMD insert the collectives; here a decoder built
with a `VocabShard` holds V/M rows of `embedding` and V/M outputs of
`deep_output` and `f_out`, and these functions make the collectives
explicit, over the shard's model group. Each is built on the SUM
all-reduce, which gloo carries for CUDA tensors:

  - `reduce_from_model`: the sum of the group's partial tensors, forward;
    the gradient passes unchanged backward (each rank's partial receives
    the replicated gradient of the sum). The embedding's lookup (ids
    outside the rank's rows give zero rows) and the loss's sums go
    through it.
  - `copy_to_model`: the identity forward; the SUM of the gradient over
    the group backward. The head's input goes through it: each rank's
    logits see only its own columns, so the gradient that reaches the
    replicated layers below the head is the group's sum.
  - `model_gather`: every rank's tensor, stacked in group order (no
    gradient): the per-rank maxima and candidates that the argmax, the
    cross-entropy's stabilizer and the beam's merge read.

The orders are `lax.top_k`'s and argmax's over the whole vocabulary: a
shard holds a contiguous range of global ids, so the lowest index among
equal values is the lowest rank's lowest local index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed


class VocabShard(NamedTuple):
    """Rank `index` of a model group of `count` ranks (`group`), holding
    global ids [offset, offset + rows) of a vocabulary of `vocab`."""
    index: int
    count: int
    group: object
    vocab: int

    @property
    def rows(self) -> int:
        return self.vocab // self.count

    @property
    def offset(self) -> int:
        return self.index * self.rows


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    torch.distributed.all_reduce(x, group=group)
    return x


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(), ctx.group), None


def reduce_from_model(x: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """The group's sum of `x`; the gradient passes through (module note)."""
    return _Reduce.apply(x, shard.group)


def copy_to_model(x: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """`x`; its gradient summed over the group (module note)."""
    return _Copy.apply(x, shard.group)


@torch.no_grad()
def model_gather(x: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """(M, *x.shape): every rank's `x` in group order, by a SUM of
    zero-filled slots (a -0.0 comes back +0.0)."""
    out = x.new_zeros((shard.count,) + tuple(x.shape))
    out[shard.index] = x
    return _all_reduce(out, shard.group)


def embed(weight: torch.Tensor, ids: torch.Tensor,
          shard: VocabShard) -> torch.Tensor:
    """The rows of global `ids` from the group's shards of the table:
    this rank's rows looked up, the others zero, summed over the group."""
    local = ids - shard.offset
    inside = (local >= 0) & (local < shard.rows)
    rows = torch.nn.functional.embedding(torch.where(inside, local, 0),
                                         weight)
    return reduce_from_model(torch.where(inside[..., None], rows, 0.0),
                             shard)


def pick(x: torch.Tensor, ids: torch.Tensor,
         shard: VocabShard) -> torch.Tensor:
    """x[..., ids] over the sharded last dim: each id's value from the
    rank that holds it, with its gradient there."""
    local = ids.long() - shard.offset
    inside = (local >= 0) & (local < shard.rows)
    v = x.gather(-1, local.clamp(0, shard.rows - 1)[..., None])[..., 0]
    return reduce_from_model(torch.where(inside, v, 0.0), shard)


@torch.no_grad()
def argmax(x: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """Global argmax over the sharded last dim of x: the lowest index
    among the maxima, as torch.argmax gives it on the whole row."""
    values, idx = x.max(dim=-1)
    values = model_gather(values, shard)                     # (M, ...)
    idx = model_gather(idx + shard.offset, shard)
    return idx.gather(0, values.argmax(dim=0)[None])[0]


def nll(logits: torch.Tensor, labels: torch.Tensor,
        shard: VocabShard) -> torch.Tensor:
    """-log_softmax(logits)[labels] over the sharded last dim: the row
    maxima gathered (a stabilizer, no gradient), the sums of exponentials
    and the label's logit summed over the group."""
    with torch.no_grad():
        top = model_gather(logits.max(dim=-1).values, shard).max(dim=0).values
    shifted = logits - top[..., None]
    total = reduce_from_model(shifted.exp().sum(dim=-1), shard)
    return torch.log(total) - pick(shifted, labels, shard)


@torch.no_grad()
def in_top_k(preds: torch.Tensor, targets: torch.Tensor, k: int,
             shard: VocabShard) -> torch.Tensor:
    """(...,) bool: targets among the k first of preds in lax.top_k's
    order (value descending, lower index first), over the sharded last
    dim: the entries before the target counted on each rank and summed."""
    t = targets.long()[..., None]
    tv = pick(preds, targets, shard)[..., None]
    idx = torch.arange(shard.offset, shard.offset + shard.rows,
                       device=preds.device)
    before = ((preds > tv) | ((preds == tv) & (idx < t))).sum(dim=-1)
    return _all_reduce(before, shard.group) < k


@torch.no_grad()
def merge_top_k(values: torch.Tensor, flat: torch.Tensor, k: int,
                shard: VocabShard):
    """The k first of the group's candidates: each rank's (B, k) values
    and global indices, gathered to (B, M*k) and ordered by value
    descending, then index ascending (lax.top_k's order). Returns
    (values (B, k), indices (B, k))."""
    v = model_gather(values, shard).permute(1, 0, 2).flatten(1)
    i = model_gather(flat, shard).permute(1, 0, 2).flatten(1)
    by_index = i.argsort(dim=1, stable=True)
    v, i = v.gather(1, by_index), i.gather(1, by_index)
    order = v.argsort(dim=1, descending=True, stable=True)[:, :k]
    return v.gather(1, order), i.gather(1, order)
