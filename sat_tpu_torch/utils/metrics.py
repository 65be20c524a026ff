"""Token-level metrics and the reference's loss.

Port of sat_tpu/utils/metrics.py, with the reference's quirks kept:
 - sequence_accuracy masks padding (reference utils.py:44-80);
 - the cross-entropy keeps PAD tokens and drops only the final timestep of
   every row (reference train.py:149-151);
 - the doubly-stochastic attention regularizer is
   alpha_c * mean((1 - sum_t alpha)^2) (reference train.py:154).

`row_mask` (B,) bool marks the real rows of a padded batch; None means all
rows are real. Top-k membership follows `lax.top_k`'s order (value
descending, lower index first among equal values), so that ties, which the
ado head's ReLU'd logits have in plenty, count as they do in sat_tpu:
the target is in the top k when fewer than k entries come before it.

`n_rows` is for data-parallel training (parallel/train_step.py): the real
rows of the whole global batch, of which this rank holds some. A loss term
given it divides its masked sum by the global count instead of its own, so
that the ranks' terms sum to the global batch's mean; `top_k_hits` gives an
accuracy's numerator and denominator apart, for the same reason.

`shard` (a parallel.vocab.VocabShard) is for the vocab-sharded head: preds
hold the rank's columns of the vocabulary, and the terms that read across
it (the cross-entropy's normalizer and target logit, top-k membership,
the argmax of the repetition penalty) reduce over the model group, so that
every rank of the group computes the whole vocabulary's numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sat_tpu_torch.parallel import vocab as vp


def _in_top_k(preds: torch.Tensor, targets: torch.Tensor, k: int,
              shard=None):
    """(...,) bool: targets (...) among the k first of preds (..., V) in
    lax.top_k's order."""
    if shard is not None:
        return vp.in_top_k(preds, targets, k, shard)
    t = targets.long()[..., None]
    tv = preds.gather(-1, t)
    idx = torch.arange(preds.shape[-1], device=preds.device)
    before = (preds > tv) | ((preds == tv) & (idx < t))
    return before.sum(dim=-1) < k


def legacy_accuracy(preds: torch.Tensor, targets: torch.Tensor,
                    k: int) -> torch.Tensor:
    """The reference's original top-k accuracy (reference utils.py:22-42):
    hits over (N, V) preds and (N,) targets, times 100 / N. Not used by the
    training loop."""
    return _in_top_k(preds, targets, k).sum() * (100.0 / targets.shape[0])


def top_k_hits(preds: torch.Tensor, targets: torch.Tensor, k: int,
               ignore_index: int = 0, row_mask: torch.Tensor | None = None,
               shard=None):
    """(hits, total): the non-padding positions whose target is among the
    top k of preds (B, T, V), and the non-padding positions, of targets
    (B, T)."""
    correct = _in_top_k(preds, targets, k, shard)
    mask = targets != ignore_index
    if row_mask is not None:
        mask = mask & row_mask[:, None]
    return (correct & mask).sum(), mask.sum()


def percent(hits: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """hits as a percentage of total; 0.0 when total is 0."""
    return torch.where(total > 0, hits * 100.0 / total.clamp(min=1),
                       torch.zeros((), device=hits.device))


def sequence_accuracy(preds: torch.Tensor, targets: torch.Tensor, k: int,
                      ignore_index: int = 0,
                      row_mask: torch.Tensor | None = None,
                      shard=None) -> torch.Tensor:
    """Top-k token accuracy over non-padding positions, as a percentage.
    preds (B, T, V) logits, targets (B, T) ids; 0.0 when every position is
    padding."""
    return percent(*top_k_hits(preds, targets, k, ignore_index, row_mask,
                               shard))


def calculate_caption_lengths(captions: torch.Tensor, skip_ids,
                              row_mask: torch.Tensor | None = None):
    """Count of tokens not in `skip_ids` over the whole batch (reference
    utils.py:101-107). The ids are compared one at a time as Python ints:
    a tensor made of them would be a host-to-device copy, which a CUDA
    graph capture refuses."""
    mask = torch.ones_like(captions, dtype=torch.bool)
    for skip in skip_ids:
        mask &= captions != skip
    if row_mask is not None:
        mask = mask & row_mask[:, None]
    return mask.sum()


def reference_packed_cross_entropy(preds: torch.Tensor, targets: torch.Tensor,
                                   row_mask: torch.Tensor | None = None,
                                   n_rows: int | None = None, shard=None):
    """Mean cross-entropy over the first T-1 timesteps of every row (the
    reference packs each row with length `len(row) - 1`)."""
    t_keep = preds.shape[1] - 1
    logits = preds[:, :t_keep].reshape(-1, preds.shape[-1])
    labels = targets[:, :t_keep].reshape(-1).long()
    if shard is not None:
        nll = vp.nll(logits, labels, shard)
    else:
        nll = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    if n_rows is not None:
        w = (torch.ones_like(nll) if row_mask is None
             else row_mask.to(nll.dtype).repeat_interleave(t_keep))
        return (nll * w).sum() / float(max(n_rows * t_keep, 1))
    if row_mask is None:
        return nll.mean()
    w = row_mask.to(nll.dtype).repeat_interleave(t_keep)
    return (nll * w).sum() / w.sum().clamp(min=1.0)


def attention_regularization(alphas: torch.Tensor, alpha_c: float,
                             row_mask: torch.Tensor | None = None,
                             n_rows: int | None = None):
    """Doubly-stochastic attention penalty (reference train.py:154);
    alphas (B, T, L)."""
    sq = (1.0 - alphas.sum(dim=1)) ** 2                   # (B, L)
    if n_rows is not None:
        if row_mask is not None:
            sq = sq * row_mask.to(sq.dtype)[:, None]
        return alpha_c * sq.sum() / float(max(n_rows * sq.shape[1], 1))
    if row_mask is None:
        return alpha_c * sq.mean()
    w = row_mask.to(sq.dtype)[:, None]
    return alpha_c * (sq * w).sum() / (w.sum() * sq.shape[1]).clamp(min=1.0)


def repetition_penalty(preds: torch.Tensor, ignore_ids, beta: float = 1.0,
                       row_mask: torch.Tensor | None = None,
                       n_rows: int | None = None, shard=None):
    """Penalty on consecutive repeated argmax tokens (reference
    train.py:357-384), off unless Config.rep_penalty_beta is set."""
    pred_tokens = (preds.argmax(dim=2) if shard is None
                   else vp.argmax(preds, shard))                   # (B, T)
    shifted = torch.cat([pred_tokens[:, :1], pred_tokens[:, :-1]], dim=1)
    repetitions = (pred_tokens == shifted).float()
    mask = torch.ones_like(repetitions, dtype=torch.bool)
    for idx in ignore_ids:
        mask &= shifted != idx
    masked = repetitions[:, 1:] * mask[:, 1:].float()
    if n_rows is not None:
        if row_mask is not None:
            masked = masked * row_mask.float()[:, None]
        return (masked.sum() / float(max(n_rows, 1))) * beta
    if row_mask is None:
        return (masked.sum() / pred_tokens.shape[0]) * beta
    w = row_mask.float()
    return ((masked * w[:, None]).sum() / w.sum().clamp(min=1.0)) * beta
