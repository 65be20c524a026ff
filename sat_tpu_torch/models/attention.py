"""Bahdanau-style soft attention over the annotation grid.

Port of sat_tpu/models/attention.py. Per hidden row (reference
attention.py:14-21):

    e      = v . tanh(W a_l + U h)     for each of the L annotation vectors
    alpha  = softmax(e)                 over L
    z      = sum_l alpha_l a_l          (context)

`W a_l` depends only on the image, so decoding precomputes it once per
image (`precompute_attention_keys`); each step pays the small `U h`
projection and the attention middle, which `attention_fwd` computes: the
CUDA kernel on the card, its plain form on the CPU. With autograd on, the
middle at R = 1 goes through `FusedAttention`, whose backward is the
attention_bwd kernel: training never stores the (B, L, E) tanh. The
`middle_dtype` (bf16 tanh) option is not ported yet and raises.
"""

from __future__ import annotations

import torch
from torch import nn

from sat_tpu_torch.ops.fused_attention import (attention_fwd,
                                               fused_soft_attention)


class Attention(nn.Module):
    """The reference's attention module: U (E -> E), W (D -> E), v (E -> 1)."""

    def __init__(self, encoder_dim: int, embedding_size: int):
        super().__init__()
        self.U = nn.Linear(embedding_size, embedding_size)
        self.W = nn.Linear(encoder_dim, embedding_size)
        self.v = nn.Linear(embedding_size, 1)


def precompute_attention_keys(attn: Attention,
                              features: torch.Tensor) -> torch.Tensor:
    """W a + b_W for all annotation vectors: (B, L, D) -> (B, L, E)."""
    return attn.W(features)


def soft_attention(attn: Attention, features: torch.Tensor,
                   hidden: torch.Tensor, keys: torch.Tensor | None = None,
                   rows_per_image: int = 1, middle_dtype=None):
    """(context (B*R, D), alpha (B*R, L)) for features (B, L, D) and hidden
    (B*R, E), R = rows_per_image hidden rows per image (1 in sat_tpu's
    soft_attention; the beam size in the de-duplicated beam)."""
    if middle_dtype is not None:
        raise NotImplementedError(
            "middle_dtype (the bf16 attention tanh) is not ported yet "
            "(ROADMAP.md, Queue 1: bf16)")
    if keys is None:
        keys = precompute_attention_keys(attn, features)
    if rows_per_image == 1 and torch.is_grad_enabled():
        return fused_soft_attention(attn, features, hidden, keys)
    return attention_fwd(keys, features, attn.U(hidden),
                         attn.v.weight.view(-1), attn.v.bias, rows_per_image)
