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
attention_bwd kernel: training never stores the (B, L, E) tanh.

`middle_dtype` (sat_tpu's bf16 attention) is the dtype in which the middle
reads keys and features: torch.bfloat16 stores them in bf16, halving the
bytes that each step reads. The middle itself is computed in float32 on
every device (ops/fused_attention.py): what sat_tpu's fused kernels compute
on bf16 inputs. sat_tpu's plain path rounds the tanh and the scores to
bf16 as well; the port does not (ROADMAP.md, Queue 3).
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
    soft_attention; the beam size in the de-duplicated beam).
    `middle_dtype` casts keys and features before the middle (module
    note); the decoder and the beam cast once, before their loops."""
    if keys is None:
        keys = precompute_attention_keys(attn, features)
    if middle_dtype is not None:
        keys, features = keys.to(middle_dtype), features.to(middle_dtype)
    if rows_per_image == 1 and torch.is_grad_enabled():
        return fused_soft_attention(attn, features, hidden, keys)
    return attention_fwd(keys, features, attn.U(hidden),
                         attn.v.weight.view(-1), attn.v.bias, rows_per_image)
