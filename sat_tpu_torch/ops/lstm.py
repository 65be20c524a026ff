"""LSTM cell as a function over an `nn.LSTMCell`'s weights.

Port of sat_tpu/ops/lstm.py. Gates are ordered (input, forget, cell,
output) in both frameworks; sat_tpu stores the weights (in, out), the
`nn.LSTMCell` here (4H, in), so the 4H blocks carry over transposed
(sat_tpu_torch.compat.jax_params):

    gates = x W_ih^T + b_ih + h W_hh^T + b_hh
    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def lstm_cell(cell: nn.LSTMCell, x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor):
    """One step. x: (B, I); h, c: (B, H) -> (h', c')."""
    gates = (F.linear(x, cell.weight_ih, cell.bias_ih)
             + F.linear(h, cell.weight_hh, cell.bias_hh))
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new
