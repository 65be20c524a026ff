"""Soft-attention LSTM caption decoder (inference).

Port of sat_tpu/models/decoder.py for decoding. The module's names are the
reference Decoder's (reference decoder.py:40-66), so a reference
`state_dict()` loads with no mapping:

  embedding   (V, E)
  init_h/init_c             — D -> E state initializers
  f_beta                    — E -> D gate
  attention   {U, W, v}     — always present, even with use_attention=False
  lstm                      — (E+D) -> E LSTMCell
  deep_output               — E -> V simple head
  f_h, f_z, f_out           — advanced deep output head, only when use_ado

Dropout is off: it only acts in training. `decoder_forward` (the training
unroll) and BERT embeddings are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sat_tpu_torch import constants
from sat_tpu_torch.models.attention import Attention, soft_attention
from sat_tpu_torch.ops.lstm import lstm_cell


@dataclass(frozen=True)
class DecoderConfig:
    """The inference subset of sat_tpu's DecoderConfig: teacher forcing
    and dropout act only in training, which is not ported yet."""
    vocab_size: int
    encoder_dim: int
    use_ado: bool = False
    use_bert: bool = False
    use_attention: bool = False

    @property
    def embedding_size(self) -> int:
        return constants.BERT_HIDDEN_SIZE if self.use_bert else 512

    @property
    def start_token(self) -> int:
        return constants.BERT_CLS if self.use_bert else constants.START

    @property
    def effective_vocab_size(self) -> int:
        return constants.BERT_VOCAB_SIZE if self.use_bert else self.vocab_size


class Decoder(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        if cfg.use_bert:
            raise NotImplementedError(
                "BERT embeddings are not ported yet (ROADMAP.md, Queue 1: "
                "still to port)")
        E, D, V = cfg.embedding_size, cfg.encoder_dim, cfg.effective_vocab_size
        self.cfg = cfg
        self.embedding = nn.Embedding(V, E)
        self.init_h = nn.Linear(D, E)
        self.init_c = nn.Linear(D, E)
        self.f_beta = nn.Linear(E, D)
        self.attention = Attention(D, E)
        self.lstm = nn.LSTMCell(E + D, E)
        self.deep_output = nn.Linear(E, V)
        if cfg.use_ado:
            self.f_h = nn.Linear(E, E)
            self.f_z = nn.Linear(D, E)
            self.f_out = nn.Linear(E, V)


def init_decoder_params(cfg: DecoderConfig,
                        generator: torch.Generator) -> dict[str, np.ndarray]:
    """Random parameters in sat_tpu's layout: the flat `/`-joined names and
    (in, out) shapes of `sat_tpu.models.decoder.init_decoder_params` as
    `tree_save_npz` writes them, drawn by the same laws (N(0, 1) embedding,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) linears, U(-1/sqrt(H), 1/sqrt(H))
    LSTM) from `generator`. The numbers differ from JAX's: feed both
    packages one array set to compare them. Build the module with
    sat_tpu_torch.compat.jax_params.decoder_from_jax."""
    E, D, V = cfg.embedding_size, cfg.encoder_dim, cfg.effective_vocab_size
    out: dict[str, np.ndarray] = {}

    def uniform(shape, k):
        return torch.empty(shape).uniform_(-k, k, generator=generator).numpy()

    def linear(name, fan_in, fan_out):
        k = 1.0 / math.sqrt(fan_in)
        out[f"{name}/w"] = uniform((fan_in, fan_out), k)
        out[f"{name}/b"] = uniform((fan_out,), k)

    out["embedding"] = torch.randn((V, E), generator=generator).numpy()
    linear("init_h", D, E)
    linear("init_c", D, E)
    linear("f_beta", E, D)
    linear("attention/U", E, E)
    linear("attention/W", D, E)
    linear("attention/v", E, 1)
    k = 1.0 / math.sqrt(E)
    out["lstm/w_ih"] = uniform((E + D, 4 * E), k)
    out["lstm/w_hh"] = uniform((E, 4 * E), k)
    out["lstm/b_ih"] = uniform((4 * E,), k)
    out["lstm/b_hh"] = uniform((4 * E,), k)
    linear("deep_output", E, V)
    if cfg.use_ado:
        linear("ado/f_h", E, E)
        linear("ado/f_z", D, E)
        linear("ado/f_out", E, V)
    return out


def embed_tokens(dec: Decoder, ids: torch.Tensor) -> torch.Tensor:
    return dec.embedding(ids)


def init_lstm_state(dec: Decoder, features: torch.Tensor):
    """h, c = tanh(Linear(mean_l features)) (reference decoder.py:137-147)."""
    avg = features.mean(dim=1)
    c = torch.tanh(dec.init_c(avg))
    h = torch.tanh(dec.init_h(avg))
    return h, c


def _advanced_deep_output(dec: Decoder, h: torch.Tensor, context: torch.Tensor,
                          token_emb: torch.Tensor) -> torch.Tensor:
    """relu(f_out(relu(f_h h) + relu(f_z z) + E y)) (reference
    decoder.py:149-158). The reference relus the final logits too; kept
    verbatim."""
    h_t = F.relu(dec.f_h(h))
    z_t = F.relu(dec.f_z(context))
    return F.relu(dec.f_out(h_t + z_t + token_emb))


def decode_step(dec: Decoder, features: torch.Tensor, keys: torch.Tensor,
                h: torch.Tensor, c: torch.Tensor, token_emb: torch.Tensor,
                rows_per_image: int = 1):
    """One decode timestep (reference decoder.py:96-125).

    features: (B, L, D) annotation grid; keys: its precomputed W-projection;
    h, c, token_emb: (B*R, ...) for R = rows_per_image hidden rows per image
    (1 is sat_tpu's decode_step; the beam size is its _decode_step_shared,
    which reads each image's grid once for all its beams).
    Returns (h', c', logits (B*R, V), alpha (B*R, L), context (B*R, D)).
    """
    L = features.shape[1]
    R = rows_per_image
    if dec.cfg.use_attention:
        context, alpha = soft_attention(dec.attention, features, h, keys, R)
        gated_context = torch.sigmoid(dec.f_beta(h)) * context
    else:
        alpha = features.new_full((features.shape[0] * R, L), 1.0 / L)
        context = features.mean(dim=1).repeat_interleave(R, dim=0)
        gated_context = context

    x = torch.cat([token_emb, gated_context], dim=-1)
    h, c = lstm_cell(dec.lstm, x, h, c)
    if dec.cfg.use_ado:
        logits = _advanced_deep_output(dec, h, context, token_emb)
    else:
        logits = dec.deep_output(h)
    return h, c, logits, alpha, context
