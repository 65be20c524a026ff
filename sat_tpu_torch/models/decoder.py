"""Soft-attention LSTM caption decoder.

Port of sat_tpu/models/decoder.py. The module's names are the
reference Decoder's (reference decoder.py:40-66), so a reference
`state_dict()` loads with no mapping:

  embedding   (V, E)
  init_h/init_c             — D -> E state initializers
  f_beta                    — E -> D gate
  attention   {U, W, v}     — always present, even with use_attention=False
  lstm                      — (E+D) -> E LSTMCell
  deep_output               — E -> V simple head
  f_h, f_z, f_out           — advanced deep output head, only when use_ado

`decode_step` is one step of decoding; `decoder_forward` is the training
and evaluation unroll over a caption, teacher-forced or autoregressive,
with dropout on h before the output head when training. With
`bf16_attention` the unroll stores the attention keys and features in
bf16 (models/attention.py). With `use_bert` the input table is BERT's
(30522, 768) word embeddings, frozen: its weight never requires a
gradient, so no optimizer sees it (sat_tpu stops its gradient), and
E = 768 is the width of the attention, the LSTM and both heads.

A decoder built with a `VocabShard` (sat_tpu's `--mesh-model M`:
parallel/vocab.py) holds V/M rows of `embedding` and V/M outputs of
`deep_output` and `f_out`, and its logits are the rank's (..., V/M): the
lookup sums the group's partial rows, the head's input passes through
`copy_to_model` (its gradient summed over the group), and the
autoregressive unroll feeds back the argmax over the whole vocabulary.
Everything else is replicated and computed alike on every rank of the
group; under remat the recomputed steps repeat their collectives in the
same order on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sat_tpu_torch import constants
from sat_tpu_torch.models.attention import (Attention,
                                           precompute_attention_keys,
                                           soft_attention)
from sat_tpu_torch.ops.lstm import lstm_cell
from sat_tpu_torch.parallel import vocab as vp


@dataclass(frozen=True)
class DecoderConfig:
    """sat_tpu's DecoderConfig. `fused_attention` is accepted for sat_tpu's
    flag set: the port's attention always runs its kernels. `remat_scan`
    recomputes each step's forward in the backward pass
    (torch.utils.checkpoint) instead of saving its activations."""
    vocab_size: int
    encoder_dim: int
    use_tf: bool = False
    use_ado: bool = False
    use_bert: bool = False
    use_attention: bool = False
    dropout_rate: float = 0.5
    fused_attention: bool = False
    bf16_attention: bool = False
    remat_scan: bool = True

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
    def __init__(self, cfg: DecoderConfig,
                 vocab_shard: vp.VocabShard | None = None):
        super().__init__()
        E, D, V = cfg.embedding_size, cfg.encoder_dim, cfg.effective_vocab_size
        self.cfg = cfg
        self.vocab_shard = vocab_shard
        if vocab_shard is not None:
            V = vocab_shard.rows
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
        self.requires_grad_(True)

    def requires_grad_(self, requires_grad: bool = True) -> "Decoder":
        """As nn.Module's, except that the BERT table stays frozen."""
        super().requires_grad_(requires_grad)
        if self.cfg.use_bert:
            self.embedding.weight.requires_grad_(False)
        return self


def init_decoder_params(cfg: DecoderConfig, generator: torch.Generator,
                        bert_embeddings: np.ndarray | None = None
                        ) -> dict[str, np.ndarray]:
    """Random parameters in sat_tpu's layout: the flat `/`-joined names and
    (in, out) shapes of `sat_tpu.models.decoder.init_decoder_params` as
    `tree_save_npz` writes them, drawn by the same laws (N(0, 1) embedding,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) linears, U(-1/sqrt(H), 1/sqrt(H))
    LSTM) from `generator`. The numbers differ from JAX's: feed both
    packages one array set to compare them. `bert_embeddings` (V, E), when
    given, is the embedding table (the random one is drawn all the same,
    so the other weights do not depend on it). Build the module with
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
    if bert_embeddings is not None:
        table = np.asarray(bert_embeddings, dtype=np.float32)
        if table.shape != (V, E):
            raise ValueError(f"the BERT embedding table is {table.shape}, "
                             f"expected {(V, E)}")
        out["embedding"] = table
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
    if dec.vocab_shard is not None:
        return vp.embed(dec.embedding.weight, ids, dec.vocab_shard)
    return dec.embedding(ids)


def head_input(dec: Decoder, x: torch.Tensor) -> torch.Tensor:
    """What a head's vocabulary shard reads: `x`, whose gradient is summed
    over the model group."""
    if dec.vocab_shard is not None:
        return vp.copy_to_model(x, dec.vocab_shard)
    return x


def token_argmax(dec: Decoder, logits: torch.Tensor) -> torch.Tensor:
    """The argmax of logits over the last dim, the whole vocabulary's
    under a vocab shard."""
    if dec.vocab_shard is not None:
        return vp.argmax(logits, dec.vocab_shard)
    return logits.argmax(dim=-1)


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
    return F.relu(dec.f_out(head_input(dec, h_t + z_t + token_emb)))


def _dropout_keep(shape, rate: float, generator, device):
    """The keep mask of dropout, Bernoulli(1 - rate) drawn from `generator`
    (a torch.Generator on `device`), or None when dropout is off."""
    if generator is None or rate <= 0.0:
        return None
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def _apply_keep(x: torch.Tensor, keep, rate: float) -> torch.Tensor:
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """sat_tpu's _dropout with an explicit torch.Generator: masks differ
    from jax.random's, so parity runs set rate 0."""
    return _apply_keep(x, _dropout_keep(x.shape, rate, generator, x.device),
                       rate)


def _recur(dec: Decoder, features, keys, h, c, token_emb, rows_per_image=1):
    """Attention, β-gate and LSTM cell of one step:
    (h', c', alpha, context)."""
    L = features.shape[1]
    R = rows_per_image
    if dec.cfg.use_attention:
        context, alpha = soft_attention(dec.attention, features, h, keys, R)
        gated_context = torch.sigmoid(dec.f_beta(h)) * context
    else:
        # a bf16 grid (the bf16 beam) gives bf16 values, widened as JAX's
        # promotion widens them
        alpha = features.new_full((features.shape[0] * R, L), 1.0 / L).float()
        context = features.mean(dim=1).float().repeat_interleave(R, dim=0)
        gated_context = context
    x = torch.cat([token_emb, gated_context], dim=-1)
    h, c = lstm_cell(dec.lstm, x, h, c)
    return h, c, alpha, context


def _head(dec: Decoder, h, context, token_emb):
    if dec.cfg.use_ado:
        return _advanced_deep_output(dec, h, context, token_emb)
    return dec.deep_output(head_input(dec, h))


def decode_step(dec: Decoder, features: torch.Tensor, keys: torch.Tensor,
                h: torch.Tensor, c: torch.Tensor, token_emb: torch.Tensor,
                rows_per_image: int = 1, dropout_keep=None,
                dropout_rate: float = 0.0):
    """One decode timestep (reference decoder.py:96-125).

    features: (B, L, D) annotation grid; keys: its precomputed W-projection;
    h, c, token_emb: (B*R, ...) for R = rows_per_image hidden rows per image
    (1 is sat_tpu's decode_step; the beam size is its _decode_step_shared,
    which reads each image's grid once for all its beams). `dropout_keep`
    (a bool mask of h's shape, or None) drops h before the output head at
    `dropout_rate`, as sat_tpu does in training.
    Returns (h', c', logits (B*R, V), alpha (B*R, L), context (B*R, D));
    under a vocab shard the logits are the rank's (B*R, V/M).
    """
    h, c, alpha, context = _recur(dec, features, keys, h, c, token_emb,
                                  rows_per_image)
    logits = _head(dec, _apply_keep(h, dropout_keep, dropout_rate), context,
                   token_emb)
    return h, c, logits, alpha, context


def _ar_step(dec, features, keys, h, c, prev_emb, keep, rate):
    h, c, logits, alpha, _ = decode_step(dec, features, keys, h, c, prev_emb,
                                         dropout_keep=keep, dropout_rate=rate)
    return h, c, embed_tokens(dec, token_argmax(dec, logits)), logits, alpha


def decoder_forward(dec: Decoder, cfg: DecoderConfig, features: torch.Tensor,
                    captions: torch.Tensor, generator=None,
                    train: bool = False):
    """Full unroll over T = caption_length - 1 steps (sat_tpu's
    decoder_forward). Teacher-forced (cfg.use_tf): step t consumes the
    ground-truth token t, the loop carries only (h, c), and the output head
    runs once over (B, T, E) after it. Otherwise autoregressive: step t
    consumes the embedding of the argmax of step t-1's logits, from the
    start token. With `train` and a `generator` (on the features' device),
    dropout acts on h before the head; the autoregressive branch draws all
    T masks before the loop and passes each into its step, so a recomputed
    step redraws nothing. With cfg.remat_scan and autograd on, each step
    runs under torch.utils.checkpoint. With cfg.bf16_attention (and
    attention) the keys and features are cast to bf16 once, after the LSTM
    state is read from the f32 features, as sat_tpu casts them; the
    gradient that reaches the keys through the cast is bf16, as under
    JAX's astype.

    Returns (preds (B, T, V), alphas (B, T, L)); under a vocab shard the
    preds are the rank's (B, T, V/M).
    """
    B = features.shape[0]
    T = captions.shape[1] - 1
    captions = captions.long()
    h, c = init_lstm_state(dec, features)
    keys = precompute_attention_keys(dec.attention, features)
    if cfg.bf16_attention and cfg.use_attention:
        # re-read at every step, forward and backward: bf16 halves it
        keys = keys.to(torch.bfloat16)
        features = features.to(torch.bfloat16)
    gen = generator if train else None
    remat = cfg.remat_scan and torch.is_grad_enabled()

    def run(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args)

    if cfg.use_tf:
        token_embs = embed_tokens(dec, captions[:, :T])          # (B, T, E)
        hs, ctxs, alphas = [], [], []
        for t in range(T):
            h, c, alpha, context = run(_recur, dec, features, keys, h, c,
                                       token_embs[:, t])
            hs.append(h)
            ctxs.append(context)
            alphas.append(alpha)
        h_do = _dropout(torch.stack(hs, dim=1), cfg.dropout_rate, gen)
        preds = _head(dec, h_do, torch.stack(ctxs, dim=1), token_embs)
        return preds, torch.stack(alphas, dim=1)

    start = torch.full((B,), cfg.start_token, dtype=torch.long,
                       device=features.device)
    prev_emb = embed_tokens(dec, start)
    keeps = [_dropout_keep(h.shape, cfg.dropout_rate, gen, h.device)
             for _ in range(T)]
    preds, alphas = [], []
    for t in range(T):
        h, c, prev_emb, logits, alpha = run(_ar_step, dec, features, keys, h,
                                            c, prev_emb, keeps[t],
                                            cfg.dropout_rate)
        preds.append(logits)
        alphas.append(alpha)
    return torch.stack(preds, dim=1), torch.stack(alphas, dim=1)
