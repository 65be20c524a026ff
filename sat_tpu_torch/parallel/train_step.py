"""The training and evaluation steps.

Port of sat_tpu/parallel/train_step.py for one device. A train step is the
frozen encoder's forward (or precomputed features), the decoder's unroll,
the reference loss (packed cross-entropy + the doubly-stochastic
regularizer, reference train.py:150-162), the backward pass and one Adam
update. The attention of every decoder step runs the fused kernels, forward
and backward.

Optimizer: sat_tpu's `scale_by_adam(b1=0.9, b2=0.999, eps=1e-8,
eps_root=0)` with -lr applied outside is torch.optim.Adam with the same
betas and eps; the learning rate is set on each call, so the host drives
the StepLR schedule. The state a step updates in place is a `TrainState`:
the decoder module, its optimizer and the step count.

Each `make_*` returns a function of the same arguments as sat_tpu's, with
a torch.Generator in place of the rng (dropout; None turns it off). The
K-step blocks (`make_bank_train_block`, `make_bank_eval_block`) are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sat_tpu_torch import constants
from sat_tpu_torch.models.decoder import (Decoder, DecoderConfig,
                                          decoder_forward)
from sat_tpu_torch.models.encoder import encoder_forward
from sat_tpu_torch.utils.metrics import (attention_regularization,
                                         calculate_caption_lengths,
                                         reference_packed_cross_entropy,
                                         repetition_penalty,
                                         sequence_accuracy)


@dataclass
class TrainState:
    decoder: Decoder
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(decoder: Decoder) -> torch.optim.Adam:
    """Adam over the decoder's trainable parameters; the lr is set on each
    step."""
    return torch.optim.Adam([p for p in decoder.parameters()
                             if p.requires_grad],
                            lr=0.0, betas=(0.9, 0.999), eps=1e-8)


def init_train_state(decoder: Decoder) -> TrainState:
    return TrainState(decoder=decoder, optimizer=make_optimizer(decoder))


def special_ids(use_bert: bool):
    """(pad_id, skip_ids) for accuracy masking and caption-length counting
    (reference train.py:143, 174-177)."""
    if use_bert:
        return constants.BERT_PAD, (constants.BERT_PAD, constants.BERT_CLS,
                                    constants.BERT_SEP)
    return constants.PAD, (constants.PAD, constants.START, constants.EOS)


def _loss_and_metrics(dcfg: DecoderConfig, alpha_c: float, decoder: Decoder,
                      features, captions, generator, train: bool,
                      row_mask=None, rep_penalty_beta: float = 0.0):
    """(loss, (metrics, preds, alphas)). `row_mask` (B,) bool excludes
    batch-padding rows from the loss, gradients and every metric."""
    captions = captions.long()
    preds, alphas = decoder_forward(decoder, dcfg, features, captions,
                                    generator=generator, train=train)
    targets = captions[:, 1:]
    loss = (reference_packed_cross_entropy(preds, targets, row_mask)
            + attention_regularization(alphas, alpha_c, row_mask))
    pad_id, skip_ids = special_ids(dcfg.use_bert)
    if rep_penalty_beta:
        loss = loss + repetition_penalty(preds, (pad_id, dcfg.start_token),
                                         rep_penalty_beta, row_mask)
    with torch.no_grad():
        metrics = {
            "loss": loss.detach(),
            "acc1": sequence_accuracy(preds, targets, 1, ignore_index=pad_id,
                                      row_mask=row_mask),
            "acc5": sequence_accuracy(preds, targets, 5, ignore_index=pad_id,
                                      row_mask=row_mask),
            "caption_length": calculate_caption_lengths(captions, skip_ids,
                                                        row_mask),
        }
    return loss, (metrics, preds, alphas)


def _update(state: TrainState, loss, lr: float) -> None:
    """Backward and one Adam step at `lr`."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    state.optimizer.step()
    state.step += 1


def _features(enc, network: str, imgs, from_features: bool, device):
    if from_features:
        return torch.as_tensor(imgs, dtype=torch.float32, device=device)
    # encoder_forward runs in inference mode; clone() makes a normal
    # tensor that autograd may save
    return encoder_forward(enc, network, imgs).clone()


def _device(state_or_decoder) -> torch.device:
    dec = getattr(state_or_decoder, "decoder", state_or_decoder)
    return next(dec.parameters()).device


def make_train_step(dcfg: DecoderConfig, network: str, alpha_c: float,
                    from_features: bool = False,
                    rep_penalty_beta: float = 0.0):
    """`step(state, encoder, imgs, captions, lr, generator, row_mask=None)
    -> (state, metrics)`. With `from_features` the third argument is the
    annotation grid (B, L, D) and the encoder is skipped. (sat_tpu's
    `bf16_encoder` is not ported: ROADMAP.md, Queue 1, bf16.)"""

    def step_fn(state: TrainState, encoder, imgs, captions, lr, generator,
                row_mask=None):
        dev = _device(state)
        features = _features(encoder, network, imgs, from_features, dev)
        captions = torch.as_tensor(captions, device=dev)
        loss, (metrics, _, _) = _loss_and_metrics(
            dcfg, alpha_c, state.decoder, features, captions, generator, True,
            row_mask, rep_penalty_beta)
        _update(state, loss, lr)
        return state, metrics

    return step_fn


def make_bank_train_step(dcfg: DecoderConfig, alpha_c: float,
                         rep_penalty_beta: float = 0.0):
    """Feature-bank step: the frozen encoder's grids of every unique image
    live in device memory, and a step gathers its rows by index.
    `step(state, feat_bank (U, L, D), caps_bank (N, T), img_idx (B,),
    row_idx (B,), lr, generator, row_mask=None) -> (state, metrics)`."""

    def step_fn(state: TrainState, feat_bank, caps_bank, img_idx, row_idx,
                lr, generator, row_mask=None):
        loss, (metrics, _, _) = _loss_and_metrics(
            dcfg, alpha_c, state.decoder, feat_bank[img_idx],
            caps_bank[row_idx], generator, True, row_mask, rep_penalty_beta)
        _update(state, loss, lr)
        return state, metrics

    return step_fn


def _eval(dcfg, alpha_c, decoder, features, captions, row_mask):
    with torch.no_grad():
        _, (metrics, preds, alphas) = _loss_and_metrics(
            dcfg, alpha_c, decoder, features, captions, None, False,
            row_mask)
        return metrics, preds.argmax(dim=2).int(), alphas


def make_bank_eval_step(dcfg: DecoderConfig, alpha_c: float):
    """`eval(decoder, feat_bank, caps_bank, img_idx, row_idx, row_mask=None)
    -> (metrics, pred_tokens (B, T), alphas (B, T, L))`."""

    def eval_fn(decoder, feat_bank, caps_bank, img_idx, row_idx,
                row_mask=None):
        return _eval(dcfg, alpha_c, decoder, feat_bank[img_idx],
                     caps_bank[row_idx], row_mask)

    return eval_fn


def make_eval_step(dcfg: DecoderConfig, network: str, alpha_c: float,
                   from_features: bool = False):
    """`eval(decoder, encoder, imgs, captions, row_mask=None) -> (metrics,
    pred_tokens (B, T), alphas (B, T, L))`; `from_features` as in
    make_train_step."""

    def eval_fn(decoder, encoder, imgs, captions, row_mask=None):
        dev = _device(decoder)
        features = _features(encoder, network, imgs, from_features, dev)
        return _eval(dcfg, alpha_c, decoder, features,
                     torch.as_tensor(captions, device=dev), row_mask)

    return eval_fn


def make_bank_train_block(*args, **kwargs):
    raise NotImplementedError(
        "K-step train blocks are not ported yet (ROADMAP.md, Queue 1: "
        "blocked K-step dispatch)")


def make_bank_eval_block(*args, **kwargs):
    raise NotImplementedError(
        "K-step eval blocks are not ported yet (ROADMAP.md, Queue 1: "
        "blocked K-step dispatch)")
