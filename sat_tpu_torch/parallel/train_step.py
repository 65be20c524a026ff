"""The training and evaluation steps.

Port of sat_tpu/parallel/train_step.py. A train step is the
frozen encoder's forward (or precomputed features), the decoder's unroll,
the reference loss (packed cross-entropy + the doubly-stochastic
regularizer, reference train.py:150-162), the backward pass and one Adam
update. The attention of every decoder step runs the fused kernels, forward
and backward.

Optimizer: sat_tpu's `scale_by_adam(b1=0.9, b2=0.999, eps=1e-8,
eps_root=0)` with -lr applied outside is torch.optim.Adam with the same
betas and eps; the learning rate is set on each call, so the host drives
the StepLR schedule. On the card the Adam is capturable: its step counts,
bias corrections and learning rate live on the device, so that a CUDA
graph can hold its update; the per-batch steps use the same update, so a
blocked run and a per-batch run compute the same bits. The state a step
updates in place is a `TrainState`: the decoder module, its optimizer and
the step count.

Each `make_*` returns a function of the same arguments as sat_tpu's, with
a torch.Generator in place of the rng (dropout; None turns it off). The
K-step blocks (`make_bank_train_block`, `make_bank_eval_block`) run K
steps in one dispatch: on the card, K replays of one captured step
(utils/graphs.py), as sat_tpu runs them in one `lax.scan`.

Under the grid (parallel/distributed.py): the gradients and the metric
numerators are summed over the data group, replicated parameters and
vocabulary shards alike (every model rank holds the whole loss, and the
replicated layers' whole gradient: parallel/vocab.py). With
`sharded_bank`, data rank i holds rows [i U'/N, (i+1) U'/N) of each bank
(padded to U' by the trainer), and a step's rows come from their owners:
the data group's indices gathered, each rank's own rows filled into a zero
buffer of the group's rows and summed over the group (`bank_rows`,
`bank_caps`; the sum turns a -0.0 into +0.0). Under NCCL these collectives
are captured in a block's graph with the rest of the step.

bf16: a feature bank stored in bf16 (`--bank-dtype bfloat16`) is read
through `bank_rows`, which widens the gathered rows to f32 inside the step
(and inside a captured block), so the decoder computes in f32 from
bf16-rounded features. `bf16_encoder` runs the image path's encoder in
bf16 (models/encoder.py).

`debug_nans` (train.py's --debug-nans) adds a metric `nan` to each
step's: a device bool, true when an output of the step that sat_tpu's
`jax_debug_nans` checks holds a NaN (an inf does not count, as there).
For a train step those are the loss and the metrics, the trainable
parameters after the update and Adam's two moments; for an eval step the
metrics and the alphas; for an eval block, whose outputs are metrics and
tokens, the metrics. A train step's flag is ORed over the model group,
whose shards differ. An eval step's needs no collective: under a grid its
metrics are the data group's sums, into which every row's alphas enter
(the regularizer, weighted by the row mask: NaN x 0 is NaN), so a NaN in
any rank's alphas reaches every rank's metrics. A
block computes it inside its captured step, so it costs no sync; the
caller reads it with the other metrics. Without the option the steps
compute exactly what they did.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import torch
import torch.distributed

from sat_tpu_torch import constants
from sat_tpu_torch.models.decoder import (Decoder, DecoderConfig,
                                          decoder_forward, token_argmax)
from sat_tpu_torch.models.encoder import encoder_forward
from sat_tpu_torch.parallel import distributed as dist
from sat_tpu_torch.parallel import vocab as vp
from sat_tpu_torch.utils import spans
from sat_tpu_torch.utils.graphs import GraphCache
from sat_tpu_torch.utils.metrics import (attention_regularization,
                                         calculate_caption_lengths,
                                         percent,
                                         reference_packed_cross_entropy,
                                         repetition_penalty,
                                         sequence_accuracy, top_k_hits)


@dataclass
class TrainState:
    decoder: Decoder
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(decoder: Decoder) -> torch.optim.Adam:
    """Adam over the decoder's trainable parameters; the lr is set on each
    step (`set_lr`). Capturable on the card, with the lr a device tensor
    there."""
    params = [p for p in decoder.parameters() if p.requires_grad]
    optimizer = torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999),
                                 eps=1e-8)
    place_optimizer_state(optimizer)
    return optimizer


def place_optimizer_state(optimizer: torch.optim.Adam) -> None:
    """Put each group's settings and step counts in the form its params'
    device runs: capturable, with a device lr and device step counts, on
    the card; a float lr and host step counts on the CPU. After
    `load_state_dict`, which takes the saved form (the train state's is the
    CPU form: engine/checkpoint.py::optimizer_file_state)."""
    for group in optimizer.param_groups:
        dev = group["params"][0].device
        cuda = dev.type == "cuda"
        lr = float(group["lr"])
        group["capturable"] = cuda
        group["lr"] = torch.full((), lr, device=dev) if cuda else lr
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if "step" in state:
                state["step"] = state["step"].to(dev if cuda else "cpu")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The learning rate of the coming steps: a device lr is filled in
    place, where a captured update reads it."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = float(lr)


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
                      row_mask=None, rep_penalty_beta: float = 0.0,
                      n_rows: int | None = None):
    """(loss, (metrics, preds, alphas)). `row_mask` (B,) bool excludes
    batch-padding rows from the loss, gradients and every metric. With
    `n_rows` (a data-parallel rank's slice) the loss is this rank's share
    of the global batch's, and the metrics are the numerators that
    `_reduce` sums over the ranks."""
    captions = captions.long()
    shard = decoder.vocab_shard
    preds, alphas = decoder_forward(decoder, dcfg, features, captions,
                                    generator=generator, train=train)
    targets = captions[:, 1:]
    # a slice that is the whole global batch (one rank) takes the plain
    # means, the same numbers, so that one rank computes a plain step's bits
    share = (None if row_mask is None and n_rows == captions.shape[0]
             else n_rows)
    loss = (reference_packed_cross_entropy(preds, targets, row_mask, share,
                                           shard)
            + attention_regularization(alphas, alpha_c, row_mask, share))
    pad_id, skip_ids = special_ids(dcfg.use_bert)
    if rep_penalty_beta:
        loss = loss + repetition_penalty(preds, (pad_id, dcfg.start_token),
                                         rep_penalty_beta, row_mask, share,
                                         shard)
    with torch.no_grad():
        if n_rows is not None:
            hits1, tokens = top_k_hits(preds, targets, 1, pad_id, row_mask,
                                       shard)
            hits5, _ = top_k_hits(preds, targets, 5, pad_id, row_mask,
                                  shard)
            sums = torch.stack([
                loss.detach(), hits1.float(), hits5.float(), tokens.float(),
                calculate_caption_lengths(captions, skip_ids,
                                          row_mask).float()])
            return loss, ({"sums": sums}, preds, alphas)
        metrics = {
            "loss": loss.detach(),
            "acc1": sequence_accuracy(preds, targets, 1, ignore_index=pad_id,
                                      row_mask=row_mask, shard=shard),
            "acc5": sequence_accuracy(preds, targets, 5, ignore_index=pad_id,
                                      row_mask=row_mask, shard=shard),
            "caption_length": calculate_caption_lengths(captions, skip_ids,
                                                        row_mask),
        }
    return loss, (metrics, preds, alphas)


def _any_nan(tensors, shard: vp.VocabShard | None = None):
    """One device bool: a NaN in any floating tensor of `tensors`, on any
    rank of the model group of `shard` (module note)."""
    with torch.no_grad():
        flag = torch.stack([t.isnan().any() for t in tensors
                            if t.is_floating_point()]).any()
        if shard is not None:
            flag = vp.model_gather(flag.int(), shard).max() > 0
        return flag


def _train_nan(loss, metrics: dict, state: TrainState):
    """`_any_nan` of a train step's outputs: the loss and the metrics, the
    trainable parameters and Adam's moments."""
    moments = [st[k] for st in state.optimizer.state.values()
               for k in ("exp_avg", "exp_avg_sq") if k in st]
    return _any_nan([loss, *metrics.values(),
                     *(p for p in state.decoder.parameters()
                       if p.requires_grad), *moments],
                    state.decoder.vocab_shard)


def _reduce(sums, grads=()) -> dict:
    """One SUM all-reduce over the data group of the gradients (in place)
    and of a step's metric numerators (`_loss_and_metrics`' "sums");
    returns the global batch's metrics."""
    grads = list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads] + [sums])
    torch.distributed.all_reduce(flat, group=dist.data_group())
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    loss, hits1, hits5, tokens, caption_length = flat[at:].unbind()
    return {"loss": loss, "acc1": percent(hits1, tokens),
            "acc5": percent(hits5, tokens),
            "caption_length": caption_length.round().long()}


def _update(state: TrainState, loss, sums=None):
    """Backward and one Adam step at the optimizer's lr. Given a rank's
    metric numerators `sums`, the gradients and the numerators are summed
    over the ranks first, and the global metrics returned."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    metrics = None
    if sums is not None:
        metrics = _reduce(sums, [p.grad for p in state.decoder.parameters()
                                 if p.grad is not None])
    with warnings.catch_warnings():
        # Per-batch steps run the capturable update uncaptured on purpose
        # (the same bits as a block's): torch warns once for that.
        warnings.filterwarnings("ignore", message=".*capturable=True")
        state.optimizer.step()
    state.step += 1
    return metrics


def _features(enc, network: str, imgs, from_features: bool, device,
              bf16_encoder: bool = False):
    if from_features:
        return torch.as_tensor(imgs, dtype=torch.float32, device=device)
    # encoder_forward runs in inference mode; clone() makes a normal
    # tensor that autograd may save
    return encoder_forward(enc, network, imgs,
                           torch.bfloat16 if bf16_encoder else None).clone()


def _sharded_rows(bank, idx, dtype):
    """Rows `idx` (global row numbers) of a bank sharded over the data
    group, in `dtype` (module note)."""
    group, n = dist.data_group(), bank.shape[0]
    local = dist.gather(idx, group=group) - dist.data_index() * n
    own = (local >= 0) & (local < n)
    rows = bank[torch.where(own, local, 0)].to(dtype)
    rows = torch.where(own.view((-1,) + (1,) * (rows.dim() - 1)), rows, 0)
    torch.distributed.all_reduce(rows, group=group)
    B = idx.shape[0]
    return rows[dist.data_index() * B:(dist.data_index() + 1) * B]


def bank_rows(feat_bank, img_idx, sharded: bool = False):
    """The bank's rows `img_idx` in f32: a bf16 bank is widened right
    after the gather (a no-op for an f32 bank); from the owners of a
    sharded bank (module note)."""
    if sharded:
        return _sharded_rows(feat_bank, img_idx, torch.float32)
    return feat_bank[img_idx].float()


def bank_caps(caps_bank, row_idx, sharded: bool = False):
    """The caption bank's rows `row_idx`, sharded or whole."""
    if sharded:
        return _sharded_rows(caps_bank, row_idx, caps_bank.dtype)
    return caps_bank[row_idx]


def _device(state_or_decoder) -> torch.device:
    dec = getattr(state_or_decoder, "decoder", state_or_decoder)
    return next(dec.parameters()).device


def _train_metrics(state, loss, metrics, distributed, debug_nans):
    """Backward, the all-reduce when `distributed`, Adam; the step's
    metrics."""
    reduced = _update(state, loss, metrics["sums"] if distributed else None)
    if distributed:
        metrics = reduced
    if debug_nans:
        metrics["nan"] = _train_nan(loss, metrics, state)
    return metrics


def make_train_step(dcfg: DecoderConfig, network: str, alpha_c: float,
                    bf16_encoder: bool = False, from_features: bool = False,
                    rep_penalty_beta: float = 0.0, debug_nans: bool = False,
                    distributed: bool = False):
    """`step(state, encoder, imgs, captions, lr, generator, row_mask=None,
    n_rows=None) -> (state, metrics)`. With `from_features` the third
    argument is the annotation grid (B, L, D) and the encoder is skipped;
    else the encoder runs in bf16 under `bf16_encoder`. `distributed`:
    the rank's slice of a global batch of `n_rows` real rows (module
    note)."""

    def step_fn(state: TrainState, encoder, imgs, captions, lr, generator,
                row_mask=None, n_rows=None):
        dev = _device(state)
        features = _features(encoder, network, imgs, from_features, dev,
                             bf16_encoder)
        captions = torch.as_tensor(captions, device=dev)
        loss, (metrics, _, _) = _loss_and_metrics(
            dcfg, alpha_c, state.decoder, features, captions, generator, True,
            row_mask, rep_penalty_beta, n_rows if distributed else None)
        set_lr(state.optimizer, lr)
        return state, _train_metrics(state, loss, metrics, distributed,
                                     debug_nans)

    return step_fn


def _bank_step(dcfg, alpha_c, rep_penalty_beta, debug_nans, distributed,
               sharded_bank, state: TrainState, feat_bank, caps_bank,
               img_idx, row_idx, generator, row_mask, n_rows):
    """One bank train step at the optimizer's lr: its metrics."""
    loss, (metrics, _, _) = _loss_and_metrics(
        dcfg, alpha_c, state.decoder,
        bank_rows(feat_bank, img_idx, sharded_bank),
        bank_caps(caps_bank, row_idx, sharded_bank), generator, True,
        row_mask, rep_penalty_beta, n_rows if distributed else None)
    return _train_metrics(state, loss, metrics, distributed, debug_nans)


def make_bank_train_step(dcfg: DecoderConfig, alpha_c: float,
                         rep_penalty_beta: float = 0.0,
                         debug_nans: bool = False,
                         distributed: bool = False,
                         sharded_bank: bool = False):
    """Feature-bank step: the frozen encoder's grids of every unique image
    live in device memory, f32 or bf16, and a step gathers its rows by
    index (from their owners with `sharded_bank`: module note).
    `step(state, feat_bank (U, L, D), caps_bank (N, T), img_idx (B,),
    row_idx (B,), lr, generator, row_mask=None, n_rows=None) -> (state,
    metrics)`."""

    def step_fn(state: TrainState, feat_bank, caps_bank, img_idx, row_idx,
                lr, generator, row_mask=None, n_rows=None):
        set_lr(state.optimizer, lr)
        return state, _bank_step(dcfg, alpha_c, rep_penalty_beta, debug_nans,
                                 distributed, sharded_bank, state, feat_bank,
                                 caps_bank, img_idx, row_idx, generator,
                                 row_mask, n_rows)

    return step_fn


def _eval(dcfg, alpha_c, decoder, features, captions, row_mask,
          n_rows=None, debug_nans: bool = False, with_alphas: bool = True):
    """(metrics, argmax tokens, alphas); with `n_rows`, the metrics of the
    global batch, summed over the ranks; with `debug_nans` the metric
    `nan` of the metrics, and of the alphas `with_alphas` (module
    note)."""
    with torch.no_grad():
        _, (metrics, preds, alphas) = _loss_and_metrics(
            dcfg, alpha_c, decoder, features, captions, None, False,
            row_mask, n_rows=n_rows)
        if n_rows is not None:
            metrics = _reduce(metrics["sums"])
        if debug_nans:
            metrics["nan"] = _any_nan(
                [*metrics.values()] + ([alphas] if with_alphas else []))
        return metrics, token_argmax(decoder, preds).int(), alphas


def make_bank_eval_step(dcfg: DecoderConfig, alpha_c: float,
                        distributed: bool = False,
                        sharded_bank: bool = False,
                        debug_nans: bool = False):
    """`eval(decoder, feat_bank, caps_bank, img_idx, row_idx, row_mask=None,
    n_rows=None) -> (metrics, pred_tokens (B, T), alphas (B, T, L))`."""

    def eval_fn(decoder, feat_bank, caps_bank, img_idx, row_idx,
                row_mask=None, n_rows=None):
        return _eval(dcfg, alpha_c, decoder,
                     bank_rows(feat_bank, img_idx, sharded_bank),
                     bank_caps(caps_bank, row_idx, sharded_bank), row_mask,
                     n_rows if distributed else None, debug_nans)

    return eval_fn


def make_eval_step(dcfg: DecoderConfig, network: str, alpha_c: float,
                   bf16_encoder: bool = False, from_features: bool = False,
                   distributed: bool = False, debug_nans: bool = False):
    """`eval(decoder, encoder, imgs, captions, row_mask=None, n_rows=None)
    -> (metrics, pred_tokens (B, T), alphas (B, T, L))`; `bf16_encoder`,
    `from_features`, `distributed` and `debug_nans` as in
    make_train_step."""

    def eval_fn(decoder, encoder, imgs, captions, row_mask=None,
                n_rows=None):
        dev = _device(decoder)
        features = _features(encoder, network, imgs, from_features, dev,
                             bf16_encoder)
        return _eval(dcfg, alpha_c, decoder, features,
                     torch.as_tensor(captions, device=dev), row_mask,
                     n_rows if distributed else None, debug_nans)

    return eval_fn


def _replay_block(slot, body, generators, img_idx, row_idx,
                  row_mask) -> dict:
    """One run of the slot's graph "step" for each row of the (K, B) block:
    before run i, the step's index (and mask) slots take row i by
    device-to-device copies; after it, the run's outputs (buffers["out"],
    which the eager warm-up run allocates) go to row i of the stacked
    result, on the device."""
    buf, K = slot.buffers, img_idx.shape[0]
    stacked = None
    for i in range(K):
        buf["img_idx"].copy_(img_idx[i])
        buf["row_idx"].copy_(row_idx[i])
        if row_mask is not None:
            buf["row_mask"].copy_(row_mask[i])
        slot.run("step", body, generators)
        if stacked is None:
            stacked = {k: v.new_empty((K,) + v.shape)
                       for k, v in buf["out"].items()}
        for k, v in buf["out"].items():
            stacked[k][i].copy_(v)
    return stacked


def _index_slots(feat_bank, img_idx, row_idx, row_mask):
    """The buffers of one captured bank step: its row indices and mask."""
    B, dev = img_idx.shape[1], feat_bank.device
    buf = {"img_idx": torch.empty(B, dtype=img_idx.dtype, device=dev),
           "row_idx": torch.empty(B, dtype=row_idx.dtype, device=dev),
           "row_mask": None, "out": {}}
    if row_mask is not None:
        buf["row_mask"] = torch.empty(B, dtype=torch.bool, device=dev)
    return buf


def _write_out(buf, **values) -> None:
    """Copy a run's outputs into buf["out"]; the warm-up run, eager,
    allocates them, so a capture only records copies."""
    for k, v in values.items():
        if k not in buf["out"]:
            buf["out"][k] = torch.empty_like(v)
        buf["out"][k].copy_(v)


def _eager_block(feat_bank, distributed: bool) -> bool:
    """Whether a block runs its K steps eagerly: on the CPU, and under a
    process group whose collectives a graph cannot hold (gloo)."""
    return feat_bank.device.type != "cuda" or (distributed
                                               and not dist.capturable())


def make_bank_train_block(dcfg: DecoderConfig, alpha_c: float,
                          rep_penalty_beta: float = 0.0,
                          debug_nans: bool = False,
                          distributed: bool = False,
                          sharded_bank: bool = False):
    """K optimizer steps in one dispatch, the port of sat_tpu's `lax.scan`
    block: `block(state, feat_bank (U, L, D), caps_bank (N, T), img_idx
    (K, B), row_idx (K, B), lr, generator, row_mask (K, B) or None,
    n_rows=None) -> (state, metrics)`, each metric stacked to (K,) and
    left on the device, so the host reads them once a block.

    On the card one train step is captured per (B, T, decoder config,
    mask, n_rows) shape, and the block replays it K times. Before each
    replay the step's index (and mask) slots are refreshed from the block's
    one upload by device-to-device copies; after it, its metrics are copied
    into row i of the stacked outputs. The first run of a new shape is the
    capture's eager warm-up. The lr is the optimizer's device tensor,
    filled once a block; the dropout generator is registered with the
    graph, so replay i draws the masks that the i-th per-batch step would,
    and leaves the generator where K per-batch steps leave it. Under
    `distributed` the captured step holds the all-reduce (NCCL); under
    gloo, and on the CPU, the block is K per-batch steps. Either way the
    block computes what K consecutive `make_bank_train_step` calls do, bit
    for bit. `block.graphs` is its GraphCache, `block.captured` whether
    its last call replayed a graph. Each call is a `train.block` span
    (utils/spans.py), with device time."""
    cache = GraphCache()

    def block_fn(state: TrainState, feat_bank, caps_bank, img_idx, row_idx,
                 lr, generator, row_mask=None, n_rows=None):
        with spans.span("train.block", device=feat_bank.device):
            K = img_idx.shape[0]
            set_lr(state.optimizer, lr)

            def step(ii, ri, mask):
                return _bank_step(dcfg, alpha_c, rep_penalty_beta, debug_nans,
                                  distributed, sharded_bank, state, feat_bank,
                                  caps_bank, ii, ri, generator, mask, n_rows)

            block_fn.captured = not _eager_block(feat_bank, distributed)
            if not block_fn.captured:
                runs = [step(img_idx[i], row_idx[i],
                             None if row_mask is None else row_mask[i])
                        for i in range(K)]
                return state, {k: torch.stack([m[k] for m in runs])
                               for k in runs[0]}

            gens = () if generator is None else (generator,)
            slot = cache.slot(
                ("train", img_idx.shape[1], caps_bank.shape[1], dcfg,
                 row_mask is None, n_rows),
                (state.decoder, state.optimizer, feat_bank, caps_bank) + gens,
                lambda: _index_slots(feat_bank, img_idx, row_idx, row_mask))

            def body(b):
                _write_out(b, **step(b["img_idx"], b["row_idx"],
                                     b["row_mask"]))

            step0 = state.step      # the host's count; a replay runs no Python
            metrics = _replay_block(slot, body, gens, img_idx, row_idx,
                                    row_mask)
            state.step = step0 + K
            return state, metrics

    block_fn.graphs = cache
    block_fn.captured = False
    return block_fn


def make_bank_eval_block(dcfg: DecoderConfig, alpha_c: float,
                         distributed: bool = False,
                         sharded_bank: bool = False,
                         debug_nans: bool = False):
    """K eval batches in one dispatch: `block(decoder, feat_bank, caps_bank,
    img_idx (K, B), row_idx (K, B), row_mask (K, B) or None, n_rows=None)
    -> (metrics, tokens (K, B, T-1))`, each metric stacked to (K,), all on
    the device. No alphas: the blocked path serves VALIDATION, where
    nothing reads them (and `debug_nans` flags the metrics). On the card
    one eval step is captured per (B, T, mask, n_rows) shape and replayed
    K times, as in `make_bank_train_block`; on the CPU, and under gloo, the
    block is K eval steps."""
    cache = GraphCache()

    def block_fn(decoder, feat_bank, caps_bank, img_idx, row_idx,
                 row_mask=None, n_rows=None):
        K = img_idx.shape[0]
        n = n_rows if distributed else None

        def step(ii, ri, mask):
            metrics, tokens, _ = _eval(dcfg, alpha_c, decoder,
                                       bank_rows(feat_bank, ii, sharded_bank),
                                       bank_caps(caps_bank, ri, sharded_bank),
                                       mask, n, debug_nans, with_alphas=False)
            return metrics, tokens

        if _eager_block(feat_bank, distributed):
            runs = [step(img_idx[i], row_idx[i],
                         None if row_mask is None else row_mask[i])
                    for i in range(K)]
            return ({k: torch.stack([m[k] for m, _ in runs])
                     for k in runs[0][0]},
                    torch.stack([t for _, t in runs]))

        slot = cache.slot(
            ("eval", img_idx.shape[1], caps_bank.shape[1], dcfg,
             row_mask is None, n),
            (decoder, feat_bank, caps_bank),
            lambda: _index_slots(feat_bank, img_idx, row_idx, row_mask))

        def body(b):
            metrics, tokens = step(b["img_idx"], b["row_idx"], b["row_mask"])
            _write_out(b, tokens=tokens, **metrics)

        out = _replay_block(slot, body, (), img_idx, row_idx, row_mask)
        tokens = out.pop("tokens")
        return out, tokens

    block_fn.graphs = cache
    return block_fn
