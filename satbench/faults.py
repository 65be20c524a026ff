"""Faults planted in the program under test, for the checks' own tests and
readings (`--fault NAME`): each breaks the timed path underneath, where a
faster but wrong change would, and `correct` has to come out false.

  token       the beam's top-k picks each row's entries one place off, so
              tokens are altered where they are produced; the train
              step's caption rows come with each word id one off
  rank        the beam's top-k returns each row's ranks 2..k+1 with their
              own values: a wrong search whose captions, scores and
              attention weights agree with one another
  half_batch  the caption step encodes the first half of its batch and
              repeats it; the train step computes its loss and gradients
              over the first half of its rows, the mean taken over them
  frozen      the train step computes its gradients and leaves the
              parameters and the optimizer's state unchanged
"""

from __future__ import annotations

import contextlib

NAMES = ("token", "rank", "half_batch", "frozen")


@contextlib.contextmanager
def planted(name: str | None):
    if name is None:
        yield
        return
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}; use one of {NAMES}")
    import torch

    import sat_tpu_torch.engine.serving as serving
    import sat_tpu_torch.models.beam as beam
    import sat_tpu_torch.parallel.train_step as train_step

    saved = []

    def patch(module, attr, value):
        saved.append((module, attr, getattr(module, attr)))
        setattr(module, attr, value)

    if name == "token":
        topk, caps = beam.topk, train_step.bank_caps

        def off_by_one(x, k):
            values, idx = topk(x, k)
            return values, (idx + 1) % x.shape[1]

        def caps_off(bank, rows, sharded=False):
            got = caps(bank, rows, sharded)
            return torch.where(got > 4, got - 1,
                               torch.where(got == 4, got + 1, got))
        patch(beam, "topk", off_by_one)
        patch(train_step, "bank_caps", caps_off)
    elif name == "rank":
        topk = beam.topk

        def after_best(x, k):
            values, idx = topk(x, k + 1)
            return values[:, 1:].contiguous(), idx[:, 1:].contiguous()
        patch(beam, "topk", after_best)
    elif name == "half_batch":
        encode = serving.encoder_forward
        loss = train_step._loss_and_metrics

        def half_encode(enc, network, images, dtype=None):
            half = images[:max(1, len(images) // 2)]
            grid = encode(enc, network, half, dtype)
            reps = -(-len(images) // len(half))
            return grid.repeat(reps, 1, 1)[:len(images)].contiguous()

        def half_loss(dcfg, alpha_c, decoder, features, captions, *args,
                      **kw):
            n = max(1, features.shape[0] // 2)
            return loss(dcfg, alpha_c, decoder, features[:n], captions[:n],
                        *args, **kw)
        patch(serving, "encoder_forward", half_encode)
        patch(train_step, "_loss_and_metrics", half_loss)
    else:
        update = train_step._update

        def frozen(state, loss, sums=None):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            state.step += 1
            return None
        patch(train_step, "_update", frozen)
    try:
        yield
    finally:
        for module, attr, value in reversed(saved):
            setattr(module, attr, value)
