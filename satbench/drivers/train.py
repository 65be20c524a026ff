"""Decoder training from a resident feature bank in K-step blocks: the
port's `make_bank_train_block` (parallel/train_step.py; the train CLI's
`--cache-features --steps-per-dispatch K`), driven as
`Trainer._train_epoch_blocked` drives it: each block's caption rows come
from the epoch's seeded permutation, are uploaded with their images'
bank rows as (K, B) indices, and the previous block's metrics are read
back to the host while this one runs.

Traffic parameters: `batch` rows a step, `block` steps a dispatch,
`bank_images` grids in the bank and `captions_per_image` caption rows
each (Flickr8k's Karpathy train split: 6,000 images, 30,000 captions), a
caption of `caption_tokens` columns with `words` words (lowest, highest)
between its start and end tokens, and `checked_steps`, one more than a
multiple of `block`. The bank is
uniform [0, 1) noise, as nonnegative as the encoder's ReLU grids; the
epoch's short last block of rows is left out, where the trainer would run
it as single steps.

Set-up builds the one train state that the window goes on training:
its first `checked_steps` steps are a block of one step (whose eager
warm-up captures the step's graph; the optimizer's state after it gives
the first gradient) and then full blocks of `block` steps, the window's
own shape, through the window's own call, on the epoch's first rows. The
reference follows those steps from the same weights, rows and dropout
draws (checks.training).

End-to-end: train_rows_per_s, the rows of every block in the window over
its seconds, every block's metrics read back. Traced: two blocks under
the profiler, and the window's rate.
"""

from __future__ import annotations

import statistics
import time

from satbench import checks, faults, program, trace, weights
from satbench.counts import flops, peaks
from satbench.drivers import common
from satbench.reference import model as reference


class Bank:
    """The feature bank, the caption rows and the epochs' row order, all
    from the seed."""

    def __init__(self, ctx):
        import torch
        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        self.w = weights.decoder_weights(cfg, gen, dev)
        U, (gh, gw) = tr["bank_images"], cfg["grid"]
        self.feats = torch.rand((U, gh * gw, cfg["encoder_dim"]),
                                generator=gen, device=dev)
        N, C = U * tr["captions_per_image"], tr["caption_tokens"]
        lo, hi = tr["words"]
        n = torch.randint(lo, hi + 1, (N, 1), generator=gen, device=dev)
        words = torch.randint(*cfg["word_ids"], (N, C), generator=gen,
                              device=dev)
        pos = torch.arange(C, device=dev)[None]
        self.caps = torch.where(
            pos == 0, cfg["start_token"], torch.where(
                pos <= n, words, torch.where(pos == n + 1, cfg["end_token"],
                                             cfg["pad_token"]))).int()
        self.seed, self.N, self.cpi = ctx.seed, N, tr["captions_per_image"]
        self.B, self.K = tr["batch"], tr["block"]

    def checked(self, blocks, steps: int):
        """The rows (steps, B) of the first `steps` steps, taken from the
        blocks of `blocks`."""
        import numpy as np
        got = [next(blocks) for _ in range(-(-steps // self.K))]
        return np.concatenate(got)[:steps]

    def blocks(self):
        """(rows (k, B)) blocks of the epochs' permutations, endless."""
        import numpy as np
        epoch = 0
        while True:
            order = np.random.default_rng((self.seed, epoch)).permutation(
                self.N)
            full = len(order) // (self.K * self.B) * self.K * self.B
            for s in range(0, full, self.K * self.B):
                yield order[s:s + self.K * self.B].reshape(self.K, self.B)
            epoch += 1

    def indices(self, rows, device):
        """(img_idx, row_idx) of rows (k, B) on the device, as
        Trainer._bank_indices uploads them."""
        import torch
        rows = torch.as_tensor(rows, dtype=torch.long)
        return (rows // self.cpi).to(device), rows.to(device)


def _dropout_seed(seed: int) -> int:
    return seed + 1


def _keeps(ctx, bank: Bank, steps: int):
    """The dropout masks of the first steps, drawn as the program's step
    draws them from a generator of the same seed."""
    import torch
    cfg = ctx.config
    gen = torch.Generator(device=ctx.device).manual_seed(
        _dropout_seed(ctx.seed))
    shape = (bank.B, ctx.traffic["caption_tokens"] - 1,
             cfg["embedding_size"])
    return [torch.rand(shape, generator=gen, device=ctx.device)
            < 1.0 - cfg["dropout_rate"] for _ in range(steps)]


def _reference(ctx, bank: Bank, rows, tf32: bool):
    """The reference's (losses, first gradients, parameters after) over
    the checked steps' rows."""
    cfg = ctx.config
    keeps = _keeps(ctx, bank, len(rows))
    batches = []
    for r, keep in zip(rows, keeps):
        img, row = bank.indices(r, ctx.device)
        batches.append((bank.feats[img], bank.caps[row], keep))
    with reference.precision(tf32):
        return reference.train_steps(bank.w, weights.trainable(cfg, bank.w),
                                     batches, cfg["dropout_rate"],
                                     cfg["alpha_c"], cfg["lr"])


def _compare(ctx, bank, rows, losses, grads, params):
    import torch
    ref_losses, ref_grads, ref_params = _reference(ctx, bank, rows, False)
    w = bank.w
    deltas = {k: params[k] - w[k] for k in ref_params}
    ref_deltas = {k: ref_params[k] - w[k] for k in ref_params}
    grads = {k: grads.get(k, torch.zeros_like(w[k])) for k in ref_grads}
    return checks.training(losses, ref_losses, grads, ref_grads, deltas,
                           ref_deltas)


def run(ctx) -> dict:
    import torch
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_train_block)

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    ctx.mark("imports")
    bank = Bank(ctx)
    ctx.mark("inputs")
    B, K, C = bank.B, bank.K, tr["caption_tokens"]
    n_check = tr["checked_steps"]
    if (n_check - 1) % K or n_check < 1 + K:
        raise ValueError(f"checked_steps {n_check} is not 1 + a multiple "
                         f"of block {K}")
    program.f32_math()
    with faults.planted(ctx.fault):
        dcfg, dec = program.decoder(cfg, bank.w, dev)
        state = init_train_state(dec)
        block = make_bank_train_block(dcfg, cfg["alpha_c"])
        gen = torch.Generator(device=dev).manual_seed(_dropout_seed(ctx.seed))
        blocks = bank.blocks()
        first = bank.checked(blocks, n_check)
        names = [k for k, p in dec.named_parameters() if p.requires_grad]
        by_param = dict(zip((p for p in dec.parameters() if p.requires_grad),
                            names))

        def run_block(rows, launches=None):
            nonlocal state
            img, row = bank.indices(rows, dev)
            t = time.perf_counter()
            state, m = block(state, bank.feats, bank.caps, img, row,
                             cfg["lr"], gen)
            if launches is not None:    # host seconds the block's launch took
                launches.append(time.perf_counter() - t)
            return m

        ctx.mark("program")
        losses = [float(x) for x in run_block(first[:1])["loss"].cpu()]
        ctx.mark("first_block")
        b1 = 1.0 - state.optimizer.param_groups[0]["betas"][0]
        grads = {by_param[p]: s["exp_avg"].detach() / b1
                 for p, s in state.optimizer.state.items() if "exp_avg" in s}
        grads = {k: v.clone() for k, v in grads.items()}
        for at in range(1, n_check, K):
            losses += [float(x) for x in
                       run_block(first[at:at + K])["loss"].cpu()]
        params = {k: p.detach().clone() for k, p in dec.named_parameters()}
        common.synchronize(dev)
        setup_s = time.perf_counter() - ctx.t0
        steps, pending, ends, launches = 0, None, [], []
        t_start = time.perf_counter()
        while True:
            m = run_block(next(blocks), launches)
            if pending is not None:
                read_back(pending)
            pending = m
            steps += K
            ends.append(time.perf_counter() - t_start)
            if ends[-1] >= ctx.seconds:
                break
        read_back(pending)
        window_s = time.perf_counter() - t_start
        peak = (torch.cuda.max_memory_allocated()
                if dev.startswith("cuda") else 0)
        traced = None
        if ctx.trace:
            prof = trace.profile(lambda: [run_block(next(blocks))["loss"]
                                          .cpu() for _ in range(2)])
            L, D, E = bank.feats.shape[1], cfg["encoder_dim"], \
                cfg["embedding_size"]
            traced = {
                "profile": prof, "steps_per_s": steps / window_s,
                "flops_per_step": flops.train_step(B, C - 1, L, D, E,
                                                   cfg["vocab_size"]),
                "peaks": peaks.card_peaks(torch.cuda.get_device_name(0)),
                "attention_fwd": {"images": B, "R": 1, "L": L, "D": D,
                                  "E": E},
                "attention_bwd": {"images": B, "L": L, "D": D, "E": E}}
    del state, block, dec
    common.free(dev)
    t_ref = time.perf_counter()
    numbers = _compare(ctx, bank, first, losses, grads, params)
    numbers["reference_s"] = time.perf_counter() - t_ref
    ctx.log(cell=ctx.cell.name, seed=ctx.seed, steps=steps,
            window_s=window_s, setup_s=setup_s, losses=losses,
            quarter_rates=common.quarter_rates(ends, K * B, ctx.seconds),
            launch_ms_median=1e3 * statistics.median(launches),
            numbers=numbers)
    return {"setup_s": setup_s, "window_s": window_s,
            "attempted": steps * B, "failed": 0,
            "e2e": {"train_rows_per_s": steps * B / window_s},
            "numbers": numbers, "memory_peak_bytes": peak,
            "trace": traced}


def control(ctx) -> dict:
    """The control: the reference's checked steps with TF32 on, in the
    program's place."""
    bank = Bank(ctx)
    rows = bank.checked(bank.blocks(), ctx.traffic["checked_steps"])
    losses, grads, params = _reference(ctx, bank, rows, True)
    return _compare(ctx, bank, rows, losses, grads, params)


def read_back(metrics: dict) -> dict:
    """A block's metrics on the host, as the trainer reads them."""
    return {k: v.cpu() for k, v in metrics.items()}
