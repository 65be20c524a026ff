"""What the captioning drivers share: the seeded weights and image pool,
and the check of sampled beam captions against the reference."""

from __future__ import annotations

import gc
import time

from satbench import checks, weights
from satbench.reference import model as reference


class CaptionInputs:
    """The encoder's and decoder's weights and a pool of images, all from
    the seed, in one generator on the device. The pool's images are
    N(0, 1) noise scaled by one of `contrast` levels in turn (so that
    images differ in how their captions end) and live on the host as
    float32 NHWC arrays, as a server's preloaded pool and an offline
    split's batches do. The decoder's first stop id has its output bias
    raised by the traffic's `stop_boost`."""

    def __init__(self, ctx):
        import numpy as np
        import torch
        cfg, tr = ctx.config, ctx.traffic
        dev = self.device = ctx.device
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        self.enc_w = weights.encoder_weights(gen, dev)
        self.dec_w = weights.raise_stop(
            weights.decoder_weights(cfg, gen, dev), cfg["stop_ids"][0],
            tr["stop_boost"])
        P, S = tr["pool"], cfg["image_size"]
        lo, hi, n = tr["contrast"]
        levels = torch.linspace(lo, hi, n, device=dev)
        scale = levels[torch.arange(P, device=dev) % n]
        pool = torch.randn((P, S, S, 3), generator=gen, device=dev)
        self.pool = np.ascontiguousarray(
            (pool * scale[:, None, None, None]).cpu().numpy())
        del pool

    def images(self, rows):
        """Pool rows as a tensor on the reference's device."""
        import torch
        return torch.as_tensor(self.pool[rows], device=self.device)


def synchronize(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def free(device) -> None:
    """Return what the program held to the card before the reference
    runs."""
    import torch
    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()


def check_captions(ctx, inputs: CaptionInputs, batches, tf32: bool = False):
    """The compared numbers of `batches`, [(pool rows, result dict)], each
    a program's (or, with `tf32`, the control's) beam captions of those
    images, against the reference in float32."""
    cfg, K = ctx.config, ctx.traffic["beam"]
    nums, t0 = [], time.perf_counter()
    for rows, out in batches:
        with reference.precision(False):
            grid = reference.encode(inputs.enc_w, inputs.images(rows))
            nums.append(checks.caption(out, grid, inputs.dec_w, K,
                                       cfg["stop_ids"], cfg["start_token"],
                                       reference))
    synchronize(ctx.device)
    numbers = checks.worst(nums)
    numbers["beam_steps"] = [b["ref_steps"] for b in nums]
    numbers["reference_s"] = time.perf_counter() - t0
    numbers["checked"] = sum(len(r) if not isinstance(r, slice)
                             else r.stop - r.start for r, _ in batches)
    return numbers


def control_captions(inputs: CaptionInputs, ctx, rows) -> dict:
    """The reference's beam captions of pool `rows` with TF32 on: the
    control, in the program's place."""
    with reference.precision(True):
        grid = reference.encode(inputs.enc_w, inputs.images(rows))
        return reference.beam_search(inputs.dec_w, grid, ctx.traffic["beam"],
                                     ctx.config["stop_ids"],
                                     ctx.config["start_token"])


def log_short_beams(ctx, steps) -> None:
    """Say on the log when a checked batch's beam ran fewer than the
    configuration's max_steps: the traffic's worst case (every batch
    decodes all the steps) did not hold there."""
    short = [n for n in steps if n < ctx.config["max_steps"]]
    if short:
        ctx.log(warning="a checked batch's beam ran fewer steps than "
                f"max_steps {ctx.config['max_steps']}", beam_steps=steps)


def quarter_rates(ends, unit: float, seconds: float) -> list:
    """Work a second in each quarter of the window, from the seconds
    (from the window's start) at which each item of `unit` work ended;
    the last item, which ends past `seconds`, counts in the last
    quarter."""
    q = seconds / 4
    counts = [0, 0, 0, 0]
    for t in ends:
        counts[min(3, int(t // q))] += 1
    return [c * unit / q for c in counts]
