"""Offline beam captioning: batches of images through the port's caption
step (engine/serving.py::build_caption_step, beam search, its graphs
replayed), as `caption_split` and `generate_caption` drive it.

Traffic parameters: `batch` images a call, `beam`, a `pool` of images
from the seed (a multiple of `batch`; call i takes the pool's slice i mod
pool/batch), their `contrast` levels and the `stop_boost` of the decoder
(drivers/common.py). The check takes one window call of each of the
pool's slices, drawn from the seed as the window runs (reservoir sampling,
so that only they are kept): every distinct batch of the window is
checked, and the reference's beam steps on it are the steps of every
window call on that slice.

End-to-end: captions_per_s, the images of every call in the window over
the window's seconds, each call's tokens, lengths, scores and found flags
read back to the host as a caller reads them. Traced: one profiled slice
of three calls, CUDA-event spans around the encoder and the beam on one
batch (the beam replaying the step's own graphs), and the window's rate;
mfu.caption counts the decode at the reference's mean beam steps over the
checked batches.
"""

from __future__ import annotations

import random
import time

from satbench import faults, program, trace
from satbench.counts import flops, peaks
from satbench.drivers import common

def run(ctx) -> dict:
    import torch
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.models.beam import beam_search_batched
    from sat_tpu_torch.models.encoder import encoder_forward

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    B, K, P = tr["batch"], tr["beam"], tr["pool"]
    if P % B:
        raise ValueError(f"pool {P} is not a multiple of batch {B}")
    slices = [slice(o, o + B) for o in range(0, P, B)]
    ctx.mark("imports")
    inputs = common.CaptionInputs(ctx)
    ctx.mark("inputs")
    program.f32_math()
    with faults.planted(ctx.fault):
        enc = program.encoder(cfg, inputs.enc_w, dev)
        dcfg, dec = program.decoder(cfg, inputs.dec_w, dev)
        step = build_caption_step(cfg["network"], dcfg, K, device=dev)
        ctx.mark("program")

        def call(i):
            out = step(enc, dec, inputs.pool[slices[i % len(slices)]])
            for k in ("tokens", "length", "score", "found"):
                out[k].cpu()          # the caller's read-back
            return out

        call(0)                       # the first call captures the graphs
        ctx.mark("first_call")
        call(1)
        common.synchronize(dev)
        ctx.mark("warm")
        setup_s = time.perf_counter() - ctx.t0
        seen, kept, ends, n = [0] * len(slices), {}, [], 0
        pick = random.Random(ctx.seed)
        t_start = time.perf_counter()
        while True:
            out = call(n)
            s = n % len(slices)
            seen[s] += 1
            if pick.randrange(seen[s]) == 0:
                kept[s] = (n, out)
            n += 1
            ends.append(time.perf_counter() - t_start)
            if ends[-1] >= ctx.seconds:
                break
        window_s = ends[-1]
        del out
        peak = (torch.cuda.max_memory_allocated()
                if dev.startswith("cuda") else 0)
        traced = None
        if ctx.trace:
            prof = trace.profile(lambda: [call(i) for i in range(3)])
            images = inputs.pool[slices[0]]
            feats = encoder_forward(enc, cfg["network"], images)
            L, D = feats.shape[1], feats.shape[2]
            E, V = cfg["embedding_size"], cfg["vocab_size"]
            traced = {
                "profile": prof,
                "spans_ms": {
                    "encoder": trace.spans_ms(lambda: encoder_forward(
                        enc, cfg["network"], images)),
                    "decode": trace.spans_ms(lambda: beam_search_batched(
                        dec, feats, K, graphs=step.graphs))},
                "batches_per_s": n / window_s,
                "peaks": peaks.card_peaks(torch.cuda.get_device_name(0)),
                "topk": {"rows": B, "n": K * V, "k": K},
                "attention_fwd": {"images": B, "R": K, "L": L, "D": D,
                                  "E": E}}
    picks = sorted(i for i, _ in kept.values())
    kept = [(slices[s], out) for s, (_, out) in sorted(kept.items())]
    del step, enc, dec
    common.free(dev)
    numbers = common.check_captions(ctx, inputs, kept)
    if traced is not None:
        steps = sum(numbers["beam_steps"]) / len(numbers["beam_steps"])
        traced["flops_per_batch"] = flops.caption_batch(
            B, cfg["image_size"], K, steps, L, D, E, V)
    ctx.log(cell=ctx.cell.name, seed=ctx.seed, batches=n, window_s=window_s,
            setup_s=setup_s, checked_batches=picks,
            quarter_rates=common.quarter_rates(ends, B, ctx.seconds),
            numbers=numbers)
    common.log_short_beams(ctx, numbers["beam_steps"])
    return {"setup_s": setup_s, "window_s": window_s, "attempted": n * B,
            "failed": 0, "e2e": {"captions_per_s": n * B / window_s},
            "numbers": numbers, "memory_peak_bytes": peak,
            "trace": traced}


def control(ctx) -> dict:
    """The control's numbers on every slice of the pool."""
    tr = ctx.traffic
    inputs = common.CaptionInputs(ctx)
    rows = [slice(o, o + tr["batch"]) for o in
            range(0, tr["pool"], tr["batch"])]
    batches = [(r, common.control_captions(inputs, ctx, r)) for r in rows]
    return common.check_captions(ctx, inputs, batches)
