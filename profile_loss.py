#!/usr/bin/env python3
"""How often torch.profiler loses a kernel of a graph replay, on the card.

    python3 profile_loss.py [--reps N] [--seed 0] [--out FILE]

Run from the root of a checkout, on a machine with a CUDA card. It builds
the kernels as chip_smoke.py does and captures greedy decode's CUDA graph
at B = 128 twice: with BERT's decoder (E = 768, V = 30,522) and with the
flagship's (vocab 2633, E = D = 512), random weights from --seed and the
stop logits pinned, so that every replay runs all 51 steps and launches 51
attention_fwd. Each replay is profiled alone, with the card idle
chip_smoke.py's PROFILE_PAD_S before and after it inside the window (but
without chip_smoke.py's LEAD_IN spin kernels), N times for BERT, N / 2
for the flagship, and N / 2 for BERT with four small kernels launched
just before the replay. For
each profile it counts attention_fwd twice: in `key_averages()`, which
chip_smoke.py reads, and in the raw Kineto events, before torch parses
them; and it records the first device event's start against the first
host event's (the lead, negative when the card's clock runs ahead). Prints
one JSON line a case (the profiles short of 51, the leads' range) and the
card's name and power limit; `--out` writes every profile's counts and
times.
"""

from __future__ import annotations

import argparse
import json
import time

import chip_smoke as smoke


def profile_replay(fn, lead_in: bool) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(smoke.PROFILE_PAD_S)
        if lead_in:
            z = torch.zeros(1, device="cuda")
            for _ in range(4):
                z.add_(1)
        fn()
        torch.cuda.synchronize()
        time.sleep(smoke.PROFILE_PAD_S)
    cuda = torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results
    start = raw.trace_start_ns()
    device = sorted((e.start_ns() - start, e.name()) for e in raw.events()
                    if e.device_type() == cuda)
    host = [e.start_ns() - start for e in raw.events()
            if e.device_type() != cuda]
    averaged = sum(e.count for e in prof.key_averages()
                   if e.device_type == cuda
                   and smoke.kernel_of(e.key) == "attention_fwd")
    return {"key_averages": averaged,
            "raw": sum("attention_fwd" in n for _, n in device),
            "device_events": len(device),
            "lead_us": (device[0][0] - min(host)) / 1e3
            if device and host else None,
            "attention_us": [round(t / 1e3, 1) for t, n in device
                             if "attention_fwd" in n]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=150)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args()
    dev = smoke.phase_device()
    smoke.phase_build()
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 encoder_from_jax)
    from sat_tpu_torch.models.beam import greedy_caption
    from sat_tpu_torch.models.encoder import encoder_forward
    from sat_tpu_torch.utils.graphs import GraphCache

    dcfg, _, worst, enc_flat, images = smoke.make_weights(args.seed)
    feats = encoder_forward(encoder_from_jax(enc_flat, "vgg19", "cuda"),
                            "vgg19", images)
    bert_cfg, _, _, bert_worst = smoke.bert_weights(args.seed)
    decoders = {"bert": decoder_from_jax(bert_worst, bert_cfg, "cuda"),
                "flagship": decoder_from_jax(worst, dcfg, "cuda")}
    detail = {}
    for name, reps, lead_in in (("bert", args.reps, False),
                                ("flagship", args.reps // 2, False),
                                ("bert", args.reps // 2, True)):
        dec, cache = decoders[name], GraphCache()
        for _ in range(2):                    # capture, then one replay
            greedy_caption(dec, feats, graphs=cache)
        runs = [profile_replay(lambda: greedy_caption(dec, feats,
                                                      graphs=cache), lead_in)
                for _ in range(reps)]
        case = f"{name}{'_lead_in' if lead_in else ''}"
        leads = [r["lead_us"] for r in runs]
        short = [i for i, r in enumerate(runs)
                 if r["key_averages"] != smoke.STEPS
                 or r["raw"] != smoke.STEPS]
        smoke.emit({"case": case, "profiles": reps,
                    "expected_attention_fwd": smoke.STEPS,
                    "short": [{k: runs[i][k] for k in (
                        "key_averages", "raw", "lead_us")} for i in short],
                    "lead_us_min": min(leads), "lead_us_max": max(leads)})
        detail[case] = runs
    if args.out:
        with open(args.out, "w") as f:
            json.dump(detail, f)
    print(dev["card"], flush=True)


if __name__ == "__main__":
    main()
