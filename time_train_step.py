#!/usr/bin/env python3
"""The per-batch bank train step of a checkout of sat_tpu_torch, timed.

    python3 time_train_step.py [--tree DIR] [--steps 16]

Imports sat_tpu_torch from DIR (default: the directory of this script),
which builds its kernels at first use, and times the flagship decoder's
per-batch bank train step as chip_smoke.py's train phase drives it: tf +
ado + attention, vocab 2633, E = D = 512, dropout 0.5, B = 64 rows of
27-token captions, a device bank of 512 random feature grids, TF32 off.
Host clock around `--steps` synchronized steps, after 3 warm-up steps of
each mode, remat on and off in turns (on, off, off, on). Prints one JSON
line: the tree, the card's name and power limit, and for each mode the ms
a step and the peak memory allocated of each window.

To compare two commits on one card, run it in one call for both trees in
turns (A, B, B, A), the other commit unpacked by `git archive` into a
git-ignored directory. `--device cpu --batch 2 --steps 1` checks the
script itself on a host without CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

VOCAB, CAP_LEN, BANK_U, BANK_N = 2633, 27, 512, 1024
L, D = 196, 512            # VGG19 grid and annotation width
N_BATCHES = 8
SEED = 0


def captions(torch, constants, gen, rows: int):
    """(rows, CAP_LEN) int32: <start>, 8 to 25 words, <eos>, then <pad>."""
    caps = torch.full((rows, CAP_LEN), constants.PAD, dtype=torch.int32)
    caps[:, 0] = constants.START
    for i, n in enumerate(torch.randint(8, CAP_LEN - 1, (rows,),
                                        generator=gen).tolist()):
        caps[i, 1:n + 1] = torch.randint(4, VOCAB, (n,), generator=gen,
                                         dtype=torch.int32)
        caps[i, n + 1] = constants.EOS
    return caps


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        "not read: nvidia-smi failed"


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    parser.add_argument("--steps", type=int, default=16)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    import sat_tpu_torch
    from sat_tpu_torch import constants
    from sat_tpu_torch.compat.jax_params import decoder_from_jax
    from sat_tpu_torch.models.decoder import (DecoderConfig,
                                              init_decoder_params)
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_train_step)

    where = os.path.dirname(os.path.dirname(os.path.abspath(
        sat_tpu_torch.__file__)))
    if where != tree:
        raise SystemExit(f"sat_tpu_torch came from {where}, not {tree}")
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("time_train_step: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    gen = torch.Generator().manual_seed(SEED)
    dcfg = DecoderConfig(vocab_size=VOCAB, encoder_dim=D, use_tf=True,
                         use_ado=True, use_attention=True)
    flat = init_decoder_params(dcfg, gen)
    bank = torch.rand((BANK_U, L, D), generator=gen).to(args.device)
    caps = captions(torch, constants, gen, BANK_N).to(args.device)
    batches = [(torch.randint(0, BANK_U, (args.batch,), generator=gen)
                .to(args.device),
                torch.randint(0, BANK_N, (args.batch,), generator=gen)
                .to(args.device)) for _ in range(N_BATCHES)]
    state = init_train_state(decoder_from_jax(flat, dcfg, args.device,
                                              trainable=True))
    dgen = torch.Generator(device=args.device).manual_seed(SEED)
    steps = {"remat": make_bank_train_step(dcfg, 1.0),
             "no_remat": make_bank_train_step(
                 dataclasses.replace(dcfg, remat_scan=False), 1.0)}
    done = 0

    def run(mode: str, n: int):
        nonlocal state, done
        for _ in range(n):
            ii, ri = batches[done % N_BATCHES]
            state, m = steps[mode](state, bank, caps, ii, ri, 1e-4, dgen)
            done += 1
        return float(m["loss"])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for mode in steps:
        run(mode, 3)
    timing = {m: {"ms_per_step": [], "peak_mem_gb": []} for m in steps}
    for mode in ("remat", "no_remat", "no_remat", "remat"):
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = run(mode, args.steps)
        sync()
        timing[mode]["ms_per_step"].append(
            (time.perf_counter() - t0) * 1e3 / args.steps)
        timing[mode]["peak_mem_gb"].append(
            torch.cuda.max_memory_allocated() / 1e9 if cuda else None)
    print(json.dumps({"tree": tree, "card": card() if cuda else None,
                      "batch": args.batch, "steps": args.steps,
                      "last_loss": loss, "timing": timing}), flush=True)


if __name__ == "__main__":
    main()
