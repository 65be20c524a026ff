#!/usr/bin/env python3
"""Top-k past k = 16 of a checkout of sat_tpu_torch, timed on the card.

    python3 time_topk.py [--tree DIR] [--reps 100]

Imports sat_tpu_torch from DIR (default: the directory of this script),
which builds its kernels at first use, and times, at the sampler's rows
(B = 1, 32 and 128 rows of the flagship's V = 2,633 and BERT's V = 30,522
entries, random f32 from a seed), the top-k wrapper at k = 17, 50, 64, 256
and 1,024, and past 1,024 at k = 1,025, 2,048 and 2,632 (V = 2,633) and
1,025, 4,096, 16,384 and 30,521 (V = 30,522): the median of `--reps`
CUDA-event-timed calls (fewer, at least 3, where one call takes more than
a millisecond: 100 ms of calls), warm (back to back) and cold (a 128 MB
write before each call evicts the L2), beside torch.topk's warm time on
the same rows and the bound (the rows read once, k values and int64
indices written, at 3.35 TB/s). Each result is first held to the plain
form bit for bit. Then it times sample decode alone (T = 0.8, p = 0.9, k =
10, 50, 1,024 and 1,025, and the widest k, 2,632 and 30,521) through its
CUDA graph at B = 128 on random grids (196 x 512) with two decoders of
random weights: the flagship's (attention + ado, E = 512, V = 2,633) and
BERT's (tf + ado + attention, E = 768, V = 30,522, a random table): host
clock around 3 synchronized runs after the capture. Prints one JSON line:
the tree, the card's name and power limit, the rows and the decodes.

To compare two commits on one card, run it in one call for both trees in
turns (A, B, B, A), the other commit unpacked by `git archive` into a
git-ignored directory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# CUDA events, warm or with the L2 evicted; host clock around a synchronized
# call; the card's name and power limit
from chip_smoke import host_ms, nvidia_smi, time_ms

BATCHES = (1, 32, 128)
KS = (17, 50, 64, 256, 1024)
# width -> k past 1,024 (the radix sort of the survivors)
WIDE_KS = {2633: (1025, 2048, 2632), 30522: (1025, 4096, 16384, 30521)}
DECODE_KS = {"flagship": (10, 50, 1024, 1025, 2632),
             "bert": (10, 50, 1024, 1025, 30521)}
L, D = 196, 512            # VGG19 grid and annotation width
BYTES_S = 3.35e12          # H100 SXM memory rate (data sheet)
SEED = 0
CLOCK_HZ = 1.98e9          # H100 SXM's top SM clock: sizes time_ms's lead-in


def kernel_rows(torch, reps: int) -> list:
    from sat_tpu_torch.ops.topk import topk, topk_plain
    gen = torch.Generator().manual_seed(SEED)
    rows = []
    for n, wide in WIDE_KS.items():
        for B in BATCHES:
            x = torch.randn((B, n), generator=gen).cuda()
            for k in KS + wide:
                got, want = topk(x, k), topk_plain(x, k)
                if not (torch.equal(got[1], want[1]) and torch.equal(
                        got[0].view(torch.int32), want[0].view(torch.int32))):
                    raise SystemExit(f"time_topk: ({B}, {n}), k={k}: the "
                                     f"kernel differs from its plain form")
                n_reps = max(3, min(reps, int(100 / max(
                    host_ms(lambda: topk(x, k)), 1e-3))))
                rows.append({
                    "shape": [B, n], "k": k, "reps": n_reps,
                    "ms": time_ms(lambda: topk(x, k), CLOCK_HZ, n_reps,
                                  warmup=min(10, n_reps)),
                    "cold_ms": time_ms(lambda: topk(x, k), CLOCK_HZ, n_reps,
                                       warmup=min(10, n_reps), cold=True),
                    "library_ms": time_ms(
                        lambda: torch.topk(x, k, dim=1), CLOCK_HZ, reps),
                    "bound_ms": (4 * B * n + 12 * B * k) / BYTES_S * 1e3})
    return rows


def decodes(torch) -> dict:
    from sat_tpu_torch.compat.jax_params import decoder_from_jax
    from sat_tpu_torch.models.beam import batch_generator, sample_caption
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
    from sat_tpu_torch.utils.graphs import GraphCache

    gen = torch.Generator().manual_seed(SEED)
    table = (torch.randn((30522, 768), generator=gen) * 0.02).numpy()
    configs = {
        "flagship": (DecoderConfig(vocab_size=2633, encoder_dim=D,
                                   use_ado=True, use_attention=True), {}),
        "bert": (DecoderConfig(vocab_size=30522, encoder_dim=D, use_tf=True,
                               use_ado=True, use_bert=True,
                               use_attention=True),
                 {"bert_embeddings": table})}
    feats = torch.rand((128, L, D), generator=gen).cuda()
    out = {}
    for name, (cfg, extra) in configs.items():
        dec = decoder_from_jax(init_decoder_params(cfg, gen, **extra), cfg,
                               "cuda")
        cache = GraphCache()
        for k in DECODE_KS[name]:
            def run(k=k):
                return sample_caption(dec, feats,
                                      batch_generator(5, 0, "cuda"), 0.8, k,
                                      0.9, graphs=cache)
            run()                                     # the capture
            out[f"{name}_k{k}"] = [host_ms(run) for _ in range(3)]
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    parser.add_argument("--reps", type=int, default=100)
    args = parser.parse_args()

    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    import sat_tpu_torch

    where = os.path.dirname(os.path.dirname(os.path.abspath(
        sat_tpu_torch.__file__)))
    if where != tree:
        raise SystemExit(f"sat_tpu_torch came from {where}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("time_topk: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"tree": tree, "card": nvidia_smi("name,power.limit"),
                      "rows": kernel_rows(torch, args.reps),
                      "decode_ms": decodes(torch)}), flush=True)


if __name__ == "__main__":
    main()
