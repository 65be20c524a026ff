#!/usr/bin/env python3
"""Host cost of calling the port's kernels, on the card unless asked.

    python3 time_op_dispatch.py [--tree DIR] [--device cuda|cpu] [--calls N]
                                [--custom-op]

Imports sat_tpu_torch from DIR (default: the directory of this script),
which builds its kernels at first use. Where the tree registers the three
kernels as the operators `sat::topk`, `sat::attention_fwd` and
`sat::attention_bwd` (sat_tpu_torch/ops), each public wrapper checks its
inputs and calls its operator, which the dispatcher routes to the
implementation of the tensors' device: the plain form on the CPU, the
kernel's launch on the card. For each kernel this times, on the host
clock, microseconds a call of:
  - `wrapper`: the public function (`topk`, `attention_fwd`,
    `attention_bwd`), in every tree;
  - `operator`: `torch.ops.sat.<name>` (dispatch and implementation);
  - `implementation`: the implementation called directly;
and `dispatch_us` = operator - implementation, the cost the operators add
to every eager call. A tree without the operators (an older commit) gets
the wrapper's time only. One more row, `fused_attention`, times as its
`wrapper` the training path: `FusedAttention` forward and backward, the
keys, u_h, v and b_v requiring gradients and the features not, as in a
bank train step. `--custom-op` adds, for top-k, `custom_op`: the
same implementation registered through `torch.library.custom_op` (a probe
operator, `sat_probe::topk`), the higher-level API that the operators do
not use, because it cost more. The inputs are small (the host's cost is the
call's); on the card the calls are queued back to back and the clock
stops after a synchronize. The median of 11 rounds of --calls calls each,
the forms in turns within a round. Prints one JSON line, with the card's
name and power limit.

To compare two commits on one card, run it in one call for both trees in
turns (A, B, B, A), the other commit unpacked by `git archive` into a
git-ignored directory. `--device cpu` times the plain forms on one CPU
thread.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch


def _us(fns: dict, device: torch.device, calls: int,
        rounds: int = 11) -> dict:
    """{name: median microseconds a call} of each function of `fns`, timed
    in turns: a round times `calls` calls of each in order."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for fn in fns.values():
        for _ in range(max(calls // 10, 10)):
            fn()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            sync()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            sync()
            times[name].append((time.perf_counter() - t0) / calls * 1e6)
    return {name: statistics.median(t) for name, t in times.items()}


def measure(device="cuda", calls: int = 1000,
            custom_op: bool = False) -> dict:
    """{kernel: {wrapper[, operator, implementation, dispatch_us]}} and
    {"fused_attention": {wrapper}} in microseconds a call on `device`,
    top-k's with `custom_op` if asked (module note)."""
    from sat_tpu_torch.device import resolve_device
    from sat_tpu_torch.ops import fused_attention as fa
    from sat_tpu_torch.ops import topk as tk

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    B, L, E, D = 2, 8, 16, 16
    x = rand(B, 64)
    keys, feats, u_h = rand(B, L, E), rand(B, L, D), rand(B, E)
    v, b_v = rand(E), rand(1)
    alpha = torch.softmax(rand(B, L), dim=-1)
    dctx, dalpha = rand(B, D), rand(B, L)
    fwd = (keys, feats, u_h, v, b_v, 1)
    bwd = (keys, feats, u_h, v, alpha, dctx, dalpha, True)
    cases = {"topk": (tk.topk, (x, 5)),
             "attention_fwd": (fa.attention_fwd, fwd),
             "attention_bwd": (fa.attention_bwd, bwd)}
    operators = hasattr(tk, "topk_cuda")
    if operators:
        cuda = dev.type == "cuda"
        impls = {"topk": tk.topk_cuda if cuda else tk.topk_plain,
                 "attention_fwd": (fa.attention_fwd_cuda if cuda
                                   else fa.attention_plain),
                 "attention_bwd": (fa.attention_bwd_cuda if cuda
                                   else fa.attention_bwd_plain)}
    params = [t.clone().requires_grad_() for t in (keys, u_h, v, b_v)]

    def train_pair():
        k, u, vv, b = params
        out, a = fa.FusedAttention.apply(k, feats, u, vv, b)
        (out.sum() + a.sum()).backward()

    out = {"fused_attention": _us({"wrapper": train_pair}, dev, calls)}
    for name, (wrapper, args) in cases.items():
        fns = {"wrapper": lambda f=wrapper, a=args: f(*a)}
        if operators:
            op = getattr(torch.ops.sat, name)
            fns["operator"] = lambda f=op, a=args: f(*a)
            fns["implementation"] = lambda f=impls[name], a=args: f(*a)
            if custom_op and name == "topk":
                fns["custom_op"] = lambda f=_custom_op(impls[name]): f(x, 5)
        row = _us(fns, dev, calls)
        if operators:
            row["dispatch_us"] = row["operator"] - row["implementation"]
        out[name] = row
    return out


def _custom_op(impl):
    """`impl` (x, k) as the custom_op `sat_probe::topk`."""
    @torch.library.custom_op("sat_probe::topk", mutates_args=())
    def probe(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        return impl(x, k)
    return probe


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        "not read: nvidia-smi failed"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("--calls", type=int, default=1000)
    parser.add_argument("--custom-op", action="store_true",
                        help="also time top-k as a torch.library.custom_op")
    args = parser.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import sat_tpu_torch

    where = os.path.dirname(os.path.dirname(os.path.abspath(
        sat_tpu_torch.__file__)))
    if where != tree:
        raise SystemExit(f"sat_tpu_torch came from {where}, not {tree}")
    if args.device == "cpu":
        torch.set_num_threads(1)
    us = measure(args.device, args.calls, args.custom_op)
    where = card() if args.device != "cpu" else "cpu, one thread"
    print(json.dumps({"tree": tree, "device": args.device, "where": where,
                      "torch": torch.__version__, "us_per_call": us}),
          flush=True)


if __name__ == "__main__":
    main()
