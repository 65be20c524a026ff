#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out chiprun_out]

Run from the root of a checkout. It builds the CUDA kernels from the
sources in the checkout and drives the port's serving path at the flagship
width: VGG19 on 128 images of 224 px, then the beam at width 5 with the
soft-attention + ado decoder (vocab 2633, E = D = 512), weights random from
--seed. Each phase prints one JSON line; a failed check exits non-zero and
no result line is printed:

  1. device  — needs CUDA; the card's name and power limit; TF32 off (the
               main path is exact f32)
  2. build   — nvcc builds ops/csrc/*.cu; build seconds, ptxas report
  3. kernels — each kernel against its plain PyTorch form at the main
               path's shapes (top-k bit-exact, also on adversarial rows;
               attention ctx atol 1e-5, alpha atol 1e-6, at R = 5 and R = 1),
               and the times of kernel, plain form and library call
  4. main    — the worst case (stop-token logits pinned to -1e9, so every
               beam runs all 51 steps) through build_caption_step; every
               kernel's launch count in that run; encoder and decode times
               and a torch.profiler breakdown of each; 8 of the images
               decoded on the GPU, beam and greedy, with their launch
               counts, and again on the CPU with the plain forms, must agree
  5. serve   — a checkpoint directory on disk, the port's build_server +
               CaptionServer on an ephemeral port, 16 concurrent requests
               and the kernels' launch counts in serving them

Then come the `{"kernels": [...]}` line, the card's name and power limit as
nvidia-smi gives them, and last `{"ok": true, "device": {...}}`. Details go
to <out>/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

B, BEAM, VOCAB, SIZE, STEPS = 128, 5, 2633, 224, 51
STOP_IDS = (1, 102)        # the vanilla beam's completion ids
EOS_BOOST = 0.6            # added to the <eos> logit bias (make_weights)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def card_peaks(name: str) -> dict:
    """Published peaks of the card (NVIDIA data sheets, dense, at the full
    power limit): memory bytes/s and f32 (non-tensor) FLOP/s."""
    if "PCIe" in name:
        return {"bytes_s": 2.0e12, "f32_s": 51.2e12, "part": "H100 PCIe"}
    if "NVL" in name:
        return {"bytes_s": 3.9e12, "f32_s": 60.0e12, "part": "H100 NVL"}
    return {"bytes_s": 3.35e12, "f32_s": 66.9e12, "part": "H100 SXM"}


def reset_launches() -> None:
    """Zero every kernel wrapper's launch count."""
    from sat_tpu_torch.ops.fused_attention import attention_fwd
    from sat_tpu_torch.ops.topk import topk
    topk.launches = attention_fwd.launches = 0


def read_launches() -> dict:
    from sat_tpu_torch.ops.fused_attention import attention_fwd
    from sat_tpu_torch.ops.topk import topk
    return {"topk": topk.launches, "attention_fwd": attention_fwd.launches}


def time_ms(fn, clock_hz: float, reps: int = 100, warmup: int = 10) -> float:
    """Median device time of one call of `fn`: `reps` calls after `warmup`,
    each between a pair of CUDA events. A sleep kernel queued first keeps
    the device behind the host while the calls are enqueued, so each pair
    brackets the call's kernels and not the host's time to launch them
    (which, for a kernel of some microseconds, is the longer)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(2 * enqueue_s * clock_hz))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


# ------------------------------------------------------------------ phases

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this test runs "
                         "only on a GPU")
    card = nvidia_smi("name,power.limit")
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    props = torch.cuda.get_device_properties(0)
    info = {"phase": "device", "card": card,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "sms": props.multi_processor_count, "max_sm_mhz": max_sm_mhz,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    emit(info)
    return info


def phase_build():
    from sat_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    log = _kernels.build(force=True)
    _kernels.library()
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})
    return {"seconds": seconds, "log": log}


def topk_inputs(gen):
    """The beam's candidate block at the main path's shape, plus
    adversarial rows: ties, -inf rows, NaN, duplicates of the max."""
    import torch
    x = torch.randn((B, BEAM * VOCAB), generator=gen)
    x[:8, VOCAB:] = float("-inf")              # step 1: row 0 only
    adv = torch.randn((B, BEAM * VOCAB), generator=gen)
    adv[0] = torch.randint(0, 3, (BEAM * VOCAB,), generator=gen).float()
    adv[1] = float("-inf")
    adv[2, 100:] = float("-inf")
    adv[3] = float("nan")
    adv[4, ::7] = float("nan")
    adv[5] = 0.0
    adv[5, [17, 4000, 9000]] = 3.0
    adv[6] = 1.0
    return x.cuda(), adv.cuda()


def phase_kernels(dev, gen) -> list[dict]:
    import torch
    from sat_tpu_torch.ops.fused_attention import (attention_fwd,
                                                   attention_plain)
    from sat_tpu_torch.ops.topk import topk, topk_plain

    peaks = card_peaks(dev["name"])
    hz = dev["max_sm_mhz"] * 1e6
    sfu_s = 16 * dev["sms"] * hz                  # MUFU results/s
    rows = []

    # ---- exact top-k (B, K*V) -> (B, K)
    x, adv = topk_inputs(gen)
    topk_err = 0.0
    for name, inp in (("random", x), ("adversarial", adv)):
        kv, ki = topk(inp, BEAM)
        pv, pi = topk_plain(inp, BEAM)
        torch.cuda.synchronize()
        check(torch.equal(ki, pi), f"topk indices differ on {name} rows")
        check(torch.equal(kv, pv), f"topk values differ on {name} rows")
        # -inf - -inf is NaN: equal entries, so NaN counts as 0
        topk_err = max(topk_err,
                       (kv - pv).abs().nan_to_num(0.0).max().item())
    n = x.numel()
    bytes_ = 4 * n + B * BEAM * (4 + 8)
    t_bytes = bytes_ / peaks["bytes_s"]
    t_ops = n * BEAM / peaks["f32_s"]          # one compare per entry a round
    rows.append({
        "name": "topk", "route": "cuda",
        "source": "sat_tpu_torch/ops/csrc/topk.cu",
        "replaces": "sat_tpu/ops/topk.py:41",
        "shape": f"x ({B}, {BEAM * VOCAB}) f32, k={BEAM}",
        "max_abs_err": topk_err,
        "ms": time_ms(lambda: topk(x, BEAM), hz),
        "plain_ms": time_ms(lambda: topk_plain(x, BEAM), hz),
        "library_ms": time_ms(lambda: torch.topk(x, BEAM, dim=1), hz),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"})

    # ---- fused attention forward, R = BEAM (dedup beam) and R = 1
    L, E, D = 196, 512, 512
    errs = {}
    for R in (BEAM, 1):
        keys = torch.randn((B, L, E), generator=gen).cuda()
        feats = torch.rand((B, L, D), generator=gen).cuda()
        u_h = torch.randn((B * R, E), generator=gen).cuda()
        v = (torch.randn((E,), generator=gen) / E ** 0.5).cuda()
        b_v = torch.randn((1,), generator=gen).cuda()
        args = (keys, feats, u_h, v, b_v, R)
        ctx, alpha = attention_fwd(*args)
        pctx, palpha = attention_plain(*args)
        torch.cuda.synchronize()
        e_ctx = (ctx - pctx).abs().max().item()
        e_alpha = (alpha - palpha).abs().max().item()
        errs[R] = {"ctx": e_ctx, "alpha": e_alpha}
        check(e_ctx <= 1e-5, f"attention R={R}: ctx max err {e_ctx} > 1e-5")
        check(e_alpha <= 1e-6,
              f"attention R={R}: alpha max err {e_alpha} > 1e-6")
        if R == BEAM:
            timed = args
    bytes_ = 4 * (B * L * (E + D) + B * BEAM * (E + D + L) + E + 1)
    tanh = B * BEAM * L * E
    flops = 2 * tanh + 2 * B * BEAM * L * D     # score add+fma, context fma
    t_bytes = bytes_ / peaks["bytes_s"]
    # The bound takes the published f32 rate; the special-function units'
    # time for the tanh and exp (16 results per SM a clock) is reported
    # beside it, since it is the nearer limit after the bytes.
    t_ops = flops / peaks["f32_s"]
    rows.append({
        "name": "attention_fwd", "route": "cuda",
        "source": "sat_tpu_torch/ops/csrc/attention_fwd.cu",
        "replaces": "sat_tpu/ops/fused_attention.py:42",
        "shape": f"keys/feats ({B}, {L}, {E}), u_h ({B * BEAM}, {E}), "
                 f"R={BEAM}",
        "max_abs_err": max(max(e.values()) for e in errs.values()),
        "errors_by_R": errs,
        "ms": time_ms(lambda: attention_fwd(*timed), hz),
        "plain_ms": time_ms(lambda: attention_plain(*timed), hz),
        "library_ms": None,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_parts_ms": {"bytes": t_bytes * 1e3,
                           "f32": flops / peaks["f32_s"] * 1e3,
                           "sfu": (tanh + B * BEAM * L) / sfu_s * 1e3}})
    emit({"phase": "kernels", "peaks": peaks,
          "checks": {"topk": "bit-exact on random and adversarial rows",
                     "attention_fwd": errs},
          "ms": {r["name"]: r["ms"] for r in rows}})
    return rows


def make_weights(seed: int):
    import torch
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
    from sat_tpu_torch.models.encoder import init_encoder_params

    gen = torch.Generator().manual_seed(seed)
    dcfg = DecoderConfig(vocab_size=VOCAB, encoder_dim=512, use_ado=True,
                         use_attention=True)
    dec = init_decoder_params(dcfg, gen)
    enc = init_encoder_params("vgg19", gen)
    # Random weights never emit <eos> within 51 steps; a raised <eos> bias
    # lets some beams complete, at different steps for images of different
    # contrast, so the CPU check and the server see completed sentences.
    bias = dec["ado/f_out/b"].copy()
    bias[STOP_IDS[0]] += EOS_BOOST
    dec["ado/f_out/b"] = bias
    worst = dict(dec)
    bias = worst["ado/f_out/b"].copy()
    bias[list(STOP_IDS)] = -1e9          # no beam ever completes: 51 steps
    worst["ado/f_out/b"] = bias
    contrast = torch.linspace(0.25, 4.0, 8).repeat(B // 8)
    images = (torch.randn((B, SIZE, SIZE, 3), generator=gen)
              * contrast[:, None, None, None]).numpy()
    return dcfg, dec, worst, enc, images


def first_diff(a, b) -> int:
    import numpy as np
    idx = np.flatnonzero(np.asarray(a) != np.asarray(b))
    return int(idx[0]) if idx.size else -1


def phase_main(dcfg, dec_flat, worst_flat, enc_flat, images) -> dict:
    import numpy as np
    import torch
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 encoder_from_jax)
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.models.beam import beam_search_batched
    from sat_tpu_torch.models.encoder import encoder_forward

    enc = encoder_from_jax(enc_flat, "vgg19", "cuda")
    dec = decoder_from_jax(worst_flat, dcfg, "cuda")
    step = build_caption_step("vgg19", dcfg, BEAM, device="cuda")
    step(enc, dec, images)                     # warm-up: cuDNN, allocator
    torch.cuda.synchronize()

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = step(enc, dec, images)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, n in launches.items():
        check(n == STEPS, f"{name}: {n} launches in the main path, "
                          f"expected {STEPS}")
    tokens = out["tokens"].cpu().numpy()
    check(tokens.shape == (B, 1 + STEPS), f"tokens shape {tokens.shape}")
    check(not out["found"].any().item(),
          "a beam completed although the stop logits are pinned")
    check(bool(torch.isfinite(out["alphas"]).all()), "non-finite alphas")

    # encoder and decode alone, host clock around synchronized work
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = encoder_forward(enc, "vgg19", images)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    beam_search_batched(dec, feats, BEAM)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3
    profile = {
        "encoder": profile_run(lambda: encoder_forward(enc, "vgg19", images)),
        "decode": profile_run(lambda: beam_search_batched(dec, feats, BEAM))}

    # 8 images again on the CPU with the plain forms, seeded weights (stop
    # ids not pinned, so some beams complete), beam and greedy
    n = 8
    enc_cpu = encoder_from_jax(enc_flat, "vgg19", "cpu")
    dec_cpu = decoder_from_jax(dec_flat, dcfg, "cpu")
    dec_gpu = decoder_from_jax(dec_flat, dcfg, "cuda")
    ref = {}
    for decode in ("beam", "greedy"):
        reset_launches()
        g = build_caption_step("vgg19", dcfg, BEAM, decode=decode,
                               device="cuda")(enc, dec_gpu, images[:n])
        torch.cuda.synchronize()
        counts = read_launches()
        if decode == "greedy":       # all 51 steps, argmax and no top-k
            check(counts == {"topk": 0, "attention_fwd": STEPS},
                  f"greedy: launches {counts}, expected attention_fwd "
                  f"{STEPS} and topk 0")
        else:                        # one of each a step, until all complete
            check(counts["topk"] == counts["attention_fwd"]
                  and 1 <= counts["topk"] <= STEPS,
                  f"beam: launches {counts}, expected equal counts in "
                  f"1..{STEPS}")
        c = build_caption_step("vgg19", dcfg, BEAM, decode=decode,
                               device="cpu")(enc_cpu, dec_cpu, images[:n])
        g = {k: v.cpu().numpy() for k, v in g.items()}
        c = {k: v.cpu().numpy() for k, v in c.items()}
        agree, diverged = 0, []
        for i in range(n):
            same = bool(np.array_equal(g["tokens"][i], c["tokens"][i])
                        and g["length"][i] == c["length"][i]
                        and g["found"][i] == c["found"][i])
            agree += same
            if not same:
                diverged.append({
                    "image": i,
                    "first_step": first_diff(g["tokens"][i], c["tokens"][i]),
                    "score_gap": float(abs(g["score"][i] - c["score"][i]))})
        ref[decode] = {"agree": agree, "of": n, "launches": counts,
                       "found": int(g["found"].sum()),
                       "max_score_err": float(np.max(np.abs(
                           np.where(g["found"], g["score"], 0)
                           - np.where(c["found"], c["score"], 0)))),
                       "diverged": diverged}
        check(agree >= n - 1, f"{decode}: GPU and CPU agree on {agree} of "
                              f"{n} images")
    check(ref["beam"]["found"] > 0, "no beam completed in the CPU check")
    res = {"phase": "main", "images": B, "beam": BEAM, "steps": STEPS,
           "wall_ms": wall_s * 1e3, "captions_per_s": B / wall_s,
           "encoder_ms": enc_ms, "decode_ms": dec_ms,
           "decode_ms_per_step": dec_ms / STEPS,
           "peak_mem_gb": peak_gb, "launches": launches, "cpu_check": ref,
           "profile": profile}
    emit(res)
    return res


def profile_run(fn, top: int = 10) -> dict:
    """One run of `fn` under torch.profiler: device time by kernel (and
    copy) name, the device's busy share of the wall time, and the run's
    host-clock wall time (the profiler's own cost included). Only device
    events count: a host op such as aten::addmm also reports its kernels'
    time, which would count them twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = sorted(((e.key, device_us(e), e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and device_us(e) > 0),
                  key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    if not rows:
        return {"device_time": "not measured: the profiler saw no device "
                               "events"}
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "top": [{"name": k[:90], "ms": us / 1e3, "calls": n,
                     "share_of_busy": us / busy_us}
                    for k, us, n in rows[:top]]}


def phase_serve(dcfg, dec_flat, enc_flat) -> dict:
    import numpy as np
    import torch
    from PIL import Image
    from sat_tpu_torch.engine.evaluate import decode_caption
    from sat_tpu_torch.serve import build_parser, build_server

    n = 16
    with tempfile.TemporaryDirectory() as tmp:
        words = ["<start>", "<eos>", "<unk>", "<pad>"] + [
            f"w{i}" for i in range(4, VOCAB)]
        word_dict = {w: i for i, w in enumerate(words)}
        with open(os.path.join(tmp, "word_dict.json"), "w") as f:
            json.dump(word_dict, f)
        with open(os.path.join(tmp, "model_config.json"), "w") as f:
            json.dump({"data": tmp, "network": "vgg19", "ado": True,
                       "attention": True, "bert": False, "tf": False}, f)
        model = os.path.join(tmp, "model_vgg19_0.npz")
        np.savez(model, **dec_flat)
        enc_path = os.path.join(tmp, "vgg19.npz")
        np.savez(enc_path, **enc_flat)
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        rng = np.random.default_rng(0)
        for i in range(n):       # noise of rising contrast
            Image.fromarray(rng.integers(0, 16 * (i + 1), (SIZE, SIZE, 3),
                                         np.uint8)).save(
                os.path.join(img_dir, f"{i:02d}.png"))
        args = build_parser().parse_args([
            "--model", model, "--encoder-weights", enc_path,
            "--port", "0", "--max-batch", str(n), "--batch-window-ms", "50",
            "--preload-images", img_dir, "--preload-count", str(n)])
        server = build_server(args)
        server.start()
        replies = [None] * n

        def ask(i):
            with socket.create_connection(("127.0.0.1", server.port),
                                          timeout=120) as s:
                s.sendall(json.dumps({"id": i, "cached": i}).encode() + b"\n")
                buf = b""
                while not buf.endswith(b"\n"):
                    chunk = s.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
            replies[i] = json.loads(buf)

        try:
            threads = [threading.Thread(target=ask, args=(i,))
                       for i in range(n)]
            reset_launches()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            check(not any(t.is_alive() for t in threads),
                  "a request got no reply")
            torch.cuda.synchronize()
            launches = read_launches()
            stats = server.snapshot()
            # the same pool through the caption step directly
            direct = server._caption_fn(server._image_pool)
            direct = {k: v.cpu().numpy() for k, v in direct.items()}
        finally:
            server.stop()
    captions = [r.get("caption") for r in replies]
    check(all(c is not None for c in captions),
          f"errors in replies: {[r for r in replies if 'caption' not in r]}")
    check(stats["errors"] == 0, f"server errors: {stats}")
    check(stats["batches"] < n, f"no request was coalesced: {stats}")
    # each batch runs the beam: one top-k and one attention launch a step,
    # 1..51 steps until its beams complete
    check(launches["topk"] == launches["attention_fwd"]
          and stats["batches"] <= launches["topk"] <= STEPS * stats["batches"],
          f"serve: launches {launches} for {stats['batches']} batches, "
          f"expected equal counts in 1..{STEPS} per batch")
    for i in range(n):
        row = (direct["tokens"][i, :int(direct["length"][i]) + 1].tolist()
               if direct["found"][i] else [0])
        check(captions[i] == " ".join(decode_caption(row, word_dict)),
              f"request {i}: served caption differs from the caption step")
    res = {"phase": "serve", "requests": n, "stats": stats,
           "launches": launches,
           "latency_p50_ms": stats.get("latency_p50_ms"),
           "latency_p99_ms": stats.get("latency_p99_ms"),
           "nonempty_captions": sum(bool(c) for c in captions)}
    emit(res)
    return res


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default="chiprun_out")
    args = parser.parse_args()

    dev = phase_device()
    import torch
    build = phase_build()
    gen = torch.Generator().manual_seed(args.seed + 1)
    kernels = phase_kernels(dev, gen)
    dcfg, dec_flat, worst_flat, enc_flat, images = make_weights(args.seed)
    main_res = phase_main(dcfg, dec_flat, worst_flat, enc_flat, images)
    serve = phase_serve(dcfg, dec_flat, enc_flat)

    for row in kernels:
        row["launches"] = main_res["launches"][row["name"]]
    summary = {"kernels": [{k: row[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for row in kernels]}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"device": dev, "build_seconds": build["seconds"],
                   "build_log": build["log"], "kernels": kernels,
                   "main": main_res, "serve": serve}, f, indent=1)
    emit(summary)
    print(dev["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
    sys.exit(0)
