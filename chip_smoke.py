#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out DIR]
                          [--phase parallel|export|tensor_parallel]

Run from the root of a checkout. It builds the CUDA kernels from the
sources in the checkout and drives the port's serving path at the flagship
width: VGG19 on 128 images of 224 px, then the beam at width 5 with the
soft-attention + ado decoder (vocab 2633, E = D = 512), weights random from
--seed, then the same at the width of the ResNet152 and DenseNet161
encoders, sample decode, BERT captioning (E = 768, V = 30,522), the CLIs
and the data layer from raw files. Each phase prints one JSON line; a
failed check exits non-zero and no result line is printed:

  1. device  — needs CUDA; the card's name and power limit; TF32 off (the
               main path is exact f32)
  2. build   — nvcc builds ops/csrc/*.cu; build seconds, ptxas report,
               the four topk_select kernels' (row resident or not, bitonic
               or radix sort) registers, spills and shared memory
  3. kernels — each kernel against its plain PyTorch form at the main
               path's shapes (top-k bit-exact on random and adversarial
               rows at B = 128, at B = 1 and 32, and at k = 20, the
               select kernel, with its bound and torch.topk's time;
               attention ctx atol 1e-5, alpha atol 1e-6, at
               R = 5 and R = 1; the backward's bounds), two launches of
               each kernel bit-identical, and the times of kernel, plain
               form and library call: warm (back to back) and cold (a
               128 MB write before each call evicts the L2), each beside
               its bound and a PyTorch pass over the same bytes
               (`stream_ms`); top-k at B = 1, 32 and 128 and at each
               cluster size; the forward at the beam's R = 5, B = 128,
               training's R = 1, B = 64 and greedy's R = 1, B = 128; the
               issue time of the precise tanhf, counted from cuobjdump's
               SASS of a probe kernel; the bf16 variants of the two
               attention kernels (keys and features bf16) the same way,
               the forward at R = 5, B = 128 and R = 1, B = 64, the
               backward's bf16 dkeys within one bf16 unit in the last
               place of the plain form's; the same kernels at the widths
               of the encoders, the sampler and BERT (top-k over
               (128, 152,610) rows at each cluster size, with ties on both
               sides of every split; the sampler's (128, 30,522) at k = 10
               and 50; the sampler's rows at both widths at k = 17, 64,
               256 and 1,024 (the select kernel's bitonic sort) and past it
               (its radix sort: 1,025, 2,048 and 2,632 at the flagship's
               2,633, 1,025, 4,096, 16,384 and 30,521 at BERT's 30,522),
               each also at B = 1 and 32; the forward at E = 768, f32
               and bf16, also on a ragged last tile; the backward at E = 768; top-k over a
               model rank's (128, 76,305) rows of the vocab-sharded BERT
               beam)
  4. main    — the worst case (stop-token logits pinned to -1e9, so every
               beam runs all 51 steps) through a new build_caption_step,
               whose first batch captures the beam's CUDA graphs (the
               wrappers' host launch counts: the warm-up's and the
               capture's, exactly) and whose second and third replay them,
               bit for bit, the third under the profiler (no host launch,
               51 of top-k and of attention_fwd on the device);
               the decode through its graphs and without (`graphs=None`),
               equal bit for bit, three host-clock times each in turns,
               capture seconds, profiles (device busy share; top-k and
               attention_fwd 51 times each on the device); greedy the
               same way; graph against eager at B = 1 and 7; decode ms by
               the exit-read interval S, worst case and seeded weights; 8
               of the images decoded eagerly on the GPU, beam and greedy,
               with their launch counts, and again on the CPU with the
               plain forms, must agree; then the bf16 path
               (build_caption_step(bf16=True)): its capture's and its
               replay's launches of top-k and attention_fwd_bf16, wall
               ms in turns with the f32 step, the bf16 encoder's ms and
               memory format, f32 and bf16 decodes captured apart in one
               GraphCache, the bf16 decode of 8 grids against the CPU
  4b. export — AOT caption artifacts (engine/serving.py's
               export_caption_artifact: torch.export, the kernels as the
               operators sat::attention_fwd and sat::topk) at the main
               path's width, B = 128, worst case: sat_tpu's defaults (the
               library sort), pallas_topk=True, and fast_topk + bf16, each
               exported here and run by a fresh process that imports only
               the loader (engine/artifact.py; no model module), against
               the live caption step on its route: tokens, lengths and
               found bit for bit, score and alpha differences printed; its
               profile's kernels equal to its wrappers' counts (51
               attention_fwd or _bf16, 51 top-k only with pallas_topk);
               a fourth artifact whose <eos> bias makes the live beam stop
               early, while the artifact runs all 51 steps, the same
               tokens; export seconds, bytes, load seconds, the artifact's
               ms a batch against the live graphs' in turns; the eager
               decode at B = 1 and 7 through the operators, beside their
               host cost a call (time_op_dispatch.py)
  5. serve   — a checkpoint directory on disk, the port's build_server +
               CaptionServer on an ephemeral port (batches padded to
               power-of-two buckets), 16 concurrent requests and the
               kernels' launch counts in serving them; a batch of 7
               requests padded to 8, each answered from its own row; a
               fresh `python -m sat_tpu_torch.serve` process, whose answer to
               one cached request must be this process's f32 answer bit
               for bit (the CLI turns TF32 off itself); a fresh
               `serve --bf16-decode` process against this process's bf16
               step, bit for bit
  5c. bert   — sat_tpu's default BERT run (VGG19, tf + ado + attention,
               E = 768, V = 30,522, a random (30522, 768) table) at
               B = 128, beam 5, worst case (the stop set {1, 0} pinned):
               a new caption step's capture (host launches exactly), two
               replays bit for bit, a profiled replay (51 top-k and
               attention_fwd on the device, none from the host); the
               decode through its graphs and eagerly, in turns; with
               [PAD]'s bias raised, graph against eager and 8 images
               against the CPU's plain forms (beam and greedy); greedy
               and sample (k = 10 and 50) through their graphs against
               eager, their profiles and peak memory; sample decode alone
               at k = 17, 64, 256 and 1,024 (the select kernel's bitonic
               sort) and 1,025, 4,096, 16,384 and 30,521 (its radix
               sort), each replay's 51 top-k on the device and its ms; the bf16 decode;
               then BERT bank training at B = 64 (one step against the
               CPU, the table unchanged and outside Adam, launches and
               profiles, K = 8 blocks against per-batch steps in turns,
               one --bf16-attention step)
  6. train   — the flagship decoder (tf + ado + attention) in bank
               training at B = 64, captions (64, 27), a device bank of 512
               random feature grids: one step on the card against the same
               step on the CPU (dropout 0); each step's attention launches
               with remat on and off; K = 8 blocks (--steps-per-dispatch,
               CUDA-graph replays): their host and device launches, ms
               per step and rows/s per-batch and blocked in turns, with
               peak memory allocated, and for a block with its graph's
               pool (measured from the allocator's snapshot around its
               capture), capture seconds, a block against 8 per-batch steps from one
               state (dropout 0, remat on and off) and two blocked runs
               with dropout 0.5, each bit for bit; a profile of one step
               and of one block; the loss falling over 20 steps on one
               batch; then --bf16-attention on a bf16 bank (remat on):
               its launches (bf16 variants only), a block against 8
               per-batch steps bit for bit, ms per step and peak memory
               per batch and blocked in turns with the f32 path, the
               bank's bytes, a step on images through the bf16 encoder
  7. entry   — a synthetic dataset on disk (512 train, 128 val and 16
               test rows of 224 px PNGs, a 2633-word vocabulary) through
               `python -m sat_tpu_torch.train`'s main for one epoch and
               the test pass: BLEU-1..4 of validation and test, 1-50
               attention plots, the train state, the launches; the same
               run through the Trainer, preempted by SIGUSR1 after its
               first step, then finished by main with --resume: decoder
               and Adam moments equal to the first run's bit for bit; the
               three runs again with --steps-per-dispatch 4 (preempted
               after the first block), whose meter rows and final state
               must be the per-batch run's and whose resumed run must end
               where its uninterrupted run does; the first run's
               checkpoint loaded by the port's server code, which
               captions one image; one blocked run with --bf16-attention
               --bank-dtype bfloat16 --bf16-encoder (bf16 launches only);
               one blocked run with --network densenet161 (attention_bwd
               at D = 2208 on the CLI's path)
  7a. tooling — on that dataset, one blocked run with --debug-nans and
               --profile-dir (the same meter rows, launches and final state
               as without, bit for bit; a trace whose device kernels
               include attention_fwd and attention_bwd), and a fresh
               per-batch `train --lr 1e38 --debug-nans` process, which must
               stop with FloatingPointError
  7b. cli    — fresh processes on that dataset: generate_caption on a
               ResNet152 model (beam and its PNG; --decode sample
               --sample-seed 3 twice, one caption; the model as a `.pth`
               of its decoder's state_dict, the `.npz`'s caption),
               evaluate --split val (an in-process Trainer.validate's
               rows and BLEU), caption_split at --pipeline-depth 1 and 2
               (equal JSONL)
  7c. bert_cli — the same dataset with a 30,522-line vocab.txt written by
               the script and BERT caption files written from a split of
               its images by a fresh `generate_json_data_bert
               --vocab-file` process (their layout checked): one blocked
               epoch of
               `train --bert --bert-embeddings --bert-vocab` (BLEU, the
               table in the `.npz` bit for bit the `.npy`), a fresh
               `serve --bert-vocab` process against this process's words,
               `generate_caption --bert-vocab`
  7d. parallel — on that dataset, data-parallel training and mesh
               serving on the one card (nothing here measures a speed-up
               across cards): `torchrun --standalone --nproc_per_node 1 -m
               sat_tpu_torch.train --mesh-data 1 --steps-per-dispatch 8`
               (NCCL, the all-reduce inside the block's CUDA graph) against
               the same run in this plain process, bit for bit; one block
               replay under NCCL at world size 1, profiled (8 x 52
               attention_fwd, 8 x 26 attention_bwd, and NCCL's kernels, or
               none for one rank); two gloo ranks on cuda:0 driving the
               Trainer through the API on 511 train rows (the last batch
               padded), per batch and in blocks of 8 (eager: gloo cannot be
               captured), each rank's host launches, against one process
               within the bound of tests/test_torch_parallel.py; SIGTERM to
               rank 1 alone: both stop at one boundary, rank 0 alone writes
               the train state, resumed at world size 1 against the straight
               run; `build_caption_step(mesh_data=2, devices=[cuda:0,
               cuda:0])` at B = 127 and 128, worst case, the one-card step's
               tokens, its score and alpha differences, times in turns; a
               fresh `serve --mesh-data 2`, which must refuse with
               make_mesh's message; the beam's kernel, `pallas_topk=False`
               and `fast_topk=True` routes at B = 128, worst case, through
               their graphs, the same tokens bit for bit, decode ms three
               times each in turns (the kernels phase times the sort route
               beside torch.topk at each top-k row's shape: `sort_ms`)
  7e. tensor_parallel — the vocab-sharded head (--mesh-model 2) at
               bert-att's full width (VGG19 grid 196 x 512, E = 768, V =
               30,522, a bank of 512 grids, B = 64): (a) two gloo ranks
               on the card at data 1 x model 2 against one process on the
               same 8 batches, dropout 0: each step's loss, acc1, acc5 and
               caption length, the parameters and Adam moments joined over
               the group, a K = 8 block (eager under gloo) equal to the
               ranks' steps, the evaluation's argmax tokens and BLEU at
               the start weights, the train state written after 4 steps
               and resumed by this process, a B = 128 beam-5 worst-case
               batch decoded by the group (tokens, lengths and completion
               equal to one card's; top-k at each rank's (128, 76,305)
               rows, held to its plain form, 51 launches a rank); (b) four
               gloo ranks at 2 x 2 with the bank sharded over the data
               ranks against the same process, one step of data rank 0
               profiled (its attention launches at 32 rows equal to the
               host's count, the kernels at those rows held to their plain
               forms), at dropout 0.5 the four ranks' replicated parameters
               bit-equal; (c) NCCL at world size 1 through the grid's code
               (a one-way sharded bank): the block's graph captured and bit
               for bit a plain process's; (d) a fresh `train --mesh-model
               2` at the flagship's V = 2,633, refused with the
               divisibility message; each rank's bytes of its vocabulary
               shards and its bank (the ranks `chip_smoke.py --tp-rank R
               --tp-spec JSON` processes; nothing here measures a speed-up
               across cards)
  8. data    — the data layer from raw files at the flagship's width: a
               Karpathy split of 512 train, 128 val and 16 test images of
               640 x 480 and 500 x 375 (half JPEG, half PNG, four
               grayscale PNGs, one BMP; five sentences each), a fresh
               `generate_json_data` process (the files' layout checked),
               the native loader built from sat_tpu_torch/native/preproc.cpp
               (build seconds, the codecs built in) and held on 128 of the
               files at 224 px to PIL's decode and its own resize (PNG bit
               for bit, JPEG within max 0.06, mean 0.005), at 1 thread and
               at all, and timed against PIL one row at a time (host
               images/s, three runs each in turns); `SAT_NATIVE_PREPROC=1
               train --cache-features --steps-per-dispatch 4 --fraction
               0.25` as a fresh process (its rows decoded natively = the
               files the codecs take) and the same run without the toggle
               (two feature-cache keys a split); 128 `path` requests to an in-process server
               under the toggle (its native rows, every served image the
               native tensor, the tokens the caption step's on those
               tensors); `train_models smoke` from a directory whose
               data/flickr8k is the split

Then come the `{"kernels": [...]}` line, the card's name and power limit as
nvidia-smi gives them, and last `{"ok": true, "device": {...}}`. Details go
to <out>/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zipfile

B, BEAM, VOCAB, SIZE, STEPS = 128, 5, 2633, 224, 51
TRAIN_B, CAP_LEN, BANK_U, BANK_N = 64, 27, 512, 1024
K_BLOCK = 8                # train steps a block in the train phase
T = CAP_LEN - 1            # decoder steps of a training caption
L, E, D = 196, 512, 512    # VGG19 grid, embedding and annotation widths
PARITY_LR = 1e-3           # tests/test_train_parity.py's learning rate
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


# The kernels by the names of their rows and counts: the attention
# kernels' bf16 variants are counted apart from their f32 ones.
KERNELS = ("topk", "attention_fwd", "attention_bwd", "attention_fwd_bf16",
           "attention_bwd_bf16")


def reset_launches() -> None:
    """Zero every kernel wrapper's launch counts."""
    from sat_tpu_torch.ops.fused_attention import attention_bwd, attention_fwd
    from sat_tpu_torch.ops.topk import topk
    topk.launches = attention_fwd.launches = attention_bwd.launches = 0
    attention_fwd.launches_bf16 = attention_bwd.launches_bf16 = 0


def read_launches() -> dict:
    from sat_tpu_torch.ops.fused_attention import attention_bwd, attention_fwd
    from sat_tpu_torch.ops.topk import topk
    return {"topk": topk.launches, "attention_fwd": attention_fwd.launches,
            "attention_bwd": attention_bwd.launches,
            "attention_fwd_bf16": attention_fwd.launches_bf16,
            "attention_bwd_bf16": attention_bwd.launches_bf16}


def counts(**nonzero) -> dict:
    """A launch count of every kernel: those named, the rest 0."""
    return {k: nonzero.get(k, 0) for k in KERNELS}


def kernel_of(name: str):
    """The count name of a device kernel's profiler row, or None."""
    for k in ("topk", "attention_fwd", "attention_bwd"):
        if k in name:
            return k + ("_bf16" if "bfloat16" in name else "")
    return None


_SCRATCH = []


def evict_l2() -> None:
    """Write 128 MB, more than twice the card's 50 MB L2, so that the next
    call reads its inputs from device memory."""
    import torch
    if not _SCRATCH:
        _SCRATCH.append(torch.empty(32 * 2 ** 20, device="cuda"))
    _SCRATCH[0].zero_()


def time_ms(fn, clock_hz: float, reps: int = 100, warmup: int = 10,
            cold: bool = False) -> float:
    """Median device time of one call of `fn`: `reps` calls after `warmup`,
    each between a pair of CUDA events. A sleep kernel queued first keeps
    the device behind the host while the calls are enqueued, so each pair
    brackets the call's kernels and not the host's time to launch them
    (which, for a kernel of some microseconds, is the longer). `cold`
    evicts the L2 before each call, outside its pair of events."""
    import torch
    pre = evict_l2 if cold else (lambda: None)
    for _ in range(warmup):
        pre()
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        pre()
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(2 * enqueue_s * clock_hz))
    for start, end in events:
        pre()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


TANH_PROBE = r"""
extern "C" __global__ void probe(const float* x, float* y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = %s;
}
"""


def tanhf_instructions() -> dict:
    """SASS instructions of one precise tanhf on sm_90a: a probe kernel
    y[i] = tanhf(x[i]) less the same kernel with y[i] = x[i], both built
    by nvcc as the kernels are (-O3) and listed by cuobjdump -sass; NOPs
    are not counted."""
    import re

    from sat_tpu_torch.ops import _kernels
    try:
        nvcc = _kernels.nvcc_path()
        cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        counts = {}
        with tempfile.TemporaryDirectory() as tmp:
            for name, expr in (("tanhf", "tanhf(x[i])"), ("copy", "x[i]")):
                src = os.path.join(tmp, f"{name}.cu")
                with open(src, "w") as f:
                    f.write(TANH_PROBE % expr)
                cubin = os.path.join(tmp, f"{name}.cubin")
                subprocess.run([nvcc, *_kernels.ARCH_FLAGS, "-O3", "-cubin",
                                "-o", cubin, src], check=True,
                               capture_output=True, timeout=120)
                sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                                      capture_output=True, text=True,
                                      timeout=60).stdout
                ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]+);", sass)
                counts[name] = sum(1 for op in ops
                                   if not op.split()[0].startswith("NOP"))
    except (OSError, RuntimeError, subprocess.SubprocessError) as err:
        return {"instructions": None, "error": f"not measured: {err}"}
    return {"instructions": counts["tanhf"] - counts["copy"],
            "probe_instructions": counts}


def shares(row: dict) -> dict:
    """bound_ms over the warm and the cold time."""
    out = {"bound_share": row["bound_ms"] / row["ms"]}
    if row.get("cold_ms"):
        out["bound_share_cold"] = row["bound_ms"] / row["cold_ms"]
    return out


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
    select = {name: info for name, info in ptxas_by_function(log).items()
              if "topk_select" in name}
    check(len(select) == 4, f"build: ptxas reported {sorted(select)}, not "
                            f"the four topk_select kernels")
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas,
          "topk_select": select})
    return {"seconds": seconds, "log": log, "topk_select": select}


def ptxas_by_function(log: str) -> dict:
    """nvcc -Xptxas -v's report, by kernel: registers, static shared memory
    bytes, spill stores and loads (bytes), stack frame bytes."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            out[name]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


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

    peaks = card_peaks(dev["name"])
    hz = dev["max_sm_mhz"] * 1e6
    sfu_s = 16 * dev["sms"] * hz                  # MUFU results/s
    rows = []

    rows.append(topk_row(peaks, hz, gen))

    # ---- fused attention forward, R = BEAM (dedup beam) and R = 1
    tanh_instr = tanhf_instructions()
    # issue slots: 4 warp schedulers of 32 lanes on each SM, a clock each
    issue_s = 128 * dev["sms"] * hz
    errs, determinism, variants = {}, {}, {}
    for R in (BEAM, 1):
        args = fwd_inputs(gen, B, R)
        ctx, alpha = attention_fwd(*args)
        pctx, palpha = attention_plain(*args)
        again = attention_fwd(*args)
        torch.cuda.synchronize()
        e_ctx = (ctx - pctx).abs().max().item()
        e_alpha = (alpha - palpha).abs().max().item()
        errs[R] = {"ctx": e_ctx, "alpha": e_alpha}
        check(e_ctx <= 1e-5, f"attention R={R}: ctx max err {e_ctx} > 1e-5")
        check(e_alpha <= 1e-6,
              f"attention R={R}: alpha max err {e_alpha} > 1e-6")
        determinism[R] = all(map(torch.equal, (ctx, alpha), again))
        check(determinism[R], f"attention R={R}: two launches differ")
    for key, Bx, R in (("r5_b128", B, BEAM), ("r1_b64", TRAIN_B, 1),
                       ("r1_b128", B, 1)):
        args = fwd_inputs(gen, Bx, R)
        parts = fwd_bound_parts(Bx, R, peaks, sfu_s)
        if tanh_instr["instructions"]:
            parts["tanhf_instr"] = (Bx * R * L * E * tanh_instr["instructions"]
                                    / issue_s * 1e3)
        t_bytes, t_ops = parts["bytes"], parts["f32"]
        var = {"shape": f"keys/feats ({Bx}, {L}, {E}), u_h ({Bx * R}, {E}), "
                        f"R={R}",
               "ms": time_ms(lambda: attention_fwd(*args), hz),
               "cold_ms": time_ms(lambda: attention_fwd(*args), hz,
                                  cold=True),
               "plain_ms": time_ms(lambda: attention_plain(*args), hz),
               **stream_ms(lambda: (args[0].sum(), args[1].sum()), hz),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bound_parts_ms": parts}
        var.update(shares(var))
        variants[key] = var
    main_fwd = variants["r5_b128"]
    rows.append({
        "name": "attention_fwd", "route": "cuda",
        "source": "sat_tpu_torch/ops/csrc/attention_fwd.cu",
        "replaces": "sat_tpu/ops/fused_attention.py:42",
        "shape": main_fwd["shape"],
        "max_abs_err": max(max(e.values()) for e in errs.values()),
        "errors_by_R": errs, "bit_identical_by_R": determinism,
        "library_ms": None, "tanhf": tanh_instr, "variants": variants,
        **{k: main_fwd[k] for k in ("ms", "cold_ms", "plain_ms", "bound_ms",
                                    "bound_by", "bound_parts_ms",
                                    "bound_share", "bound_share_cold")}})
    rows.append(attention_bwd_row(peaks, sfu_s, issue_s, tanh_instr, hz, gen))
    rows.append(attention_fwd_bf16_row(peaks, sfu_s, hz, gen))
    rows.append(attention_bwd_row(peaks, sfu_s, issue_s, tanh_instr, hz, gen,
                                  bf16=True))
    wide = wide_rows(peaks, sfu_s, issue_s, tanh_instr, hz, gen)
    bert = bert_kernel_rows(peaks, sfu_s, issue_s, tanh_instr, hz, gen)
    _SCRATCH.clear()          # the later phases' peak memory excludes it
    emit({"phase": "kernels", "peaks": peaks,
          "checks": {"topk": rows[0]["checks"],
                     "attention_fwd": errs,
                     "attention_fwd_bit_identical": determinism,
                     "attention_bwd": rows[2]["errors"],
                     "attention_bwd_bit_identical": True,
                     "attention_fwd_bf16": rows[3]["errors"],
                     "attention_fwd_bf16_bit_identical":
                         rows[3]["bit_identical"],
                     "attention_bwd_bf16": rows[4]["errors"],
                     "attention_bwd_bf16_bit_identical": True},
          "tanhf_instructions": tanh_instr["instructions"],
          "ms": {r["name"]: r["ms"] for r in rows},
          "cold_ms": {r["name"]: r.get("cold_ms") for r in rows},
          "topk_ms": {k: (v["ms"], v["cold_ms"], v["stream_ms"],
                          v["stream_cold_ms"])
                      for k, v in rows[0]["variants"].items()},
          "topk_ms_by_cluster": rows[0]["ms_by_cluster"],
          "floor_ms": rows[0]["floor_ms"],
          "attention_fwd_ms": {k: (v["ms"], v["cold_ms"], v["stream_ms"],
                                   v["stream_cold_ms"])
                               for k, v in variants.items()},
          "attention_fwd_bf16_ms": {k: (v["ms"], v["cold_ms"], v["stream_ms"],
                                        v["stream_cold_ms"])
                                    for k, v in rows[3]["variants"].items()},
          "wide": {r["name"]: {"shape": r["shape"],
                               "max_abs_err": r["max_abs_err"],
                               "ms": r["ms"], "cold_ms": r["cold_ms"],
                               "bound_ms": r["bound_ms"],
                               "plain_ms": r["plain_ms"],
                               "library_ms": r["library_ms"]}
                   for r in wide},
          "bert": {r["name"]: {"shape": r["shape"],
                               "max_abs_err": r["max_abs_err"],
                               "ms": r["ms"], "cold_ms": r["cold_ms"],
                               "bound_ms": r["bound_ms"],
                               "plain_ms": r["plain_ms"],
                               "library_ms": r["library_ms"],
                               **({"variants": r["variants"]}
                                  if "variants" in r else {})}
                   for r in bert}})
    return rows + wide + bert


def same_bits(a, b) -> bool:
    """Equal bit for bit: floats compared as their int32 patterns, so that
    -0.0 is not +0.0."""
    import torch
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


TOPK_BATCHES = (1, 32, B)   # one request, the server's default batch, main


def topk_row(peaks, hz, gen) -> dict:
    """Top-k against its plain form, bit for bit: random and adversarial
    rows at B = 128, random rows at B = 1 and 32, k = 20 (the select
    kernel), two launches against each other. Times warm and cold at each
    batch beside the bound and the yardstick (torch.amax over the same
    rows, one pass that returns one value a row), the plain form's and
    torch.topk's at B = 128, and the one-pass kernel at every cluster size
    (the wrapper picks one from B)."""
    import torch
    from sat_tpu_torch.ops.topk import (cluster_size, launch, topk,
                                        topk_library, topk_plain)

    x, adv = topk_inputs(gen)
    inputs = {Bx: torch.randn((Bx, BEAM * VOCAB), generator=gen).cuda()
              for Bx in TOPK_BATCHES if Bx != B}
    inputs[B] = x
    cases = [("random", x, BEAM), ("adversarial", adv, BEAM),
             ("random B=1", inputs[1], BEAM),
             ("random B=32", inputs[32], BEAM), ("k=20 random", x, 20),
             ("k=20 adversarial", adv, 20)]
    err = 0.0
    for name, inp, k in cases:
        kv, ki = topk(inp, k)
        pv, pi = topk_plain(inp, k)
        torch.cuda.synchronize()
        check(torch.equal(ki, pi), f"topk indices differ on {name} rows")
        check(same_bits(kv, pv), f"topk values differ on {name} rows")
        # -inf - -inf is NaN: equal entries, so NaN counts as 0
        err = max(err, (kv - pv).abs().nan_to_num(0.0).max().item())
    first, second = topk(x, BEAM), topk(x, BEAM)
    torch.cuda.synchronize()
    check(all(map(same_bits, first, second)), "topk: two launches differ")
    check(all(map(same_bits, topk_library(x, BEAM), first)),
          "topk: the library route (a stable sort) differs from the kernel")

    variants, by_cluster = {}, {}
    for Bx in TOPK_BATCHES:
        xb = inputs[Bx]
        var = {"shape": f"x ({Bx}, {BEAM * VOCAB}) f32, k={BEAM}",
               "cluster": cluster_size(Bx),
               "ms": time_ms(lambda: topk(xb, BEAM), hz),
               "cold_ms": time_ms(lambda: topk(xb, BEAM), hz, cold=True),
               **stream_ms(lambda: torch.amax(xb, dim=1), hz),
               **topk_bound(xb, BEAM, peaks)}
        var.update(shares(var))
        variants[f"b{Bx}"] = var
        by_cluster[f"b{Bx}"] = {c: time_ms(lambda: launch(xb, BEAM, c), hz)
                                for c in (1, 2, 4)}
    main = variants[f"b{B}"]
    return {
        "name": "topk", "route": "cuda",
        "source": "sat_tpu_torch/ops/csrc/topk.cu",
        "replaces": "sat_tpu/ops/topk.py:41",
        "shape": main["shape"], "max_abs_err": err,
        "checks": [name for name, _, _ in cases] + ["two launches"],
        "plain_ms": time_ms(lambda: topk_plain(x, BEAM), hz),
        "library_ms": time_ms(lambda: torch.topk(x, BEAM, dim=1), hz),
        "sort_ms": time_ms(lambda: topk_library(x, BEAM), hz),
        "k20_ms": time_ms(lambda: topk(x, 20), hz),
        "k20_library_ms": time_ms(lambda: torch.topk(x, 20, dim=1), hz),
        "k20_bound_ms": topk_bound(x, 20, peaks)["bound_ms"],
        # one PyTorch kernel that does almost nothing: what a launch costs
        # by this method
        "floor_ms": time_ms(lambda: torch.amax(inputs[1][:, :1], dim=1), hz),
        "variants": variants, "ms_by_cluster": by_cluster,
        **{k: main[k] for k in ("ms", "cold_ms", "stream_ms",
                                "stream_cold_ms", "bound_ms", "bound_by",
                                "bound_share", "bound_share_cold")}}


def stream_ms(fn, hz) -> dict:
    """A yardstick beside the bound: the time PyTorch takes to move the
    kernel's main bytes once (a sum reads a tensor, a copy reads one and
    writes one), warm and cold."""
    return {"stream_ms": time_ms(fn, hz),
            "stream_cold_ms": time_ms(fn, hz, cold=True)}


def fwd_inputs(gen, Bx: int, R: int, Lx: int = L, Dx: int = D,
               Ex: int = E):
    """attention_fwd's arguments at the main path's widths (or a grid of
    Lx rows of Dx, keys of Ex), on the card."""
    import torch
    keys = torch.randn((Bx, Lx, Ex), generator=gen).cuda()
    feats = torch.rand((Bx, Lx, Dx), generator=gen).cuda()
    u_h = torch.randn((Bx * R, Ex), generator=gen).cuda()
    v = (torch.randn((Ex,), generator=gen) / Ex ** 0.5).cuda()
    b_v = torch.randn((1,), generator=gen).cuda()
    return keys, feats, u_h, v, b_v, R


def fwd_bound_parts(Bx: int, R: int, peaks, sfu_s, grid_bytes: int = 4,
                    L: int = L, D: int = D, E: int = E) -> dict:
    """The forward's least times in ms: its bytes (inputs read once,
    outputs written once; keys and features `grid_bytes` an element, 2 in
    bf16) over the memory rate, its f32 operations (score add and
    multiply-add, context multiply-add) over the f32 rate, and, beside
    them, its tanh and exp over the special-function units (16 results per
    SM a clock)."""
    bytes_ = (grid_bytes * Bx * L * (E + D)
              + 4 * (Bx * R * (E + D + L) + E + 1))
    tanh = Bx * R * L * E
    flops = 2 * tanh + 2 * Bx * R * L * D
    return {"bytes": bytes_ / peaks["bytes_s"] * 1e3,
            "f32": flops / peaks["f32_s"] * 1e3,
            "sfu": (tanh + Bx * R * L) / sfu_s * 1e3}


def bf16_err(got, want) -> float:
    """The largest difference between two bf16 tensors in units of
    2^-7 |want| + 1e-5: at most 1 where two f32 values within 1e-5 of each
    other were rounded to bf16 (one unit in the last place apart)."""
    g, w = got.float(), want.float()
    return ((g - w).abs() / (2 ** -7 * w.abs() + 1e-5)).max().item()


def attention_fwd_bf16_row(peaks, sfu_s, hz, gen) -> dict:
    """The forward kernel's bf16 variant (keys and features bf16, the
    rest and the math f32) against its plain form on the same inputs at
    the bf16 beam's shape (R = 5, B = 128) and at training's (R = 1,
    B = 64): ctx atol 1e-5, alpha atol 1e-6, as the f32 kernel (f32 math
    on both sides); two launches bit for bit; times warm and cold beside
    the bound of bf16 bytes."""
    import torch
    from sat_tpu_torch.ops.fused_attention import (attention_fwd,
                                                   attention_plain)
    errs, same, variants = {}, {}, {}
    for key, Bx, R in (("r5_b128", B, BEAM), ("r1_b64", TRAIN_B, 1)):
        keys, feats, u_h, v, b_v, _ = fwd_inputs(gen, Bx, R)
        bf16 = torch.bfloat16
        args = (keys.to(bf16), feats.to(bf16), u_h, v, b_v, R)
        ctx, alpha = attention_fwd(*args)
        pctx, palpha = attention_plain(*args)
        again = attention_fwd(*args)
        torch.cuda.synchronize()
        errs[key] = {"ctx": (ctx - pctx).abs().max().item(),
                     "alpha": (alpha - palpha).abs().max().item()}
        check(errs[key]["ctx"] <= 1e-5 and errs[key]["alpha"] <= 1e-6,
              f"attention_fwd_bf16 {key}: errors {errs[key]} above ctx "
              f"1e-5, alpha 1e-6")
        same[key] = all(map(same_bits, (ctx, alpha), again))
        check(same[key], f"attention_fwd_bf16 {key}: two launches differ")
        parts = fwd_bound_parts(Bx, R, peaks, sfu_s, grid_bytes=2)
        var = {"shape": f"keys/feats ({Bx}, {L}, {E}) bf16, u_h "
                        f"({Bx * R}, {E}), R={R}",
               "ms": time_ms(lambda: attention_fwd(*args), hz),
               "cold_ms": time_ms(lambda: attention_fwd(*args), hz,
                                  cold=True),
               "plain_ms": time_ms(lambda: attention_plain(*args), hz),
               **stream_ms(lambda: (args[0].sum(), args[1].sum()), hz),
               "bound_ms": max(parts["bytes"], parts["f32"]),
               "bound_by": ("bytes" if parts["bytes"] >= parts["f32"]
                            else "operations"),
               "bound_parts_ms": parts}
        var.update(shares(var))
        variants[key] = var
    main = variants["r5_b128"]
    return {"name": "attention_fwd_bf16", "route": "cuda",
            "source": "sat_tpu_torch/ops/csrc/attention_fwd.cu",
            "replaces": "sat_tpu/ops/fused_attention.py:42",
            "shape": main["shape"],
            "max_abs_err": max(max(e.values()) for e in errs.values()),
            "errors": errs, "bit_identical": same, "library_ms": None,
            "variants": variants,
            **{k: main[k] for k in ("ms", "cold_ms", "plain_ms", "bound_ms",
                                    "bound_by", "bound_parts_ms",
                                    "bound_share", "bound_share_cold")}}


def attention_bwd_row(peaks, sfu_s, issue_s, tanh_instr, hz, gen,
                      bf16: bool = False, L: int = L, D: int = D,
                      row_name: str | None = None, E: int = E) -> dict:
    """The backward kernel at the training shape (B = 64, R = 1) against
    its plain form, with dfeats asked and not, and two launches against
    each other; its times, warm and cold (the main path does not ask for
    dfeats: bank features need no gradient), and bound. With `bf16` its
    bf16 variant: keys and features bf16, dkeys and dfeats written in
    bf16 and held to the plain form's within one bf16 unit in the last
    place (`bf16_err` <= 1)."""
    import torch
    from sat_tpu_torch.ops.fused_attention import (attention_bwd,
                                                   attention_bwd_plain,
                                                   attention_plain)
    Bt = TRAIN_B
    grid_bytes = 2 if bf16 else 4
    keys, feats, u_h, v, b_v, _ = fwd_inputs(gen, Bt, 1, L, D, E)
    if bf16:
        keys, feats = keys.to(torch.bfloat16), feats.to(torch.bfloat16)
    dctx = torch.randn((Bt, D), generator=gen).cuda()
    dalpha = torch.randn((Bt, L), generator=gen).cuda()
    _, alpha = attention_plain(keys, feats, u_h, v, b_v)
    args = (keys, feats, u_h, v, alpha, dctx, dalpha)
    g = torch.bmm(feats.float(), dctx[:, :, None])[:, :, 0] + dalpha
    de_max = (alpha * (g - (alpha * g).sum(1, keepdim=True))).abs().max()
    errors = {}
    for want in (True, False):
        got = attention_bwd(*args, want_dfeats=want)
        ref = attention_bwd_plain(*args, want_dfeats=want)
        again = attention_bwd(*args, want_dfeats=want)
        torch.cuda.synchronize()
        check((got[1] is None) == (not want), "attention_bwd: dfeats "
              f"returned {got[1] is not None}, asked {want}")
        check(all(a is None and b is None or torch.equal(a, b)
                  for a, b in zip(got, again)),
              f"attention_bwd (dfeats {want}): two launches differ")
        err = {}
        for name, a, b in zip(("dkeys", "dfeats", "du_h"), got, ref):
            if b is None:
                continue
            if bf16 and name != "du_h":
                err[f"{name}_ulps"] = bf16_err(a, b)
                check(err[f"{name}_ulps"] <= 1,
                      f"attention_bwd_bf16: {name} {err[f'{name}_ulps']} "
                      f"bf16 units from the plain form's")
                b = b.float()
            err[name] = (a.float() - b).abs().max().item()
            if not (bf16 and name != "du_h"):
                check(err[name] <= 1e-5,
                      f"attention_bwd: {name} max err {err[name]} > 1e-5")
        # dv and db_v are sums over B*L = 12,544 terms, taken in another
        # order than the plain form's: error <= 1e-4 of their size. db_v
        # is zero in exact arithmetic (sum_l de = 0 for each image), so its
        # size is that of the terms it sums, max |de|.
        for name, a, b, size in (("dv", got[3], ref[3], ref[3].abs().max()),
                                 ("db_v", got[4], ref[4], de_max)):
            err[name] = (a - b).abs().max().item()
            check(err[name] <= 1e-4 * size.item(),
                  f"attention_bwd: {name} max err {err[name]} > 1e-4 x "
                  f"{size.item()}")
        errors["dfeats" if want else "no_dfeats"] = err

    def parts(with_dfeats: bool) -> dict:
        n_le, n_ld = Bt * L * E, Bt * L * D
        bytes_ = (grid_bytes * (2 * n_le + n_ld
                                + (n_ld if with_dfeats else 0))
                  + 4 * (2 * Bt * E + 2 * Bt * L + Bt * D + 2 * E + 1))
        # per (b, l, e): add, square, subtract, two products, the du_h add
        # and the dv multiply-add; per (b, l, d): the g multiply-add, and
        # the dfeats product when asked
        flops = 8 * n_le + (3 if with_dfeats else 2) * n_ld
        out = {"bytes": bytes_ / peaks["bytes_s"] * 1e3,
               "f32": flops / peaks["f32_s"] * 1e3,
               "sfu": n_le / sfu_s * 1e3}
        if tanh_instr["instructions"]:
            out["tanhf_instr"] = (n_le * tanh_instr["instructions"] / issue_s
                                  * 1e3)
        return out

    main_parts, dfeats_parts = parts(False), parts(True)
    dkeys_like = torch.empty_like(keys)
    bound_by = ("bytes" if main_parts["bytes"] >= main_parts["f32"]
                else "operations")
    row = {
        "name": row_name or ("attention_bwd_bf16" if bf16
                             else "attention_bwd"),
        "route": "cuda",
        "source": "sat_tpu_torch/ops/csrc/attention_bwd.cu",
        "replaces": "sat_tpu/ops/fused_attention.py:107",
        "shape": f"keys ({Bt}, {L}, {E}), feats ({Bt}, {L}, {D})"
                 f"{' bf16' if bf16 else ''}, R=1, dfeats not asked",
        "max_abs_err": max(v for e in errors.values() for k, v in e.items()
                           if not k.endswith("_ulps")),
        "errors": errors,
        "ms": time_ms(lambda: attention_bwd(*args, want_dfeats=False), hz),
        "cold_ms": time_ms(lambda: attention_bwd(*args, want_dfeats=False),
                           hz, cold=True),
        "plain_ms": time_ms(
            lambda: attention_bwd_plain(*args, want_dfeats=False), hz),
        **stream_ms(lambda: (dkeys_like.copy_(keys), feats.sum()), hz),
        "library_ms": None,
        "bound_ms": max(main_parts["bytes"], main_parts["f32"]),
        "bound_by": bound_by, "bound_parts_ms": main_parts,
        "with_dfeats": {
            "ms": time_ms(lambda: attention_bwd(*args), hz),
            "cold_ms": time_ms(lambda: attention_bwd(*args), hz, cold=True),
            "bound_ms": max(dfeats_parts["bytes"], dfeats_parts["f32"]),
            "bound_parts_ms": dfeats_parts}}
    row.update(shares(row))
    return row


# The grids of the wider encoders: 7 x 7 rows of 2048 (ResNet152) and 2208
# (DenseNet161) channels
WIDE = {"resnet152": 2048, "densenet161": 2208}
L_WIDE = 49
SAMPLE_KS = (10, 50)        # the sample phase's top-k
# top-k past the cluster kernel's 16: the select kernel's k with the bitonic
# sort (to kMaxSelect, read from the source) and with the radix sort above
# it (`sort_ks`)
SELECT_KS = (17, 64, 256)


def topk_max_select() -> int:
    """csrc/topk.cu's kMaxSelect (= kSelectThreads): the select kernel's
    largest k."""
    src = open(os.path.join(REPO_DIR, "sat_tpu_torch", "ops", "csrc",
                            "topk.cu")).read()
    return int(re.search(r"constexpr int kSelectThreads = (\d+);",
                         src).group(1))


def sort_ks(vocab: int) -> tuple:
    """The sampler's k past kMaxSelect, where the select kernel sorts its
    survivors by radix: its least k, and up to the widest, V - 1, at the
    flagship's V and at BERT's (where the index buffers leave shared
    memory past 19,228)."""
    top = topk_max_select()
    return ((top + 1, 2048, vocab - 1) if vocab == VOCAB
            else (top + 1, 4096, 16384, vocab - 1))


def topk_bound(x, k: int, peaks) -> dict:
    """The least time for a top-k of x's rows, in ms, and what sets it:
    each entry read once and k values and int64 indices a row written,
    over the memory rate, or one compare an entry over the f32 rate,
    whichever is larger."""
    rows, n = x.shape
    t_bytes = (4 * rows * n + rows * k * (4 + 8)) / peaks["bytes_s"]
    t_ops = rows * n / peaks["f32_s"]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fwd_check(name: str, gen, Bx: int, R: int, Lx: int, Dx: int, Ex: int,
              bf16: bool):
    """attention_fwd (or its bf16 variant) at (Bx, Lx, Ex, Dx), R rows an
    image, against its plain form (ctx atol 1e-5, alpha atol 1e-6, as at
    the main path's shape) and two launches bit for bit: (its arguments,
    its errors)."""
    import torch
    from sat_tpu_torch.ops.fused_attention import (attention_fwd,
                                                   attention_plain)
    keys, feats, u_h, v, b_v, _ = fwd_inputs(gen, Bx, R, Lx, Dx, Ex)
    if bf16:
        keys, feats = keys.to(torch.bfloat16), feats.to(torch.bfloat16)
    args = (keys, feats, u_h, v, b_v, R)
    ctx, alpha = attention_fwd(*args)
    pctx, palpha = attention_plain(*args)
    again = attention_fwd(*args)
    torch.cuda.synchronize()
    errs = {"ctx": (ctx - pctx).abs().max().item(),
            "alpha": (alpha - palpha).abs().max().item()}
    check(errs["ctx"] <= 1e-5 and errs["alpha"] <= 1e-6,
          f"{name}: errors {errs} above ctx 1e-5, alpha 1e-6")
    check(all(map(same_bits, (ctx, alpha), again)),
          f"{name}: two launches differ")
    return args, errs


def fwd_row(name: str, peaks, sfu_s, hz, gen, Lx: int, Dx: int,
            bf16: bool = False, R: int = BEAM, Bx: int = B,
            Ex: int = E) -> dict:
    """`fwd_check` at (Bx, Lx, Ex, Dx), then times warm and cold beside
    the bound."""
    from sat_tpu_torch.ops.fused_attention import (attention_fwd,
                                                   attention_plain)
    args, errs = fwd_check(name, gen, Bx, R, Lx, Dx, Ex, bf16)
    parts = fwd_bound_parts(Bx, R, peaks, sfu_s, 2 if bf16 else 4, Lx, Dx,
                            Ex)
    row = {"name": name, "route": "cuda",
           "source": "sat_tpu_torch/ops/csrc/attention_fwd.cu",
           "replaces": "sat_tpu/ops/fused_attention.py:42",
           "shape": f"keys ({Bx}, {Lx}, {Ex}), feats ({Bx}, {Lx}, {Dx})"
                    f"{' bf16' if bf16 else ''}, u_h ({Bx * R}, {Ex}), "
                    f"R={R}",
           "max_abs_err": max(errs.values()), "errors": errs,
           "ms": time_ms(lambda: attention_fwd(*args), hz),
           "cold_ms": time_ms(lambda: attention_fwd(*args), hz, cold=True),
           "plain_ms": time_ms(lambda: attention_plain(*args), hz),
           **stream_ms(lambda: (args[0].sum(), args[1].sum()), hz),
           "library_ms": None,
           "bound_ms": max(parts["bytes"], parts["f32"]),
           "bound_by": ("bytes" if parts["bytes"] >= parts["f32"]
                        else "operations"),
           "bound_parts_ms": parts}
    row.update(shares(row))
    return row


def sample_topk_row(k: int, peaks, hz, gen, vocab: int = VOCAB,
                    name: str | None = None) -> dict:
    """Top-k at the sampler's rows, (B, vocab) f32, at k: the cluster
    kernel for k <= 16, the select kernel above (its bitonic sort to
    kMaxSelect, its radix sort past it); bit for bit against its plain form on random and
    adversarial rows, two launches alike, times warm and cold beside the
    bound and torch.topk's; the same at B = 1 and 32 (`variants`)."""
    import torch
    from sat_tpu_torch.ops.topk import topk, topk_library, topk_plain
    x = torch.randn((B, vocab), generator=gen).cuda()
    adv = torch.randn((B, vocab), generator=gen)
    adv[0] = torch.randint(0, 3, (vocab,), generator=gen).float()
    adv[1] = float("-inf")
    adv[2, ::5] = float("nan")
    adv[3, 7:] = float("-inf")
    adv[4] = 0.0
    adv[4, ::2] = -0.0
    adv = adv.cuda()
    small = {Bx: torch.randn((Bx, vocab), generator=gen).cuda()
             for Bx in TOPK_BATCHES if Bx != B}
    for label, inp in (("random", x), ("adversarial", adv),
                       *((f"random B={Bx}", xb) for Bx, xb in small.items())):
        kv, ki = topk(inp, k)
        pv, pi = topk_plain(inp, k)
        torch.cuda.synchronize()
        check(torch.equal(ki, pi) and same_bits(kv, pv),
              f"{name or k}: differs from its plain form on {label} rows")
    check(all(map(same_bits, topk(x, k), topk(x, k))),
          f"{name or k}: two launches differ")
    variants = {}
    for Bx, xb in small.items():
        var = {"shape": f"x ({Bx}, {vocab}) f32, k={k}",
               "ms": time_ms(lambda: topk(xb, k), hz),
               "cold_ms": time_ms(lambda: topk(xb, k), hz, cold=True),
               "library_ms": time_ms(lambda: torch.topk(xb, k, dim=1), hz),
               **topk_bound(xb, k, peaks)}
        var.update(shares(var))
        variants[f"b{Bx}"] = var
    row = {"name": name or f"topk_k{k}", "route": "cuda",
           "source": "sat_tpu_torch/ops/csrc/topk.cu",
           "replaces": "sat_tpu/ops/topk.py:41",
           "shape": f"x ({B}, {vocab}) f32, k={k}", "max_abs_err": 0.0,
           "ms": time_ms(lambda: topk(x, k), hz),
           "cold_ms": time_ms(lambda: topk(x, k), hz, cold=True),
           "plain_ms": time_ms(lambda: topk_plain(x, k), hz),
           "library_ms": time_ms(lambda: torch.topk(x, k, dim=1), hz),
           "library_cold_ms": time_ms(lambda: torch.topk(x, k, dim=1), hz,
                                      cold=True),
           "sort_ms": time_ms(lambda: topk_library(x, k), hz),
           **stream_ms(lambda: torch.amax(x, dim=1), hz),
           **topk_bound(x, k, peaks), "variants": variants}
    row.update(shares(row))
    return row


def select_rows(peaks, hz, gen, vocab: int, prefix: str) -> list[dict]:
    """Top-k at the sampler's rows past k = 16 beside the sample phase's
    k = 50: the select kernel at SELECT_KS and at its largest k for the
    bitonic sort, and at `sort_ks` past it."""
    top = topk_max_select()
    return [sample_topk_row(k, peaks, hz, gen, vocab=vocab,
                            name=f"{prefix}_k{k}")
            for k in SELECT_KS + (top,) + sort_ks(vocab)]


def wide_rows(peaks, sfu_s, issue_s, tanh_instr, hz, gen) -> list[dict]:
    """The kernels at the shapes this slice's paths give them: the forward
    (f32 and bf16) on the two wider encoders' beam grids, the backward on
    DenseNet161's training grid, top-k on the sampler's rows."""
    rows = []
    for net, Dx in WIDE.items():
        for bf16 in (False, True):
            rows.append(fwd_row(
                f"attention_fwd{'_bf16' if bf16 else ''}_d{Dx}", peaks,
                sfu_s, hz, gen, L_WIDE, Dx, bf16))
    rows.append(attention_bwd_row(peaks, sfu_s, issue_s, tanh_instr, hz, gen,
                                  L=L_WIDE, D=WIDE["densenet161"],
                                  row_name="attention_bwd_d2208"))
    rows += [sample_topk_row(k, peaks, hz, gen) for k in SAMPLE_KS]
    rows += select_rows(peaks, hz, gen, VOCAB, "topk")
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


def results_equal(a, b) -> list:
    """Names of the fields in which two results (BeamResult or tuples of
    tensors) differ bit for bit."""
    names = getattr(a, "_fields", None) or [str(i) for i in range(len(a))]
    return [n for n, x, y in zip(names, a, b) if not same_bits(x, y)]


def host_ms(fn) -> float:
    """Host clock around one call of `fn` and a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


SYNCS = (1, 2, 4, 8, 16, 51)    # beam steps between exit reads, timed


def beam_blocks(steps: int, sync_every: int) -> set:
    """The distinct lengths of a worst-case decode's step blocks, each one
    graph: S, and the last block's steps left when S does not divide."""
    full, rest = divmod(steps, sync_every)
    return ({sync_every} if full else set()) | ({rest} if rest else set())


def phase_main(dcfg, dec_flat, worst_flat, enc_flat, images) -> dict:
    import torch
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 encoder_from_jax)
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.models.beam import (SYNC_EVERY, beam_search_batched,
                                           greedy_caption)
    from sat_tpu_torch.models.encoder import encoder_forward
    from sat_tpu_torch.utils.graphs import GraphCache

    enc = encoder_from_jax(enc_flat, "vgg19", "cuda")
    dec = decoder_from_jax(worst_flat, dcfg, "cuda")
    eager_step = build_caption_step("vgg19", dcfg, BEAM, device="cuda",
                                    graphs=False)
    eager_step(enc, dec, images)           # warm-up: cuDNN, allocator
    torch.cuda.synchronize()

    # The main path: a new caption step. Its first call captures the
    # beam's graphs: the wrappers count the host launches of each block's
    # warm-up run and capture, one step each, for every distinct block
    # length. Its second call replays them (timed), and so does its third,
    # under the profiler with the counts reset just before: no host launch,
    # and on the device STEPS of top-k and of attention_fwd.
    step = build_caption_step("vgg19", dcfg, BEAM, device="cuda")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = step(enc, dec, images)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    host_launches = read_launches()
    capture_s = step.graphs.capture_seconds
    want = 2 * sum(beam_blocks(STEPS, SYNC_EVERY))
    check(host_launches == counts(topk=want, attention_fwd=want),
          f"main path's capturing batch: host launches {host_launches}, "
          f"expected {want} of top-k and attention_fwd (S = {SYNC_EVERY})")
    t0 = time.perf_counter()
    out = step(enc, dec, images)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    replayed = {}
    reset_launches()
    main_profile = profile_run(lambda: replayed.update(step(enc, dec,
                                                            images)))
    replay_host = read_launches()
    device_launches = main_profile.get("kernel_calls")
    check(replay_host == counts()
          and device_launches == counts(topk=STEPS, attention_fwd=STEPS),
          f"main path's replayed batch: host launches {replay_host}, device "
          f"{device_launches}; expected none and {STEPS} of top-k and "
          f"attention_fwd")
    for again in (out, replayed):
        check(not [k for k in again if not same_bits(again[k], first[k])],
              "main path: a replayed batch differs from the captured one")
    tokens = out["tokens"].cpu().numpy()
    check(tokens.shape == (B, 1 + STEPS), f"tokens shape {tokens.shape}")
    check(not out["found"].any().item(),
          "a beam completed although the stop logits are pinned")
    check(bool(torch.isfinite(out["alphas"]).all()), "non-finite alphas")

    enc_ms = host_ms(lambda: encoder_forward(enc, "vgg19", images))
    feats = encoder_forward(enc, "vgg19", images)

    # Graph against eager: bits, host-clock decode ms in turns, capture
    # seconds of a fresh cache, profiles (device busy share, the kernels'
    # device launches)
    graphs = {"graph": GraphCache(), "eager": None}
    decodes = {m: (lambda m=m: beam_search_batched(dec, feats, BEAM,
                                                   graphs=graphs[m]))
               for m in graphs}
    res = {m: decodes[m]() for m in graphs}
    diff = results_equal(res["eager"], res["graph"])
    check(not diff, f"beam B={B}: graph and eager differ in {diff}")
    decode_ms = {m: [] for m in graphs}
    for m in ("graph", "eager", "eager", "graph", "graph", "eager"):
        decode_ms[m].append(host_ms(decodes[m]))
    profile = {"main": main_profile, "encoder": profile_run(
        lambda: encoder_forward(enc, "vgg19", images))}
    for m in graphs:
        profile[f"decode_{m}"] = prof = profile_run(decodes[m])
        calls = prof.get("kernel_calls", {})
        check(calls.get("topk") == STEPS and calls.get("attention_fwd")
              == STEPS, f"beam ({m}): the profile shows kernels {calls}, "
                        f"expected {STEPS} of top-k and attention_fwd")

    greedy = {m: (lambda m=m: greedy_caption(dec, feats, with_alphas=True,
                                             graphs=graphs[m]))
              for m in graphs}
    gres = {m: greedy[m]() for m in graphs}
    diff = results_equal(gres["eager"], gres["graph"])
    check(not diff, f"greedy B={B}: graph and eager differ in {diff}")
    greedy_ms = {m: [] for m in graphs}
    for m in ("graph", "eager", "eager", "graph", "graph", "eager"):
        greedy_ms[m].append(host_ms(greedy[m]))
    for m in graphs:
        profile[f"greedy_{m}"] = prof = profile_run(greedy[m])
        calls = prof.get("kernel_calls", {})
        check(calls.get("topk") == 0 and calls.get("attention_fwd") == STEPS,
              f"greedy ({m}): the profile shows kernels {calls}, expected "
              f"{STEPS} of attention_fwd and no top-k")

    # Graph against eager at B = 1 and 7 (not a power of two), beam and
    # greedy, on the seeded weights whose beams complete at other steps
    dec_gpu = decoder_from_jax(dec_flat, dcfg, "cuda")
    small = {}
    for Bx in (1, 7):
        fx = feats[:Bx].contiguous()
        cache = GraphCache()
        for name, run in (
                ("beam", lambda g: beam_search_batched(dec_gpu, fx, BEAM,
                                                       graphs=g)),
                ("greedy", lambda g: greedy_caption(dec_gpu, fx,
                                                    with_alphas=True,
                                                    graphs=g))):
            e, g = run(None), run(cache)
            diff = results_equal(e, g)
            check(not diff, f"{name} B={Bx}: graph and eager differ in "
                            f"{diff}")
            if name == "beam":
                small[Bx] = {"beam_found": int(e.found.sum())}

    # The exit read every S steps: decode ms by S, worst case and seeded
    # weights (beams completing at different steps), each S on a fresh
    # cache (its capture seconds) and then replayed
    real = beam_search_batched(dec_gpu, feats, BEAM, graphs=None)
    by_sync = {}
    for label, d in (("worst", dec), ("seeded", dec_gpu)):
        ref = beam_search_batched(d, feats, BEAM, graphs=None)
        rows = {}
        for S in SYNCS:
            cache = GraphCache()
            got = beam_search_batched(d, feats, BEAM, sync_every=S,
                                      graphs=cache)
            diff = results_equal(ref, got)
            check(not diff, f"beam S={S} ({label}): differs from the eager "
                            f"path in {diff}")
            rows[S] = {"capture_s": cache.capture_seconds,
                       "ms": [host_ms(lambda: beam_search_batched(
                           d, feats, BEAM, sync_every=S, graphs=cache))
                           for _ in range(2)]}
        by_sync[label] = rows
    lengths = real.length[real.found]

    # 8 images again on the CPU with the plain forms, seeded weights (stop
    # ids not pinned, so some beams complete), beam and greedy; the card
    # side eager, whose launches the wrappers count (the graph paths equal
    # it, above)
    enc_cpu = encoder_from_jax(enc_flat, "vgg19", "cpu")
    dec_cpu = decoder_from_jax(dec_flat, dcfg, "cpu")
    ref = cpu_agreement("vgg19", dcfg, enc, dec_gpu, enc_cpu, dec_cpu,
                        images, "main")
    check(ref["beam"]["found"] > 0, "no beam completed in the CPU check")

    def busy(p):
        return p.get("device_busy_share")

    res = {"phase": "main", "images": B, "beam": BEAM, "steps": STEPS,
           "sync_every": SYNC_EVERY,
           "first_call_s": first_s, "capture_s": capture_s,
           "wall_ms": wall_s * 1e3, "captions_per_s": B / wall_s,
           "encoder_ms": enc_ms,
           "decode_ms": decode_ms, "greedy_ms": greedy_ms,
           "decode_capture_s": graphs["graph"].capture_seconds,
           "decode_ms_per_step": statistics.median(decode_ms["graph"])
           / STEPS,
           "device_busy_share": {k: busy(v) for k, v in profile.items()},
           "device_launches": device_launches,
           "by_sync": by_sync, "small_batches": small,
           "seeded_found": int(real.found.sum()),
           "seeded_lengths": sorted(set(lengths.tolist())),
           "peak_mem_gb": peak_gb, "host_launches": host_launches,
           "cpu_check": ref,
           "profile": profile}
    res["bf16"] = main_bf16(dcfg, enc, dec, dec_gpu, dec_cpu, images, step)
    emit({k: v for k, v in res.items() if k != "profile"}
         | {"bf16": {k: v for k, v in res["bf16"].items()
                     if k != "profile"}})
    return res


def main_bf16(dcfg, enc, dec, dec_gpu, dec_cpu, images, step32) -> dict:
    """The bf16 main path (`build_caption_step(bf16=True)`, serve's
    --bf16-decode) at B = 128, beam 5, worst case: a new step, whose first
    batch captures its graphs (host launches of top-k and the forward's
    bf16 variant exactly as the f32 path's, none of the f32 kernel), whose
    second replays them under the profiler (no host launch; STEPS of
    top-k and of attention_fwd_bf16 on the device); wall ms in turns with
    the f32 step; the encoder's ms in f32 and bf16 and the memory format
    its bf16 convs leave; the beam alone on one GraphCache that decodes f32
    and bf16 in turns (their graphs captured apart, each replayed to its
    first bits), decode ms by dtype in turns with profiles; the bf16 decode
    of 8 images' bf16 grid on the card against the CPU's plain forms."""
    import numpy as np
    import torch
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.models.beam import SYNC_EVERY, beam_search_batched
    from sat_tpu_torch.models.encoder import encoder_forward, vgg19_forward
    from sat_tpu_torch.utils.graphs import GraphCache

    bf16 = torch.bfloat16
    step = build_caption_step("vgg19", dcfg, BEAM, bf16=True, device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    first = step(enc, dec, images)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    host_launches = read_launches()
    want = 2 * sum(beam_blocks(STEPS, SYNC_EVERY))
    check(host_launches == counts(topk=want, attention_fwd_bf16=want),
          f"bf16 main path's capturing batch: host launches "
          f"{host_launches}, expected {want} of top-k and "
          f"attention_fwd_bf16 and no other")
    replayed = {}
    reset_launches()
    profile = {"main": profile_run(lambda: replayed.update(
        step(enc, dec, images)))}
    replay_host = read_launches()
    device_launches = profile["main"].get("kernel_calls")
    check(replay_host == counts() and device_launches
          == counts(topk=STEPS, attention_fwd_bf16=STEPS),
          f"bf16 main path's replayed batch: host launches {replay_host}, "
          f"device {device_launches}; expected none and {STEPS} of top-k "
          f"and attention_fwd_bf16")
    check(not [k for k in first if not same_bits(first[k], replayed[k])],
          "bf16 main path: a replayed batch differs from the captured one")
    check(tuple(first["tokens"].shape) == (B, 1 + STEPS)
          and not first["found"].any().item()
          and bool(torch.isfinite(first["alphas"]).all()),
          "bf16 main path: tokens, found or alphas wrong")
    steps = {"f32": step32, "bf16": step}
    wall_ms = {m: [] for m in steps}
    for m in ("f32", "bf16", "bf16", "f32", "f32", "bf16"):
        wall_ms[m].append(host_ms(lambda m=m: steps[m](enc, dec, images)))

    encode = {m: (lambda dt=dt: encoder_forward(enc, "vgg19", images, dt))
              for m, dt in (("f32", None), ("bf16", bf16))}
    encoder_ms = {m: [] for m in encode}
    for m in ("f32", "bf16", "bf16", "f32", "f32", "bf16"):
        encoder_ms[m].append(host_ms(encode[m]))
    profile["encoder"] = profile_run(encode["bf16"])
    with torch.inference_mode():
        conv = vgg19_forward(enc, torch.as_tensor(images[:8], device="cuda"),
                             bf16).permute(0, 3, 1, 2)
    memory_format = {"dtype": str(conv.dtype),
                     "nchw_contiguous": conv.is_contiguous(),
                     "channels_last": conv.is_contiguous(
                         memory_format=torch.channels_last)}
    feats = encode["f32"]()
    grid16 = encode["bf16"]()
    check(grid16.dtype == torch.float32 and grid16.is_contiguous()
          and bool(torch.isfinite(grid16).all()),
          "bf16 encoder: grid not f32, contiguous and finite")
    grid_rel = ((grid16 - feats).abs().mean() / feats.abs().mean()).item()
    check(grid_rel < 0.1, f"bf16 encoder: mean relative difference "
                          f"{grid_rel} from the f32 grid (sat_tpu's bound "
                          f"0.1)")

    # one GraphCache, f32 and bf16 in turns
    cache = GraphCache()
    decode = {m: (lambda bf=bf: beam_search_batched(
        dec, feats, BEAM, bf16=bf, graphs=cache))
        for m, bf in (("f32", False), ("bf16", True))}
    got, captures = {}, []
    for m in ("f32", "bf16", "f32", "bf16"):
        out = decode[m]()
        captures.append(cache.captures)
        if m in got:
            diff = results_equal(got[m], out)
            check(not diff, f"beam ({m}): a replay through the shared cache "
                            f"differs in {diff}")
        got[m] = out
    check(captures[0] < captures[1] == captures[2] == captures[3],
          f"f32 and bf16 graphs not captured apart: captures {captures}")
    check(bool(results_equal(got["f32"], got["bf16"])),
          "the bf16 decode gave the f32 decode's bits")
    decode_ms = {m: [] for m in decode}
    for m in ("f32", "bf16", "bf16", "f32", "f32", "bf16"):
        decode_ms[m].append(host_ms(decode[m]))
    for m in decode:
        profile[f"decode_{m}"] = profile_run(decode[m])

    # 8 images' bf16 grid, seeded weights (beams completing), the bf16 beam
    # eager on the card and with the plain forms on the CPU
    n = 8
    g8 = grid16[:n].contiguous()
    reset_launches()
    card = beam_search_batched(dec_gpu, g8, BEAM, bf16=True)
    torch.cuda.synchronize()
    cpu_launches = read_launches()
    check(cpu_launches["topk"] == cpu_launches["attention_fwd_bf16"]
          and 1 <= cpu_launches["topk"] <= STEPS
          and cpu_launches == counts(
              topk=cpu_launches["topk"],
              attention_fwd_bf16=cpu_launches["topk"]),
          f"bf16 beam: launches {cpu_launches}")
    cpu = beam_search_batched(dec_cpu, g8.cpu(), BEAM, bf16=True)
    agree = sum(bool(np.array_equal(card.tokens[i].cpu().numpy(),
                                    cpu.tokens[i].numpy())
                     and card.found[i].item() == cpu.found[i].item())
                for i in range(n))
    check(agree >= n - 1, f"bf16 beam: card and CPU agree on {agree} of {n}")
    check(bool(card.found.any()), "bf16 beam: no beam completed on 8 images")
    found = card.found.cpu() & cpu.found
    score_err = ((card.score.cpu()[found] - cpu.score[found]).abs().max()
                 if found.any() else None)
    return {"first_call_s": first_s, "capture_s": step.graphs.capture_seconds,
            "host_launches": host_launches,
            "device_launches": device_launches, "wall_ms": wall_ms,
            "captions_per_s": {m: B * 1e3 / statistics.median(v)
                               for m, v in wall_ms.items()},
            "encoder_ms": encoder_ms, "encoder_memory_format": memory_format,
            "grid_mean_rel_diff": grid_rel, "graph_captures": captures,
            "decode_ms": decode_ms,
            "device_busy_ms": {k: v.get("device_busy_ms")
                               for k, v in profile.items()},
            "device_busy_share": {k: v.get("device_busy_share")
                                  for k, v in profile.items()},
            "cpu_check": {"agree": agree, "of": n,
                          "found": int(card.found.sum()),
                          "max_score_err": None if score_err is None
                          else float(score_err),
                          "launches": cpu_launches},
            "profile": profile}


def calibrate_batch_norms(enc, network: str, images) -> None:
    """Set each batch norm's running statistics to those of its input on
    `images`, layer by layer (a forward in training mode with momentum 1):
    random weights then give grids of a trained network's scale, where
    sat_tpu's identity statistics let ResNet152's residual sums grow to
    1e10."""
    import torch.nn.functional as F
    from sat_tpu_torch.models import encoder as encoder_mod

    plain = encoder_mod._batch_norm

    def batch_stats(w, name, x):
        return F.batch_norm(x, w[f"{name}.running_mean"],
                            w[f"{name}.running_var"], w[f"{name}.weight"],
                            w[f"{name}.bias"], True, 1.0, encoder_mod.BN_EPS)

    encoder_mod._batch_norm = batch_stats
    try:
        encoder_mod.encoder_forward(enc, network, images)
    finally:
        encoder_mod._batch_norm = plain


def wide_weights(seed: int, network: str, images):
    """(decoder config, seeded and worst-case decoder archives, encoder
    archive) of a wider encoder's model: sat_tpu's init for the encoder,
    its batch norms calibrated on 32 of the images on the card; the
    decoder drawn and its <eos> bias set as make_weights does, at the
    encoder's width."""
    import torch
    from sat_tpu_torch.compat.jax_params import encoder_from_jax, encoder_to_jax
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
    from sat_tpu_torch.models.encoder import init_encoder_params

    gen = torch.Generator().manual_seed(seed)
    enc = encoder_from_jax(init_encoder_params(network, gen), network, "cuda")
    calibrate_batch_norms(enc, network, images[:32])
    dcfg = DecoderConfig(vocab_size=VOCAB, encoder_dim=WIDE[network],
                         use_ado=True, use_attention=True)
    dec = init_decoder_params(dcfg, gen)
    bias = dec["ado/f_out/b"].copy()
    bias[STOP_IDS[0]] += EOS_BOOST
    dec["ado/f_out/b"] = bias
    worst = dict(dec)
    bias = bias.copy()
    bias[list(STOP_IDS)] = -1e9
    worst["ado/f_out/b"] = bias
    return dcfg, dec, worst, encoder_to_jax(enc.state_dict(), network)


SCORE_RTOL = 1e-4     # card against CPU, a beam's summed logits


def rel_diff(a, b) -> float:
    """Mean relative difference of two grids: mean |a - b| / mean |b|."""
    return ((a - b).abs().mean() / b.abs().mean()).item()


def phase_encoders(seed: int, images) -> dict:
    """ResNet152 and DenseNet161 on the main path's batch (B = 128 images
    of 224 px, beam 5, worst case), f32 and bf16 through new caption
    steps: each step's capturing batch (host launches of top-k and of the
    forward, f32 or bf16, exactly as phase_main's), a replay under the
    profiler (no host launch, STEPS of each on the device), equal to the
    capture bit for bit; wall ms, encoder ms and decode ms in turns f32 and
    bf16; 2 images on the CPU (seeded weights, beams completing): tokens,
    lengths and completion equal, scores within SCORE_RTOL; the bf16
    grid's decode on the CPU too."""
    import torch
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 encoder_from_jax)
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.models.beam import SYNC_EVERY, beam_search_batched
    from sat_tpu_torch.models.encoder import encoder_forward
    from sat_tpu_torch.utils.graphs import GraphCache

    bf16 = torch.bfloat16
    out, weights = {}, {}
    for net_i, net in enumerate(WIDE):
        dcfg, dec_flat, worst_flat, enc_flat = wide_weights(
            seed + 10 + net_i, net, images)
        weights[net] = (dcfg, dec_flat, enc_flat)
        enc = encoder_from_jax(enc_flat, net, "cuda")
        dec = decoder_from_jax(worst_flat, dcfg, "cuda")
        res = {"host_launches": {}, "device_launches": {}, "profile": {}}
        steps = {}
        for mode, bf in (("f32", False), ("bf16", True)):
            kname = "attention_fwd_bf16" if bf else "attention_fwd"
            step = build_caption_step(net, dcfg, BEAM, bf16=bf,
                                      device="cuda")
            reset_launches()
            first = step(enc, dec, images)
            torch.cuda.synchronize()
            host = read_launches()
            want = 2 * sum(beam_blocks(STEPS, SYNC_EVERY))
            check(host == counts(topk=want, **{kname: want}),
                  f"{net} {mode}: capturing batch's host launches {host}, "
                  f"expected {want} of top-k and {kname}")
            replayed = {}
            reset_launches()
            prof = profile_run(lambda: replayed.update(
                step(enc, dec, images)))
            calls = prof.get("kernel_calls")
            check(read_launches() == counts()
                  and calls == counts(topk=STEPS, **{kname: STEPS}),
                  f"{net} {mode}: replayed batch's device launches {calls}, "
                  f"expected {STEPS} of top-k and {kname}, no host launch")
            check(not [k for k in first
                       if not same_bits(first[k], replayed[k])],
                  f"{net} {mode}: a replay differs from the capture")
            check(tuple(first["tokens"].shape) == (B, 1 + STEPS)
                  and not first["found"].any().item()
                  and bool(torch.isfinite(first["alphas"]).all())
                  and first["alphas"].shape[-1] == L_WIDE,
                  f"{net} {mode}: tokens, found or alphas wrong")
            res["host_launches"][mode] = host
            res["device_launches"][mode] = calls
            res["profile"][mode] = prof
            res[f"capture_s_{mode}"] = step.graphs.capture_seconds
            steps[mode] = step
        order = ("f32", "bf16", "bf16", "f32", "f32", "bf16")
        wall = {m: [] for m in steps}
        for m in order:
            wall[m].append(host_ms(lambda m=m: steps[m](enc, dec, images)))
        encode = {m: (lambda dt=dt: encoder_forward(enc, net, images, dt))
                  for m, dt in (("f32", None), ("bf16", bf16))}
        enc_ms = {m: [] for m in encode}
        for m in order:
            enc_ms[m].append(host_ms(encode[m]))
        res["profile"]["encoder_f32"] = profile_run(encode["f32"])
        res["profile"]["encoder_bf16"] = profile_run(encode["bf16"])
        grids = {m: encode[m]() for m in encode}
        check(all(bool(torch.isfinite(g).all()) for g in grids.values())
              and not torch.equal(grids["bf16"], grids["f32"]),
              f"{net}: a grid is not finite, or the bf16 grid is the f32 "
              f"one")
        # recorded, not bounded: these random nets amplify a perturbation
        # block by block, on the CPU as on the card (cpu_check's
        # `bf16_grid_rel_diff`); the CPU tests bound the bf16 path against
        # sat_tpu's on weights that do not (tests/test_torch_encoders.py)
        rel = rel_diff(grids["bf16"], grids["f32"])
        cache = GraphCache()
        decode = {m: (lambda m=m: beam_search_batched(
            dec, grids[m], BEAM, bf16=m == "bf16", graphs=cache))
            for m in grids}
        for m in decode:
            decode[m]()
        dec_ms = {m: [] for m in decode}
        for m in order:
            dec_ms[m].append(host_ms(decode[m]))

        # 2 images, seeded weights: the card against the CPU
        n = 2
        dec_gpu = decoder_from_jax(dec_flat, dcfg, "cuda")
        enc_cpu = encoder_from_jax(enc_flat, net, "cpu")
        dec_cpu = decoder_from_jax(dec_flat, dcfg, "cpu")
        card = build_caption_step(net, dcfg, BEAM, device="cuda",
                                  graphs=False)(enc, dec_gpu, images[:n])
        cpu = build_caption_step(net, dcfg, BEAM, device="cpu")(
            enc_cpu, dec_cpu, images[:n])
        card16 = beam_search_batched(dec_gpu, grids["bf16"][:n].contiguous(),
                                     BEAM, bf16=True)
        cpu16 = beam_search_batched(dec_cpu, grids["bf16"][:n].cpu(), BEAM,
                                    bf16=True)
        cpu_check = {"bf16_grid_rel_diff": {
            "card": rel_diff(grids["bf16"][:n], grids["f32"][:n]),
            "cpu": rel_diff(encoder_forward(enc_cpu, net, images[:n], bf16),
                            encoder_forward(enc_cpu, net, images[:n]))}}
        for label, g, c in (("f32", card, cpu),
                            ("bf16_grid", card16._asdict(),
                             cpu16._asdict())):
            g = {k: v.cpu() for k, v in g.items()}
            same = all(torch.equal(g[k], c[k])
                       for k in ("tokens", "length", "found"))
            found = g["found"] & c["found"]    # others score -inf
            err = ((g["score"][found] - c["score"][found]).abs()
                   / c["score"][found].abs().clamp(min=1.0)).max().item() \
                if found.any() else 0.0
            cpu_check[label] = {"tokens_equal": same, "score_rel_err": err,
                                "found": int(g["found"].sum())}
            check(same and err <= SCORE_RTOL,
                  f"{net} {label}: card and CPU differ on {n} images "
                  f"{cpu_check[label]}")
        res.update({
            "wall_ms": wall,
            "captions_per_s": {m: B * 1e3 / statistics.median(v)
                               for m, v in wall.items()},
            "encoder_ms": enc_ms, "decode_ms": dec_ms,
            "grid_mean_rel_diff_bf16": rel,
            "grid_mean_abs": grids["f32"].abs().mean().item(),
            "cpu_check": cpu_check})
        out[net] = res
        del enc, dec, steps, cache
        torch.cuda.empty_cache()
    emit({"phase": "encoders",
          **{net: {k: v for k, v in r.items() if k != "profile"}
             | {"device_busy_ms": {k: p.get("device_busy_ms")
                                   for k, p in r["profile"].items()}}
             for net, r in out.items()}})
    out["weights"] = weights
    return out


def phase_sample(dcfg, dec_flat, enc_flat, images, wide) -> dict:
    """Sample decode at B = 128 through its graph, on VGG19 (the main
    path's weights) and ResNet152 (the encoders phase's), at T = 0.8,
    p = 0.9, k = 10 and 50: one generator seed gives the same tokens on
    two replays and on the eager step, the next seed other captions;
    k = 1 gives greedy's tokens bit for bit; a replayed batch launches 51
    top-k (at k) and 51 attention_fwd on the device and nothing from the
    host; decode ms beside greedy's; on VGG19 also the decode alone at
    k = 50, 17, 64, 256, 1,024 (the select kernel's bitonic sort) and
    1,025, 2,048 and 2,632 (its radix sort), each replay's launches counted
    the same way."""
    import torch
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 encoder_from_jax)
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.models.beam import (batch_generator, greedy_caption,
                                           sample_caption)
    from sat_tpu_torch.models.encoder import encoder_forward
    from sat_tpu_torch.utils.graphs import GraphCache

    models = {"vgg19": (dcfg, dec_flat, enc_flat),
              "resnet152": wide["resnet152"]}
    out = {"device_launches": {}}
    for net, (cfg, dflat, eflat) in models.items():
        enc = encoder_from_jax(eflat, net, "cuda")
        dec = decoder_from_jax(dflat, cfg, "cuda")
        res = {}
        for k in SAMPLE_KS:
            knobs = dict(temperature=0.8, top_k=k, top_p=0.9)
            step = build_caption_step(net, cfg, BEAM, decode="sample",
                                      device="cuda", **knobs)
            eager = build_caption_step(net, cfg, BEAM, decode="sample",
                                       device="cuda", graphs=False, **knobs)

            def gen(i):
                return batch_generator(3, i, "cuda")

            runs = [step(enc, dec, images, gen(0)) for _ in range(2)]
            reset_launches()
            replayed = {}
            prof = profile_run(lambda: replayed.update(
                step(enc, dec, images, gen(0))))
            calls = prof.get("kernel_calls")
            check(read_launches() == counts()
                  and calls == counts(topk=STEPS, attention_fwd=STEPS),
                  f"sample {net} k={k}: replayed batch's device launches "
                  f"{calls}, expected {STEPS} of top-k and attention_fwd")
            out["device_launches"][f"{net}_k{k}"] = calls
            want = eager(enc, dec, images, gen(0))
            for got in runs + [replayed]:
                check(not [f for f in want if not same_bits(want[f], got[f])],
                      f"sample {net} k={k}: a replay differs from the eager "
                      f"step for one seed")
            other = step(enc, dec, images, gen(1))
            differ = int((other["tokens"] != want["tokens"]).any(1).sum())
            check(differ > 0, f"sample {net} k={k}: batch seeds (3, 0) and "
                              f"(3, 1) gave the same captions")
            ms = [host_ms(lambda: step(enc, dec, images, gen(0)))
                  for _ in range(3)]
            res[f"k{k}"] = {"decode_wall_ms": ms,
                            "images_differing_by_seed": differ,
                            "device_busy_ms": prof.get("device_busy_ms"),
                            "tokens_mean_length": float(
                                want["length"].float().mean())}
        feats = encoder_forward(enc, net, images)
        cache = GraphCache()
        one = sample_caption(dec, feats, batch_generator(5, 0, "cuda"), 0.8,
                             1, with_alphas=True, graphs=cache)
        greedy = greedy_caption(dec, feats, with_alphas=True, graphs=cache)
        check(all(map(same_bits, one, greedy)),
              f"sample {net}: top_k = 1 differs from greedy")
        sample_ms, greedy_ms = [], []
        for _ in range(3):
            sample_ms.append(host_ms(lambda: sample_caption(
                dec, feats, batch_generator(5, 0, "cuda"), 0.8, 10, 0.9,
                graphs=cache)))
            greedy_ms.append(host_ms(lambda: greedy_caption(
                dec, feats, graphs=cache)))
        res["decode_only_ms"] = {"sample_k10": sample_ms,
                                 "greedy": greedy_ms}
        if net == "vgg19":
            top = topk_max_select()
            res["by_k"] = by_k = decode_by_k(
                dec, feats, cache,
                (50,) + SELECT_KS + (top,) + sort_ks(VOCAB),
                f"sample {net}")
            out["device_launches"].update(
                {f"{net}_k{k}": v["device_launches"]
                 for k, v in by_k.items()})
        out[net] = res
    emit({"phase": "sample", **out})
    return out


def decode_by_k(dec, feats, cache, ks, label: str) -> dict:
    """Sample decode alone (T = 0.8, p = 0.9) through its graph at each k:
    a replayed batch launches 51 top-k and 51 attention_fwd on the device
    and nothing from the host; decode ms (host clock, 3 runs) and the
    profile's device busy ms."""
    from sat_tpu_torch.models.beam import batch_generator, sample_caption
    out = {}
    for k in ks:
        def run(k=k):
            return sample_caption(dec, feats, batch_generator(5, 0, "cuda"),
                                  0.8, k, 0.9, graphs=cache)

        run()                                         # its capture
        reset_launches()
        prof = profile_run(run)
        calls = prof.get("kernel_calls")
        check(read_launches() == counts()
              and calls == counts(topk=STEPS, attention_fwd=STEPS),
              f"{label} k={k}: a replayed batch's device launches {calls}, "
              f"expected {STEPS} of top-k and attention_fwd")
        out[k] = {"decode_ms": [host_ms(run) for _ in range(3)],
                  "device_launches": calls,
                  "device_busy_ms": prof.get("device_busy_ms")}
    return out


PROFILE_PAD_S = 0.2   # the idle card's seconds on each side of a profiled run
LEAD_IN = 64          # spin kernels queued just before a profiled run


def profile_run(fn, top: int = 10, count=(), warmup: bool = False) -> dict:
    """One run of `fn` under torch.profiler: device time by kernel (and
    copy) name, the device's busy share of the wall time, the run's
    host-clock wall time (the profiler's own cost included), the device
    calls of each attention kernel, and of the device events whose names
    hold each string of `count` (case aside). Only device events count: a
    host op such as aten::addmm also reports its kernels' time, which
    would count them twice. The card idles PROFILE_PAD_S before and after
    the run, inside the recorded window: the profiler drops a device event
    whose timestamps fall outside that window, and on the H100 machines
    the first kernels of a run that starts at once have been dropped (1-9
    of a train step's or block's attention_fwd, none of its later
    kernels). The pads did not stop it: a later profile of a train step
    missed every kernel of one decoder step, and one of a greedy replay
    one attention_fwd of its 51. So LEAD_IN spin kernels
    (`torch.cuda._sleep`, about 0.5 us each) are queued just before the
    run, and the loss takes them instead: on an H100, the profiles of one
    run of this script kept 14-32 of 32, fewer as the process aged, and no
    run lost a kernel. They count in no row; `lead_in_seen` says how many
    of them the profile kept. `device_lead_us` is how far the first
    device event's start (a spin kernel's) lies after the first host
    event's; a negative value is a clock offset between the two. With
    `warmup`, one run of `fn` in a warm-up cycle of the profiler comes
    first."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=(schedule(wait=0, warmup=1, active=1, repeat=1)
                           if warmup else None)) as prof:
        if warmup:
            fn()
            torch.cuda.synchronize()
            prof.step()
        time.sleep(PROFILE_PAD_S)
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1000)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(PROFILE_PAD_S)

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    lead_in_seen = sum(e.count for e in device if "spin_kernel" in e.key)
    rows = sorted(((e.key, device_us(e), e.count) for e in device
                   if device_us(e) > 0 and "spin_kernel" not in e.key),
                  key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    if not rows:
        return {"device_time": "not measured: the profiler saw no device "
                               "events"}
    kernel_calls = {name: sum(n for k, _, n in rows if kernel_of(k) == name)
                    for name in KERNELS}
    named = {sub: sum(n for k, _, n in rows if sub.lower() in k.lower())
             for sub in count}
    first = {}
    for e in prof.events():
        side = e.device_type == torch.autograd.DeviceType.CUDA
        first[side] = min(first.get(side, math.inf), e.time_range.start)
    lead_us = first.get(True, math.nan) - first.get(False, math.nan)
    if lead_us < 0:
        print(f"chip_smoke: a profile's first device event starts "
              f"{-lead_us:.1f} us before its first host event",
              file=sys.stderr)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "device_lead_us": lead_us, "lead_in_seen": lead_in_seen,
            "kernel_calls": kernel_calls, "named_calls": named,
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
            # one batch of 7 requests, which the server pads to the bucket
            # of 8 with a copy of its last image: each reply must be its
            # own row of that padded batch, the padded row dropped
            padded_replies = {}
            server._dispatch_batch([
                ({"id": i, "cached": i}, server._image_pool[i],
                 lambda obj, i=i: padded_replies.__setitem__(i, obj))
                for i in range(7)])()
            pool7 = server._image_pool[:7]
            padded = server._caption_fn(np.concatenate([pool7, pool7[-1:]]))
            padded = {k: v.cpu().numpy() for k, v in padded.items()}
        finally:
            server.stop()
        cli = cli_f32_check(model, enc_path, img_dir, server, word_dict)
        cli_bf16 = cli_bf16_check(model, enc_path, img_dir, server,
                                  word_dict)
        cli_sample = [cli_reply(model, enc_path, img_dir, "--decode",
                                "sample", "--seed", "3", "--temperature",
                                "0.8", "--top-k", "10", "--top-p", "0.9")
                      for _ in range(2)]
    captions = [r.get("caption") for r in replies]
    check(all(c is not None for c in captions),
          f"errors in replies: {[r for r in replies if 'caption' not in r]}")
    check(stats["errors"] == 0, f"server errors: {stats}")
    check(stats["batches"] < n, f"no request was coalesced: {stats}")
    # each new batch shape (a power-of-two bucket) captures the beam's
    # graphs: the wrappers count the warm-up's and the capture's launches,
    # one of each kernel a step, and no replay
    check(launches["topk"] == launches["attention_fwd"] > 0
          and launches["attention_bwd"] == 0,
          f"serve: launches {launches} for {stats['batches']} batches, "
          f"expected equal counts of top-k and attention_fwd")
    for i in range(n):
        row = (direct["tokens"][i, :int(direct["length"][i]) + 1].tolist()
               if direct["found"][i] else [0])
        check(captions[i] == " ".join(decode_caption(row, word_dict)),
              f"request {i}: served caption differs from the caption step")
    check(sorted(padded_replies) == list(range(7)),
          f"padded batch: replies {sorted(padded_replies)}")
    for i, reply in padded_replies.items():
        row = (padded["tokens"][i, :int(padded["length"][i]) + 1].tolist()
               if padded["found"][i] else [0])
        check(reply.get("caption") == " ".join(decode_caption(row, word_dict))
              and reply.get("score") == float(padded["score"][i]),
              f"padded batch, request {i}: {reply} is not row {i} of the "
              f"batch padded to 8")
    check(cli_sample[0][0] == cli_sample[1][0]
          and cli_sample[0][0].get("caption") is not None
          and cli_sample[0][2] == cli_sample[1][2] == 0,
          f"serve --decode sample --seed 3: two processes answered "
          f"{cli_sample[0]} and {cli_sample[1]}")
    res = {"phase": "serve", "requests": n, "stats": stats,
           "launches": launches,
           "latency_p50_ms": stats.get("latency_p50_ms"),
           "latency_p99_ms": stats.get("latency_p99_ms"),
           "nonempty_captions": sum(bool(c) for c in captions),
           "padded_batch_found": int(padded["found"][:7].sum()),
           "cli_f32": cli, "cli_bf16": cli_bf16,
           "cli_sample_seed3": [{"reply": r, "seconds": t}
                                for r, t, _ in cli_sample]}
    emit(res)
    return res


def cli_f32_check(model, enc_path, img_dir, server, word_dict) -> dict:
    """A fresh `python -m sat_tpu_torch.serve` process (its own TF32
    settings, not this script's) answers one cached request: its caption,
    score and completion must be the in-process f32 path's for that image,
    bit for bit. The same image captioned in this process with TF32 on is
    recorded beside it, to show what the check would catch."""
    import torch
    from sat_tpu_torch.engine.evaluate import decode_caption

    def in_process():
        out = server._caption_fn(server._image_pool[:1])
        found = bool(out["found"][0])
        row = (out["tokens"][0, :int(out["length"][0]) + 1].tolist()
               if found else [0])
        return {"caption": " ".join(decode_caption(row, word_dict)),
                "score": float(out["score"][0].cpu()), "completed": found}

    want = in_process()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = in_process()
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    got, seconds, code = cli_reply(model, enc_path, img_dir)
    check(got == want, f"cli: the fresh serve process answered {got}, the "
                       f"in-process f32 path {want}")
    return {"seconds": seconds, "reply": got, "exit_code": code,
            "tf32_in_process": tf32, "tf32_differs": tf32 != want}


def cli_bf16_check(model, enc_path, img_dir, server, word_dict) -> dict:
    """A fresh `python -m sat_tpu_torch.serve --bf16-decode` process
    answers one cached request: its caption, score and completion must be
    this process's bf16 caption step's for that image (B = 1, the
    server's modules), bit for bit, and its score not the f32 one."""
    import torch
    from sat_tpu_torch.engine.evaluate import decode_caption
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.serve import load_model

    _, dcfg, enc, dec, _ = load_model(model, encoder_weights=enc_path,
                                      device="cuda")
    out = build_caption_step("vgg19", dcfg, BEAM, bf16=True, device="cuda")(
        enc, dec, server._image_pool[:1])
    found = bool(out["found"][0])
    row = (out["tokens"][0, :int(out["length"][0]) + 1].tolist()
           if found else [0])
    want = {"caption": " ".join(decode_caption(row, word_dict)),
            "score": float(out["score"][0].cpu()), "completed": found}
    got, seconds, code = cli_reply(model, enc_path, img_dir, "--bf16-decode")
    check(got == want, f"cli --bf16-decode: the fresh serve process "
                       f"answered {got}, the in-process bf16 step {want}")
    f32 = server._caption_fn(server._image_pool[:1])
    f32_score = float(f32["score"][0].cpu())
    check(not found or f32_score != got["score"],
          "cli --bf16-decode: the score is the f32 path's")
    return {"seconds": seconds, "reply": got, "exit_code": code,
            "f32_score": f32_score}


def cli_reply(model, enc_path, img_dir, *flags):
    """(reply, seconds, exit code) of a fresh `python -m
    sat_tpu_torch.serve` process with `flags`, asked for cached image 0 and
    then shut down."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "sat_tpu_torch.serve", "--model", model,
         "--encoder-weights", enc_path, "--port", "0", "--max-batch", "1",
         "--preload-images", img_dir, "--preload-count", "1", *flags],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, PYTHONUNBUFFERED="1"))
    killer = threading.Timer(300, proc.kill)
    killer.start()
    lines, reply, m, t0 = [], None, None, time.perf_counter()
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            m = re.search(r"listening on [\d.]+:(\d+)", line)
            if m:
                break
        check(m is not None, f"cli: the server did not start: {lines[-5:]}")
        with socket.create_connection(("127.0.0.1", int(m.group(1))),
                                      timeout=120) as sock:
            f = sock.makefile("rwb")
            f.write(b'{"id": 0, "cached": 0}\n')
            f.flush()
            reply = json.loads(f.readline())
            f.write(b'{"cmd": "shutdown"}\n')
            f.flush()
            f.readline()
        proc.wait(timeout=60)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    return ({k: reply.get(k) for k in ("caption", "score", "completed")},
            seconds, proc.returncode)


def make_captions(gen, rows: int):
    """(rows, CAP_LEN) int32 captions as the data prep writes them:
    <start>, 8 to 25 words, <eos>, then <pad>."""
    import torch
    from sat_tpu_torch import constants
    caps = torch.full((rows, CAP_LEN), constants.PAD, dtype=torch.int32)
    caps[:, 0] = constants.START
    for i, n in enumerate(torch.randint(8, CAP_LEN - 1, (rows,),
                                        generator=gen).tolist()):
        caps[i, 1:n + 1] = torch.randint(4, VOCAB, (n,), generator=gen,
                                         dtype=torch.int32)
        caps[i, n + 1] = constants.EOS
    return caps


def state_diff(a, b) -> float:
    """The largest difference between two train states' parameters and
    Adam moments; inf when their step counts differ."""
    import torch
    if a.step != b.step:
        return float("inf")
    diffs = [(x - b.decoder.state_dict()[k]).abs().max().item()
             for k, x in a.decoder.state_dict().items()]
    sb = b.optimizer.state_dict()["state"]
    for i, st in a.optimizer.state_dict()["state"].items():
        if not torch.equal(st["step"].cpu(), sb[i]["step"].cpu()):
            return float("inf")
        diffs += [(st[k] - sb[i][k]).abs().max().item()
                  for k in ("exp_avg", "exp_avg_sq")]
    return max(diffs)


def graph_pools():
    """Bytes in each private memory pool (one a CUDA graph), by pool id:
    reserved (its segments) and allocated (its live tensors), from the
    allocator's snapshot, the default pool (id (0, 0)) left out; None when
    the snapshot does not name its segments' pools."""
    import torch
    pools = {}
    for seg in torch.cuda.memory_snapshot():
        if "segment_pool_id" not in seg:
            return None
        pid = tuple(seg["segment_pool_id"])
        if pid != (0, 0):
            got = pools.setdefault(pid, {"reserved": 0, "allocated": 0})
            got["reserved"] += seg["total_size"]
            got["allocated"] += seg["allocated_size"]
    return pools


def phase_train(seed: int, enc_flat) -> dict:
    """Bank training of the flagship decoder at full width on the card."""
    import dataclasses

    import torch
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 decoder_to_jax)
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_train_block,
                                                   make_bank_train_step)

    gen = torch.Generator().manual_seed(seed + 2)
    # dropout 0.5 and remat_scan on: the training defaults
    dcfg = DecoderConfig(vocab_size=VOCAB, encoder_dim=D, use_tf=True,
                         use_ado=True, use_attention=True)
    flat = init_decoder_params(dcfg, gen)
    bank = torch.rand((BANK_U, L, D), generator=gen)
    caps = make_captions(gen, BANK_N)
    batches = [(torch.randint(0, BANK_U, (TRAIN_B,), generator=gen),
                torch.randint(0, BANK_N, (TRAIN_B,), generator=gen))
               for _ in range(K_BLOCK)]
    bank_gpu, caps_gpu = bank.cuda(), caps.cuda()
    batches_gpu = [(i.cuda(), r.cuda()) for i, r in batches]

    # (a) one step from the same params, card (kernels) against CPU (plain
    # forms), dropout 0
    exact = dataclasses.replace(dcfg, dropout_rate=0.0)
    after = {}
    for device, fb, cb, (ii, ri) in (("cpu", bank, caps, batches[0]),
                                     ("cuda", bank_gpu, caps_gpu,
                                      batches_gpu[0])):
        state = init_train_state(decoder_from_jax(flat, exact, device,
                                                  trainable=True))
        state, m = make_bank_train_step(exact, 1.0)(state, fb, cb, ii, ri,
                                                    PARITY_LR, None)
        after[device] = (float(m["loss"]), decoder_to_jax(state.decoder))
    (cpu_loss, cpu_p), (gpu_loss, gpu_p) = after["cpu"], after["cuda"]
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    check(loss_rel <= 1e-5, f"train: card loss {gpu_loss} vs CPU {cpu_loss}")
    param_err = {}
    for name, ref in cpu_p.items():
        err = float(abs(gpu_p[name] - ref).max())
        param_err[name] = err
        # The score bias's true gradient is zero: Adam turns its rounding
        # noise into a +-lr step of either sign (tests/test_train_parity.py)
        bound = 2.05 * PARITY_LR if name == "attention/v/b" else 3e-4
        check(err <= bound, f"train: {name} differs by {err} > {bound} "
                            f"after one step")
    parity = {"loss_cpu": cpu_loss, "loss_gpu": gpu_loss,
              "loss_rel_err": loss_rel, "lr": PARITY_LR,
              "max_param_err": max(v for k, v in param_err.items()
                                   if k != "attention/v/b"),
              "param_err": param_err}

    # (b, c) launches per step and step times, remat on and off
    state = init_train_state(decoder_from_jax(flat, dcfg, "cuda",
                                              trainable=True))
    dgen = torch.Generator(device="cuda").manual_seed(seed)
    steps = {"remat": make_bank_train_step(dcfg, 1.0),
             "no_remat": make_bank_train_step(
                 dataclasses.replace(dcfg, remat_scan=False), 1.0)}
    next_batch = itertools.cycle(batches_gpu)

    def run(mode: str, n: int, lr: float = 1e-4, fixed=None):
        nonlocal state
        losses = []
        for _ in range(n):
            ii, ri = fixed or next(next_batch)
            state, m = steps[mode](state, bank_gpu, caps_gpu, ii, ri, lr,
                                   dgen)
            losses.append(m["loss"])
        return losses

    launches = {}
    for mode, fwd in (("remat", 2 * T), ("no_remat", T)):
        reset_launches()
        run(mode, 1)
        torch.cuda.synchronize()
        launches[mode] = read_launches()
        check(launches[mode] == counts(attention_fwd=fwd, attention_bwd=T),
              f"train ({mode}): launches {launches[mode]}, expected "
              f"attention_fwd {fwd}, attention_bwd {T}, topk 0")
    for mode in steps:
        run(mode, 3)                                   # warm-up

    # K-step blocks (--steps-per-dispatch): the first block of each mode
    # captures its step (the warm-up's and the capture's launches are the
    # host's; the replays launch nothing from the host)
    blocks = {"remat": make_bank_train_block(dcfg, 1.0),
              "no_remat": make_bank_train_block(
                  dataclasses.replace(dcfg, remat_scan=False), 1.0)}
    blk_img = torch.stack([i for i, _ in batches_gpu])       # (K, B)
    blk_row = torch.stack([r for _, r in batches_gpu])

    def run_blocks(mode: str, n: int, lr: float = 1e-4):
        nonlocal state
        for _ in range(n):
            state, m = blocks[mode](state, bank_gpu, caps_gpu, blk_img,
                                    blk_row, lr, dgen)
        return m

    block_launches, capture_s, pool = {}, {}, {}
    for mode in blocks:
        before = graph_pools()
        reset_launches()
        run_blocks(mode, 1)
        torch.cuda.synchronize()
        after = graph_pools()
        check(before is not None and after is not None,
              "train block: the allocator's snapshot names no pools")
        pool[mode] = {k: sum(v[k] for pid, v in after.items()
                             if pid not in before)
                      for k in ("reserved", "allocated")}
        check(pool[mode]["reserved"] > 0,
              f"train block ({mode}): its capture reserved no pool")
        block_launches[mode] = read_launches()
        check(block_launches[mode] == {k: 2 * v for k, v in
                                       launches[mode].items()},
              f"train block ({mode}): host launches {block_launches[mode]}, "
              f"expected twice a step's (warm-up and capture)")
        capture_s[mode] = blocks[mode].graphs.capture_seconds

    # ms a step, per-batch and blocked in turns, with peak memory: the
    # most allocated in the window, and for a block that plus the part of
    # its graph's pool not allocated (the captured step's working set,
    # which replays reuse and the allocator does not see)
    n_timed = 2 * K_BLOCK
    order = [f"{m}{b}" for m in ("remat", "no_remat")
             for b in ("", "_blocked", "_blocked", "")]
    timing = {m: {"ms_per_step": [], "peak_mem_gb": [],
                  "peak_with_pool_gb": []} for m in dict.fromkeys(order)}
    for mode in order:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if mode.endswith("_blocked"):
            run_blocks(mode[:-len("_blocked")], n_timed // K_BLOCK)
        else:
            run(mode, n_timed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_timed
        timing[mode]["ms_per_step"].append(ms)
        peak = torch.cuda.max_memory_allocated()
        timing[mode]["peak_mem_gb"].append(peak / 1e9)
        own = pool.get(mode[:-len("_blocked")]) if mode.endswith(
            "_blocked") else None
        timing[mode]["peak_with_pool_gb"].append(
            (peak + (own["reserved"] - own["allocated"] if own else 0))
            / 1e9)
    for t in timing.values():
        t["mean_ms"] = statistics.mean(t["ms_per_step"])
        t["rows_per_s"] = TRAIN_B * 1e3 / t["mean_ms"]

    # (d) one default step under the profiler: each wrapper launch is one
    # attention kernel on the device; one block of K replays: K steps'
    # kernels on the device
    reset_launches()
    profile = profile_run(lambda: run("remat", 1))
    counted = read_launches()
    check(profile.get("kernel_calls") == counted,
          f"train: the profile shows attention kernels "
          f"{profile.get('kernel_calls')}, the wrappers counted {counted}")
    block_profile = profile_run(lambda: run_blocks("remat", 1))
    calls = block_profile.get("kernel_calls")
    want = {k: K_BLOCK * v for k, v in launches["remat"].items()}
    check(calls == want, f"train block: the profile shows kernels {calls}, "
                         f"expected {want}")

    # (f) a block of K replays against K per-batch steps from one state,
    # dropout 0: the same bits in parameters, Adam moments and step counts
    block_diff = {}
    for mode, cfg_m in (("remat", exact),
                        ("no_remat", dataclasses.replace(
                            exact, remat_scan=False))):
        pair = [init_train_state(decoder_from_jax(flat, cfg_m, "cuda",
                                                  trainable=True))
                for _ in range(2)]
        one = make_bank_train_step(cfg_m, 1.0)
        for ii, ri in batches_gpu:
            pair[0], _ = one(pair[0], bank_gpu, caps_gpu, ii, ri, PARITY_LR,
                             None)
        pair[1], _ = make_bank_train_block(cfg_m, 1.0)(
            pair[1], bank_gpu, caps_gpu, blk_img, blk_row, PARITY_LR, None)
        block_diff[mode] = state_diff(*pair)
        check(block_diff[mode] == 0.0,
              f"train block ({mode}): {K_BLOCK} replays differ from "
              f"{K_BLOCK} per-batch steps by {block_diff[mode]}")

    # (g) two blocked runs with dropout 0.5 give the same bits
    runs = []
    for _ in range(2):
        st = init_train_state(decoder_from_jax(flat, dcfg, "cuda",
                                               trainable=True))
        gen = torch.Generator(device="cuda").manual_seed(seed)
        blk = make_bank_train_block(dcfg, 1.0)
        for _ in range(2):
            st, _ = blk(st, bank_gpu, caps_gpu, blk_img, blk_row, 1e-4, gen)
        runs.append((st, gen.get_state()))
    dropout_diff = state_diff(runs[0][0], runs[1][0])
    check(dropout_diff == 0.0 and torch.equal(runs[0][1], runs[1][1]),
          f"train block: two dropout runs differ by {dropout_diff}")

    # (e) 20 steps on one batch lower the loss
    state = init_train_state(decoder_from_jax(flat, dcfg, "cuda",
                                              trainable=True))
    losses = [float(x) for x in run("remat", 20, lr=1e-3,
                                    fixed=batches_gpu[0])]
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"train: the loss did not fall on a fixed batch: {losses}")
    res = {"phase": "train", "batch": TRAIN_B, "caption_len": CAP_LEN,
           "bank_images": BANK_U, "bank_mb": bank.numel() * 4 / 1e6,
           "parity": parity, "launches": launches,
           "block_k": K_BLOCK, "block_launches": block_launches,
           "block_device_launches": calls, "block_capture_s": capture_s,
           "block_pool_gb": {m: {k: v / 1e9 for k, v in p.items()}
                             for m, p in pool.items()},
           "block_max_abs_diff": block_diff,
           "block_dropout_max_abs_diff": dropout_diff, "timing": timing,
           "ms_per_step": timing["remat"]["mean_ms"],
           "rows_per_s": timing["remat"]["rows_per_s"],
           "peak_mem_gb": max(timing["remat"]["peak_mem_gb"]),
           "fixed_batch_losses": losses, "profile": profile,
           "block_profile": block_profile}
    res["bf16"] = train_bf16(dcfg, flat, bank_gpu, caps_gpu, batches_gpu,
                             blk_img, blk_row, seed, enc_flat)
    emit({k: v for k, v in res.items()
          if k not in ("parity", "profile", "block_profile", "bf16")}
         | {"parity": {k: v for k, v in parity.items()
                       if k != "param_err"},
            "block_device_busy_share": block_profile.get(
                "device_busy_share"),
            "step_device_busy_share": profile.get("device_busy_share"),
            "bf16": {k: v for k, v in res["bf16"].items()
                     if k not in ("profile", "block_profile")}})
    return res


def train_bf16(dcfg, flat, bank_gpu, caps_gpu, batches_gpu, blk_img,
               blk_row, seed, enc_flat) -> dict:
    """The bf16 training path at B = 64 (`--bf16-attention --bank-dtype
    bfloat16`, remat on, dropout 0.5): the bank in bf16 (half the bytes);
    one step's launches (counts reset just before, read just after: 2T of
    the forward's bf16 variant, T of the backward's, no f32 attention
    kernel) and its profile; the first step's loss beside the f32 path's
    from the same state (dropout 0); a K = 8 block's host and device
    launches, and against 8 per-batch steps bit for bit (dropout 0); ms a
    step per batch and blocked, in turns with the f32 path's, with peak
    memory and each block's graph pool; a step on 224 px images through
    the bf16 encoder (`--bf16-encoder` without the bank)."""
    import dataclasses

    import torch
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 encoder_from_jax)
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_train_block,
                                                   make_bank_train_step,
                                                   make_train_step)

    cfg = dataclasses.replace(dcfg, bf16_attention=True)
    bank16 = bank_gpu.to(torch.bfloat16)
    check(bank16.nbytes * 2 == bank_gpu.nbytes, "bf16 bank: not half")
    cfgs = {"f32": dcfg, "bf16": cfg}
    banks = {"f32": bank_gpu, "bf16": bank16}

    def fresh(mode, dropout=True):
        c = cfgs[mode] if dropout else dataclasses.replace(
            cfgs[mode], dropout_rate=0.0)
        return init_train_state(decoder_from_jax(flat, c, "cuda",
                                                 trainable=True)), c

    # the first step from one state, dropout 0: bf16 against f32
    first_loss = {}
    for mode in cfgs:
        st, c = fresh(mode, dropout=False)
        ii, ri = batches_gpu[0]
        _, m = make_bank_train_step(c, 1.0)(st, banks[mode], caps_gpu, ii, ri,
                                            PARITY_LR, None)
        first_loss[mode] = float(m["loss"])
    loss_rel = abs(first_loss["bf16"] - first_loss["f32"]) / abs(
        first_loss["f32"])
    check(math.isfinite(first_loss["bf16"]) and loss_rel < 1e-2,
          f"bf16 train: first loss {first_loss} (relative {loss_rel})")

    states, steps, blocks, gens = {}, {}, {}, {}
    for mode in cfgs:
        states[mode], _ = fresh(mode)
        steps[mode] = make_bank_train_step(cfgs[mode], 1.0)
        blocks[mode] = make_bank_train_block(cfgs[mode], 1.0)
        gens[mode] = torch.Generator(device="cuda").manual_seed(seed)

    def run(mode, n):
        for i in range(n):
            ii, ri = batches_gpu[i % len(batches_gpu)]
            states[mode], m = steps[mode](states[mode], banks[mode], caps_gpu,
                                          ii, ri, 1e-4, gens[mode])
        return m

    def run_blocks(mode, n):
        for _ in range(n):
            states[mode], m = blocks[mode](states[mode], banks[mode],
                                           caps_gpu, blk_img, blk_row, 1e-4,
                                           gens[mode])
        return m

    reset_launches()
    run("bf16", 1)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == counts(attention_fwd_bf16=2 * T, attention_bwd_bf16=T),
          f"bf16 train step: launches {launches}, expected "
          f"attention_fwd_bf16 {2 * T}, attention_bwd_bf16 {T} and no other")
    run("f32", 1)
    reset_launches()
    profile = profile_run(lambda: run("bf16", 1))
    counted = read_launches()
    check(profile.get("kernel_calls") == counted,
          f"bf16 train step: the profile shows {profile.get('kernel_calls')}"
          f", the wrappers counted {counted}")
    pool, block_launches = {}, None
    for mode in cfgs:
        before = graph_pools()
        reset_launches()
        run_blocks(mode, 1)
        torch.cuda.synchronize()
        after = graph_pools()
        if mode == "bf16":
            block_launches = read_launches()
            check(block_launches == {k: 2 * v for k, v in launches.items()},
                  f"bf16 train block: host launches {block_launches}, "
                  f"expected twice a step's")
        pool[mode] = {k: sum(v[k] for pid, v in after.items()
                             if pid not in before)
                      for k in ("reserved", "allocated")}
    block_profile = profile_run(lambda: run_blocks("bf16", 1))
    want = {k: K_BLOCK * v for k, v in launches.items()}
    check(block_profile.get("kernel_calls") == want,
          f"bf16 train block: the profile shows "
          f"{block_profile.get('kernel_calls')}, expected {want}")

    # Both paths' states, banks and graphs stay resident here, so each
    # window's peak is read above what was allocated at its start: the
    # step's working set (a block's with the free part of its pool)
    n_timed = 2 * K_BLOCK
    order = ["f32", "bf16", "bf16_blocked", "f32_blocked", "f32_blocked",
             "bf16_blocked", "bf16", "f32"]
    timing = {m: {"ms_per_step": [], "peak_mem_gb": [],
                  "peak_with_pool_gb": [], "working_set_gb": []}
              for m in dict.fromkeys(order)}
    for key in order:
        mode, blocked = key.split("_")[0], key.endswith("_blocked")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        if blocked:
            run_blocks(mode, n_timed // K_BLOCK)
        else:
            run(mode, n_timed)
        torch.cuda.synchronize()
        timing[key]["ms_per_step"].append(
            (time.perf_counter() - t0) * 1e3 / n_timed)
        peak = torch.cuda.max_memory_allocated()
        free_pool = (pool[mode]["reserved"] - pool[mode]["allocated"]
                     if blocked else 0)
        timing[key]["peak_mem_gb"].append(peak / 1e9)
        timing[key]["peak_with_pool_gb"].append((peak + free_pool) / 1e9)
        timing[key]["working_set_gb"].append((peak - base + free_pool)
                                             / 1e9)
    for t in timing.values():
        t["mean_ms"] = statistics.mean(t["ms_per_step"])
        t["rows_per_s"] = TRAIN_B * 1e3 / t["mean_ms"]

    # a block against K per-batch steps from one state, dropout 0
    pair = [fresh("bf16", dropout=False)[0] for _ in range(2)]
    exact = dataclasses.replace(cfg, dropout_rate=0.0)
    one = make_bank_train_step(exact, 1.0)
    for ii, ri in batches_gpu:
        pair[0], _ = one(pair[0], bank16, caps_gpu, ii, ri, PARITY_LR, None)
    pair[1], _ = make_bank_train_block(exact, 1.0)(
        pair[1], bank16, caps_gpu, blk_img, blk_row, PARITY_LR, None)
    block_diff = state_diff(*pair)
    check(block_diff == 0.0, f"bf16 train block: {K_BLOCK} replays differ "
                             f"from {K_BLOCK} per-batch steps by "
                             f"{block_diff}")

    # the image path through the bf16 encoder
    enc = encoder_from_jax(enc_flat, "vgg19", "cuda")
    imgs = torch.randn((TRAIN_B, SIZE, SIZE, 3),
                       generator=torch.Generator().manual_seed(seed + 3))
    caps = caps_gpu[batches_gpu[0][1]]
    img_step = make_train_step(cfg, "vgg19", 1.0, bf16_encoder=True)
    st, _ = fresh("bf16")
    img_step(st, enc, imgs, caps, 1e-4, gens["bf16"])         # warm-up
    reset_launches()
    t0 = time.perf_counter()
    st, m = img_step(st, enc, imgs, caps, 1e-4, gens["bf16"])
    img_loss = float(m["loss"])
    image_step_ms = (time.perf_counter() - t0) * 1e3
    img_launches = read_launches()
    check(math.isfinite(img_loss) and img_launches == launches,
          f"bf16 image step: loss {img_loss}, launches {img_launches}")
    return {"bank_bytes": bank16.nbytes, "f32_bank_bytes": bank_gpu.nbytes,
            "first_loss": first_loss, "first_loss_rel_diff": loss_rel,
            "launches": launches, "block_launches": block_launches,
            "block_device_launches": block_profile.get("kernel_calls"),
            "block_pool_gb": {m: {k: v / 1e9 for k, v in p.items()}
                              for m, p in pool.items()},
            "block_max_abs_diff": block_diff, "timing": timing,
            "step_device_busy_share": profile.get("device_busy_share"),
            "block_device_busy_share": block_profile.get("device_busy_share"),
            "step_device_busy_ms": profile.get("device_busy_ms"),
            "block_device_busy_ms": block_profile.get("device_busy_ms"),
            "image_step_ms": image_step_ms, "image_step_loss": img_loss,
            "profile": profile, "block_profile": block_profile}


def _bleu_of(log: str, mode: str) -> dict:
    """BLEU-1..4 from the `{mode} Epoch:` line of a training log."""
    line = next(ln for ln in log.splitlines()
                if ln.startswith(f"{mode} Epoch: "))
    return {f"bleu{n}": float(v)
            for n, v in re.findall(r"BLEU-(\d) \(([^)]*)\)", line)}


# Images of the entry phase's dataset, two caption rows each: 8 train
# batches of 64 (two blocks of ENTRY_K), 2 validation batches, one test
# batch of 16 rows (8 attention plots)
ENTRY_IMAGES = {"train": 256, "val": 64, "test": 8}
ENTRY_K = 4


def meter_rows(log: str) -> list:
    """The stdout rows of the train and eval meters and the BLEU lines."""
    return [ln for ln in log.splitlines()
            if ln.startswith(("Train Batch", "EvalMode."))]


def run_diff(dir_a: str, dir_b: str, step: int) -> dict:
    """Differences between two runs' last decoder `.npz` and the Adam
    moments of their train states at `step`."""
    import numpy as np
    import torch
    diffs = {}
    with np.load(os.path.join(dir_a, "model_vgg19_1.npz")) as a, \
            np.load(os.path.join(dir_b, "model_vgg19_1.npz")) as b:
        for k in a.files:
            diffs[k] = float(np.abs(a[k] - b[k]).max())
    ends = [torch.load(os.path.join(d, "train_state", f"{step}.pt"),
                       weights_only=True)["optimizer"]["state"]
            for d in (dir_a, dir_b)]
    for i, moments in ends[0].items():
        for k in ("exp_avg", "exp_avg_sq"):
            diffs[f"adam/{i}/{k}"] = float(
                (moments[k] - ends[1][i][k]).abs().max())
    return diffs


def write_entry_split(root: str, enc_flat) -> str:
    """The entry phase's dataset in `root` (ENTRY_IMAGES random 224 px PNGs
    a split, two caption rows an image, a VOCAB-word dictionary) and the
    encoder's archive; returns the archive's path."""
    import numpy as np
    import torch
    from PIL import Image

    gen = torch.Generator().manual_seed(7)
    rng = np.random.default_rng(7)
    words = ["<start>", "<eos>", "<unk>", "<pad>"] + [
        f"w{i}" for i in range(4, VOCAB)]
    with open(os.path.join(root, "word_dict.json"), "w") as f:
        json.dump({w: i for i, w in enumerate(words)}, f)
    os.makedirs(os.path.join(root, "imgs"))
    for split, images in ENTRY_IMAGES.items():
        paths = []
        for i in range(images):        # two caption rows an image
            path = os.path.join(root, "imgs", f"{split}_{i:03d}.png")
            Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3),
                                         np.uint8)).save(path)
            paths += [path, path]
        with open(os.path.join(root, f"{split}_img_paths.json"), "w") as f:
            json.dump(paths, f)
        with open(os.path.join(root, f"{split}_captions.json"), "w") as f:
            json.dump(make_captions(gen, len(paths)).tolist(), f)
    enc_path = os.path.join(root, "vgg19.npz")
    np.savez(enc_path, **enc_flat)
    return enc_path


def phase_entry(enc_flat, wide, seed: int, serving: tuple) -> dict:
    """`python -m sat_tpu_torch.train` for one epoch and its test pass on
    a dataset on disk; the same run preempted by SIGUSR1 after its first
    step and finished by `--resume`, which must end with the same decoder
    and Adam moments; the three runs again with `--steps-per-dispatch 4`
    (the preemption after the first block), whose meter rows and final
    state must be the per-batch run's; the checkpoint through the port's
    server code."""
    import contextlib
    import io
    import signal

    import numpy as np
    import torch
    from PIL import Image
    from sat_tpu_torch.config import build_arg_parser, config_from_args
    from sat_tpu_torch.data.transforms import load_and_preprocess_image
    from sat_tpu_torch.engine import checkpoint as ckpt
    from sat_tpu_torch.engine.evaluate import decode_caption
    from sat_tpu_torch.engine.loop import Trainer
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.serve import load_model
    from sat_tpu_torch.train import main as train_main
    from sat_tpu_torch.train import set_seed

    n_train = 2 * ENTRY_IMAGES["train"] // TRAIN_B       # train batches
    n_val = -(-2 * ENTRY_IMAGES["val"] // TRAIN_B)

    def timed(fn, *args):
        """(result, seconds, launches, stdout) of one synchronized call."""
        out = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = fn(*args)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, read_launches(), out.getvalue()

    def launches(fwd, bwd):
        return counts(attention_fwd=fwd * T, attention_bwd=bwd * T)

    with tempfile.TemporaryDirectory() as root:
        enc_path = write_entry_split(root, enc_flat)

        def argv(ckpt_dir, *extra, encoder=enc_path):
            return ["--data", root, "--tf", "--ado", "--attention",
                    "--cache-features", "--epochs", "1", "--batch-size",
                    str(TRAIN_B), "--log-interval", "1", "--checkpoint-dir",
                    ckpt_dir, "--encoder-weights", encoder, *extra]

        def preempted_run(ckpt_dir, attr, *extra):
            """The run through the Trainer as the CLI configures it; the
            first call of its `attr` (the train step or block) sends this
            process SIGUSR1, which the handler that fit installs turns into
            a save at the next step (block) boundary."""
            args = build_arg_parser().parse_args(argv(ckpt_dir, *extra))
            cfg = config_from_args(args)
            set_seed(cfg.seed)
            with contextlib.redirect_stdout(io.StringIO()):
                trainer = Trainer(cfg, device=args.device)
            plain, calls = getattr(trainer, attr), []

            def signalling(*a, **k):
                calls.append(1)
                if len(calls) == 1:
                    os.kill(os.getpid(), signal.SIGUSR1)
                return plain(*a, **k)

            setattr(trainer, attr, signalling)
            return timed(trainer.fit) + (trainer,)

        # (a) the uninterrupted run, its test pass timed apart
        ckpt_dir = os.path.join(root, "model")
        test_seconds = []
        plain_test = Trainer.test

        def timed_test(self, epoch):
            t0 = time.perf_counter()
            res = plain_test(self, epoch)
            torch.cuda.synchronize()
            test_seconds.append(time.perf_counter() - t0)
            return res

        Trainer.test = timed_test
        try:
            last, seconds, run_launches, log = timed(train_main,
                                                     argv(ckpt_dir))
        finally:
            Trainer.test = plain_test
        for line in (f"Train Batch: [{n_train - 1}/{n_train}]",
                     f"EvalMode.VALIDATION Batch: [{n_val - 1}/{n_val}]",
                     "EvalMode.VALIDATION Epoch: 1\tBLEU-1 (",
                     "EvalMode.TEST Batch: [0/1]",
                     "EvalMode.TEST Epoch: 1\tBLEU-1 ("):
            check(line in log, f"entry: no {line!r} in the training output")
        # each train batch 2T forward (remat) and T backward launches, each
        # validation and test batch T forward
        check(run_launches == launches(2 * n_train + n_val + 1, n_train),
              f"entry: launches {run_launches}")
        bleu = {"val": _bleu_of(log, "EvalMode.VALIDATION"),
                "test": _bleu_of(log, "EvalMode.TEST")}
        check(all(len(b) == 4 and all(math.isfinite(v) and 0 <= v <= 1
                                      for v in b.values())
                  for b in bleu.values()), f"entry: BLEU {bleu}")
        check(bleu["test"] == {k: float(last[k]) for k in bleu["test"]}
              and math.isfinite(last["loss"]), f"entry: test pass {last}")
        viz = os.path.join(ckpt_dir, "attention_viz_epoch1")
        plots = sorted(os.listdir(viz)) if os.path.isdir(viz) else []
        check(1 <= len(plots) <= 50, f"entry: {len(plots)} attention plots")
        for name in plots:
            with Image.open(os.path.join(viz, name)) as im:
                im.load()
                check(im.format == "PNG" and im.width > 0,
                      f"entry: plot {name}")
        states = os.listdir(os.path.join(ckpt_dir, "train_state"))
        check(states == [f"{n_train}.pt"], f"entry: train states {states}")
        state_bytes = os.path.getsize(os.path.join(
            ckpt_dir, "train_state", f"{n_train}.pt"))

        # (b) preempted after its first step
        cut_dir = os.path.join(root, "cut")
        cut, cut_seconds, cut_launches, cut_log, trainer = preempted_run(
            cut_dir, "train_step")
        check(cut == {"preempted": True, "epoch": 1}
              and "Preempted at epoch 1 batch 1" in cut_log,
              f"entry: the SIGUSR1 run returned {cut}")
        check(cut_launches == launches(2, 1),
              f"entry: preempted run's launches {cut_launches}")
        states = os.listdir(os.path.join(cut_dir, "train_state"))
        check(states == ["1.pt"], f"entry: preempted train states {states}")
        tree = ckpt.restore_train_state(cut_dir, 1, "cuda")
        check((tree["epoch"], tree["batch_offset"]) == (1, 1),
              f"entry: preempted state at epoch {tree['epoch']} offset "
              f"{tree['batch_offset']}")
        t0 = time.perf_counter()
        ckpt.save_train_state(os.path.join(root, "save_probe"),
                              trainer.state.step,
                              trainer.train_state_tree(1, 1))
        save_seconds = time.perf_counter() - t0

        # (c) --resume finishes the epoch and the test pass
        resumed, resume_seconds, resume_launches, resume_log = timed(
            train_main, argv(cut_dir, "--resume"))
        check("Resuming epoch 1 at batch offset 1" in resume_log
              and "EvalMode.TEST Epoch: 1\tBLEU-1 (" in resume_log
              and "bleu4" in resumed, f"entry: the resumed run {resumed}")
        check(resume_launches == launches(2 * (n_train - 1) + n_val + 1,
                                          n_train - 1),
              f"entry: resumed run's launches {resume_launches}")
        diffs = run_diff(ckpt_dir, cut_dir, n_train)
        resume_max_abs_diff = max(diffs.values())
        check(resume_max_abs_diff == 0,
              f"entry: the resumed run differs from the uninterrupted one: "
              f"{ {k: v for k, v in diffs.items() if v} }")

        # (d-f) the same with --steps-per-dispatch: on the card the train
        # blocks and validation replay CUDA graphs; the wrappers count each
        # new graph's warm-up and capture (two blocks of 4 train steps,
        # one block of the 2 validation batches), and the test batch
        k_flag = ("--steps-per-dispatch", str(ENTRY_K))
        blk_dir = os.path.join(root, "blocked")
        blk_last, blk_seconds, blk_launches, blk_log = timed(
            train_main, argv(blk_dir, *k_flag))
        check(meter_rows(blk_log) == meter_rows(log),
              "entry: the blocked run's meter rows differ from the "
              "per-batch run's")
        check(blk_launches == launches(2 * 2 + 2 + 1, 2),
              f"entry: blocked run's host launches {blk_launches}")
        blocked_diffs = run_diff(ckpt_dir, blk_dir, n_train)
        blocked_max_abs_diff = max(blocked_diffs.values())
        check(blocked_max_abs_diff == 0,
              f"entry: the blocked run ends elsewhere than the per-batch "
              f"run: { {k: v for k, v in blocked_diffs.items() if v} }")

        bcut_dir = os.path.join(root, "blocked_cut")
        bcut, bcut_seconds, bcut_launches, bcut_log, _ = preempted_run(
            bcut_dir, "train_block", *k_flag)
        check(bcut == {"preempted": True, "epoch": 1}
              and f"Preempted at epoch 1 batch {ENTRY_K}" in bcut_log,
              f"entry: the blocked SIGUSR1 run returned {bcut}")
        check(bcut_launches == launches(4, 2),
              f"entry: blocked preempted run's launches {bcut_launches}")
        bresumed, bresume_seconds, bresume_launches, bresume_log = timed(
            train_main, argv(bcut_dir, "--resume", *k_flag))
        check(f"Resuming epoch 1 at batch offset {ENTRY_K}" in bresume_log
              and "bleu4" in bresumed,
              f"entry: the blocked resumed run {bresumed}")
        check(bresume_launches == launches(2 * 2 + 2 + 1, 2),
              f"entry: blocked resumed run's launches {bresume_launches}")
        bdiffs = run_diff(blk_dir, bcut_dir, n_train)
        blocked_resume_max_abs_diff = max(bdiffs.values())
        check(blocked_resume_max_abs_diff == 0,
              f"entry: the blocked resumed run differs from the "
              f"uninterrupted blocked one: "
              f"{ {k: v for k, v in bdiffs.items() if v} }")

        tooling = entry_tooling(argv, k_flag, blk_dir, blk_log,
                                blk_launches, root, n_train)

        # (g) the bf16 options through the CLI, blocked: --bf16-attention,
        # --bank-dtype bfloat16, --bf16-encoder (the precompute); every
        # attention launch is a bf16 variant's
        bf_dir = os.path.join(root, "bf16")
        bf_last, bf_seconds, bf_launches, bf_log = timed(train_main, argv(
            bf_dir, "--bf16-attention", "--bank-dtype", "bfloat16",
            "--bf16-encoder", *k_flag))
        want = launches(2 * 2 + 2 + 1, 2)
        check(bf_launches == counts(
            attention_fwd_bf16=want["attention_fwd"],
            attention_bwd_bf16=want["attention_bwd"]),
            f"entry: bf16 run's host launches {bf_launches}")
        check("bfloat16)" in bf_log
              and "EvalMode.TEST Epoch: 1\tBLEU-1 (" in bf_log
              and math.isfinite(bf_last["loss"]),
              f"entry: the bf16 run {bf_last}")
        bf_bleu = _bleu_of(bf_log, "EvalMode.TEST")

        # (h) DenseNet161, blocked: the precompute's (rows, 49, 2208) grids
        # and attention_bwd at D = 2208 on the CLI's path
        dn_enc = os.path.join(root, "densenet161.npz")
        np.savez(dn_enc, **wide["densenet161"][2])
        dn_dir = os.path.join(root, "densenet161")
        dn_last, dn_seconds, dn_launches, dn_log = timed(train_main, argv(
            dn_dir, "--network", "densenet161", *k_flag, encoder=dn_enc))
        check(dn_launches == launches(2 * 2 + 2 + 1, 2),
              f"entry: densenet161 run's host launches {dn_launches}")
        check("EvalMode.TEST Epoch: 1\tBLEU-1 (" in dn_log
              and math.isfinite(dn_last["loss"])
              and os.path.exists(os.path.join(dn_dir,
                                              "model_densenet161_1.npz")),
              f"entry: the densenet161 run {dn_last}")
        with np.load(os.path.join(dn_dir, "model_densenet161_1.npz")) as arc:
            check(arc["f_beta/w"].shape == (E, WIDE["densenet161"]),
                  f"entry: densenet161 decoder f_beta {arc['f_beta/w'].shape}")

        model = os.path.join(ckpt_dir, "model_vgg19_1.npz")
        cfg, dcfg, enc, dec, word_dict = load_model(
            model, encoder_weights=enc_path, device="cuda")
        image = load_and_preprocess_image(
            os.path.join(root, "imgs", "val_000.png"), cfg.image_size)
        cap = build_caption_step("vgg19", dcfg, BEAM, device="cuda")(
            enc, dec, image[None])
        tokens = cap["tokens"][0].cpu().numpy()
        check(tokens.shape == (1 + STEPS,)
              and bool(torch.isfinite(cap["alphas"]).all()),
              f"entry: caption of shape {tokens.shape}")
        row = (tokens[:int(cap["length"][0]) + 1].tolist()
               if bool(cap["found"][0]) else [0])
        caption = " ".join(decode_caption(row, word_dict))
        cli = phase_cli(root, ckpt_dir, enc_path, wide["resnet152"])
        bert_cli = phase_bert_cli(root, enc_path, seed)
        t0 = time.perf_counter()
        parallel = phase_parallel(root, enc_path, *serving)
        parallel["seconds"] = time.perf_counter() - t0
    res = {"phase": "entry", "images": ENTRY_IMAGES, "seconds": seconds,
           "launches": run_launches, "test": last, "bleu": bleu,
           "test_seconds": test_seconds[0], "plots": len(plots),
           "train_state_bytes": state_bytes,
           "train_state_save_seconds": save_seconds,
           "preempted_seconds": cut_seconds, "preempted_launches":
           cut_launches, "resume_seconds": resume_seconds,
           "resume_launches": resume_launches,
           "resume_max_abs_diff": resume_max_abs_diff,
           "blocked_k": ENTRY_K, "blocked_seconds": blk_seconds,
           "blocked_launches": blk_launches,
           "blocked_max_abs_diff": blocked_max_abs_diff,
           "blocked_test": blk_last,
           "blocked_preempted_seconds": bcut_seconds,
           "blocked_resume_seconds": bresume_seconds,
           "blocked_resume_max_abs_diff": blocked_resume_max_abs_diff,
           "bf16_seconds": bf_seconds, "bf16_launches": bf_launches,
           "bf16_test": bf_last, "bf16_test_bleu": bf_bleu,
           "densenet161_seconds": dn_seconds,
           "densenet161_launches": dn_launches, "densenet161_test": dn_last,
           "caption": caption, "log_tail": log.splitlines()[-6:]}
    emit(res)
    res.update(cli=cli, bert_cli=bert_cli, tooling=tooling, parallel=parallel)
    return res


def entry_tooling(argv, k_flag, blk_dir, blk_log, blk_launches, root,
                  n_train) -> dict:
    """train.py's tooling flags on the entry phase's blocked run, in one
    run with both: under --debug-nans it must log the same rows, launch
    the same kernels and end in the same state bit for bit (the finite
    flag is computed inside each block's graph and read with its metrics),
    and --profile-dir must leave a trace whose device kernels include
    attention_fwd and attention_bwd (the blocks' graph replays); and a
    fresh per-batch `train --lr 1e38 --debug-nans` process must stop with
    FloatingPointError (the first update's step size overflows to inf), so
    that the flag is shown on both paths."""
    import contextlib
    import io

    import torch
    from sat_tpu_torch.train import main as train_main

    def run(ckpt_dir, *extra):
        out = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = train_main(argv(ckpt_dir, *k_flag, *extra))
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, read_launches(), out.getvalue()

    res = {}
    tool_dir, trace_dir = (os.path.join(root, "tooling"),
                           os.path.join(root, "trace"))
    last, res["seconds"], launches, log = run(
        tool_dir, "--debug-nans", "--profile-dir", trace_dir)
    check(meter_rows(log) == meter_rows(blk_log) and "bleu4" in last,
          "tooling: the --debug-nans --profile-dir run's meter rows differ "
          "from the blocked run's")
    check(launches == blk_launches,
          f"tooling: launches {launches}, blocked {blk_launches}")
    diffs = run_diff(blk_dir, tool_dir, n_train)
    res["max_abs_diff"] = max(diffs.values())
    check(res["max_abs_diff"] == 0,
          f"tooling: the run ends elsewhere than the blocked run: "
          f"{ {k: v for k, v in diffs.items() if v} }")
    traces = os.listdir(trace_dir)
    check(len(traces) == 1 and traces[0].endswith(".pt.trace.json"),
          f"tooling: --profile-dir wrote {traces}")
    path = os.path.join(trace_dir, traces[0])
    res["trace_bytes"] = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            k = kernel_of(e.get("name", ""))
            if k:
                kernels[k] = kernels.get(k, 0) + 1
    res["trace_kernels"] = kernels
    check(kernels.get("attention_fwd", 0) > 0
          and kernels.get("attention_bwd", 0) > 0,
          f"tooling: the trace's attention kernels {kernels}")

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sat_tpu_torch.train",
         *argv(os.path.join(root, "nan"), "--lr", "1e38", "--debug-nans")],
        capture_output=True, text=True, timeout=300, cwd=REPO_DIR,
        env=cli_env())
    res["nan_run_seconds"] = time.perf_counter() - t0
    res["nan_run_exit_code"] = proc.returncode
    res["nan_run_error"] = (proc.stderr.strip().splitlines() or [""])[-1]
    check(proc.returncode != 0 and res["nan_run_error"].startswith(
        "FloatingPointError: --debug-nans:"),
        f"tooling: train --lr 1e38 --debug-nans exited "
        f"{proc.returncode}: {proc.stderr[-1500:]}")
    emit({"phase": "tooling", **res})
    return res


def run_cli(module: str, *args, timeout: int = 300, env=None, cwd=None):
    """(stdout, seconds) of a fresh `python -m sat_tpu_torch.<module>`
    process, which must exit 0; `env` adds to this process's environment,
    `cwd` (default: the checkout) is where it runs."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"sat_tpu_torch.{module}", *args],
        capture_output=True, text=True, timeout=timeout,
        cwd=cwd or REPO_DIR, env=cli_env(**(env or {})))
    check(proc.returncode == 0,
          f"cli {module} {' '.join(args)}: exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    return proc.stdout, time.perf_counter() - t0


REPO_DIR = os.path.dirname(os.path.abspath(__file__))


def cli_env(**extra) -> dict:
    """This process's environment for a fresh CLI process, the checkout on
    its PYTHONPATH (for one started in another directory)."""
    path = os.pathsep.join(p for p in (REPO_DIR, os.environ.get("PYTHONPATH"))
                           if p)
    return dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=path, **extra)


def caption_of(stdout: str) -> str:
    return next(ln for ln in stdout.splitlines()
                if ln.startswith("Caption: "))


# The parallel phase: blocks of PAR_K steps; a fraction of the entry split
# that leaves 511 train rows (the last batch of 63 pads to 64 over two
# ranks; validation's 127 rows pad too)
PAR_K = 8
PAR_FRACTION = 511 / 512
PAR_SYNC = 4           # the gloo ranks agree on a preemption every 4 batches


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def npz_diff(path_a: str, path_b: str, skip=()) -> dict:
    """Per parameter: the largest difference between two decoder archives
    and how many elements differ by more than 3e-4."""
    import numpy as np
    out = {}
    with np.load(path_a) as a, np.load(path_b) as b:
        for k in a.files:
            if k not in skip:
                d = np.abs(a[k].astype(np.float64) - b[k])
                out[k] = (float(d.max()), int((d > 3e-4).sum()), d.size)
    return out


def params_close(diffs: dict, steps: int, lr: float) -> bool:
    """Two runs' parameters agree, as tests/test_torch_parallel.py holds
    them: every element within Adam's reach of the run (2 * steps * lr),
    all but 1e-4 of each tensor's elements within 3e-4 (the score bias,
    whose gradient is zero but for rounding, is left out by the caller)."""
    return all(m <= 2 * steps * lr and n <= 1e-4 * size
               for m, n, size in diffs.values())


def par_config(root: str, enc_path: str, out: str, **kw):
    """The gloo runs' configuration (sat_tpu_torch.config.Config), through
    the API as the CLI would make it: the entry split cut to 511 train
    rows, dropout 0, no test pass."""
    from sat_tpu_torch.config import Config
    args = dict(data=root, tf=True, ado=True, attention=True,
                cache_features=True, epochs=1, batch_size=TRAIN_B,
                log_interval=100, checkpoint_dir=out, lr=PARITY_LR,
                encoder_weights=enc_path, dropout_rate=0.0,
                feature_cache_dir=os.path.join(root, "feature_cache"),
                fraction=PAR_FRACTION, perform_test=False, mesh_data=2)
    args.update(kw)
    return Config(**args)


def parallel_rank(rank: int, spec: dict) -> None:
    """One of the two gloo ranks on the card: `Trainer` through the API,
    per batch, then in PAR_K blocks, then a run in which this rank, if it
    is rank 1, sends itself SIGTERM at its first step. Prints one JSON
    line: each run's seconds, launches and path, the preempted result and
    the train states this rank wrote."""
    import contextlib
    import io
    import signal

    import torch
    from sat_tpu_torch.engine import checkpoint as ckpt
    from sat_tpu_torch.engine.loop import Trainer
    from sat_tpu_torch.parallel import distributed as dist

    dev = dist.initialize("cuda:0", backend="gloo", init_method=spec["init"],
                          rank=rank, world_size=2, local_rank=rank,
                          local_world_size=2)
    saves, out = [], {"rank": rank, "device": str(dev),
                      "backend": dist.backend()}
    save = ckpt.save_train_state

    def recorded(path, step, tree):
        saves.append((step, tree["batch_offset"]))
        return save(path, step, tree)

    ckpt.save_train_state = recorded
    for name, extra in (("batch", {}), ("blocked",
                                        {"steps_per_dispatch": PAR_K})):
        cfg = par_config(spec["root"], spec["enc"],
                         os.path.join(spec["root"], f"gloo_{name}"), **extra)
        with contextlib.redirect_stdout(io.StringIO()):
            trainer = Trainer(cfg, device="cuda:0")
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            last = trainer.fit()
        torch.cuda.synchronize()
        out[name] = {"seconds": time.perf_counter() - t0,
                     "launches": read_launches(), "val": last,
                     "captured": getattr(trainer.train_block, "captured",
                                         None)}
    Trainer.PREEMPT_SYNC_EVERY = PAR_SYNC
    cfg = par_config(spec["root"], spec["enc"],
                     os.path.join(spec["root"], "gloo_cut"))
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = Trainer(cfg, device="cuda:0")
    step, calls = trainer.train_step, []

    def signalled(*a, **k):
        calls.append(1)
        if rank == 1 and len(calls) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*a, **k)

    trainer.train_step = signalled
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        out["cut"] = trainer.fit()
    out["cut_log"] = [ln for ln in log.getvalue().splitlines()
                      if ln.startswith(("Signal", "Preempted"))]
    out["saves"] = saves
    dist.shutdown()
    print(json.dumps(out), flush=True)


def phase_parallel(root: str, enc_path: str, dcfg, worst_flat, enc_flat,
                   images) -> dict:
    """Data-parallel training and mesh serving on the one card: the
    training CLI under torchrun at world size 1 (NCCL, the all-reduce in
    the block's graph) against the same run without torchrun; a profile
    of one block replay under NCCL; two gloo ranks on the card against one
    process, per batch and blocked, and a SIGTERM to rank 1 alone, resumed
    at world size 1; two serving replicas on the card against one; a
    `serve --mesh-data 2` process that must refuse; the beam's three top-k
    routes. Nothing here measures a speed-up across cards: the machine has
    one."""
    import contextlib
    import io

    import torch
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 encoder_from_jax)
    from sat_tpu_torch.engine.loop import Trainer
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.models.beam import SYNC_EVERY, beam_search_batched
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
    from sat_tpu_torch.models.encoder import encoder_forward
    from sat_tpu_torch.parallel import distributed as dist
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_train_block)
    from sat_tpu_torch.train import main as train_main
    from sat_tpu_torch.utils.graphs import GraphCache

    res = {"phase": "parallel", "card_count": torch.cuda.device_count()}
    fcache = os.path.join(root, "feature_cache")
    model = "model_vgg19_1.npz"

    def argv(ckpt_dir, *extra):
        return ["--data", root, "--tf", "--ado", "--attention",
                "--cache-features", "--epochs", "1", "--batch-size",
                str(TRAIN_B), "--log-interval", "1", "--checkpoint-dir",
                ckpt_dir, "--encoder-weights", enc_path,
                "--feature-cache-dir", fcache, "--steps-per-dispatch",
                str(PAR_K), *extra]

    # (a) NCCL at world size 1: the CLI under torchrun, then in this plain
    # process; one rank computes a plain step's bits (the bound is 0)
    nccl_dir, plain_dir = (os.path.join(root, d) for d in ("nccl", "plain"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "sat_tpu_torch.train",
         "--mesh-data", "1", *argv(nccl_dir)],
        capture_output=True, text=True, timeout=600, cwd=REPO_DIR,
        env=cli_env())
    res["torchrun_seconds"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"parallel: torchrun train exit "
                                f"{proc.returncode}: {proc.stderr[-2000:]}")
    check("EvalMode.TEST Epoch: 1\tBLEU-1 (" in proc.stdout,
          "parallel: the torchrun run printed no test BLEU")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        train_main(argv(plain_dir))
    torch.cuda.synchronize()
    res["plain_seconds"] = time.perf_counter() - t0
    check(meter_rows(log.getvalue()) == meter_rows(proc.stdout),
          "parallel: torchrun's meter rows differ from the plain run's")
    diffs = npz_diff(os.path.join(nccl_dir, model),
                     os.path.join(plain_dir, model))
    res["nccl_world1_max_abs_diff"] = max(m for m, _, _ in diffs.values())
    check(res["nccl_world1_max_abs_diff"] == 0,
          f"parallel: one NCCL rank ends elsewhere than one process: "
          f"{ {k: v for k, v in diffs.items() if v[0]} }")

    # (b) one block replay under NCCL at world size 1, profiled: K times a
    # step's attention launches, and the all-reduce's device work
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
    os.environ.update(env)
    try:
        check(dist.initialize("cuda") == torch.device("cuda", 0)
              and dist.backend() == "nccl", "parallel: no NCCL group")
        gen = torch.Generator().manual_seed(11)
        tcfg = DecoderConfig(vocab_size=VOCAB, encoder_dim=D, use_tf=True,
                             use_ado=True, use_attention=True)
        state = init_train_state(decoder_from_jax(
            init_decoder_params(tcfg, gen), tcfg, "cuda", trainable=True))
        bank = torch.rand((BANK_U, L, D), generator=gen).cuda()
        caps = make_captions(gen, BANK_N).cuda()
        img_idx = torch.randint(0, BANK_U, (PAR_K, TRAIN_B),
                                generator=gen).cuda()
        row_idx = torch.randint(0, BANK_N, (PAR_K, TRAIN_B),
                                generator=gen).cuda()
        block = make_bank_train_block(tcfg, 1.0, distributed=True)
        dgen = torch.Generator(device="cuda").manual_seed(1)

        def run():
            return block(state, bank, caps, img_idx, row_idx, 1e-4, dgen,
                         n_rows=TRAIN_B)

        reset_launches()
        run()                                         # warm-up + capture
        torch.cuda.synchronize()
        res["nccl_capture_launches"] = read_launches()
        check(block.captured and block.graphs.captures == 1,
              "parallel: the NCCL block was not captured")
        reset_launches()
        prof = profile_run(run, count=("nccl",), warmup=True)
        check(read_launches() == counts(),
              f"parallel: a replay launched from the host "
              f"{read_launches()}")
    finally:
        dist.shutdown()
        for k in env:
            os.environ.pop(k, None)
    calls = prof.get("kernel_calls", {})
    check(calls.get("attention_fwd") == PAR_K * 2 * T
          and calls.get("attention_bwd") == PAR_K * T,
          f"parallel: a block replay ran {calls} on the device, expected "
          f"{PAR_K} x ({2 * T}, {T})")
    nccl_calls = prof["named_calls"]["nccl"]
    res["nccl_block_profile"] = prof
    res["nccl_allreduce"] = (
        f"{nccl_calls} NCCL kernels in a replay of {PAR_K} steps"
        if nccl_calls else "NCCL launched nothing for the all-reduce of "
        "one rank (in place, nothing to move): not a failure")
    check(nccl_calls in (0, PAR_K), f"parallel: {nccl_calls} NCCL kernels "
                                    f"in a block of {PAR_K} steps")

    # (c) two gloo ranks on the card, against one process
    spec = {"root": root, "enc": enc_path,
            "init": "file://" + os.path.join(root, "gloo_rendezvous")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank",
         str(rank), "--parallel-spec", json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO_DIR, env=cli_env()) for rank in range(2)]
    ranks = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"parallel: gloo rank exit "
                                    f"{proc.returncode}: {stderr[-2000:]}")
        ranks.append(json.loads(stdout.strip().splitlines()[-1]))
    res["gloo_seconds"] = time.perf_counter() - t0
    n_batches = -(-int(2 * ENTRY_IMAGES["train"] * PAR_FRACTION) // TRAIN_B)
    n_val = -(-int(2 * ENTRY_IMAGES["val"] * PAR_FRACTION) // TRAIN_B)
    want = counts(attention_fwd=(2 * n_batches + n_val) * T,
                  attention_bwd=n_batches * T)
    for r in ranks:
        check(r["backend"] == "gloo" and r["device"] == "cuda:0",
              f"parallel: rank {r['rank']} ran {r['backend']} on "
              f"{r['device']}")
        for name in ("batch", "blocked"):
            check(r[name]["launches"] == want,
                  f"parallel: gloo rank {r['rank']} {name} launches "
                  f"{r[name]['launches']}, expected {want}")
        check(r["blocked"]["captured"] is False,
              "parallel: a gloo block claims a captured graph")
        check(r["cut"] == {"preempted": True, "epoch": 1}
              and f"Preempted at epoch 1 batch {PAR_SYNC}" in r["cut_log"][
                  -1], f"parallel: gloo rank {r['rank']} cut run "
                       f"{r['cut']} {r['cut_log']}")
    check(ranks[0]["saves"] == [[n_batches, 0], [n_batches, 0],
                                [PAR_SYNC, PAR_SYNC]]
          and ranks[1]["saves"] == [],
          f"parallel: train states written: rank 0 {ranks[0]['saves']}, "
          f"rank 1 {ranks[1]['saves']}")
    check(any(ln.startswith("Signal") for ln in ranks[1]["cut_log"])
          and not any(ln.startswith("Signal") for ln in ranks[0]["cut_log"]),
          "parallel: the SIGTERM reached another rank than rank 1")
    res["gloo_ranks"] = ranks
    one_dir = os.path.join(root, "one_process")
    with contextlib.redirect_stdout(io.StringIO()):
        Trainer(par_config(root, enc_path, one_dir, mesh_data=0)).fit()
    gloo_model = os.path.join(root, "gloo_batch", model)
    skip = ("attention/v/b",)
    diffs = npz_diff(gloo_model, os.path.join(one_dir, model), skip)
    res["gloo_vs_one_process"] = {
        "max_abs_diff": max(m for m, _, _ in diffs.values()),
        "elements_beyond_3e-4": sum(n for _, n, _ in diffs.values())}
    check(params_close(diffs, n_batches, PARITY_LR),
          f"parallel: two gloo ranks end elsewhere than one process: "
          f"{ {k: v for k, v in diffs.items() if v[1]} }")
    blocked = npz_diff(gloo_model, os.path.join(root, "gloo_blocked", model))
    res["gloo_blocked_max_abs_diff"] = max(m for m, _, _ in blocked.values())
    check(res["gloo_blocked_max_abs_diff"] == 0,
          "parallel: the gloo blocked run differs from its per-batch run")
    cut_dir = os.path.join(root, "gloo_cut")
    with contextlib.redirect_stdout(io.StringIO()) as log:
        resumed = Trainer(par_config(root, enc_path, cut_dir, mesh_data=0,
                                     resume=True))
        check((resumed.start_epoch, resumed.state.step) == (1, PAR_SYNC),
              f"parallel: resumed at epoch {resumed.start_epoch} step "
              f"{resumed.state.step}")
        resumed.fit()
    check(resumed.state.step == n_batches, "parallel: resumed run's steps")
    diffs = npz_diff(os.path.join(cut_dir, model), gloo_model, skip)
    res["resume_world1_max_abs_diff"] = max(m for m, _, _ in diffs.values())
    check(params_close(diffs, n_batches, PARITY_LR),
          f"parallel: the state of two ranks resumed on one ends elsewhere "
          f"than the straight run: "
          f"{ {k: v for k, v in diffs.items() if v[1]} }")

    # (d) mesh serving: two replicas on the one card, worst case
    enc = encoder_from_jax(enc_flat, "vgg19", "cuda")
    dec = decoder_from_jax(worst_flat, dcfg, "cuda")
    one = build_caption_step("vgg19", dcfg, BEAM)
    two = build_caption_step("vgg19", dcfg, BEAM, mesh_data=2,
                             devices=["cuda:0", "cuda:0"])
    serving = {}
    for Bx in (127, B):
        batch = images[:Bx]
        want_out = one(enc, dec, batch)
        reset_launches()
        got = two(enc, dec, batch)                     # the replicas capture
        torch.cuda.synchronize()
        capture_launches = read_launches()
        times = {"one_ms": [], "mesh_ms": []}
        for _ in range(2):
            for name, step in (("one_ms", one), ("mesh_ms", two)):
                times[name].append(host_ms(lambda: step(enc, dec, batch)))
        again = two(enc, dec, batch)
        for k in ("tokens", "length", "found"):
            check(torch.equal(got[k], want_out[k])
                  and torch.equal(again[k], got[k]),
                  f"parallel: mesh serving's {k} differ from one card's "
                  f"at B = {Bx}")
        serving[f"b{Bx}"] = {
            "score_max_abs_diff": (got["score"] - want_out["score"]).abs()
            .nan_to_num(0.0).max().item(),
            "alphas_max_abs_diff": (got["alphas"] - want_out["alphas"])
            .abs().max().item(),
            "capture_launches": capture_launches, **times}
    # B = 127 pads to 128: each replica's slice of 64 rows is captured at
    # the first batch, and B = 128 replays the same graphs
    first = serving["b127"]["capture_launches"]
    check(first["topk"] > 0 and first["attention_fwd"] > 0
          and serving[f"b{B}"]["capture_launches"] == counts(),
          f"parallel: the replicas launched {first}, then "
          f"{serving[f'b{B}']['capture_launches']}")
    res["mesh_serving"] = serving
    proc = subprocess.run(
        [sys.executable, "-m", "sat_tpu_torch.serve", "--model",
         os.path.join(nccl_dir, model), "--encoder-weights", enc_path,
         "--mesh-data", "2", "--port", "0"],
        capture_output=True, text=True, timeout=300, cwd=REPO_DIR,
        env=cli_env())
    refusal = "mesh data=2 x model=1 needs 2 devices, but only 1 are visible"
    check(proc.returncode != 0 and refusal in proc.stderr,
          f"parallel: serve --mesh-data 2 on one card exit "
          f"{proc.returncode}: {proc.stderr[-1000:]}")
    res["serve_mesh_refusal"] = refusal

    # (e) the beam's top-k routes at B = 128, worst case, through graphs
    feats = encoder_forward(enc, "vgg19", images[:B])
    routes = {"kernel": {}, "pallas_topk_false": {"pallas_topk": False},
              "fast_topk": {"fast_topk": True}}
    caches = {name: GraphCache() for name in routes}

    def decode(name):
        return beam_search_batched(dec, feats, BEAM, graphs=caches[name],
                                   **routes[name])

    reset_launches()
    outs = {name: decode(name) for name in routes}    # captures
    torch.cuda.synchronize()
    route_launches = read_launches()
    for name in routes:
        check(torch.equal(outs[name].tokens, outs["kernel"].tokens)
              and same_bits(outs[name].score, outs["kernel"].score),
              f"parallel: the {name} route's tokens differ from the "
              f"kernel's")
    decode_ms = {name: [] for name in routes}
    for _ in range(3):
        for name in routes:
            decode_ms[name].append(host_ms(lambda: decode(name)))
    check(route_launches["topk"] == 2 * sum(beam_blocks(STEPS, SYNC_EVERY)),
          f"parallel: top-k launches of the three captures "
          f"{route_launches}: only the kernel route's capture launches it")
    res["topk_routes"] = {"decode_ms": decode_ms,
                          "capture_launches": route_launches}
    emit({k: v for k, v in res.items() if k not in ("gloo_ranks",
                                                     "nccl_block_profile")})
    return res

# The tensor_parallel phase: sat_tpu's bert-att run (VGG19 grid, E = 768,
# V = 30,522) with the vocabulary split over TP_M model ranks
TP_M = 2
TP_DEVICE = "cuda:0"       # every gloo rank's card
TP_LR = PARITY_LR
TP_VAL = 4                 # evaluation batches of TRAIN_B rows
TP_RESUME_AT = 4           # the per-batch run's train state, written here
TP_TOKEN_SLACK = 2         # of the evaluation's 6,656 argmax tokens


def tp_inputs(seed: int, dropout: float = 0.0):
    """The phase's decoder config (dropout `dropout`), weights, bank of
    BANK_U grids (CPU), BERT captions, K_BLOCK training batches and TP_VAL
    evaluation batches of TRAIN_B rows, from the seed: every process of
    the phase makes the same."""
    import torch
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
    gen = torch.Generator().manual_seed(seed + 13)
    dcfg = DecoderConfig(vocab_size=BERT_V, encoder_dim=D, use_tf=True,
                         use_ado=True, use_bert=True, use_attention=True,
                         dropout_rate=dropout)
    table = (torch.randn((BERT_V, BERT_E), generator=gen) * 0.02).numpy()
    flat = init_decoder_params(dcfg, gen, bert_embeddings=table)
    bank = torch.rand((BANK_U, L, D), generator=gen)
    caps = make_bert_captions(gen, BANK_N)
    batches = [(torch.randint(0, BANK_U, (TRAIN_B,), generator=gen),
                torch.randint(0, BANK_N, (TRAIN_B,), generator=gen))
               for _ in range(K_BLOCK + TP_VAL)]
    return dcfg, flat, bank, caps, batches[:K_BLOCK], batches[K_BLOCK:]


def tp_beam_weights(flat: dict, boost: float | None = None) -> dict:
    """The beam's weights: the stop set's logits pinned to -1e9 (the worst
    case: every beam runs all STEPS steps), or with `boost` added to
    [PAD]'s bias (seeded: beams complete, at different steps)."""
    out = dict(flat)
    bias = out["ado/f_out/b"].copy()
    if boost is None:
        bias[list(BERT_STOP_IDS)] = -1e9
    else:
        bias[BERT_PAD] += boost
    out["ado/f_out/b"] = bias
    return out


def tp_state(state) -> dict:
    """A train state's parameters and Adam moments on the host, by name
    (whole arrays, joined over the model group: every rank of the group
    calls it)."""
    from sat_tpu_torch.compat.jax_params import whole_state_dict
    from sat_tpu_torch.engine.checkpoint import whole_optimizer_state
    dec = state.decoder
    out = {f"param/{k}": v.cpu() for k, v in whole_state_dict(dec).items()}
    names = [n for n, p in dec.named_parameters() if p.requires_grad]
    opt = whole_optimizer_state(state.optimizer, dec)["state"]
    for i, st in opt.items():
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"{k}/{names[i]}"] = st[k].cpu()
    return out


def tp_diffs(a: dict, b: dict, skip=("attention.v.bias",)) -> dict:
    """Per tensor of two `tp_state`s: (max abs diff, elements beyond 3e-4,
    size), parameters and moments both; `skip` the score bias's (its
    gradient is zero but for rounding)."""
    out = {}
    for k, x in a.items():
        if not any(k.endswith(s) for s in skip):
            d = (x.double() - b[k].double()).abs()
            out[k] = (d.max().item(), int((d > 3e-4).sum()), d.numel())
    return out


def tp_bleu(tokens, caps) -> dict:
    """BLEU-1..4 of argmax token rows against each row's caption, ids as
    words (engine/evaluate.py's BLEU)."""
    from sat_tpu_torch.engine.evaluate import compute_bleu
    hyps = [[str(t) for t in row] for row in tokens.tolist()]
    refs = [[[str(t) for t in row[1:]]] for row in caps.tolist()]
    return compute_bleu(refs, hyps)


def bwd_check(name: str, gen, Bx: int, Lx: int, Dx: int, Ex: int) -> dict:
    """attention_bwd at (Bx, Lx, Ex, Dx), R = 1, without dfeats (the bank
    step's call) against its plain form: dkeys and du_h within 1e-5, dv
    and db_v within 1e-4 of their size (attention_bwd_row's bounds)."""
    import torch
    from sat_tpu_torch.ops.fused_attention import (attention_bwd,
                                                   attention_bwd_plain,
                                                   attention_plain)
    keys, feats, u_h, v, b_v, _ = fwd_inputs(gen, Bx, 1, Lx, Dx, Ex)
    dctx = torch.randn((Bx, Dx), generator=gen).cuda()
    dalpha = torch.randn((Bx, Lx), generator=gen).cuda()
    _, alpha = attention_plain(keys, feats, u_h, v, b_v)
    args = (keys, feats, u_h, v, alpha, dctx, dalpha)
    got = attention_bwd(*args, want_dfeats=False)
    ref = attention_bwd_plain(*args, want_dfeats=False)
    torch.cuda.synchronize()
    g = torch.bmm(feats, dctx[:, :, None])[:, :, 0] + dalpha
    de_max = (alpha * (g - (alpha * g).sum(1, keepdim=True))).abs().max()
    errs = {k: (got[i] - ref[i]).abs().max().item()
            for i, k in ((0, "dkeys"), (2, "du_h"), (3, "dv"), (4, "db_v"))}
    check(errs["dkeys"] <= 1e-5 and errs["du_h"] <= 1e-5
          and errs["dv"] <= 1e-4 * ref[3].abs().max().item()
          and errs["db_v"] <= 1e-4 * de_max.item(),
          f"{name}: errors {errs} beyond their bounds")
    return errs


def tp_rank(rank: int, spec: dict) -> None:
    """One gloo rank of the tensor_parallel phase on cuda:0, at data
    spec["n_data"] x model TP_M. Grid (a), 1 x 2: K_BLOCK per-batch bank
    steps (the train state written after TP_RESUME_AT of them), one
    K_BLOCK block from the same start, the evaluation batches, the
    worst-case beam at B = 128 (top-k at each rank's (128, 5 x V/2)).
    Grid (b), 2 x 2: the K_BLOCK steps with the bank sharded over the data
    ranks (each data rank's rows of every batch; attention at its rows,
    held to the plain forms and profiled), then two steps at dropout 0.5.
    Prints one JSON line; rank 0 writes the whole states."""
    import dataclasses

    import torch
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 whole_state_dict)
    from sat_tpu_torch.device import use_f32_math
    from sat_tpu_torch.engine import checkpoint as ckpt
    from sat_tpu_torch.engine.loop import dropout_seed
    from sat_tpu_torch.models.beam import beam_search_batched
    from sat_tpu_torch.ops.topk import topk, topk_plain
    from sat_tpu_torch.parallel import distributed as dist
    from sat_tpu_torch.parallel.mesh import VOCAB_SHARDED_TORCH
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_eval_step,
                                                   make_bank_train_block,
                                                   make_bank_train_step)
    from sat_tpu_torch.parallel.vocab import VocabShard

    n_data, out_dir = spec["n_data"], spec["dir"]
    dist.initialize(TP_DEVICE, backend="gloo", init_method=spec["init"],
                    rank=rank, world_size=n_data * TP_M, local_rank=rank,
                    local_world_size=n_data * TP_M)
    dist.setup_grid(TP_M)
    use_f32_math()
    i, j = dist.data_index(), dist.model_index()
    shard = VocabShard(j, TP_M, dist.model_group(), BERT_V)
    dcfg, flat, bank, caps, batches, val = tp_inputs(spec["seed"])
    rows = TRAIN_B // n_data
    own = slice(i * rows, (i + 1) * rows)
    if n_data > 1:                  # this data rank's rows of each bank
        bank, caps = bank.chunk(n_data)[i], caps.chunk(n_data)[i]
    bank, caps = bank.cuda(), caps.cuda()
    batches = [(a[own].cuda(), b[own].cuda()) for a, b in batches]
    sharded = n_data > 1
    out = {"rank": rank, "cell": [i, j], "device": str(bank.device),
           "backend": dist.backend()}

    def fresh(cfg=dcfg):
        return init_train_state(decoder_from_jax(
            flat, cfg, TP_DEVICE, trainable=True, vocab_shard=shard))

    state = fresh()
    if not sharded:
        # the evaluation batches, at the start weights
        ev = make_bank_eval_step(dcfg, 1.0, distributed=True)
        toks = [ev(state.decoder, bank, caps, a.cuda(), b.cuda(),
                   n_rows=TRAIN_B)[1].cpu() for a, b in val]
        if rank == 0:
            torch.save(torch.cat(toks), os.path.join(out_dir,
                                                     "tp_eval_tokens.pt"))
    sd = state.decoder.state_dict()
    out["bytes"] = {
        "sharded_params": sum(sd[k].nbytes for k in VOCAB_SHARDED_TORCH),
        "bank": bank.nbytes + caps.nbytes}
    step = make_bank_train_step(dcfg, 1.0, distributed=True,
                                sharded_bank=sharded)
    metrics = []
    reset_launches()
    t0 = time.perf_counter()
    for s, (ii, ri) in enumerate(batches):
        if sharded and s == 1 and rank == 0:   # one step profiled
            host = read_launches()
            prof = profile_run(lambda: step(state, bank, caps, ii, ri,
                                            TP_LR, None, n_rows=TRAIN_B))
            step_host = {k: read_launches()[k] - host[k] for k in host}
            out["profile_kernel_calls"] = prof["kernel_calls"]
            out["profile_host_launches"] = step_host
            check(all(prof["kernel_calls"][k] == step_host[k]
                      for k in ("attention_fwd", "attention_bwd"))
                  and step_host["attention_bwd"] == T,
                  f"tensor_parallel: rank {rank}'s profiled step ran "
                  f"{prof['kernel_calls']} on the device, {step_host} from "
                  f"the host")
            m = None
        else:
            state, m = step(state, bank, caps, ii, ri, TP_LR, None,
                            n_rows=TRAIN_B)
        metrics.append(None if m is None else
                       {k: float(v) for k, v in m.items()})
        if not sharded and s + 1 == TP_RESUME_AT:
            tree = {"decoder": whole_state_dict(state.decoder),
                    "optimizer": ckpt.whole_optimizer_state(
                        state.optimizer, state.decoder),
                    "step": state.step, "epoch": 1,
                    "batch_offset": TP_RESUME_AT, "dropout_generator": None}
            if rank == 0:
                ckpt.save_train_state(out_dir, state.step, tree)
    torch.cuda.synchronize()
    out["steps_seconds"] = time.perf_counter() - t0
    out["step_launches"] = read_launches()
    out["metrics"] = metrics
    final = tp_state(state)
    if rank == 0:
        torch.save(final, os.path.join(out_dir, f"tp_{n_data}x{TP_M}.pt"))

    gen = torch.Generator().manual_seed(spec["seed"] + 17 + rank)
    if sharded:
        # the kernels at a data rank's rows, against their plain forms
        _, out["attention_fwd_errors"] = fwd_check(
            "tensor_parallel attention_fwd", gen, rows, 1, L, D, BERT_E,
            False)
        out["attention_bwd_errors"] = bwd_check(
            "tensor_parallel attention_bwd", gen, rows, L, D, BERT_E)
        # dropout 0.5: one mask a model group
        cfg = dataclasses.replace(dcfg, dropout_rate=0.5)
        state = fresh(cfg)
        dgen = torch.Generator(device=TP_DEVICE).manual_seed(
            dropout_seed(spec["seed"], i))
        drop = make_bank_train_step(cfg, 1.0, distributed=True,
                                    sharded_bank=True)
        for ii, ri in batches[:2]:
            state, _ = drop(state, bank, caps, ii, ri, TP_LR, dgen,
                            n_rows=TRAIN_B)
        torch.save({k: v.cpu() for k, v in state.decoder.state_dict().items()
                    if k not in VOCAB_SHARDED_TORCH},
                   os.path.join(out_dir, f"tp_dropout_{rank}.pt"))
    else:
        # the block from the same start: K_BLOCK eager steps under gloo
        block_state = fresh()
        block = make_bank_train_block(dcfg, 1.0, distributed=True)
        block_state, _ = block(block_state, bank, caps,
                               torch.stack([a for a, _ in batches]),
                               torch.stack([b for _, b in batches]), TP_LR,
                               None, n_rows=TRAIN_B)
        got = tp_state(block_state)
        out["block_equal"] = (not block.captured and all(
            torch.equal(got[k], final[k]) for k in final))
        # the worst-case beam of the group, each rank's top-k at its rows
        x, _ = bert_topk_inputs(gen, BERT_V // TP_M)
        check(all(torch.equal(a, b) for a, b in zip(topk(x, BEAM),
                                                    topk_plain(x, BEAM))),
              f"tensor_parallel: rank {rank}'s top-k at {tuple(x.shape)} "
              f"differs from its plain form")
        del x
        feats = torch.load(os.path.join(out_dir, "tp_feats.pt")).cuda()
        for name, boost in (("worst", None), ("seeded", spec["boost"])):
            dec = decoder_from_jax(tp_beam_weights(flat, boost), dcfg,
                                   TP_DEVICE, vocab_shard=shard)
            reset_launches()
            t0 = time.perf_counter()
            res = beam_search_batched(dec, feats, BEAM)
            torch.cuda.synchronize()
            out[f"beam_{name}_seconds"] = time.perf_counter() - t0
            out[f"beam_{name}_launches"] = read_launches()
            if rank == 0:
                torch.save({k: v.cpu() for k, v in res._asdict().items()},
                           os.path.join(out_dir, f"tp_beam_{name}.pt"))
    dist.shutdown()
    print(json.dumps(out), flush=True)


def phase_tensor_parallel(seed: int, enc_flat, images) -> dict:
    """The vocab-sharded head (--mesh-model 2) at bert-att's full width on
    the one card: (a) two gloo ranks at 1 x 2 against one process on the
    same K_BLOCK batches of TRAIN_B rows (per batch and one block, dropout
    0: losses, metrics, parameters and Adam moments joined over the
    group; the evaluation tokens and their BLEU; the train state written
    after TP_RESUME_AT steps, resumed by this process; the worst-case beam
    at B = 128 against one card's); (b) four gloo ranks at 2 x 2 with the
    bank sharded over the data ranks against the same process, and at
    dropout 0.5 the replicated parameters of all four ranks bit-equal; (c)
    NCCL at world size 1 through the grid's code (the bank's sharded
    gather one-way), the block's graph captured and bit for bit a plain
    process's block; (d) `train --mesh-model 2` at the flagship's V =
    2,633, refused at start-up by a fresh process. Every rank's bytes of
    the vocabulary shards and of its bank. Nothing here measures a
    speed-up across cards: the machine has one."""
    import torch
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 encoder_from_jax)
    from sat_tpu_torch.engine import checkpoint as ckpt
    from sat_tpu_torch.models.beam import beam_search_batched
    from sat_tpu_torch.models.encoder import encoder_forward
    from sat_tpu_torch.parallel import distributed as dist
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_eval_step,
                                                   make_bank_train_block,
                                                   make_bank_train_step,
                                                   place_optimizer_state)

    res = {"phase": "tensor_parallel", "grid": f"model {TP_M}",
           "shape": f"bert-att: L = {L}, D = {D}, E = {BERT_E}, V = "
                    f"{BERT_V}, bank {BANK_U} grids, B = {TRAIN_B}"}
    t_phase = time.perf_counter()
    dcfg, flat, bank, caps, batches, val = tp_inputs(seed)
    bank_gpu, caps_gpu = bank.cuda(), caps.cuda()
    batches_gpu = [(a.cuda(), b.cuda()) for a, b in batches]
    with tempfile.TemporaryDirectory() as tmp:
        # one card's beam input and result (worst case), then the ranks
        enc = encoder_from_jax(enc_flat, "vgg19", "cuda")
        feats = encoder_forward(enc, "vgg19", images[:B]).clone()
        del enc
        torch.save(feats.cpu(), os.path.join(tmp, "tp_feats.pt"))
        boost = pad_boost(decoder_from_jax(flat, dcfg, "cuda"), feats[:32])
        procs = []
        for n_data in (1, 2):
            spec = {"n_data": n_data, "dir": tmp, "seed": seed,
                    "boost": boost,
                    "init": "file://" + os.path.join(tmp, f"rdv{n_data}")}
            procs += [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tp-rank",
                 str(r), "--tp-spec", json.dumps(spec)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=REPO_DIR, env=cli_env()) for r in range(n_data * TP_M)]
        # (d) while the ranks run: a fresh train process at V = 2,633
        vocab_dir = os.path.join(tmp, "vocab2633")
        os.makedirs(vocab_dir)
        with open(os.path.join(vocab_dir, "word_dict.json"), "w") as f:
            json.dump({f"w{k}": k for k in range(VOCAB)}, f)
        refused = subprocess.run(
            [sys.executable, "-m", "sat_tpu_torch.train", "--data",
             vocab_dir, "--mesh-model", str(TP_M), "--tf", "--ado",
             "--attention"], capture_output=True, text=True, timeout=300,
            cwd=REPO_DIR, env=cli_env())
        message = (f"the vocabulary ({VOCAB} words) is not divisible by "
                   f"--mesh-model {TP_M}")
        check(refused.returncode != 0 and message in refused.stderr,
              f"tensor_parallel: train --mesh-model {TP_M} at V = {VOCAB} "
              f"exit {refused.returncode}: {refused.stderr[-1000:]}")
        res["refusal"] = message

        # one process on the same batches
        one_beam = {name: beam_search_batched(decoder_from_jax(
            tp_beam_weights(flat, b), dcfg, "cuda"), feats, BEAM)
            for name, b in (("worst", None), ("seeded", boost))}
        state = init_train_state(decoder_from_jax(flat, dcfg, "cuda",
                                                  trainable=True))
        ev = make_bank_eval_step(dcfg, 1.0)
        one_tokens = torch.cat([ev(state.decoder, bank_gpu, caps_gpu,
                                   a.cuda(), b.cuda())[1].cpu()
                                for a, b in val])
        step = make_bank_train_step(dcfg, 1.0)
        one_metrics = []
        for ii, ri in batches_gpu:
            state, m = step(state, bank_gpu, caps_gpu, ii, ri, TP_LR, None)
            one_metrics.append({k: float(v) for k, v in m.items()})
        one = tp_state(state)
        del state

        # (c) NCCL at world size 1 through the grid's code
        env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                   RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                   LOCAL_WORLD_SIZE="1")
        blk_img = torch.stack([a for a, _ in batches_gpu])
        blk_row = torch.stack([b for _, b in batches_gpu])
        plain = init_train_state(decoder_from_jax(flat, dcfg, "cuda",
                                                  trainable=True))
        plain, _ = make_bank_train_block(dcfg, 1.0)(
            plain, bank_gpu, caps_gpu, blk_img, blk_row, TP_LR, None)
        plain = tp_state(plain)
        os.environ.update(env)
        try:
            check(dist.initialize("cuda") == torch.device("cuda", 0)
                  and dist.backend() == "nccl",
                  "tensor_parallel: no NCCL group")
            dist.setup_grid(1)
            nccl = init_train_state(decoder_from_jax(flat, dcfg, "cuda",
                                                     trainable=True))
            block = make_bank_train_block(dcfg, 1.0, distributed=True,
                                          sharded_bank=True)
            nccl, _ = block(nccl, bank_gpu, caps_gpu, blk_img, blk_row,
                            TP_LR, None, n_rows=TRAIN_B)
            check(block.captured and block.graphs.captures == 1,
                  "tensor_parallel: the NCCL block was not captured")
            nccl = tp_state(nccl)
        finally:
            dist.shutdown()
            for k in env:
                os.environ.pop(k, None)
        res["nccl_world1_max_abs_diff"] = max(
            d for d, _, _ in tp_diffs(nccl, plain, skip=()).values())
        check(res["nccl_world1_max_abs_diff"] == 0,
              "tensor_parallel: the NCCL block with the one-way bank differs "
              "from a plain process's block")
        del nccl, plain

        ranks = []
        try:
            for proc in procs:
                stdout, stderr = proc.communicate(timeout=400)
                check(proc.returncode == 0,
                      f"tensor_parallel: rank exit {proc.returncode}: "
                      f"{stderr[-2000:]}")
                ranks.append(json.loads(stdout.strip().splitlines()[-1]))
        finally:
            for proc in procs:      # a failed rank leaves its peers waiting
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        res["ranks_seconds"] = time.perf_counter() - t_phase
        a_ranks, b_ranks = ranks[:TP_M], ranks[TP_M:]

        # (a) 1 x 2 against one process
        for r in a_ranks:
            for got, want in zip(r["metrics"], one_metrics):
                check(abs(got["loss"] - want["loss"]) <= 1e-5 * abs(
                    want["loss"]) and got["caption_length"]
                      == want["caption_length"]
                      and abs(got["acc1"] - want["acc1"]) <= 1e-4
                      and abs(got["acc5"] - want["acc5"]) <= 1e-4,
                      f"tensor_parallel: rank {r['rank']}'s step {got} vs "
                      f"one process {want}")
            check(r["block_equal"], f"tensor_parallel: rank {r['rank']}'s "
                                    f"block differs from its steps")
            check(r["step_launches"] == counts(attention_fwd=K_BLOCK * 2 * T,
                                               attention_bwd=K_BLOCK * T),
                  f"tensor_parallel: rank {r['rank']}'s step launches "
                  f"{r['step_launches']}")
            check(r["beam_worst_launches"] == counts(topk=STEPS,
                                                     attention_fwd=STEPS),
                  f"tensor_parallel: rank {r['rank']}'s worst-case beam "
                  f"launches {r['beam_worst_launches']}, expected {STEPS} "
                  f"of top-k and attention_fwd")
        diffs = tp_diffs(torch.load(os.path.join(tmp, f"tp_1x{TP_M}.pt")),
                         one)
        res["a"] = {
            "params_max_abs_diff": max(d for k, (d, _, _) in diffs.items()
                                       if k.startswith("param/")),
            "moments_max_abs_diff": max(d for k, (d, _, _) in diffs.items()
                                        if not k.startswith("param/")),
            "elements_beyond_3e-4": sum(n for _, n, _ in diffs.values()),
            "losses": [m["loss"] for m in a_ranks[0]["metrics"]],
            "one_process_losses": [m["loss"] for m in one_metrics]}
        check(params_close(diffs, K_BLOCK, TP_LR),
              f"tensor_parallel: 1 x {TP_M} ends elsewhere than one process: "
              f"{ {k: v for k, v in diffs.items() if v[1]} }")
        # the evaluation at the start weights: the argmax over the group
        # against one process's (TP_TOKEN_SLACK positions may take the
        # other side of a near-tie: the heads' products, cut in two, may
        # round differently)
        tokens = torch.load(os.path.join(tmp, "tp_eval_tokens.pt"))
        val_caps = torch.cat([caps[b] for _, b in val])
        res["a"]["bleu"] = tp_bleu(tokens, val_caps)
        res["a"]["one_process_bleu"] = tp_bleu(one_tokens, val_caps)
        res["a"]["eval_tokens_differing"] = int((tokens != one_tokens).sum())
        check(res["a"]["eval_tokens_differing"] <= TP_TOKEN_SLACK
              and all(abs(res["a"]["bleu"][k] - v) <= 1e-3
                      for k, v in res["a"]["one_process_bleu"].items()),
              f"tensor_parallel: the evaluation's tokens ("
              f"{res['a']['eval_tokens_differing']} differ) or BLEU "
              f"{res['a']['bleu']} differ from one process's "
              f"{res['a']['one_process_bleu']}")
        # the train state of the group, resumed by one process
        step_n = ckpt.latest_train_state_step(tmp)
        check(step_n == TP_RESUME_AT, f"tensor_parallel: train state at "
                                      f"step {step_n}")
        tree = ckpt.restore_train_state(tmp, step_n, "cuda")
        state = init_train_state(decoder_from_jax(flat, dcfg, "cuda",
                                                  trainable=True))
        state.decoder.load_state_dict(tree["decoder"])
        state.optimizer.load_state_dict(tree["optimizer"])
        place_optimizer_state(state.optimizer)
        state.step = int(tree["step"])
        for ii, ri in batches_gpu[TP_RESUME_AT:]:
            state, _ = step(state, bank_gpu, caps_gpu, ii, ri, TP_LR, None)
        diffs = tp_diffs(tp_state(state), one)
        res["a"]["resumed_max_abs_diff"] = max(
            d for d, _, _ in diffs.values())
        check(params_close(diffs, K_BLOCK, TP_LR),
              f"tensor_parallel: the group's state resumed by one process "
              f"ends elsewhere: {({k: v for k, v in diffs.items() if v[1]})}")
        del state
        # the beams of the group against one card's: worst case (no beam
        # completes, so the tokens are all zero) and seeded
        res["a"]["beam"] = {}
        for name, want in one_beam.items():
            beam = torch.load(os.path.join(tmp, f"tp_beam_{name}.pt"))
            for k in ("tokens", "length", "found"):
                check(torch.equal(beam[k], getattr(want, k).cpu()),
                      f"tensor_parallel: the group's {name} beam {k} differ "
                      f"from one card's")
            found = beam["found"]
            res["a"]["beam"][name] = {
                "found": int(found.sum()),
                "score_max_abs_diff": (beam["score"] - want.score.cpu())[
                    found].abs().max().item() if found.any() else None,
                "alphas_max_abs_diff": (beam["alphas"] - want.alphas.cpu())
                .abs().max().item(),
                "seconds": [r[f"beam_{name}_seconds"] for r in a_ranks],
                "launches": [r[f"beam_{name}_launches"] for r in a_ranks]}
        check(res["a"]["beam"]["seeded"]["found"] > 0,
              "tensor_parallel: no seeded beam completed")
        res["a"]["beam"]["pad_boost"] = boost

        # (b) 2 x 2, the bank sharded, against the same process
        diffs = tp_diffs(torch.load(os.path.join(tmp, f"tp_2x{TP_M}.pt")),
                         one)
        res["b"] = {
            "params_max_abs_diff": max(d for k, (d, _, _) in diffs.items()
                                       if k.startswith("param/")),
            "moments_max_abs_diff": max(d for k, (d, _, _) in diffs.items()
                                        if not k.startswith("param/")),
            "elements_beyond_3e-4": sum(n for _, n, _ in diffs.values()),
            "profiles": [{k: r[k] for k in ("cell", "profile_kernel_calls",
                                             "profile_host_launches")}
                         for r in b_ranks if "profile_kernel_calls" in r],
            "attention_errors": [{k: r[k] for k in (
                "attention_fwd_errors", "attention_bwd_errors")}
                for r in b_ranks]}
        check(params_close(diffs, K_BLOCK, TP_LR),
              f"tensor_parallel: 2 x {TP_M} ends elsewhere than one process: "
              f"{ {k: v for k, v in diffs.items() if v[1]} }")
        for r in b_ranks:
            check(all(got is None or abs(got["loss"] - want["loss"])
                      <= 1e-5 * abs(want["loss"])
                      for got, want in zip(r["metrics"], one_metrics)),
                  f"tensor_parallel: rank {r['rank']}'s (2 x 2) losses")
        drop = [torch.load(os.path.join(tmp, f"tp_dropout_{r}.pt"))
                for r in range(2 * TP_M)]
        res["b"]["dropout_replicated_equal"] = all(
            torch.equal(d[k], drop[0][k]) for d in drop[1:] for k in drop[0])
        check(res["b"]["dropout_replicated_equal"],
              "tensor_parallel: at dropout 0.5 the ranks' replicated "
              "parameters differ")
    whole_params = sum(v.nbytes for k, v in one.items()
                       if k.startswith("param/") and any(
                           k.endswith(s) for s in (
                               "embedding.weight", "deep_output.weight",
                               "deep_output.bias", "f_out.weight",
                               "f_out.bias")))
    res["bytes"] = {"whole_sharded_params": whole_params,
                    "whole_bank": bank.nbytes + caps.nbytes,
                    "ranks": [{"cell": r["cell"], **r["bytes"]}
                              for r in ranks]}
    res["rank_seconds"] = [r["steps_seconds"] for r in ranks]
    res["seconds"] = time.perf_counter() - t_phase
    emit({k: v for k, v in res.items() if k != "b"})
    return res


def phase_cli(root: str, ckpt_dir: str, enc_path: str, resnet) -> dict:
    """The CLIs as fresh processes, on the entry phase's dataset and
    model: generate_caption on a ResNet152 model (beam, its PNG; sample
    with --sample-seed 3 twice, one caption; the same model as a `.pth`
    of `torch.save(decoder.state_dict())`, the `.npz`'s caption);
    evaluate --split val, whose meter rows and BLEU line must be an
    in-process Trainer.validate's; caption_split at --pipeline-depth 1
    and 2, equal JSONL files."""
    import contextlib
    import io

    import numpy as np
    import torch
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.engine.loop import Trainer
    from sat_tpu_torch.serve import load_model

    dcfg, dec_flat, enc_flat = resnet
    model_dir = os.path.join(root, "resnet")
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "model_config.json"), "w") as f:
        json.dump({"data": root, "network": "resnet152", "ado": True,
                   "attention": True, "bert": False, "tf": False}, f)
    npz = os.path.join(model_dir, "model_resnet152_1.npz")
    np.savez(npz, **dec_flat)
    enc_npz = os.path.join(model_dir, "resnet152.npz")
    np.savez(enc_npz, **enc_flat)
    img = os.path.join(root, "imgs", "val_000.png")
    res = {"seconds": {}}

    def gen_caption(tag, model, *flags):
        png = os.path.join(model_dir, f"{tag}.png")
        out, res["seconds"][f"generate_caption_{tag}"] = run_cli(
            "generate_caption", "--img-path", img, "--model", model,
            "--encoder-weights", enc_npz, "--beam-size", str(BEAM), "--out",
            png, *flags)
        check(os.path.getsize(png) > 0, f"cli generate_caption {tag}: no PNG")
        return caption_of(out), out

    beam, _ = gen_caption("beam", npz)
    knobs = ("--decode", "sample", "--sample-seed", "3", "--temperature",
             "0.8", "--top-k", "10")
    samples = [gen_caption(f"sample{i}", npz, *knobs)[0] for i in range(2)]
    check(samples[0] == samples[1],
          f"cli generate_caption --decode sample --sample-seed 3: {samples}")
    _, _, _, dec, _ = load_model(npz, encoder_weights=enc_npz, device="cuda")
    pth = os.path.join(model_dir, "model_resnet152_1.pth")
    torch.save(dec.state_dict(), pth)
    from_pth, pth_out = gen_caption("pth", pth)
    check(from_pth == beam and "Strict loading failed" not in pth_out,
          f"cli generate_caption: the .pth model's {from_pth!r}, the .npz "
          f"model's {beam!r}")
    res.update(beam_caption=beam, sample_caption=samples[0])

    model = os.path.join(ckpt_dir, "model_vgg19_1.npz")
    out, res["seconds"]["evaluate"] = run_cli(
        "evaluate", "--model", model, "--split", "val", "--encoder-weights",
        enc_path)
    cfg = Config.from_model_config(
        os.path.join(ckpt_dir, "model_config.json"), model=model,
        encoder_weights=enc_path, perform_test=False, resume=False)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        want = Trainer(cfg).validate(0)
    rows = meter_rows(out)
    check(rows == meter_rows(log.getvalue()) and any(
        ln.startswith("EvalMode.VALIDATION Epoch: 0\tBLEU-1 (") for ln in rows),
          "cli evaluate: its rows differ from the in-process validate's")
    res["evaluate"] = {k: float(v) for k, v in want.items()}

    files = []
    for depth in (1, 2):
        jsonl = os.path.join(root, f"caps{depth}.jsonl")
        out, res["seconds"][f"caption_split_depth{depth}"] = run_cli(
            "caption_split", "--model", model, "--encoder-weights", enc_path,
            "--split", "val", "--batch-size", str(TRAIN_B),
            "--pipeline-depth", str(depth), "--out", jsonl)
        res[f"caption_split_depth{depth}"] = json.loads(
            out.strip().splitlines()[-1])
        with open(jsonl) as f:
            files.append(f.read())
    check(files[0] == files[1] and files[0].count("\n")
          == 2 * ENTRY_IMAGES["val"],
          "cli caption_split: the JSONL at depths 1 and 2 differ")
    emit({"phase": "cli", **res})
    return res


# ---------------------------------------------------------------- export

# The export phase's artifacts, each against the live caption step on the
# same top-k route: sat_tpu's export defaults (the library sort), the
# top-k operator, and the fast modes (fast top-k, bf16 decode).
EXPORTS = (("f32", {"pallas_topk": False}),
           ("f32_topk_kernel", {"pallas_topk": True}),
           ("fast_bf16", {"fast_topk": True, "bf16": True}))
EARLY_EXIT_BOOSTS = (2.0, 4.0, 8.0, 16.0, 32.0)   # added to <eos>'s bias
EXPORT_TURNS = ("artifact", "live", "live", "artifact", "artifact", "live")
EAGER_BATCHES = (1, 7)


def max_abs_diff(a, b) -> float:
    """The largest |a - b|, equal entries (infinities too) counting 0."""
    import torch
    a, b = a.float().cpu(), b.float().cpu()
    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


def artifact_run(spec: dict) -> None:
    """One artifact in a fresh process (`--artifact-run`), which imports
    the loader (engine/artifact.py) and nothing of the model code: load
    it, caption the images once (its kernels load at first launch), then
    once more under the profiler with the launch counts zeroed, and write
    the outputs (<out>.npz) and the seconds, counts and profile
    (<out>.json)."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    torch.zeros((), device="cuda")          # the process's CUDA context
    cuda_init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    from sat_tpu_torch.engine.artifact import load_caption_artifact
    caption = load_caption_artifact(spec["path"])
    load_s = time.perf_counter() - t0
    images = np.load(spec["images"])
    first_ms = host_ms(lambda: caption(images))
    out = {}
    reset_launches()
    prof = profile_run(lambda: out.update(caption(images)))
    host = read_launches()
    modules = sorted(m for m in sys.modules if m.startswith("sat_tpu_torch"))
    np.savez(spec["out"] + ".npz", **{k: v.cpu().numpy()
                                      for k, v in out.items()})
    with open(spec["out"] + ".json", "w") as f:
        json.dump({"cuda_init_s": cuda_init_s, "load_s": load_s,
                   "first_ms": first_ms,
                   "host_launches": host, "profile": prof,
                   "modules": modules}, f)


def phase_export(dcfg, dec_flat, worst_flat, enc_flat, images) -> dict:
    """AOT caption artifacts at the flagship's width (B = 128, 224 px, beam
    5, worst case): each exported here (engine/serving.py), run by a fresh
    process that imports only the loader (`artifact_run`), held bit for
    bit to the live caption step on its top-k route (tokens, length,
    found; the score and alpha differences printed), its profile's
    kernels equal to its wrappers' counts; a fourth artifact of a decoder
    whose <eos> bias is raised until the live beam stops early, while the
    artifact runs all 51 steps. Then, in this process, each artifact
    against the live graphs in turns, and the eager decode at B = 1 and 7
    beside the operators' host cost a call (time_op_dispatch.py)."""
    import numpy as np
    import torch
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 encoder_from_jax)
    from sat_tpu_torch.engine.serving import (build_caption_step,
                                              export_caption_artifact,
                                              load_caption_artifact)
    from sat_tpu_torch.models.beam import beam_search_batched
    from sat_tpu_torch.models.encoder import encoder_forward
    from time_op_dispatch import measure

    enc = encoder_from_jax(enc_flat, "vgg19", "cuda")
    worst = decoder_from_jax(worst_flat, dcfg, "cuda")
    seeded = decoder_from_jax(dec_flat, dcfg, "cuda")
    feats = encoder_forward(enc, "vgg19", images)

    # the early-exit decoder: <eos> raised until every image's beams
    # complete and the live (eager) beam stops before its 51 steps
    early = None
    for boost in EARLY_EXIT_BOOSTS:
        flat = dict(dec_flat)
        bias = flat["ado/f_out/b"].copy()
        bias[STOP_IDS[0]] += boost
        flat["ado/f_out/b"] = bias
        dec = decoder_from_jax(flat, dcfg, "cuda")
        reset_launches()
        beam_search_batched(dec, feats, BEAM)
        torch.cuda.synchronize()
        steps = read_launches()["topk"]
        if steps < STEPS:
            early = {"boost": boost, "live_steps": steps, "decoder": dec}
            break
    check(early is not None, f"export: no <eos> boost of "
                             f"{EARLY_EXIT_BOOSTS} stops the beam early")
    plans = [(name, worst, kw) for name, kw in EXPORTS]
    plans.append(("early_exit", early["decoder"], {"pallas_topk": False}))

    res = {"phase": "export", "images": B, "beam": BEAM, "steps": STEPS,
           "early_exit": {k: v for k, v in early.items() if k != "decoder"},
           "artifacts": {}}
    with tempfile.TemporaryDirectory() as tmp:
        img_path = os.path.join(tmp, "images.npy")
        np.save(img_path, images)
        procs = []
        for name, dec, kw in plans:
            path = os.path.join(tmp, name + ".pt2")
            t0 = time.perf_counter()
            export_caption_artifact(path, "vgg19", dcfg, enc, dec, B, SIZE,
                                    BEAM, device="cuda", **kw)
            art = {"export_s": time.perf_counter() - t0,
                   "bytes": os.path.getsize(path), "options": kw}
            res["artifacts"][name] = art
            # the fresh process starts while the next export traces
            spec = {"path": path, "images": img_path,
                    "out": os.path.join(tmp, name)}
            procs.append((name, path, dec, kw, spec, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--artifact-run", json.dumps(spec)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=REPO_DIR, env=cli_env())))
        for name, _, _, _, _, proc in procs:
            try:
                _, err = proc.communicate(timeout=600)
            finally:
                proc.kill()
            check(proc.returncode == 0, f"export {name}: the fresh process "
                                        f"exit {proc.returncode}: "
                                        f"{err[-2000:]}")
        # every fresh process has ended: the timings below run alone
        for name, path, dec, kw, spec, _ in procs:
            art = res["artifacts"][name]
            with zipfile.ZipFile(path) as z:
                art["largest_entries"] = sorted(
                    ((i.filename, i.file_size) for i in z.infolist()),
                    key=lambda e: -e[1])[:4]
            with open(spec["out"] + ".json") as f:
                run = json.load(f)
            with np.load(spec["out"] + ".npz") as z:
                got = {k: torch.from_numpy(z[k]) for k in z.files}
            art.update(cuda_init_s=run["cuda_init_s"], load_s=run["load_s"],
                       first_ms=run["first_ms"],
                       fresh_modules=run["modules"])
            check(not [m for m in run["modules"] if ".models" in m],
                  f"export {name}: the loading process imported model "
                  f"code: {run['modules']}")
            variant = "_bf16" if kw.get("bf16") else ""
            want = counts(**{f"attention_fwd{variant}": STEPS,
                             **({"topk": STEPS} if kw.get("pallas_topk")
                                else {})})
            device = run["profile"].get("kernel_calls")
            check(run["host_launches"] == want and device == want,
                  f"export {name}: a run's host launches "
                  f"{run['host_launches']}, device {device}; expected "
                  f"{want}")
            art["launches"] = want
            art["profile"] = {k: run["profile"].get(k) for k in (
                "wall_ms", "device_busy_ms", "device_busy_share",
                "device_lead_us", "top")}

            # the live step on the same route: graphs for the timed
            # artifacts, eager for the early exit (its steps counted)
            live_step = build_caption_step("vgg19", dcfg, BEAM,
                                           device="cuda",
                                           graphs=name != "early_exit", **kw)
            live = live_step(enc, dec, images)
            for k in ("tokens", "length", "found"):
                check(same_bits(live[k].cpu(), got[k]),
                      f"export {name}: {k} differ from the live step's")
            art["max_score_diff"] = max_abs_diff(live["score"], got["score"])
            art["max_alpha_diff"] = max_abs_diff(live["alphas"],
                                                 got["alphas"])
            art["found"] = int(got["found"].sum())
            if name == "early_exit":
                check(art["found"] == B, "export early_exit: an image "
                                         "completed no sentence")
                continue
            check(art["found"] == 0, f"export {name}: a beam completed "
                                     f"although the stop logits are pinned")
            t0 = time.perf_counter()
            caption = load_caption_artifact(path)
            art["load_s_here"] = time.perf_counter() - t0
            caption(images)
            torch.cuda.synchronize()
            ms = {"artifact": [], "live": []}
            for turn in EXPORT_TURNS:
                ms[turn].append(host_ms(
                    (lambda: caption(images)) if turn == "artifact"
                    else (lambda: live_step(enc, dec, images))))
            art["ms"] = ms
            del caption

    # the eager decode through the operators, and their host cost a call
    eager = {}
    for Bx in EAGER_BATCHES:
        fx = feats[:Bx].contiguous()
        beam_search_batched(seeded, fx, BEAM)
        eager[Bx] = [host_ms(lambda: beam_search_batched(seeded, fx, BEAM))
                     for _ in range(3)]
    res["eager_decode_ms"] = eager
    res["host_us_per_call"] = measure("cuda")
    emit(res | {"artifacts": {n: {k: v for k, v in a.items()
                                  if k != "profile"}
                              for n, a in res["artifacts"].items()}})
    return res


# ------------------------------------------------------------------ BERT

# sat_tpu_torch.constants: BERT_VOCAB_SIZE, BERT_HIDDEN_SIZE, the special
# ids, and the BERT beam's completion ids ([unused0] and [PAD])
BERT_V, BERT_E = 30522, 768
BERT_PAD, BERT_CLS, BERT_SEP = 0, 101, 102
BERT_UNK = 100
BERT_STOP_IDS = (1, 0)


def bert_topk_inputs(gen, vocab: int = BERT_V):
    """The BERT beam's candidate block, (B, 5 x vocab): random rows with
    step 1's layout in 8 of them (row 0 live only), and adversarial rows:
    equal maxima on both sides of each split point of the rows between the
    blocks of a cluster of 2 (rows 8-23) and of 4 (rows 24-39), and at the
    head/float4 and float4/tail cuts; ties, -inf, NaN and signed zeros.
    A row is 610,440 bytes, 8 mod 16, so its start alternates between 0
    and 8 mod 16 and its head between 0 and 2 scalars."""
    import torch
    n = BEAM * vocab
    x = torch.randn((B, n), generator=gen)
    x[:8, vocab:] = float("-inf")
    adv = torch.randn((B, n), generator=gen)
    adv[0] = torch.randint(0, 3, (n,), generator=gen).float()
    adv[1] = float("-inf")
    adv[2, ::3] = float("nan")
    adv[3] = 0.0
    adv[3, ::2] = -0.0
    adv[4, :n - 3] = float("-inf")             # the tail only
    for row in range(8, 40):
        cluster = 2 if row < 24 else 4
        head = (16 - (4 * n * row) % 16) % 16 // 4   # allocations: 16 B
        nvec = (n - head) // 4
        per = -(-nvec // cluster)
        cuts = [head + 4 * per * r for r in range(1, cluster)]
        cuts += [max(head, 1), head + 4 * nvec]
        for cut in cuts:
            adv[row, cut - 1:cut + 1] = 9.0 + row % 3
    return x.cuda(), adv.cuda()


def bert_topk_row(peaks, hz, gen, vocab: int = BERT_V,
                  name: str = "topk_bert") -> dict:
    """Top-k at the BERT beam's rows, (128, 152,610), k = 5 (or at a model
    rank's (128, 5 x vocab)), bit for bit against its plain form on random
    and adversarial rows at the wrapper's cluster size and at each of 1, 2
    and 4; two launches alike; times warm and cold beside the bound, the
    plain form's and torch.topk's."""
    import torch
    from sat_tpu_torch.ops.topk import (cluster_size, launch, topk,
                                        topk_library, topk_plain)
    x, adv = bert_topk_inputs(gen, vocab)
    checks = []
    for label, inp in (("random", x), ("adversarial", adv)):
        pv, pi = topk_plain(inp, BEAM)
        for c in ("wrapper", 1, 2, 4):
            kv, ki = (topk(inp, BEAM) if c == "wrapper"
                      else launch(inp, BEAM, c))
            torch.cuda.synchronize()
            check(torch.equal(ki, pi) and same_bits(kv, pv),
                  f"{name}: differs from its plain form on {label} rows "
                  f"at cluster {c}")
            checks.append(f"{label}, cluster {c}")
    check(all(map(same_bits, topk(x, BEAM), topk(x, BEAM))),
          f"{name}: two launches differ")
    row = {"name": name, "route": "cuda",
           "source": "sat_tpu_torch/ops/csrc/topk.cu",
           "replaces": "sat_tpu/ops/topk.py:41",
           "shape": f"x ({B}, {BEAM * vocab}) f32, k={BEAM}",
           "max_abs_err": 0.0, "checks": checks + ["two launches"],
           "cluster": cluster_size(B),
           "ms": time_ms(lambda: topk(x, BEAM), hz),
           "cold_ms": time_ms(lambda: topk(x, BEAM), hz, cold=True),
           "plain_ms": time_ms(lambda: topk_plain(x, BEAM), hz),
           "library_ms": time_ms(lambda: torch.topk(x, BEAM, dim=1), hz),
           "sort_ms": time_ms(lambda: topk_library(x, BEAM), hz),
           **stream_ms(lambda: torch.amax(x, dim=1), hz),
           "ms_by_cluster": {c: time_ms(lambda: launch(x, BEAM, c), hz)
                             for c in (1, 2, 4)},
           **topk_bound(x, BEAM, peaks)}
    row.update(shares(row))
    return row


def bert_kernel_rows(peaks, sfu_s, issue_s, tanh_instr, hz, gen) -> list:
    """The kernels at BERT's shapes (E = 768, V = 30,522): top-k on the
    beam's rows and on the sampler's at k = 10 and 50; the forward at the
    beam's R = 5, B = 128 and training's R = 1, B = 64, f32 and bf16, and
    on a grid of L = 199 whose last block ends in a ragged tile in both
    types (f32 tiles of 2 key rows, bf16 of 5); the backward at (64, 196,
    768, 512), f32 and bf16."""
    rows = [bert_topk_row(peaks, hz, gen),
            bert_topk_row(peaks, hz, gen, vocab=BERT_V // TP_M,
                          name="topk_tp")]
    rows += [sample_topk_row(k, peaks, hz, gen, vocab=BERT_V,
                             name=f"topk_bert_k{k}") for k in SAMPLE_KS]
    rows += select_rows(peaks, hz, gen, BERT_V, "topk_bert")
    for bf16 in (False, True):
        name = f"attention_fwd{'_bf16' if bf16 else ''}_e768"
        row = fwd_row(name, peaks, sfu_s, hz, gen, L, D, bf16, Ex=BERT_E)
        r1 = fwd_row(name, peaks, sfu_s, hz, gen, L, D, bf16, R=1,
                     Bx=TRAIN_B, Ex=BERT_E)
        _, ragged = fwd_check(name, gen, 4, BEAM, 199, D, BERT_E, bf16)
        row["variants"] = {"r1_b64": {k: r1[k] for k in (
            "shape", "ms", "cold_ms", "plain_ms", "bound_ms", "bound_share",
            "errors")}}
        row["errors_ragged_l199"] = ragged
        row["max_abs_err"] = max(row["max_abs_err"], r1["max_abs_err"],
                                 *ragged.values())
        rows.append(row)
    for bf16 in (False, True):
        rows.append(attention_bwd_row(
            peaks, sfu_s, issue_s, tanh_instr, hz, gen, bf16=bf16,
            E=BERT_E, row_name=f"attention_bwd{'_bf16' if bf16 else ''}"
                               f"_e768"))
    return rows


def write_bert_vocab(path: str) -> str:
    """A 30,522-line vocab.txt with bert-base-uncased's special-token
    layout ([PAD] 0, [unused0-98] 1-99, [UNK] 100, [CLS] 101, [SEP] 102,
    [MASK] 103), then words, every fourth a word piece."""
    lines = ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    lines += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    lines += [f"##p{i}" if i % 4 == 0 else f"w{i}"
              for i in range(BERT_V - len(lines))]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def make_bert_captions(gen, rows: int):
    """(rows, CAP_LEN) int32 captions in sat_tpu's BERT layout: [CLS], 8 to
    25 word ids, [PAD] up to the last column, then [SEP]."""
    import torch
    caps = torch.full((rows, CAP_LEN), BERT_PAD, dtype=torch.int32)
    caps[:, 0] = BERT_CLS
    caps[:, -1] = BERT_SEP
    for i, n in enumerate(torch.randint(8, CAP_LEN - 1, (rows,),
                                        generator=gen).tolist()):
        caps[i, 1:n + 1] = torch.randint(104, BERT_V, (n,), generator=gen,
                                         dtype=torch.int32)
    return caps


def bert_weights(seed: int):
    """sat_tpu's default BERT run's decoder (tf + ado + attention, VGG19's
    D = 512, E = 768, V = 30,522): random weights from the seed with a
    random table (N(0, 0.02)), and the worst case: the stop set's logits
    pinned to -1e9."""
    import torch
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
    gen = torch.Generator().manual_seed(seed + 9)
    dcfg = DecoderConfig(vocab_size=BERT_V, encoder_dim=D, use_tf=True,
                         use_ado=True, use_bert=True, use_attention=True)
    table = (torch.randn((BERT_V, BERT_E), generator=gen) * 0.02).numpy()
    flat = init_decoder_params(dcfg, gen, bert_embeddings=table)
    worst = dict(flat)
    bias = worst["ado/f_out/b"].copy()
    bias[list(BERT_STOP_IDS)] = -1e9
    worst["ado/f_out/b"] = bias
    return dcfg, table, flat, worst


def pad_boost(dec, feats) -> float:
    """A rise of [PAD]'s output bias with which some beams complete: the
    median, over the images, of the gap between the largest logit of the
    first step and [PAD]'s."""
    import torch
    from sat_tpu_torch.models.decoder import (decode_step, embed_tokens,
                                              init_lstm_state)
    with torch.inference_mode():
        h, c = init_lstm_state(dec, feats)
        emb = embed_tokens(dec, torch.full((feats.shape[0],), BERT_CLS,
                                           device=feats.device))
        logits = decode_step(dec, feats, dec.attention.W(feats), h, c,
                             emb)[2]
        gap = logits.max(dim=1).values - logits[:, BERT_PAD]
    return float(gap.median())


def cpu_agreement(network, dcfg, enc, dec_gpu, enc_cpu, dec_cpu, images,
                  tag: str, n: int = 8) -> dict:
    """n images captioned on the card (eager, its launches counted) and on
    the CPU with the plain forms, beam and greedy: tokens, length and
    completion equal on all but at most one image."""
    import numpy as np
    import torch
    from sat_tpu_torch.engine.serving import build_caption_step
    ref = {}
    for decode in ("beam", "greedy"):
        reset_launches()
        g = build_caption_step(network, dcfg, BEAM, decode=decode,
                               device="cuda", graphs=False)(
            enc, dec_gpu, images[:n])
        torch.cuda.synchronize()
        got = read_launches()
        if decode == "greedy":       # all 51 steps, argmax and no top-k
            check(got == counts(attention_fwd=STEPS),
                  f"{tag} greedy: launches {got}, expected attention_fwd "
                  f"{STEPS} and no other")
        else:                        # one of each a step, until all complete
            check(1 <= got["topk"] <= STEPS
                  and got == counts(topk=got["topk"],
                                    attention_fwd=got["topk"]),
                  f"{tag} beam: launches {got}, expected equal counts of "
                  f"top-k and attention_fwd in 1..{STEPS} and no other")
        c = build_caption_step(network, dcfg, BEAM, decode=decode,
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
        ref[decode] = {"agree": agree, "of": n, "launches": got,
                       "found": int(g["found"].sum()),
                       "max_score_err": float(np.max(np.abs(
                           np.where(g["found"], g["score"], 0)
                           - np.where(c["found"], c["score"], 0)))),
                       "diverged": diverged}
        check(agree >= n - 1, f"{tag} {decode}: GPU and CPU agree on "
                              f"{agree} of {n} images")
    return ref


def phase_bert(seed: int, enc_flat, images) -> dict:
    """BERT serving on the card (sat_tpu's default BERT run: VGG19, tf +
    ado + attention, E = 768, V = 30,522, random weights and table from
    the seed), then BERT training (`bert_train`)."""
    import torch
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 encoder_from_jax)
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.models.beam import (SYNC_EVERY, batch_generator,
                                           beam_search_batched,
                                           greedy_caption, sample_caption)
    from sat_tpu_torch.models.encoder import encoder_forward
    from sat_tpu_torch.utils.graphs import GraphCache

    dcfg, table, flat, worst = bert_weights(seed)
    enc = encoder_from_jax(enc_flat, "vgg19", "cuda")
    dec = decoder_from_jax(worst, dcfg, "cuda")
    want = 2 * sum(beam_blocks(STEPS, SYNC_EVERY))

    # (a) the worst case through a new caption step: the capturing batch's
    # host launches exactly, two replays bit for bit, a profiled replay
    # (no host launch, STEPS of top-k and attention_fwd on the device)
    step = build_caption_step("vgg19", dcfg, BEAM, device="cuda")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = step(enc, dec, images)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    host_launches = read_launches()
    check(host_launches == counts(topk=want, attention_fwd=want),
          f"bert: the capturing batch's host launches {host_launches}, "
          f"expected {want} of top-k and attention_fwd")
    t0 = time.perf_counter()
    second = step(enc, dec, images)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    replayed = {}
    reset_launches()
    main_profile = profile_run(lambda: replayed.update(step(enc, dec,
                                                            images)))
    device_launches = main_profile.get("kernel_calls")
    check(read_launches() == counts() and device_launches
          == counts(topk=STEPS, attention_fwd=STEPS),
          f"bert: the replayed batch's device launches {device_launches}, "
          f"expected {STEPS} of top-k and attention_fwd and none from the "
          f"host")
    for again in (second, replayed):
        check(not [k for k in again if not same_bits(again[k], first[k])],
              "bert: a replayed batch differs from the captured one")
    check(tuple(first["tokens"].shape) == (B, 1 + STEPS)
          and not first["found"].any().item()
          and bool(torch.isfinite(first["alphas"]).all()),
          "bert: tokens, found or alphas of the worst case wrong")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall_ms = [wall_s * 1e3] + [host_ms(lambda: step(enc, dec, images))
                                for _ in range(2)]
    enc_ms = host_ms(lambda: encoder_forward(enc, "vgg19", images))
    feats = encoder_forward(enc, "vgg19", images)

    # the decode through its graphs and eagerly, in turns
    graphs = {"graph": GraphCache(), "eager": None}
    decodes = {m: (lambda m=m: beam_search_batched(dec, feats, BEAM,
                                                   graphs=graphs[m]))
               for m in graphs}
    decoded = {m: decodes[m]() for m in graphs}
    diff = results_equal(decoded["eager"], decoded["graph"])
    check(not diff, f"bert beam: graph and eager differ in {diff}")
    decode_ms = {m: [] for m in graphs}
    for m in ("graph", "eager", "eager", "graph", "graph", "eager"):
        decode_ms[m].append(host_ms(decodes[m]))
    profile = {"main": main_profile,
               "decode_graph": profile_run(decodes["graph"])}

    # (b) [PAD]'s bias raised so that beams complete: graph against eager
    # at B = 128, and 8 images on the card against the CPU's plain forms
    seeded = dict(flat)
    boost = pad_boost(decoder_from_jax(flat, dcfg, "cuda"), feats[:32])
    bias = seeded["ado/f_out/b"].copy()
    bias[BERT_PAD] += boost
    seeded["ado/f_out/b"] = bias
    dec_s = decoder_from_jax(seeded, dcfg, "cuda")
    eager = beam_search_batched(dec_s, feats, BEAM)
    graph = beam_search_batched(dec_s, feats, BEAM, graphs=GraphCache())
    diff = results_equal(eager, graph)
    check(not diff, f"bert beam, seeded: graph and eager differ in {diff}")
    check(bool(eager.found.any()), "bert beam, seeded: no beam completed")
    stops = eager.tokens[torch.arange(B, device="cuda"), eager.length]
    check(bool(torch.isin(stops[eager.found],
                          torch.tensor(BERT_STOP_IDS, device="cuda")).all())
          and bool((eager.tokens[eager.found, 0] == BERT_CLS).all()),
          "bert beam, seeded: a sentence does not run from [CLS] to 1 or 0")
    lengths = eager.length[eager.found]
    cpu = cpu_agreement("vgg19", dcfg, enc, dec_s,
                        encoder_from_jax(enc_flat, "vgg19", "cpu"),
                        decoder_from_jax(seeded, dcfg, "cpu"), images,
                        "bert")
    check(cpu["beam"]["found"] > 0, "bert: no beam completed on 8 images")

    # (c) greedy and sample through their graphs, against eager
    cache = GraphCache()
    g_graph = greedy_caption(dec, feats, with_alphas=True, graphs=cache)
    g_eager = greedy_caption(dec, feats, with_alphas=True)
    diff = results_equal(g_eager, g_graph)
    check(not diff, f"bert greedy: graph and eager differ in {diff}")
    profile["greedy"] = prof = profile_run(
        lambda: greedy_caption(dec, feats, graphs=cache))
    check(prof.get("kernel_calls") == counts(attention_fwd=STEPS),
          f"bert greedy: the profile shows kernels "
          f"{prof.get('kernel_calls')}, expected {STEPS} of attention_fwd")
    greedy_ms = [host_ms(lambda: greedy_caption(dec, feats, graphs=cache))
                 for _ in range(3)]
    sample = {}
    for k in SAMPLE_KS:
        knobs = dict(temperature=0.8, top_k=k, top_p=0.9)
        sstep = build_caption_step("vgg19", dcfg, BEAM, decode="sample",
                                   device="cuda", **knobs)
        seager = build_caption_step("vgg19", dcfg, BEAM, decode="sample",
                                    device="cuda", graphs=False, **knobs)
        torch.cuda.reset_peak_memory_stats()
        runs = [sstep(enc, dec, images, batch_generator(3, 0, "cuda"))
                for _ in range(2)]
        peak = torch.cuda.max_memory_allocated() / 1e9
        reset_launches()
        replay = {}
        prof = profile_run(lambda: replay.update(sstep(
            enc, dec, images, batch_generator(3, 0, "cuda"))))
        calls = prof.get("kernel_calls")
        check(read_launches() == counts()
              and calls == counts(topk=STEPS, attention_fwd=STEPS),
              f"bert sample k={k}: the replayed batch's device launches "
              f"{calls}, expected {STEPS} of top-k and attention_fwd")
        ref = seager(enc, dec, images, batch_generator(3, 0, "cuda"))
        for got in runs + [replay]:
            check(not [f for f in ref if not same_bits(ref[f], got[f])],
                  f"bert sample k={k}: a replay differs from the eager "
                  f"step for one seed")

        def decode_only(k=k):
            return sample_caption(dec, feats, batch_generator(3, 0, "cuda"),
                                  0.8, k, 0.9, graphs=cache)

        decode_only()                                   # its capture
        sample[f"k{k}"] = {
            "decode_ms": [host_ms(decode_only) for _ in range(3)],
            "device_launches": calls, "peak_mem_gb": peak,
            "noise_gb": STEPS * B * BERT_V * 4 / 1e9,
            "wall_ms": [host_ms(lambda: sstep(enc, dec, images,
                                              batch_generator(3, 0, "cuda")))
                        for _ in range(3)],
            "device_busy_ms": prof.get("device_busy_ms"),
            "mean_length": float(ref["length"].float().mean())}
    top = topk_max_select()
    sample["by_k"] = decode_by_k(dec, feats, cache,
                                 SELECT_KS + (top,) + sort_ks(BERT_V),
                                 "bert sample")

    # (d) the bf16 decode: the forward's bf16 variant at E = 768
    step16 = build_caption_step("vgg19", dcfg, BEAM, bf16=True,
                                device="cuda")
    reset_launches()
    first16 = step16(enc, dec, images)
    torch.cuda.synchronize()
    host16 = read_launches()
    check(host16 == counts(topk=want, attention_fwd_bf16=want),
          f"bert bf16: the capturing batch's host launches {host16}")
    replay16 = {}
    reset_launches()
    profile["bf16"] = profile_run(lambda: replay16.update(
        step16(enc, dec, images)))
    device16 = profile["bf16"].get("kernel_calls")
    check(read_launches() == counts() and device16
          == counts(topk=STEPS, attention_fwd_bf16=STEPS),
          f"bert bf16: the replayed batch's device launches {device16}")
    check(not [k for k in first16 if not same_bits(first16[k],
                                                   replay16[k])]
          and not first16["found"].any().item(),
          "bert bf16: a replay differs from the captured batch")
    steps = {"f32": step, "bf16": step16}
    turns = {m: [] for m in steps}
    for m in ("f32", "bf16", "bf16", "f32", "f32", "bf16"):
        turns[m].append(host_ms(lambda m=m: steps[m](enc, dec, images)))

    train = bert_train(seed, table)
    res = {"phase": "bert", "images": B, "beam": BEAM, "steps": STEPS,
           "vocab": BERT_V, "embedding": BERT_E,
           "first_call_s": first_s, "capture_s": step.graphs.capture_seconds,
           "wall_ms": wall_ms,
           "captions_per_s": B * 1e3 / statistics.median(wall_ms),
           "encoder_ms": enc_ms, "decode_ms": decode_ms,
           "peak_mem_gb": peak_gb, "host_launches": host_launches,
           "device_launches": device_launches,
           "device_busy_share": {k: v.get("device_busy_share")
                                 for k, v in profile.items()},
           "device_busy_ms": {k: v.get("device_busy_ms")
                              for k, v in profile.items()},
           "pad_boost": boost, "seeded_found": int(eager.found.sum()),
           "seeded_lengths": sorted(set(lengths.tolist())),
           "cpu_check": cpu, "greedy_ms": greedy_ms, "sample": sample,
           "bf16": {"host_launches": host16, "device_launches": device16,
                    "wall_ms": turns,
                    "captions_per_s": {m: B * 1e3 / statistics.median(v)
                                       for m, v in turns.items()}},
           "train": train, "profile": profile}
    emit({k: v for k, v in res.items() if k not in ("profile", "train")}
         | {"train": {k: v for k, v in train.items()
                      if k not in ("profile", "block_profile",
                                   "bf16_profile")}})
    return res


def bert_train(seed: int, table) -> dict:
    """BERT bank training at B = 64 on BERT-layout captions of 27 tokens
    (26 steps), remat on, dropout 0.5: one step on the card against the
    CPU (dropout 0), both leaving the table as it was; a step's launches
    and profile; K = 8 blocks against per-batch steps in turns (ms a step,
    rows/s, peak memory), the block's host and device launches; the table
    bit for bit unchanged after a block, and not among Adam's parameters;
    one --bf16-attention step's launches and profile."""
    import dataclasses

    import torch
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 decoder_to_jax)
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_train_block,
                                                   make_bank_train_step)

    gen = torch.Generator().manual_seed(seed + 11)
    dcfg = DecoderConfig(vocab_size=BERT_V, encoder_dim=D, use_tf=True,
                         use_ado=True, use_bert=True, use_attention=True)
    flat = init_decoder_params(dcfg, gen, bert_embeddings=table)
    bank = torch.rand((BANK_U, L, D), generator=gen)
    caps = make_bert_captions(gen, BANK_N)
    batches = [(torch.randint(0, BANK_U, (TRAIN_B,), generator=gen),
                torch.randint(0, BANK_N, (TRAIN_B,), generator=gen))
               for _ in range(K_BLOCK)]
    bank_gpu, caps_gpu = bank.cuda(), caps.cuda()
    batches_gpu = [(i.cuda(), r.cuda()) for i, r in batches]
    table_t = torch.from_numpy(table)

    # (a) one step, card against CPU, dropout 0
    exact = dataclasses.replace(dcfg, dropout_rate=0.0)
    after = {}
    for device, fb, cb, (ii, ri) in (("cpu", bank, caps, batches[0]),
                                     ("cuda", bank_gpu, caps_gpu,
                                      batches_gpu[0])):
        state = init_train_state(decoder_from_jax(flat, exact, device,
                                                  trainable=True))
        state, m = make_bank_train_step(exact, 1.0)(state, fb, cb, ii, ri,
                                                    PARITY_LR, None)
        check(torch.equal(state.decoder.embedding.weight.cpu(), table_t),
              f"bert train ({device}): a step moved the table")
        after[device] = (float(m["loss"]), decoder_to_jax(state.decoder))
    (cpu_loss, cpu_p), (gpu_loss, gpu_p) = after["cpu"], after["cuda"]
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    check(loss_rel <= 1e-5, f"bert train: card loss {gpu_loss} vs CPU "
                            f"{cpu_loss}")
    param_err = {}
    for name, ref in cpu_p.items():
        param_err[name] = err = float(abs(gpu_p[name] - ref).max())
        bound = 2.05 * PARITY_LR if name == "attention/v/b" else 3e-4
        check(err <= bound, f"bert train: {name} differs by {err} > "
                            f"{bound} after one step")

    # (b) a step's launches and profile, then blocks against per-batch
    # steps in turns
    state = init_train_state(decoder_from_jax(flat, dcfg, "cuda",
                                              trainable=True))
    dgen = torch.Generator(device="cuda").manual_seed(seed)
    one = make_bank_train_step(dcfg, 1.0)
    block = make_bank_train_block(dcfg, 1.0)
    blk_img = torch.stack([i for i, _ in batches_gpu])
    blk_row = torch.stack([r for _, r in batches_gpu])
    step_launches = counts(attention_fwd=2 * T, attention_bwd=T)

    def run(n):
        nonlocal state
        for i in range(n):
            ii, ri = batches_gpu[i % K_BLOCK]
            state, _ = one(state, bank_gpu, caps_gpu, ii, ri, 1e-4, dgen)

    def run_blocks(n):
        nonlocal state
        for _ in range(n):
            state, _ = block(state, bank_gpu, caps_gpu, blk_img, blk_row,
                             1e-4, dgen)

    reset_launches()
    run(1)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == step_launches, f"bert train: a step's launches "
                                     f"{launches}, expected {step_launches}")
    run(2)                                            # warm-up
    reset_launches()
    profile = profile_run(lambda: run(1))
    check(profile.get("kernel_calls") == read_launches() == step_launches,
          f"bert train: the step's profile shows kernels "
          f"{profile.get('kernel_calls')}")
    reset_launches()
    run_blocks(1)
    torch.cuda.synchronize()
    block_launches = read_launches()
    check(block_launches == {k: 2 * v for k, v in step_launches.items()},
          f"bert train block: host launches {block_launches}, expected "
          f"twice a step's (warm-up and capture)")
    check(torch.equal(state.decoder.embedding.weight.cpu(), table_t),
          "bert train: a block moved the table")
    tracked = {id(p) for g in state.optimizer.param_groups
               for p in g["params"]}
    check(id(state.decoder.embedding.weight) not in tracked
          and state.decoder.embedding.weight not in state.optimizer.state,
          "bert train: the table is among Adam's parameters")
    block_profile = profile_run(lambda: run_blocks(1))
    calls = block_profile.get("kernel_calls")
    check(calls == {k: K_BLOCK * v for k, v in step_launches.items()},
          f"bert train block: the profile shows kernels {calls}")
    n_timed = 2 * K_BLOCK
    timing = {m: {"ms_per_step": [], "peak_mem_gb": []}
              for m in ("per_batch", "blocked")}
    for m in ("per_batch", "blocked", "blocked", "per_batch"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_blocks(n_timed // K_BLOCK) if m == "blocked" else run(n_timed)
        torch.cuda.synchronize()
        timing[m]["ms_per_step"].append(
            (time.perf_counter() - t0) * 1e3 / n_timed)
        timing[m]["peak_mem_gb"].append(
            torch.cuda.max_memory_allocated() / 1e9)
    for t in timing.values():
        t["rows_per_s"] = TRAIN_B * 1e3 / statistics.mean(t["ms_per_step"])
    check(torch.equal(state.decoder.embedding.weight.cpu(), table_t),
          "bert train: the timed steps moved the table")

    # (c) --bf16-attention: the kernels' bf16 variants only
    cfg16 = dataclasses.replace(dcfg, bf16_attention=True)
    st16 = init_train_state(decoder_from_jax(flat, cfg16, "cuda",
                                             trainable=True))
    step16 = make_bank_train_step(cfg16, 1.0)

    def run16():
        nonlocal st16
        st16, _ = step16(st16, bank_gpu, caps_gpu, *batches_gpu[0], 1e-4,
                         dgen)

    reset_launches()
    run16()
    torch.cuda.synchronize()
    launches16 = read_launches()
    want16 = counts(attention_fwd_bf16=2 * T, attention_bwd_bf16=T)
    check(launches16 == want16, f"bert bf16 train: launches {launches16}")
    reset_launches()
    bf16_profile = profile_run(run16)
    check(bf16_profile.get("kernel_calls") == want16,
          f"bert bf16 train: the profile shows kernels "
          f"{bf16_profile.get('kernel_calls')}")
    return {"batch": TRAIN_B, "caption_len": CAP_LEN,
            "parity": {"loss_cpu": cpu_loss, "loss_gpu": gpu_loss,
                       "loss_rel_err": loss_rel,
                       "max_param_err": max(v for k, v in param_err.items()
                                            if k != "attention/v/b")},
            "launches": launches, "block_launches": block_launches,
            "block_device_launches": calls, "timing": timing,
            "bf16_launches": launches16,
            "step_device_busy_share": profile.get("device_busy_share"),
            "block_device_busy_share": block_profile.get(
                "device_busy_share"),
            "profile": profile, "block_profile": block_profile,
            "bf16_profile": bf16_profile}


def write_bert_split(root: str, seed: int) -> str:
    """A Karpathy split of the entry phase's images, two sentences each,
    in the order of its `{split}_img_paths.json` rows: 8 to 22 words of
    the script's BERT vocabulary, a third of them a word and a word piece
    run together ("w5p8": w5 ##p8), so that the longest sentence has more
    word pieces than words."""
    import numpy as np
    rng = np.random.default_rng(seed)
    words = [i for i in range(1, BERT_V - 104) if i % 4]
    pieces = [i for i in range(4, BERT_V - 104, 4)]
    images = []
    for split in ENTRY_IMAGES:
        with open(os.path.join(root, f"{split}_img_paths.json")) as f:
            paths = json.load(f)[::2]
        for path in paths:
            sentences = []
            for _ in range(2):
                toks = [f"w{rng.choice(words)}" for _ in range(
                    int(rng.integers(8, 23)))]
                toks = [t + f"p{rng.choice(pieces)}" if rng.random() < 1 / 3
                        else t for t in toks]
                sentences.append({"tokens": toks})
            images.append({"filename": os.path.basename(path),
                           "split": split, "sentences": sentences})
    path = os.path.join(root, "dataset_bert.json")
    with open(path, "w") as f:
        json.dump({"images": images}, f)
    return path


def phase_bert_cli(root: str, enc_path: str, seed: int) -> dict:
    """BERT through the CLIs on the entry phase's dataset, its caption
    files written by `python -m sat_tpu_torch.generate_json_data_bert
    --vocab-file` from a split of its images (`[CLS] + ids + [PAD]* +
    [SEP]`, the length the words' + 2, the rows word pieces): one blocked
    epoch of
    `python -m sat_tpu_torch.train --bert --bert-embeddings --bert-vocab`
    (BLEU, and the table in the `.npz` bit for bit the `.npy` given); a
    fresh `serve --bert-vocab --decode greedy` process, whose words for a
    cached request must be this process's, and `generate_caption
    --bert-vocab --decode greedy`, one caption from [CLS], both on a
    checkpoint of the bert phase's worst-case decoder, which never emits
    the stop set. (The epoch's model stops at once: its captions are
    mostly [PAD]; and a random beam completes no sentence in 51 steps,
    which leaves its caption empty.)"""
    import numpy as np
    import torch
    from sat_tpu_torch.data.transforms import load_and_preprocess_image
    from sat_tpu_torch.engine.evaluate import decode_caption_bert
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.generate_caption import (caption_words,
                                                decode_single_image)
    from sat_tpu_torch.models.encoder import encoder_forward
    from sat_tpu_torch.serve import load_image_pool, load_model

    gen = torch.Generator().manual_seed(seed + 13)
    vocab = write_bert_vocab(os.path.join(root, "bert_vocab.txt"))
    res = {"seconds": {}}
    out, res["seconds"]["generate_json_data_bert"] = run_cli(
        "generate_json_data_bert", "--split-path",
        write_bert_split(root, seed + 13), "--data-path", root,
        "--max-captions", "2", "--vocab-file", vocab)
    length = int(out.split("Maximum caption length: ")[1].split()[0])
    res["caption_length"] = length
    for split in ENTRY_IMAGES:
        with open(os.path.join(root, f"{split}_img_paths.json")) as f:
            rows = len(json.load(f))
        with open(os.path.join(root, f"{split}_captions_bert.json")) as f:
            caps = np.asarray(json.load(f))
        check(caps.shape == (rows, length + 2)
              and (caps[:, 0] == BERT_CLS).all()
              and (caps[:, -1] == BERT_SEP).all()
              and (caps[:, 1:-1] != BERT_CLS).all()
              and (caps[:, 1:-1] != BERT_UNK).all(),
              f"bert cli: the {split} caption file {caps.shape}")
    check(length == 24, f"bert cli: caption length {length}, want the "
                        f"longest sentence's 22 words + 2")
    table = (torch.randn((BERT_V, BERT_E), generator=gen) * 0.02).numpy()
    table_path = os.path.join(root, "bert_table.npy")
    np.save(table_path, table)
    ckpt_dir = os.path.join(root, "bert")
    log, res["seconds"]["train"] = run_cli(
        "train", "--data", root, "--bert", "--bert-embeddings", table_path,
        "--bert-vocab", vocab, "--tf", "--ado", "--attention",
        "--cache-features", "--epochs", "1", "--batch-size", str(TRAIN_B),
        "--log-interval", "1", "--checkpoint-dir", ckpt_dir,
        "--encoder-weights", enc_path, "--steps-per-dispatch", str(ENTRY_K))
    bleu = {"val": _bleu_of(log, "EvalMode.VALIDATION"),
            "test": _bleu_of(log, "EvalMode.TEST")}
    check(all(len(b) == 4 and all(math.isfinite(v) and 0 <= v <= 1
                                  for v in b.values())
              for b in bleu.values()), f"bert cli: BLEU {bleu}")
    model = os.path.join(ckpt_dir, "model_vgg19_1.npz")
    with np.load(model) as arc:
        check(np.array_equal(arc["embedding"], table),
              "bert cli: the table in the .npz differs from the .npy")
        trainable = sum(arc[k].size for k in arc.files if k != "embedding")
    decoder_table = log.split("Decoder parameters:\n")[1]
    check("| embedding " not in decoder_table.split("Total Trainable")[0]
          and f"Total Trainable Params: {trainable}\n" in decoder_table,
          "bert cli: the decoder table counts the frozen table")

    # a fresh serve process against this process, one cached image, B = 1,
    # on the worst-case decoder
    model_dir = os.path.join(root, "bert_worst")
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "model_config.json"), "w") as f:
        json.dump({"data": root, "network": "vgg19", "ado": True,
                   "attention": True, "bert": True, "tf": False}, f)
    model = os.path.join(model_dir, "model_vgg19_0.npz")
    np.savez(model, **bert_weights(seed)[3])
    img_dir = os.path.join(root, "imgs")
    cfg, dcfg, enc, dec, words = load_model(model, encoder_weights=enc_path,
                                            device="cuda", bert_vocab=vocab)
    out = build_caption_step("vgg19", dcfg, BEAM, decode="greedy",
                             device="cuda")(
        enc, dec, load_image_pool(img_dir, cfg.image_size, 1))
    row = out["tokens"][0, :int(out["length"][0]) + 1].tolist()
    want = {"caption": " ".join(decode_caption_bert(row, words)),
            "score": float(out["score"][0].cpu()),
            "completed": bool(out["found"][0])}
    check(row[0] == BERT_CLS and len(row) == 1 + STEPS,
          f"bert cli: the in-process greedy caption {row[:4]}... stopped")
    got, res["seconds"]["serve"], code = cli_reply(
        model, enc_path, img_dir, "--bert-vocab", vocab, "--decode",
        "greedy")
    check(got == want, f"bert cli: the fresh serve process answered {got}, "
                       f"this process {want}")
    # generate_caption's words: sat_tpu's tokenizer.decode of [CLS] and
    # the greedy tokens, as this process renders them
    img = os.path.join(img_dir, "val_000.png")
    png = os.path.join(model_dir, "caption.png")
    out, res["seconds"]["generate_caption"] = run_cli(
        "generate_caption", "--img-path", img, "--model", model,
        "--encoder-weights", enc_path, "--bert-vocab", vocab, "--decode",
        "greedy", "--out", png)
    caption = caption_of(out)
    feats = encoder_forward(enc, "vgg19",
                            load_and_preprocess_image(img, cfg.image_size)
                            [None])[0]
    sentence, _ = decode_single_image(dcfg, dec, feats, decode="greedy")
    want_caption = "Caption: " + " ".join(caption_words(sentence, words))
    check(os.path.getsize(png) > 0 and caption == want_caption
          and caption.startswith("Caption: [CLS]"),
          f"bert cli generate_caption: {caption!r}, this process "
          f"{want_caption!r}")
    res.update(bleu=bleu, serve_reply=got, serve_exit_code=code,
               generate_caption=caption[:200])
    emit({"phase": "bert_cli", **res})
    return res


# ------------------------------------------------------------------ data

# The data phase's split: COCO-like image sizes (the resize downscales),
# five sentences an image
DATA_IMAGES = {"train": 512, "val": 128, "test": 16}
DATA_SHAPES = ((480, 640), (375, 500), (640, 480), (500, 375))
DATA_CHECKED = 128         # files of the native checks and of the serving
DATA_FRACTION = 0.25       # of each split, for the two training runs


def data_kind(n: int) -> str:
    """The format of the split's n-th image: every other one a JPEG, one
    BMP (which the native codecs reject), four grayscale PNGs, the rest
    RGB PNGs."""
    if n == 7:
        return "bmp"
    if n % 2 == 0:
        return "jpg"
    return "gray" if n % 160 == 1 else "png"


def write_split(root: str, seed: int) -> list:
    """`<root>/dataset.json` in the schema of tests/_synth.py (a Karpathy
    split) and its images in `<root>/imgs`: smooth random pictures with
    noise, made and saved by a thread pool; sentences of 6-28 words drawn
    from 3,000 words with Zipf frequencies. Returns [(path, kind)] in
    split order."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "imgs"))
    noise = rng.integers(-12, 13, (704, 704, 3), dtype=np.int16)
    words = [f"v{i}" for i in range(3000)]
    zipf = 1.0 / np.arange(1, len(words) + 1)
    zipf /= zipf.sum()

    def save(base, oy, ox, h, w, path, kind):
        arr = np.clip(np.asarray(base.resize((w, h), Image.BICUBIC),
                                 np.int16) + noise[oy:oy + h, ox:ox + w],
                      0, 255).astype(np.uint8)
        if kind == "gray":
            Image.fromarray(arr[:, :, 0], mode="L").save(path,
                                                        compress_level=1)
        elif kind == "jpg":
            Image.fromarray(arr).save(path, quality=90)
        elif kind == "png":
            Image.fromarray(arr).save(path, compress_level=1)
        else:
            Image.fromarray(arr).save(path)

    images, files, n = [], [], 0
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        futures = []
        for split, count in DATA_IMAGES.items():
            for i in range(count):
                h, w = DATA_SHAPES[n % len(DATA_SHAPES)]
                kind = data_kind(n)
                base = Image.fromarray(rng.integers(0, 256, (6, 8, 3),
                                                    np.uint8))
                oy, ox = (int(v) for v in rng.integers(0, 64, 2))
                ext = "png" if kind == "gray" else kind
                name = f"{split}_{i:03d}.{ext}"
                path = os.path.join(root, "imgs", name)
                futures.append(pool.submit(save, base, oy, ox, h, w, path,
                                           kind))
                lengths = rng.integers(6, 29, 5)
                drawn = rng.choice(len(words), size=int(lengths.sum()),
                                   p=zipf)
                cuts = np.cumsum(lengths)[:-1]
                sentences = [{"tokens": [words[t] for t in part]}
                             for part in np.split(drawn, cuts)]
                images.append({"filename": name, "split": split,
                               "sentences": sentences})
                files.append((path, kind))
                n += 1
        for f in futures:
            f.result()
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"dataset": "synthetic", "images": images}, f)
    return files


def phase_data(enc_flat, seed: int) -> dict:
    """The data layer from raw files at the flagship's width: a split on
    disk, `python -m sat_tpu_torch.generate_json_data` (the vocabulary from
    the split), the native loader built from the checkout's source and held
    to PIL on 128 files (a file its codecs do not take: PIL's decode and
    the C++ resize, held to the resize's numpy mirror), with its host
    images/s; `SAT_NATIVE_PREPROC=1 python -m sat_tpu_torch.train
    --cache-features --steps-per-dispatch 4` on a quarter of each split
    and the same run without the toggle (two feature-cache keys; the native
    run's rows decoded natively = its JPEGs and PNGs, where the codecs are
    built); 128 `path` requests
    to the server under the toggle, answered with the caption step's tokens
    of the natively loaded images; `python -m sat_tpu_torch.train_models
    smoke` from a directory whose data/flickr8k is the split."""
    import contextlib
    import hashlib
    import io

    import numpy as np
    import torch
    from sat_tpu_torch.data import native
    from sat_tpu_torch.data.transforms import (load_and_preprocess_image,
                                               pil_loader)
    from sat_tpu_torch.serve import build_parser, build_server
    from sat_tpu_torch.train import main as train_main

    check(os.environ.get("SAT_NATIVE_PREPROC") != "1",
          "data: run without SAT_NATIVE_PREPROC=1 (the phase sets it)")
    res = {"images": DATA_IMAGES, "seconds": {}}
    secs = res["seconds"]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        files = write_split(root, seed + 21)
        secs["write_split"] = time.perf_counter() - t0
        kinds = [k for _, k in files]
        res["files"] = {k: kinds.count(k) for k in sorted(set(kinds))}

        # the data-prep CLI, then the layout of its files
        _, secs["generate_json_data"] = run_cli(
            "generate_json_data", "--split-path",
            os.path.join(root, "dataset.json"), "--data-path", root)
        with open(os.path.join(root, "word_dict.json")) as f:
            word_dict = json.load(f)
        check(sorted(word_dict.values()) == list(range(len(word_dict)))
              and [word_dict[w] for w in ("<start>", "<eos>", "<unk>",
                                          "<pad>")] == [0, 1, 2, 3],
              "data: word_dict.json's ids")
        res["vocab"] = len(word_dict)
        for split, count in DATA_IMAGES.items():
            with open(os.path.join(root, f"{split}_img_paths.json")) as f:
                paths = json.load(f)
            with open(os.path.join(root, f"{split}_captions.json")) as f:
                caps = np.asarray(json.load(f))
            check(len(paths) == caps.shape[0] == 5 * count
                  and caps.shape[1] == CAP_LEN
                  and all(os.path.exists(p) for p in paths[::5])
                  and (caps[:, 0] == 0).all()
                  and ((caps == 1).sum(axis=1) == 1).all(),
                  f"data: the {split} files' layout {caps.shape}")

        # the native loader, built from the checkout's source
        if os.path.exists(native._LIB_PATH):
            os.remove(native._LIB_PATH)
        t0 = time.perf_counter()
        built = native.available()
        res["build_seconds"] = time.perf_counter() - t0
        check(built, "data: the native loader did not build")
        support = native.decode_support()
        decodes = {"jpg": bool(support & 1), "png": bool(support & 2),
                   "gray": bool(support & 2), "bmp": False}
        res["decode_support"] = support
        res["codecs_missing"] = [c for c, bit in (("JPEG", 1), ("PNG", 2))
                                 if not support & bit]
        sample = files[:DATA_CHECKED]
        paths = [p for p, _ in sample]
        one, status = native.load_images(paths, SIZE, n_threads=1)
        pool_rows, pool_status = native.load_images(paths, SIZE)
        check(np.array_equal(status, pool_status)
              and np.array_equal(one[status == native.OK],
                                 pool_rows[status == native.OK]),
              "data: load_images at 1 thread and at all threads differ")
        jpeg_err, resize_err = [], []
        for (path, kind), st, row in zip(sample, status, one):
            check((st == native.OK) == decodes[kind],
                  f"data: {kind} {path} has status {st}")
            rgb = np.asarray(pil_loader(path), np.uint8)
            via_pil = native.resize_normalize(rgb, SIZE)
            if st != native.OK:
                # the tier the file takes: PIL's decode, the C++ resize,
                # held to the resize's numpy mirror
                tier = load_and_preprocess_image(path, SIZE, use_native=True)
                check(np.array_equal(tier, via_pil),
                      f"data: {kind} {path} is not PIL + the C++ resize")
                resize_err.append(float(np.abs(
                    tier - native.resize_normalize_reference(rgb, SIZE))
                    .max()))
                continue
            if kind == "jpg":
                err = np.abs(row - via_pil)
                jpeg_err.append((float(err.max()), float(err.mean())))
            else:
                check(np.array_equal(row, via_pil),
                      f"data: {kind} {path} differs from PIL + resize")
        if resize_err:
            res["resize_max_abs_err"] = max(resize_err)
            check(res["resize_max_abs_err"] < 1e-4,
                  f"data: the C++ resize against its numpy mirror "
                  f"{res['resize_max_abs_err']}")
        if jpeg_err:
            res["jpeg_max_abs_err"] = max(e[0] for e in jpeg_err)
            res["jpeg_mean_abs_err"] = max(e[1] for e in jpeg_err)
            check(res["jpeg_max_abs_err"] < 0.06
                  and res["jpeg_mean_abs_err"] < 0.005,
                  f"data: JPEG rows against PIL {res['jpeg_max_abs_err']} "
                  f"max, {res['jpeg_mean_abs_err']} mean")

        def native_tier():
            rows, st = native.load_images(paths, SIZE)
            for i in np.flatnonzero(st != native.OK):
                rows[i] = load_and_preprocess_image(paths[i], SIZE,
                                                    use_native=True)
            return rows

        def pil_rows():
            return [load_and_preprocess_image(p, SIZE, use_native=False)
                    for p in paths]

        rates = {"native": [], "pil": []}
        for _ in range(3):
            for name, fn in (("native", native_tier), ("pil", pil_rows)):
                t0 = time.perf_counter()
                fn()
                rates[name].append(len(paths) / (time.perf_counter() - t0))
        res["host_images_per_s"] = rates
        res["cpu_count"] = os.cpu_count()

        # training from a quarter of each split, with the toggle (a fresh
        # process) and without (in this process); each run publishes its
        # feature cache
        enc_npz = os.path.join(root, "vgg19.npz")
        np.savez(enc_npz, **enc_flat)
        cache = os.path.join(root, "feature_cache")

        def data_argv(ckpt_dir):
            return ["--data", root, "--tf", "--ado", "--attention",
                    "--cache-features", "--steps-per-dispatch",
                    str(ENTRY_K), "--epochs", "1", "--batch-size",
                    str(TRAIN_B), "--log-interval", "10",
                    "--checkpoint-dir", ckpt_dir, "--encoder-weights",
                    enc_npz, "--feature-cache-dir", cache, "--fraction",
                    str(DATA_FRACTION)]

        def native_rows_of(log):
            m = re.search(r"\((\d+) decoded by the native loader\)", log)
            check(m is not None, "data: no count of native rows printed")
            return int(m.group(1))

        native_dir = os.path.join(root, "model_native")
        log, secs["train_native"] = run_cli(
            "train", *data_argv(native_dir), env={"SAT_NATIVE_PREPROC": "1"})
        res["train_native_rows"] = native_rows_of(log)
        kind_of = dict(files)
        want_rows = 0
        for split in DATA_IMAGES:
            with open(os.path.join(root, f"{split}_img_paths.json")) as f:
                rows = json.load(f)
            want_rows += sum(decodes[kind_of[p]] for p in set(
                rows[:int(len(rows) * DATA_FRACTION)]))
        check(res["train_native_rows"] == want_rows,
              f"data: {res['train_native_rows']} rows decoded natively, "
              f"{want_rows} JPEGs and PNGs")
        res["train_native_bleu"] = _bleu_of(log, "EvalMode.TEST")
        out = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            pil_last = train_main(data_argv(os.path.join(root, "model_pil")))
        torch.cuda.synchronize()
        secs["train_pil"] = time.perf_counter() - t0
        res["train_pil_launches"] = read_launches()
        check(native_rows_of(out.getvalue()) == 0 and "bleu4" in pil_last
              and res["train_pil_launches"]["attention_fwd"] > 0
              and res["train_pil_launches"]["attention_bwd"] > 0,
              f"data: the run without the toggle {pil_last} "
              f"{res['train_pil_launches']}")
        keys = {}
        for name in os.listdir(cache):
            split, key = name[len("feats_"):-len(".npz")].split("_")
            keys.setdefault(split, set()).add(key)
        check(sorted(keys) == ["test", "train", "val"]
              and all(len(k) == 2 for k in keys.values()),
              f"data: feature-cache files {sorted(os.listdir(cache))}")

        # serving the natively trained model from the files under the
        # toggle; each batch the step takes is recorded with its tokens
        os.environ["SAT_NATIVE_PREPROC"] = "1"
        try:
            server = build_server(build_parser().parse_args([
                "--model", os.path.join(native_dir, "model_vgg19_1.npz"),
                "--encoder-weights", enc_npz, "--port", "0",
                "--max-batch", str(DATA_CHECKED), "--batch-window-ms",
                "500"]))
            step, served = server._caption_fn, []

            def recording(arr):
                out = step(arr)
                served.append((arr.copy(), {k: out[k].clone() for k in (
                    "tokens", "length", "score", "found")}))
                return out

            server._caption_fn = recording
            server.start()
            reset_launches()
            t0 = time.perf_counter()
            try:
                with socket.create_connection(("127.0.0.1", server.port),
                                              timeout=300) as sock:
                    f = sock.makefile("rwb")
                    f.write(b"".join(json.dumps({"id": i, "path": p})
                                     .encode() + b"\n"
                                     for i, p in enumerate(paths)))
                    f.flush()
                    replies = [json.loads(f.readline()) for _ in paths]
                torch.cuda.synchronize()
            finally:
                server.stop()
            secs["serve"] = time.perf_counter() - t0
            res["serve_launches"] = read_launches()
            res["serve_stats"] = {k: server.stats[k] for k in (
                "requests", "batches", "errors", "captioned",
                "native_rows")}
            check(res["serve_stats"]["native_rows"]
                  == sum(decodes[k] for _, k in sample)
                  and res["serve_stats"]["captioned"] == len(paths),
                  f"data: serving {res['serve_stats']}")
            check(res["serve_launches"]["topk"] > 0
                  and res["serve_launches"]["attention_fwd"] > 0,
                  f"data: serving launches {res['serve_launches']}")
            ref = {p: load_and_preprocess_image(p, SIZE, use_native=True)
                   for p in paths}
            by_digest = {hashlib.sha1(img.tobytes()).digest(): p
                         for p, img in ref.items()}
            answered = {}
            for arr, out in served:
                rows = [by_digest.get(hashlib.sha1(r.tobytes()).digest())
                        for r in arr]
                check(None not in rows,
                      "data: a served image is not its natively loaded "
                      "tensor")
                want = step(np.stack([ref[p] for p in rows]))
                check(all(same_bits(out[k], want[k]) for k in out),
                      "data: the served tokens differ from the caption "
                      "step's on the natively loaded images")
                host = {k: v.cpu().numpy() for k, v in out.items()}
                for i, p in enumerate(rows):
                    answered.setdefault(p, " ".join(server._decode_tokens(
                        host["tokens"][i], int(host["length"][i]),
                        bool(host["found"][i]))))
            for i, (p, reply) in enumerate(zip(paths, replies)):
                check(reply.get("id") == i
                      and reply.get("caption") == answered.get(p),
                      f"data: reply {reply}, want {answered.get(p)!r}")
        finally:
            os.environ.pop("SAT_NATIVE_PREPROC", None)
        res["serve_batches"] = len(served)

        # the experiment runner, from a directory whose data/flickr8k is
        # the split
        with tempfile.TemporaryDirectory() as runs:
            os.makedirs(os.path.join(runs, "data"))
            os.symlink(root, os.path.join(runs, "data", "flickr8k"))
            log, secs["train_models_smoke"] = run_cli(
                "train_models", "smoke", cwd=runs, timeout=600)
            check("Running:" in log and "Experiment failed" not in log
                  and "EvalMode.TEST Epoch: 1\tBLEU-1 (" in log
                  and os.path.exists(os.path.join(runs, "model",
                                                  "model_vgg19_1.npz")),
                  f"data: train_models smoke: {log[-1500:]}")
    emit({"phase": "data", **res})
    return res


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default="chiprun_out")
    parser.add_argument("--phase", choices=["parallel", "export",
                                            "tensor_parallel"],
                        default=None,
                        help="run only this phase (after device and build; "
                             "parallel on the entry phase's dataset); "
                             "prints no result line")
    # an artifact run of the export phase, started by the phase itself
    parser.add_argument("--artifact-run", type=str, default=None,
                        help=argparse.SUPPRESS)
    # a gloo rank of the parallel phase, started by the phase itself
    parser.add_argument("--parallel-rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--parallel-spec", type=str, default=None,
                        help=argparse.SUPPRESS)
    # a gloo rank of the tensor_parallel phase, started by the phase itself
    parser.add_argument("--tp-rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--tp-spec", type=str, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.parallel_rank is not None:
        parallel_rank(args.parallel_rank, json.loads(args.parallel_spec))
        return
    if args.tp_rank is not None:
        tp_rank(args.tp_rank, json.loads(args.tp_spec))
        return
    if args.phase == "tensor_parallel":
        phase_device()
        phase_build()
        _, _, _, enc_flat, images = make_weights(args.seed)
        res = phase_tensor_parallel(args.seed, enc_flat, images)
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_tensor_parallel.json"),
                  "w") as f:
            json.dump(res, f, indent=1)
        print("chip_smoke: phase tensor_parallel passed (--phase prints no "
              "result line)", flush=True)
        return
    if args.artifact_run is not None:
        artifact_run(json.loads(args.artifact_run))
        return
    if args.phase == "export":
        phase_device()
        phase_build()
        dcfg, dec_flat, worst_flat, enc_flat, images = make_weights(args.seed)
        res = phase_export(dcfg, dec_flat, worst_flat, enc_flat, images)
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_export.json"),
                  "w") as f:
            json.dump(res, f, indent=1)
        print("chip_smoke: phase export passed (--phase prints no result "
              "line)", flush=True)
        return
    if args.phase == "parallel":
        phase_device()
        phase_build()
        dcfg, _, worst_flat, enc_flat, images = make_weights(args.seed)
        with tempfile.TemporaryDirectory() as root:
            enc_path = write_entry_split(root, enc_flat)
            res = phase_parallel(root, enc_path, dcfg, worst_flat, enc_flat,
                                 images)
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_parallel.json"),
                  "w") as f:
            json.dump(res, f, indent=1)
        print("chip_smoke: phase parallel passed (--phase prints no result "
              "line)", flush=True)
        return

    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    dev = phase_device()
    import torch
    build = phase_build()
    lap("device_build")
    gen = torch.Generator().manual_seed(args.seed + 1)
    kernels = phase_kernels(dev, gen)
    lap("kernels")
    dcfg, dec_flat, worst_flat, enc_flat, images = make_weights(args.seed)
    main_res = phase_main(dcfg, dec_flat, worst_flat, enc_flat, images)
    lap("main")
    export = phase_export(dcfg, dec_flat, worst_flat, enc_flat, images)
    lap("export")
    serve = phase_serve(dcfg, dec_flat, enc_flat)
    lap("serve")
    encoders = phase_encoders(args.seed, images)
    wide = encoders.pop("weights")
    lap("encoders")
    sample = phase_sample(dcfg, dec_flat, enc_flat, images, wide)
    lap("sample")
    bert = phase_bert(args.seed, enc_flat, images)
    lap("bert")
    train = phase_train(args.seed, enc_flat)
    lap("train")
    entry = phase_entry(enc_flat, wide, args.seed,
                        (dcfg, worst_flat, enc_flat, images))
    lap("entry_cli_bert_cli_parallel")
    tensor_parallel = phase_tensor_parallel(args.seed, enc_flat, images)
    lap("tensor_parallel")
    data = phase_data(enc_flat, args.seed)
    lap("data")
    emit({"phase_seconds": seconds})

    # each kernel's launches on its path: for top-k and the forward, the
    # main path's replayed batch, counted on the device by the profiler
    # (`host_launches`: the wrappers' count of its first, capturing
    # batch); for the backward, one default train step, eager, whose
    # wrapper count the profiler confirmed (its blocks are in the train
    # phase)
    # (the bf16 variants: the bf16 main path's replayed batch and one bf16
    # train step)
    # (the rows at this slice's shapes: the encoders phase's replayed
    # batches, f32 and bf16; the sample phase's replayed ResNet152 batch at
    # each k; the DenseNet161 CLI epoch's host count of the backward, its
    # blocks' warm-up and capture)
    wide_paths = {f"attention_fwd{v}_d{Dx}": (encoders[net], m,
                                              f"attention_fwd{v}")
                  for net, Dx in WIDE.items()
                  for v, m in (("", "f32"), ("_bf16", "bf16"))}
    # (the BERT rows: the bert phase's replayed batches, f32, bf16 and
    # sampled at each k, and its f32 and bf16 train steps)
    bert_paths = {
        "topk_bert": (bert["device_launches"], bert["host_launches"],
                      "topk"),
        "attention_fwd_e768": (bert["device_launches"],
                               bert["host_launches"], "attention_fwd"),
        "attention_fwd_bf16_e768": (bert["bf16"]["device_launches"],
                                    bert["bf16"]["host_launches"],
                                    "attention_fwd_bf16"),
        "attention_bwd_e768": (bert["train"]["profile"]["kernel_calls"],
                               bert["train"]["launches"], "attention_bwd"),
        "attention_bwd_bf16_e768": (
            bert["train"]["bf16_profile"]["kernel_calls"],
            bert["train"]["bf16_launches"], "attention_bwd_bf16"),
        **{f"topk_bert_k{k}": (bert["sample"][f"k{k}"]["device_launches"],
                               counts(), "topk") for k in SAMPLE_KS},
        **{f"topk_bert_k{k}": (v["device_launches"], counts(), "topk")
           for k, v in bert["sample"]["by_k"].items()}}
    for row in kernels:
        name = row["name"]
        if name == "topk_tp":
            # model rank 0's beam in the tensor_parallel phase (eager: its
            # host count is its device count)
            row["launches"] = row["host_launches"] = tensor_parallel["a"][
                "beam"]["worst"]["launches"][0]["topk"]
        elif name in bert_paths:
            device, host, kname = bert_paths[name]
            row["launches"], row["host_launches"] = device[kname], host[kname]
        elif name in wide_paths:
            res, mode, kname = wide_paths[name]
            row["launches"] = res["device_launches"][mode][kname]
            row["host_launches"] = res["host_launches"][mode][kname]
        elif name.startswith("topk_k"):
            # the sample phase's replayed batches: ResNet152's at k = 10
            # and 50, the flagship's at the other k
            k = name.rsplit("_k", 1)[1]
            launches = sample["device_launches"]
            row["launches"] = launches.get(f"resnet152_k{k}",
                                           launches.get(f"vgg19_k{k}"))["topk"]
            row["host_launches"] = 0
        elif name == "attention_bwd_d2208":
            row["launches"] = row["host_launches"] = entry[
                "densenet161_launches"]["attention_bwd"]
        elif name == "attention_bwd":
            row["launches"] = train["profile"]["kernel_calls"][name]
            row["host_launches"] = train["launches"]["remat"][name]
        elif name == "attention_bwd_bf16":
            row["launches"] = train["bf16"]["profile"]["kernel_calls"][name]
            row["host_launches"] = train["bf16"]["launches"][name]
        elif name == "attention_fwd_bf16":
            row["launches"] = main_res["bf16"]["device_launches"][name]
            row["host_launches"] = main_res["bf16"]["host_launches"][name]
        else:
            row["launches"] = main_res["device_launches"][name]
            row["host_launches"] = main_res["host_launches"][name]
    summary = {"kernels": [{k: row.get(k) for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "sort_ms",
        "bound_share", "cold_ms", "host_launches", "shape")}
        for row in kernels]}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"device": dev, "build_seconds": build["seconds"],
                   "phase_seconds": seconds,
                   "build_log": build["log"], "kernels": kernels,
                   "main": main_res, "export": export, "serve": serve,
                   "encoders": encoders,
                   "sample": sample, "bert": bert, "train": train,
                   "entry": entry, "tensor_parallel": tensor_parallel,
                   "data": data}, f,
                  indent=1)
    emit(summary)
    print(dev["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
    sys.exit(0)
