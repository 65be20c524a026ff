"""One run of one cell of the port's benchmark.

    python -m satbench --workload NAME --seed N --seconds S --trace 0|1

loads the cell, makes its weights and inputs on the card from the seed,
warms up every shape its traffic uses (set-up, `setup_s`), measures for S
seconds, checks what the timed path produced against the plain reference
(satbench/reference), and prints, as the last line of standard output, one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics), `device`,
with `--trace 1` a `breakdown`, and last `compared`: each number the check
compared with its limit. The same numbers are the last lines of standard
error. Everything else goes to standard error.

Options for the benchmark's own readings, which a check never passes:
`--control tf32` puts the reference in the program's place with TF32 on
(the comparison's control) and prints, in place of the result, a line
`{"control", "correct", "compared"}` judged by the cell's limits, which
has to read not correct; `--fault NAME` plants a fault in the program
(satbench/faults.py); `--sweep R1,R2,...` runs a serving cell's window at
each request rate after one set-up, to find the knee, one line a rate.

Without a CUDA card, or with fewer cards than the cell asks for, the run
prints no result and exits with 2. It exits with 3, and prints no result,
if a module of JAX or of the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

from satbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sat_tpu")
CACHE = spec.ROOT / ".satbench_cache"


@dataclass
class Context:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    fault: str | None = None
    t0: float = T0

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def log(self, **fields) -> None:
        print(json.dumps(fields, default=str), file=sys.stderr, flush=True)

    def mark(self, stage: str) -> None:
        """Log the host seconds from the process's start to a stage of
        set-up."""
        self.log(stage=stage, at_s=time.perf_counter() - self.t0)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def use_cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    checkout's first run builds (the port's own nvcc build is in
    sat_tpu_torch/ops/build/ there already)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def driver(cell: spec.Cell):
    return importlib.import_module(
        f"satbench.drivers.{cell.traffic['driver']}")


def execute(ctx: Context, control: str | None = None) -> dict:
    """One run of the cell's driver, or with `control` the control in the
    program's place, with its compared numbers judged by the cell's
    limits."""
    drv = driver(ctx.cell)
    out = {"numbers": drv.control(ctx), "failed": 0} if control else \
        drv.run(ctx)
    out["compared"] = [
        (k, out["numbers"].get(k, math.inf), v,
         out["numbers"].get(k, math.inf) <= v)
        for k, v in ctx.cell.limits.items()]
    out["correct"] = (all(ok for *_, ok in out["compared"])
                      and out["failed"] == 0)
    return out


def per_layer(cell: spec.Cell, trace: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"])(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(cell: spec.Cell, peak: int) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips, "memory_peak_bytes": peak}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(smi.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = "not measured"
    return info


def result(ctx: Context, out: dict) -> dict:
    cell = ctx.cell
    if ctx.trace:
        metrics = per_layer(cell, out["trace"])
    else:
        metrics = {m["name"]: {"value": (out["setup_s"]
                                         if m["name"] == "setup_s"
                                         else out["e2e"][m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    res = {"correct": out["correct"], "attempted": out["attempted"],
           "failed": out["failed"], "metrics": metrics,
           "device": device_info(cell, out["memory_peak_bytes"])}
    if ctx.trace:
        prof = out["trace"]["profile"]
        res["device"]["busy_s"] = prof.get("busy_s", 0.0)
        res["device"]["window_s"] = prof.get("window_s", 0.0)
        res["breakdown"] = {"device_ops": [r[:2] for r in
                                           prof.get("ops", [])[:10]],
                            "idle_gaps": prof.get("gaps", [])[:10]}
    res["compared"] = compared(out)
    return res


def compared(out: dict) -> dict:
    """Each compared number beside its limit."""
    return {k: {"value": v, "limit": lim} for k, v, lim, _ in out["compared"]}


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python -m satbench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32",), default=None)
    p.add_argument("--sweep", default=None,
                   help="comma-separated request rates: a serving cell's "
                        "knee sweep, one line a rate, and no result")
    p.add_argument("--fault", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    use_cache_dirs()
    cell = spec.load(args.workload)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"satbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this host has {cards}; no result", file=sys.stderr)
        return 2
    if args.sweep:
        driver(cell).sweep(Context(cell, args.seed, args.seconds, False),
                           [float(r) for r in args.sweep.split(",")])
        return 0
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace),
                  fault=args.fault)
    out = execute(ctx, args.control)
    found = forbidden_modules()
    if found:
        print(f"satbench: the process loaded {found}; no result",
              file=sys.stderr)
        return 3
    if args.control:
        ctx.log(control=args.control, numbers=out["numbers"])
        res = {"control": args.control, "correct": out["correct"],
               "compared": compared(out)}
    else:
        res = result(ctx, out)
    for k, v in res["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(finite(res)), flush=True)
    return 0


def finite(obj):
    """`obj` with every non-finite float as null, so the line is JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj
