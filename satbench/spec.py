"""What a run reads, found by name: the cell in BENCHMARK.json, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`, whose "driver" names the generator in
`drivers/`), its own file (`workloads/<cell>.json`: the limits of its
check, and traffic parameters of this cell alone, such as a serving
rate, which override the mix's), and the readers of its
per-layer metrics (`metrics/<metric>.py`). A configuration, a cell or a
metric is added by adding its files and its entry in BENCHMARK.json."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def applies(metric: dict, cell: str, reported=None) -> bool:
    """Whether `metric` is reported in `cell`: its workloads list names
    the cell, or it has none and (for a per-layer metric) the cell reports
    the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load(workload: str, benchmark: Path | None = None,
         root: Path | None = None) -> Cell:
    """The cell `workload` of BENCHMARK.json with every file it names."""
    root = root or ROOT
    bench = json.loads((benchmark or root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"satbench: no workload {workload!r} in "
                         f"BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    here = root / "satbench"
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    own = json.loads((here / "workloads" / f"{workload}.json").read_text())
    traffic |= own.get("traffic", {})
    limits = own["limits"]
    e2e = [m for m in bench["end_to_end"] if applies(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m, workload, names)]
    return Cell(workload, w["chips"], config, traffic, limits, e2e, layer)


def reader(metric: str, root: Path | None = None):
    """The `read(trace) -> float | None` of a per-layer metric."""
    path = (root or ROOT) / "satbench" / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"satbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
