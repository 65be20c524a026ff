"""BENCHMARK.json against the contract's form, and what it names."""

import json

import pytest

from satbench import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["satbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "satbench"]


def names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(names()),
                         ids=lambda x: x if isinstance(x, str)
                         else x["name"])
def test_names_units_and_keys(group, entry):
    assert spec.NAME.fullmatch(entry["name"])
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}[group]
    assert set(entry) <= allowed
    if group in ("end_to_end", "per_layer"):
        assert spec.UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    if group == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_unique_names():
    for group in ("configs", "workloads"):
        got = [e["name"] for e in BENCH[group]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_every_cell_loads_with_what_it_names():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = spec.load(w["name"])
        assert w["chips"] in (1, 4)
        assert spec.NAME.fullmatch(w["traffic"])
        assert (spec.HERE / "drivers"
                / f"{cell.traffic['driver']}.py").exists()
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert reported <= e2e and cell.per_layer and cell.limits
        for m in cell.per_layer:
            assert m["moves"] in reported
            assert callable(spec.reader(m["name"]))


def test_configs_used_and_files_own():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("satbench/")
        got = json.loads((spec.ROOT / c["file"]).read_text())
        assert got["name"] == c["name"] and c["reduced"] == []


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
