"""A configuration, a cell and a per-layer metric added as files and
entries alone, in a copy of the benchmark, are found by name."""

import json

from satbench import spec


def test_added_files_are_found(bench_copy):
    here = bench_copy / "satbench"
    cfg = json.loads((here / "configs" / "vgg19-att-ado.json").read_text())
    cfg["name"] = "vgg19-att-ado.copy"
    (here / "configs" / "vgg19-att-ado.copy.json").write_text(
        json.dumps(cfg))
    (here / "traffic" / "beam5.b64.json").write_text(json.dumps(
        {"driver": "caption", "batch": 64, "beam": 5, "pool": 512,
         "contrast": [0.25, 4.0, 8]}))
    (here / "workloads" / "caption.copy.b64.json").write_text(json.dumps(
        {"traffic": {"stop_boost": 0.5}, "limits": {"score_gap": 1e-5}}))
    (here / "metrics" / "batches_per_s.py").write_text(
        "def read(trace):\n    return trace.get('batches_per_s')\n")
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "vgg19-att-ado.copy", "source": "x",
                             "file": "satbench/configs/"
                                     "vgg19-att-ado.copy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "caption.copy.b64",
                               "config": "vgg19-att-ado.copy",
                               "traffic": "beam5.b64", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "captions_per_s":
            m["workloads"].append("caption.copy.b64")
    bench["per_layer"].append({"name": "batches_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "Caption step (engine/serving.py)",
                               "moves": "captions_per_s"})
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load("caption.copy.b64", root=bench_copy)
    assert cell.config["name"] == "vgg19-att-ado.copy"
    assert cell.traffic["batch"] == 64 and cell.traffic["stop_boost"] == 0.5
    assert cell.limits == {"score_gap": 1e-5}
    assert {m["name"] for m in cell.end_to_end} == {"captions_per_s",
                                                    "setup_s"}
    layer = {m["name"] for m in cell.per_layer}
    assert "batches_per_s" in layer          # no workloads key: every cell
    assert "encoder_ms" not in layer         # listed for other cells only
    read = spec.reader("batches_per_s", root=bench_copy)
    assert read({"batches_per_s": 4.5}) == 4.5
    # the cells already there are untouched by the additions
    assert spec.load("caption.vgg19-att-ado.b128",
                     root=bench_copy).limits == spec.load(
        "caption.vgg19-att-ado.b128").limits
