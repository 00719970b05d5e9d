"""A later configuration, mix and per-layer metric are new files and
entries alone: dropped into a copy of the benchmark, they are found,
and no file that was there changes."""

import hashlib
import json
import os
import shutil

from kwokbench import spec


def digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    here = tmp_path / "kwokbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(here)
    with open(spec.ROOT + "/BENCHMARK.json") as f:
        bench = json.load(f)

    cfg = json.loads((here / "configs" / "chaos-10k.json").read_text())
    cfg.update(name="chaos-1k", pods=1000, reduced=["pods"])
    (here / "configs" / "chaos-1k.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "sim.json").read_text())
    mix["sample_pod_rows"] = 8
    (here / "traffic" / "sim-small.json").write_text(json.dumps(mix))
    (here / "metrics" / "simulator.macro_ticks.py").write_text(
        "def read(data):\n    return float(data['macro_ticks'])\n")
    bench["configs"].append({"name": "chaos-1k", "source": "x", "file": "kwokbench/configs/chaos-1k.json",
                             "reduced": ["pods"], "why": "x"})
    bench["workloads"].append({"name": "chaos-1k.sim-small", "config": "chaos-1k",
                               "traffic": "sim-small", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("chaos-1k.sim-small")
    bench["per_layer"].append({"name": "simulator.macro_ticks", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "simulator",
                               "moves": "sim_macro_tick_ms", "workloads": ["chaos-1k.sim-small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("chaos-1k.sim-small", here=str(here))
    assert cell.config["pods"] == 1000 and cell.traffic["sample_pod_rows"] == 8
    assert [m.name for m in cell.per_layer] == ["simulator.macro_ticks"]
    assert cell.readers["simulator.macro_ticks"]({"macro_ticks": 7}) == 7.0
    assert {m.name for m in cell.end_to_end} == {"sim_macro_tick_ms", "setup_s"}
    assert spec.driver(cell).__name__ == "kwokbench.drivers.simulator"
    after = digest(here)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_cell_of_the_benchmark_loads():
    with open(spec.ROOT + "/BENCHMARK.json") as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.per_layer and len(cell.end_to_end) >= 2
        assert "setup_s" in {m.name for m in cell.end_to_end}
        for m in cell.per_layer:
            assert m.moves in {e.name for e in cell.end_to_end}
