"""Finds a cell's parts by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own, found by name:

- ``configs/<config>.json``: the configuration (sizes, stages,
  guarantees), with its plain reference named inside it;
- ``traffic/<traffic>.json``: the traffic mix, whose ``driver`` key names
  the general generator in ``drivers/`` that reads it;
- ``metrics/<metric>.py``: the reader of a per-layer metric, a function
  ``read(data)`` that returns a number or ``None`` when the run holds
  nothing to read.

So a later cell, mix or metric is new files and entries, never an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    bound: Optional[float] = None
    layer: Optional[str] = None
    moves: Optional[str] = None
    workloads: Optional[List[str]] = None

    def reported_in(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    here: str = HERE
    readers: Dict[str, Callable] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(here: str, name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``; names hold dots, so the file is
    loaded by its path."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"kwokbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(cell: Cell):
    return importlib.import_module(f"kwokbench.drivers.{cell.traffic['driver']}")


def load_cell(workload: str, benchmark: Optional[str] = None, here: str = HERE) -> Cell:
    bench = _json(benchmark or os.path.join(os.path.dirname(here), "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in bench['workloads']]}")
    config = _json(os.path.join(here, "configs", f"{entry['config']}.json"))
    traffic = _json(os.path.join(here, "traffic", f"{entry['traffic']}.json"))
    e2e = [Metric(**m) for m in bench["end_to_end"]]
    layer = [Metric(**m) for m in bench["per_layer"]]
    e2e = [m for m in e2e if m.reported_in(workload)]
    names = {m.name for m in e2e}
    # a per-layer metric without a list of cells is reported wherever
    # the end-to-end metric it moves is
    layer = [m for m in layer
             if (m.workloads is None and m.moves in names) or workload in (m.workloads or ())]
    cell = Cell(entry, config, traffic, e2e, layer, here=here)
    cell.readers = {m.name: load_reader(here, m.name) for m in cell.per_layer}
    return cell
