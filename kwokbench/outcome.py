"""What a driver is given and what it hands back."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kwokbench.spec import Cell


@dataclass
class Ctx:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    #: the torch device the program runs on: ``cuda`` on the card; the
    #: CPU tests pass ``cpu`` and smaller sizes in ``scale``
    device: str = "cuda"
    #: the harness's start on the host clock (``time.perf_counter``)
    t0: float = field(default_factory=time.perf_counter)
    #: sizes that replace the configuration's, for the CPU tests only
    scale: Dict[str, int] = field(default_factory=dict)
    #: also read the control (``kwokbench.control``), never in a benchmark run
    control: bool = False

    def size(self, key: str) -> int:
        return int(self.scale.get(key, self.cell.config[key]))

    def log(self, msg: str) -> None:
        print(msg, flush=True)

    def warn(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


@dataclass
class Result:
    #: end-to-end metrics by name (host clock)
    e2e: Dict[str, float]
    #: what the per-layer readers read (traced runs)
    layer: dict
    attempted: int
    failed: int
    #: (name, value, limit): the run is correct when every value is at
    #: most its limit
    checks: List[Tuple[str, float, float]]
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    #: the control's readings (``Ctx.control``): (name, value)
    control: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return all(v <= lim for _, v, lim in self.checks)
