"""Runs one cell of the benchmark of ``kwok_tpu_torch`` once.

    python3 -m kwokbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards.
It fails, printing no result, when PyTorch sees fewer cards than the
cell asks for.  Set-up (counted in ``setup_s`` from this module's start)
builds the cell from the seed and warms it; the window lasts
``--seconds``; then the run is checked against the plain reference.
Earlier lines of standard output say what was run and counted; the last
is one JSON object: ``correct``, ``attempted``, ``failed``, the metrics
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), the device, a breakdown of the traced window, and
every number compared beside its limit (``checks``), which also close
standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from kwokbench import spec  # noqa: E402
from kwokbench.outcome import Ctx, Result  # noqa: E402

#: top-level module names that may not be loaded in a run: JAX, and the
#: JAX package the port was made from (``kwok_tpu_torch`` is another name)
BLOCKED = ("jax", "jaxlib", "flax", "kwok_tpu")
#: where the program's build and kernel caches go, inside the checkout
CACHE = ".kwokbench-cache"


def blocked_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BLOCKED))


def environment(root: str) -> None:
    """Caches at fixed paths inside the checkout; nothing that loads JAX."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("KWOK_TORCH_DEVICE", None)


def card() -> str:
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    return line.splitlines()[0] if line else "nvidia-smi: no answer"


def result_line(ctx: Ctx, res: Result, device: dict) -> dict:
    cell = ctx.cell
    metrics = {}
    if ctx.trace:
        for m in cell.per_layer:
            value = cell.readers[m.name](res.layer)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
        if res.busy_s is not None:
            device = dict(device, busy_s=res.busy_s, window_s=res.window_s)
    else:
        for m in cell.end_to_end:
            metrics[m.name] = {"value": res.e2e[m.name], "unit": m.unit}
    line = {"correct": res.correct, "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics, "device": device}
    if ctx.trace and res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in res.checks}
    return line


def report(ctx: Ctx, res: Result, device: dict) -> int:
    """Prints the result; 3 when a blocked module was loaded."""
    found = blocked_modules()
    if found:
        print(f"kwokbench: modules loaded that a run may not load: {found}", file=sys.stderr)
        return 3
    line = result_line(ctx, res, device)
    for name, v, lim in res.checks:
        print(f"check {name}: {v} (limit {lim}){'' if v <= lim else ' FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kwokbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment(spec.ROOT)
    cell = spec.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"kwokbench: {cell.name} needs {cell.chips} CUDA card(s); PyTorch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    ctx = Ctx(cell, args.seed, args.seconds, bool(args.trace), device="cuda", t0=T0)
    res = spec.driver(cell).run(ctx)
    ctx.log(f"kwokbench {cell.name} seed {args.seed} seconds {args.seconds} trace {args.trace}: "
            f"{card()}; torch {torch.__version__} cuda {torch.version.cuda}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": res.memory_peak_bytes}
    return report(ctx, res, device)


if __name__ == "__main__":
    sys.exit(main())
