"""Reads a cell's check on many seeds, beside its control's readings.

    python3 -m kwokbench.control --workload <name> --seeds <a,b,c> --seconds <s>

The control is the reference put in the program's place one step
weaker than the configuration states: for ``chaos-10k`` the reference
computed with bfloat16 draws where the simulator draws float32; for
``kwokctl-ci`` the client's own observations with one acknowledged
delete lost.  It has to come out not correct.  One JSON line a seed:
the program's numbers compared and the control's.  A driver with a
``many(ctx, seeds)`` reads all seeds in one set-up; otherwise each seed
is a run of its own in this process.  The benchmark's runs never call
this; the limits in ``PERF.md`` are set from what it prints.
"""

from __future__ import annotations

import argparse
import json
import sys

from kwokbench import spec
from kwokbench.outcome import Ctx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kwokbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    driver = spec.driver(cell)
    if hasattr(driver, "many"):
        rows = driver.many(Ctx(cell, seeds[0], args.seconds, False, control=True), seeds)
    else:
        rows = []
        for seed in seeds:
            res = driver.run(Ctx(cell, seed, args.seconds, False, control=True))
            rows.append((seed, res.checks, res.control))
    for seed, checks, control in rows:
        print(json.dumps({"seed": seed,
                          "program": {n: v for n, v, _ in checks},
                          "limits": {n: lim for n, _, lim in checks},
                          "program_correct": all(v <= lim for _, v, lim in checks),
                          "control": dict(control),
                          "control_correct": all(dict(control).get(n, v) <= lim
                                                 for n, v, lim in checks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
