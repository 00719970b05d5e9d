"""Sweeps the rate of an open-loop cell on one cluster, to find the
highest rate it sustains.

    python3 -m kwokbench.sweep --workload kwokctl-ci.pod-stream --seed <n> \\
        --seconds 20 --rates 40,80,160

Sets up the cell's cluster once, then runs its loop at each rate in
turn, each with its own pods, and prints one JSON line a rate: the
latencies from due to Running (median, 95th and 99th percentile), the
median of each fifth of the arrivals in order (a backlog that grows
through the window shows as fifths that rise), the scheduler's binds,
the pods never Running, and how late the generator ran.  The
benchmark's runs do not use it; a cell's fixed rate is set from it.
"""

from __future__ import annotations

import argparse
import json
import sys

from kwokbench import spec, stats
from kwokbench.drivers import kwokctl_stream as stream
from kwokbench.outcome import Ctx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kwokbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    mix = cell.traffic
    ctx = Ctx(cell, args.seed, args.seconds, False)
    with stream.Cluster(ctx) as c:
        ctx.log(c.up())
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            w = c.loop(f"sweep{i}-", rate, args.seconds, float(mix["delete_after_s"]),
                       args.seed + i, float(mix["settle_s"]))
            ctx.log(stream.describe(w, rate))
            order = sorted(w["recs"].values(), key=lambda r: r["due"])
            lat = [r["running_t"] - r["due"] if r["running_t"] is not None else None
                   for r in order]
            fifth = max(1, len(lat) // 5)
            fifths = [stats.percentile([x for x in lat[i * fifth:(i + 1) * fifth] if x is not None],
                                       0.5) for i in range(5)]
            print(json.dumps({
                "rate_per_s": rate, "pods": w["n"],
                "never_running": sum(x is None for x in lat),
                "running_p50_s": stats.percentile(w["running_s"], 0.5),
                "running_p95_s": stats.percentile(w["running_s"], 0.95),
                "running_p99_s": stats.percentile(w["running_s"], 0.99),
                "p50_by_fifth_of_arrivals_s": fifths,
                "bind_p50_s": stats.percentile(w["bind_s"], 0.5),
                "bind_p95_s": stats.percentile(w["bind_s"], 0.95),
                "running_after_bind_p95_s": stats.percentile(w["running_after_bind_s"], 0.95),
                "generator_late_max_s": max(w["late"], default=0.0),
                "apiserver_request_ms": (w["api_seconds"] / w["api_requests"] * 1e3
                                         if w["api_requests"] else None),
                "checks": {n: v for n, v, _ in stream.judge(ctx, w, set(c.view.node_names),
                                                            c.n_nodes)[0]},
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
