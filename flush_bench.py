#!/usr/bin/env python3
"""Time the port's dirty-row flush on one GPU, for one checkout.

    python3 flush_bench.py [--tree DIR]

Builds the 1,000,000-pod simulator of ``chip_smoke.py``'s phase 3 from
the ``kwok_tpu_torch`` package of DIR (this file's checkout by default)
and times, on the host clock up to the end of the work on the card:

- ``DeviceSimulator._flush_pending`` at 20,000 and 30,000 pending rows
  (the host mirror synced first, so each flush writes back what the SoA
  holds), the median of 20 flushes; where the checkout packs its batch
  with ``ops.tick.pack_batch``, also the median of each part: the
  pending set to an array, the pack (gather and range check), the copy
  and launch, and the wait for the card;
- the pod macro-tick of K=8 right after each of 9 churns of
  ``chip_smoke.py``'s shape (10,000 rows released, 10,000 deleted and
  10,000 admitted), which carries the churn's flush, against the median
  of the nine macro-ticks that follow each churn.

Prints one JSON line with the card's name and power limit.  Two
checkouts are compared only within one run on one card, in turns:
parent, change, change, parent, each in its own process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_PODS = 1_000_000
CHURN = 10_000
FLUSH_ROWS = (20_000, 30_000)
REPS = 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)),
                    help="checkout whose kwok_tpu_torch is timed")
    tree = os.path.abspath(ap.parse_args().tree)
    if not torch.cuda.is_available():
        print("flush_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    import kwok_tpu_torch
    from chip_smoke import new_pod
    from kwok_tpu_torch.engine.simulator import DeviceSimulator
    from kwok_tpu_torch.ops import kernels
    from kwok_tpu_torch.ops import tick as T
    from kwok_tpu_torch.parallel.mesh import ROW_FIELDS
    from kwok_tpu_torch.stages import load_builtin

    if not kwok_tpu_torch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"kwok_tpu_torch imported from {kwok_tpu_torch.__file__}, not {tree}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    kernels.build(("tick.cu", "scatter.cu"))
    sim = DeviceSimulator(load_builtin("pod-general") + load_builtin("pod-chaos"),
                          capacity=N_PODS, seed=0)
    sim.admit_bulk(new_pod(), N_PODS)
    sim.to_device()
    for _ in range(13):
        sim.tick_many_async(100, 8)[0].cpu()
    out = {"tree": tree, "device": smi}
    split = hasattr(T, "pack_batch")
    for k in FLUSH_ROWS:
        sim._ensure_synced()
        rows = np.random.default_rng(13).choice(N_PODS, k, replace=False).tolist()
        times = []
        for i in range(REPS + 1):
            sim._pending.update(rows)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim._flush_pending()
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t0)
        out[f"flush_{k}_median_ms"] = float(np.median(times)) * 1e3
        if not split:
            continue
        parts = {p: [] for p in ("set_to_array", "pack", "copy_and_launch", "wait")}
        for i in range(REPS + 1):
            sim._pending.update(rows)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            arr = np.fromiter(sim._pending, np.int32, len(sim._pending))
            sim._pending.clear()
            t1 = time.perf_counter()
            batch = T.pack_batch(arr, tuple(getattr(sim, f) for f in ROW_FIELDS), N_PODS,
                                 sim.device, take=True)
            t2 = time.perf_counter()
            T.scatter_packed(sim._soa, batch)
            t3 = time.perf_counter()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            if i:
                for p, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                    parts[p].append(v)
        out[f"flush_{k}_split_median_ms"] = {p: float(np.median(v)) * 1e3
                                             for p, v in parts.items()}
    perm = np.random.default_rng(3).permutation(N_PODS)
    after, other = [], []
    for c in range(9):
        lo = 2 * c * CHURN
        for row in perm[lo:lo + CHURN].tolist():
            sim.release(row)
        at = sim.now_ms + 2_000
        for row in perm[lo + CHURN:lo + 2 * CHURN].tolist():
            sim.request_delete(row, at)
        for i in range(CHURN):
            sim.admit(new_pod(N_PODS + c * CHURN + i))
        t0 = time.perf_counter()
        sim.tick_many(100, 8)
        after.append(time.perf_counter() - t0)
        for _ in range(9):
            t0 = time.perf_counter()
            sim.tick_many(100, 8)
            other.append(time.perf_counter() - t0)
    out["after_churn_macro_tick_mean_ms"] = float(np.mean(after)) * 1e3
    out["other_macro_tick_median_ms"] = float(np.median(other)) * 1e3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
