"""Reduces a ``torch.profiler`` trace of one window to what the
per-layer metrics read.

The profile is exported as a Chrome trace and read back, which keeps
this independent of the profiler's Python API across versions.  Device
work is every event of the kinds ``kernel``, ``gpu_memcpy`` and
``gpu_memset``; the window is the host annotation ``WINDOW`` that the
driver puts around it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "kwokbench.window"
#: device work launched inside a host annotation with this prefix is the
#: harness's own (a traced run's counts), not the program's: left out
HARNESS = "kwokbench.harness"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_events(events: List[dict]) -> Optional[dict]:
    """From Chrome-trace events: the window's length, the device's busy
    seconds in it (the union of its operations), seconds by device
    operation name, copies by direction, and idle seconds by what the
    host was doing.  ``None`` when the window is missing."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    own = _merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                  if e.get("cat") == "user_annotation" and str(e.get("name")).startswith(HARNESS)])
    starts_own = [s for s, _ in own]

    def harness(ts):
        i = bisect.bisect_right(starts_own, ts) - 1
        return i >= 0 and own[i][1] >= ts

    skip = {(e.get("args") or {}).get("correlation") for e in events
            if e.get("cat") == "cuda_runtime" and own and harness(float(e["ts"]))}
    skip.discard(None)
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        if t <= w0 or s >= w1:
            continue
        s, t = max(s, w0), min(t, w1)
        if e.get("cat") in DEVICE_CATS:
            if (e.get("args") or {}).get("correlation") not in skip:
                dev.append((s, t, e["name"], e["cat"]))
        elif e.get("cat") in HOST_CATS and e.get("name") != WINDOW:
            host.append((s, t, e["name"]))
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for s, t, name, _ in dev:
        by_name[name][0] += 1
        by_name[name][1] += (t - s) * 1e-6
    busy = _merge([(s, t) for s, t, _, _ in dev])
    busy_s = sum(t - s for s, t in busy) * 1e-6
    # idle gaps, each named by the innermost host event over its middle
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    host.sort()
    starts = [h[0] for h in host]
    edges = sorted({x for h in host for x in h[:2]})

    def innermost(at: float) -> str:
        i = bisect.bisect_right(starts, at) - 1
        for j in range(i, max(-1, i - 64), -1):
            if host[j][1] >= at:
                return host[j][2]
        return "host: no traced call"

    # each gap is cut where a host event starts or ends, and each piece
    # is named by the innermost host event over its middle
    idle: Dict[str, float] = defaultdict(float)
    for s, t in gaps:
        cuts = edges[bisect.bisect_right(edges, s):bisect.bisect_left(edges, t)]
        for a, b in zip([s] + cuts, cuts + [t]):
            idle[innermost((a + b) / 2)] += (b - a) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "ops": {k: {"count": v[0], "seconds": v[1]} for k, v in by_name.items()},
        "idle": dict(idle),
    }


def profile_events(prof) -> List[dict]:
    """Exports ``prof`` into the run's temporary directory, reads it
    back and deletes the file."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="kwokbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def reduce_profile(prof) -> Optional[dict]:
    return reduce_events(profile_events(prof))


def reduce_device(events: List[dict], window_s: float) -> dict:
    """For a trace of device work alone, over a window of ``window_s``
    seconds that it spans: busy seconds and seconds by operation."""
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
           if e.get("ph") == "X" and "dur" in e and e.get("cat") in DEVICE_CATS]
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for s, t, name in dev:
        by_name[name][0] += 1
        by_name[name][1] += (t - s) * 1e-6
    busy = sum(t - s for s, t in _merge([(s, t) for s, t, _ in dev])) * 1e-6
    return {"window_s": window_s, "busy_s": busy,
            "ops": {k: {"count": v[0], "seconds": v[1]} for k, v in by_name.items()}}


def top(items: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(red: dict) -> dict:
    return {"device_ops": top({k: v["seconds"] for k, v in red["ops"].items()}),
            "idle_gaps": top(red["idle"])}


def seconds_where(red: dict, pred) -> Tuple[int, float]:
    """(count, seconds) of the device operations whose name passes ``pred``."""
    hits = [v for k, v in red["ops"].items() if pred(k)]
    return sum(v["count"] for v in hits), sum(v["seconds"] for v in hits)
