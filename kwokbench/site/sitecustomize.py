"""Profiles the kwok daemon's card over a benchmark window.

``kwokbench.drivers.kwokctl_stream`` puts this directory on the
``PYTHONPATH`` of the cluster it starts, in traced runs only, with
``KWOKBENCH_PROFILE_DIR`` naming a directory.  In the component whose
``KWOK_COMPONENT_NAME`` is ``kwok-controller`` (kwokctl sets it) a
thread waits for the file ``start`` there, records the card's work
with ``torch.profiler`` until the file ``stop`` appears, and writes
``daemon.json``: the window, the device's busy seconds, seconds by
operation and the process's peak device memory.  Every other process
returns at once.
"""

import os


def _profile(directory: str) -> None:
    import json

    try:
        out = _window(directory)
    except Exception as exc:  # the harness reads the failure instead of waiting
        out = {"error": f"{type(exc).__name__}: {exc}"}
    tmp = os.path.join(directory, "daemon.json.tmp")
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, os.path.join(directory, "daemon.json"))


def _window(directory: str) -> dict:
    import time

    start, stop = os.path.join(directory, "start"), os.path.join(directory, "stop")
    while not os.path.exists(start):
        time.sleep(0.05)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kwokbench import devtrace

    prof = profile(activities=[ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    prof.__enter__()
    while not os.path.exists(stop):
        time.sleep(0.05)
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    out = devtrace.reduce_device(devtrace.profile_events(prof), window)
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    return out


def _arm() -> None:
    directory = os.environ.get("KWOKBENCH_PROFILE_DIR")
    if directory and os.environ.get("KWOK_COMPONENT_NAME") == "kwok-controller":
        import threading

        threading.Thread(target=_profile, args=(directory,), daemon=True,
                         name="kwokbench-profile").start()


_arm()
