"""The trace's reduction: device busy time is the union of the
program's device work in the window; the harness's own device work is
left out; idle time is named by the innermost host event over it."""

import pytest

from kwokbench import devtrace


def x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_events():
    events = [
        x(devtrace.WINDOW, "user_annotation", 0, 1000),
        x("Pod.tick_many", "user_annotation", 0, 600),
        x("cudaLaunchKernel", "cuda_runtime", 10, 5, corr=1),
        x("tick_rows_kernel", "kernel", 20, 100, corr=1),
        x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 100, 300, corr=2),  # overlaps
        x(devtrace.HARNESS + ".count", "user_annotation", 700, 50),
        x("cudaLaunchKernel", "cuda_runtime", 710, 5, corr=3),
        x("reduce_kernel", "kernel", 720, 100, corr=3),  # the harness's: left out
        x("late_kernel", "kernel", 990, 100, corr=4),  # clipped at the window's end
    ]
    red = devtrace.reduce_events(events)
    assert red["window_s"] == pytest.approx(1e-3)
    assert red["busy_s"] == pytest.approx((400 - 20 + 10) * 1e-6)
    assert "reduce_kernel" not in red["ops"]
    assert devtrace.seconds_where(red, lambda n: "DtoH" in n) == (1, pytest.approx(300e-6))
    # idle: [0, 10), [15, 20), [400, 600) in Pod.tick_many; [700, 750) in the count but its launch
    assert red["idle"]["Pod.tick_many"] == pytest.approx(215e-6)
    assert red["idle"][devtrace.HARNESS + ".count"] == pytest.approx(45e-6)
    assert red["idle"]["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert sum(red["idle"].values()) == pytest.approx((1000 - 390) * 1e-6)


def test_reduce_events_without_a_window_is_none():
    assert devtrace.reduce_events([x("k", "kernel", 0, 1)]) is None


def test_reduce_device():
    red = devtrace.reduce_device([x("a", "kernel", 0, 10), x("b", "gpu_memcpy", 5, 10),
                                  x("c", "cpu_op", 0, 100)], 1.0)
    assert red["busy_s"] == pytest.approx(15e-6) and set(red["ops"]) == {"a", "b"}
