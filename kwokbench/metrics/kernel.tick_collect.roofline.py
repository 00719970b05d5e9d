"""The tick kernel's share of its roofline (%): the least time that the
work of the window's ``run_ticks_collect`` launches needs
(``roofline.tick_bound``: their rows' bytes read and written once, their
fire tests, matches and draws) over the device time the profiler gives
its kernels (``key_schedule_kernel`` and ``tick_rows_kernel``, which
``csrc/tick.cu`` launches for each call)."""

from kwokbench import devtrace, roofline

KERNELS = ("key_schedule_kernel", "tick_rows_kernel")


def read(data):
    red = data.get("trace")
    launches = data.get("tick_collect")
    if not red or not launches:
        return None
    n, seconds = devtrace.seconds_where(red, lambda name: any(k in name for k in KERNELS))
    if not n or seconds <= 0:
        return None
    least = sum(roofline.tick_bound(x["S"], x["KC"], x["C"], x["param_bytes"], x["n"],
                                    x["ticks"], x["rematches"], x["out_bytes"])[0] * x["launches"]
                for x in launches)
    return least / seconds * 100.0
