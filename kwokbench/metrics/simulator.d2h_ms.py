"""Device-to-host copy time per pod+node macro-tick (ms), from the
profiler's trace of the window: the fetch of the fired-stage arrays."""

from kwokbench import devtrace


def read(data):
    red = data.get("trace")
    if not red or not red["busy_s"]:
        return None
    n, seconds = devtrace.seconds_where(red, lambda name: "DtoH" in name)
    return seconds / data["macro_ticks"] * 1e3 if n else None
