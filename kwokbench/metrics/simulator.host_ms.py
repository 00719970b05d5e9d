"""Host time per pod+node macro-tick (ms): the traced window less the
device's busy time in it (dispatch, the host mirror, waits), over the
macro-ticks."""


def read(data):
    red = data.get("trace")
    if not red or not red["busy_s"]:
        return None
    return (red["window_s"] - red["busy_s"]) / data["macro_ticks"] * 1e3
