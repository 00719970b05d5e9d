"""Share of the window (%) in which no kernel and no copy of the kwok
daemon ran on the card, from the profiler window that
``site/sitecustomize.py`` opens in the daemon's process."""


def read(data):
    d = data.get("daemon")
    if not d or not d.get("busy_s"):
        return None
    return (d["window_s"] - d["busy_s"]) / d["window_s"] * 100.0
