"""Share of the traced window (%) in which no kernel and no copy ran on
the card."""


def read(data):
    red = data.get("trace")
    if not red or not red["busy_s"]:
        return None
    return (red["window_s"] - red["busy_s"]) / red["window_s"] * 100.0
