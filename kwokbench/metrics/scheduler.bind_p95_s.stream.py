"""95th percentile (s) over the window's pods of the time from a pod's
create being due to the client's watch seeing its ``spec.nodeName``."""

from kwokbench import stats


def read(data):
    v = data.get("bind_s")
    return stats.percentile(v, 0.95) if v else None
