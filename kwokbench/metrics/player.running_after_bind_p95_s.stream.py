"""95th percentile (s) over the window's pods of the time from the
client's watch seeing a pod bound to seeing it Running: the daemon's
ingest, its first drain and its status write."""

from kwokbench import stats


def read(data):
    v = data.get("running_after_bind_s")
    return stats.percentile(v, 0.95) if v else None
