"""The percentiles count what the metrics' definitions say: every sample
of the window, a lease's open gap at its end, a pod never Running with
the whole wait."""

import math

from kwokbench import stats
from kwokbench.drivers import kwokctl_stream as stream


def test_percentile_is_nearest_rank_over_all_samples():
    v = list(range(1, 101))
    assert stats.percentile(v, 0.95) == 95
    assert stats.percentile(v, 0.99) == 99
    assert stats.percentile([3.0], 0.99) == 3.0
    assert math.isnan(stats.percentile([], 0.5))
    assert stats.beyond(v, 0.95) == 5


def lease(name, renew, holder="kwok-controller"):
    return {"metadata": {"name": name}, "spec": {"holderIdentity": holder, "renewTime": renew}}


def test_lease_gaps_count_renewals_in_the_window_and_each_open_gap():
    view = stream.View()
    view.on_lease("ADDED", lease("a", "r0"), 0.0)
    view.on_lease("ADDED", lease("b", "r0"), 1.0)
    view.on_lease("MODIFIED", lease("a", "r1"), 10.0)   # gap 10, before the window
    view.on_lease("MODIFIED", lease("a", "r2"), 21.0)   # gap 11, in it
    view.on_lease("MODIFIED", lease("a", "r2"), 22.0)   # same renewTime: no renewal
    # b is never renewed again: its open gap at the window's end counts
    gaps, open_gaps = stream.lease_gaps(view, 15.0, 40.0)
    assert gaps == [11.0]
    assert sorted(open_gaps) == [19.0, 39.0]
    assert stats.percentile(gaps + open_gaps, 0.99) == 39.0


def test_a_pod_never_running_counts_its_whole_wait():
    recs = {"p1": {"due": 1.0, "running_t": 2.5}, "p2": {"due": 2.0, "running_t": None}}
    assert stream.running_latencies(recs, 70.0) == [1.5, 68.0]


def test_view_records_binds_running_and_deletes():
    view = stream.View()
    view.add_pods(["stream-000000"])
    pod = {"metadata": {"name": "stream-000000"}, "spec": {}, "status": {}}
    view.on_pod("ADDED", pod, 1.0)
    view.on_pod("MODIFIED", dict(pod, spec={"nodeName": "node-3"}), 1.2)
    view.on_pod("MODIFIED", dict(pod, spec={"nodeName": "node-3"},
                                 status={"phase": "Running"}), 1.9)
    view.on_pod("DELETED", dict(pod, spec={"nodeName": "node-3"}), 12.0)
    rec = view.pods["stream-000000"]
    assert rec["nodes"] == ["node-3"] and rec["bind_t"] == 1.2
    assert rec["running_t"] == 1.9 and rec["gone"]
    # a placed pod is only counted while Running
    view.on_pod("MODIFIED", {"metadata": {"name": "pod-0-1"}, "status": {"phase": "Running"}}, 2)
    assert view.placed_running == {"pod-0-1"}
