"""The kwokctl stream cells' check: the plain reference judges the
client's observations, and a whole run on the CPU at a small size is
judged correct, while the control and each fault planted in the
daemon's timed path are judged not correct.  (The cells run on one
chip: they have no exchange between chips to leave out.)

``kwokctl-ci.placed-stream`` is not in ``BENCHMARK.json`` (PERF.md §7):
the tests load it from a copy of ``BENCHMARK.json`` with the entries a
later change would add."""

import copy
import json
import os

import pytest

from kwokbench import spec
from kwokbench.drivers import kwokctl_stream as stream
from kwokbench.outcome import Ctx
from kwokbench.reference import cluster as ref

FAULTS = os.path.join(os.path.dirname(__file__), "faults")
SPEC = {"containers": [{"name": "app", "image": "fake-image"}]}


def running(node="node-1"):
    return {"spec": {"nodeName": node}, "status": {
        "phase": "Running", "podIP": "10.0.0.1",
        "conditions": [{"type": "Ready", "status": "True"}],
        "containerStatuses": [{"name": "app", "ready": True, "state": {"running": {}}}]}}


def sound():
    return {f"stream-{i}": {"created": True, "deleted": True, "nodes": ["node-1"],
                            "running_obj": running(), "gone": True} for i in range(4)}


def judge(recs, remaining=()):
    return ref.judge_pods(recs, SPEC, ["node-1", "node-2"], remaining)


def test_reference_judges_sound_observations_correct():
    assert set(judge(sound()).values()) == {0}


@pytest.mark.parametrize("break_it,fault", [
    (lambda r: r["stream-0"].update(gone=False), "deletes_not_applied"),
    (lambda r: r["stream-1"].update(nodes=["node-9"]), "bound_off_cluster"),
    (lambda r: r["stream-1"].update(nodes=["node-1", "node-2"]), "bound_twice"),
    (lambda r: r["stream-2"].update(running_obj=None), "never_running"),
    (lambda r: r["stream-3"]["running_obj"]["status"]["containerStatuses"][0].update(ready=False),
     "bad_running_status"),
    (lambda r: r["stream-3"]["running_obj"]["status"].pop("podIP"), "bad_running_status"),
])
def test_reference_finds_each_broken_guarantee(break_it, fault):
    recs = copy.deepcopy(sound())
    break_it(recs)
    assert judge(recs)[fault] == 1


def test_a_pod_the_final_listing_still_holds_was_not_deleted():
    assert judge(sound(), remaining={"stream-0"})["deletes_not_applied"] == 1


def test_leases_held_by_another_count():
    leases = {"a": {"holder": "kwok-controller"}, "b": {"holder": "other"}}
    assert ref.lease_faults(leases, "kwok-controller", 3) == 2


STREAM_CELL = "kwokctl-ci.placed-stream"


def with_stream_cell(path) -> str:
    """A copy of ``BENCHMARK.json`` at ``path`` with the stream cell, its
    configuration and its metrics."""
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "kwokctl-ci", "source": "x", "why": "x", "reduced": [],
                             "file": "kwokbench/configs/kwokctl-ci.json"})
    bench["workloads"].append({"name": STREAM_CELL, "config": "kwokctl-ci",
                               "traffic": "placed-stream", "chips": 1, "why": "x"})
    for name in ("pod_running_p50_s", "pod_running_p95_s", "lease_renew_gap_p99_s"):
        bench["end_to_end"].append({"name": name, "unit": "s", "better": "lower", "bound": 0.25,
                                    "source": "host_clock", "workloads": [STREAM_CELL]})
    for name, layer in (("player.running_after_bind_p95_s.stream", "stage player"),
                        ("apiserver.request_ms.stream", "apiserver"),
                        ("device.idle_share.stream", "device")):
        bench["per_layer"].append({"name": name, "unit": "x", "better": "lower",
                                   "source": "host_clock", "layer": layer,
                                   "moves": "pod_running_p95_s", "workloads": [STREAM_CELL]})
    bench["per_layer"].append({"name": "kwokctl.up_s", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "kwokctl", "moves": "setup_s",
                               "workloads": [STREAM_CELL]})
    out = os.path.join(str(path), "BENCHMARK.json")
    with open(out, "w") as f:
        json.dump(bench, f)
    return out


def test_stream_cell_loads_with_its_entries(tmp_path):
    cell = spec.load_cell(STREAM_CELL, benchmark=with_stream_cell(tmp_path))
    assert spec.driver(cell).__name__ == "kwokbench.drivers.kwokctl_stream"
    assert {m.name for m in cell.end_to_end} == {"pod_running_p50_s", "pod_running_p95_s",
                                                 "lease_renew_gap_p99_s", "setup_s"}
    assert len(cell.per_layer) == 4


def run_cell(monkeypatch, fault=None, tmp_path=None, control=False):
    cell = spec.load_cell(STREAM_CELL, benchmark=with_stream_cell(tmp_path))
    cell.traffic.update(rate_per_s=4, settle_s=15, warm_s=1)
    if fault:
        arm = str(tmp_path / "armed")
        monkeypatch.setenv("KWOKBENCH_TEST_FAULT", fault)
        monkeypatch.setenv("KWOKBENCH_TEST_FAULT_ARM", arm)
        monkeypatch.setenv("PYTHONPATH", FAULTS)
        real = stream.Cluster.loop

        def loop(self, prefix, *args, **kw):
            if prefix == stream.STREAM:
                open(arm, "w").close()
            return real(self, prefix, *args, **kw)

        monkeypatch.setattr(stream.Cluster, "loop", loop)
    ctx = Ctx(cell, 3_000_000_011, 4.0, False, device="cpu",
              scale={"nodes": 10, "placed_pods": 20}, control=control)
    return spec.driver(cell).run(ctx)


def test_sound_run_is_correct_and_its_control_is_not(monkeypatch, tmp_path):
    res = run_cell(monkeypatch, tmp_path=tmp_path, control=True)
    assert res.correct, res.checks
    assert res.attempted == 16 and res.failed == 0
    assert dict(res.control)["pods_deletes_not_applied"] == 1


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_in_the_daemons_timed_path_is_not_correct(monkeypatch, tmp_path, fault):
    res = run_cell(monkeypatch, fault, tmp_path)
    assert not res.correct, res.checks
