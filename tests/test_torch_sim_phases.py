"""The phase spans of the port's DeviceSimulator (``kwok_sim_phase_seconds``).

Each phase is observed once for each time it does work, under the
simulator's resource kind; the spans observe only, so the fired stages
and the SoA are the same bit for bit with telemetry on and off; while a
``torch.profiler`` records, each phase is a ``kwok.sim.<phase>`` range on
its timeline, and with none recording no range is entered.  The
benchmark's four readers of the family (``kwokbench/metrics/``) read the
exposition's sums and counts, and nothing from a program without it.
"""

import json
import os

import numpy as np
import pytest
import torch

from kwok_tpu_torch.engine import simulator as simmod
from kwok_tpu_torch.engine.simulator import REBASE_AT_MS, DeviceSimulator
from kwok_tpu_torch.stages import default_node_stages, load_builtin
from kwok_tpu_torch.utils import telemetry

from kwokbench import simphase, spec

PHASES = ("compile", "kernels", "upload", "flush", "sync", "rebase", "launch", "fetch")
CHAOS = {"pod-container-running-failed.stage.kwok.x-k8s.io": "true"}


def pod(i=0, labels=None):
    meta = {"name": f"p{i}", "namespace": "d", "uid": f"u{i}"}
    if labels:
        meta["labels"] = labels
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": meta,
        "spec": {"nodeName": "n0", "containers": [{"name": "c", "image": "img"}]},
        "status": {},
    }


def pod_sim(seed=0, capacity=64):
    stages = load_builtin("pod-general") + load_builtin("pod-chaos")
    return DeviceSimulator(stages, capacity=capacity, seed=seed, device="cpu")


@pytest.fixture(autouse=True)
def fresh_family():
    """An empty family, telemetry armed, for each test (the family is
    process-global; it is cleared in place, never replaced)."""
    prev = telemetry.set_enabled(True)
    simmod._H_PHASE.clear()
    simmod._H_FETCH.clear()
    yield
    simmod._H_PHASE.clear()
    simmod._H_FETCH.clear()
    telemetry.set_enabled(prev)


def counts():
    """{(kind, phase): observations}."""
    return {lv: c["count"] for lv, c in simmod._H_PHASE.snapshot().items()}


def test_each_phase_counts_its_calls():
    sim = pod_sim()
    sim.admit_bulk(pod(labels=CHAOS), 16)
    sim.to_device()
    for _ in range(3):
        sim.tick_many(100, 8)
    # a clean tick_many neither flushes nor downloads
    assert counts() == {
        ("Pod", "kernels"): 1, ("Pod", "compile"): 1, ("Pod", "upload"): 1,
        ("Pod", "launch"): 3, ("Pod", "fetch"): 3,
    }
    sim.admit(pod(100))
    sim.tick_many(100, 8)
    sim.admit(pod(101))
    sim._ensure_synced()
    c = counts()
    assert c[("Pod", "flush")] == 2 and c[("Pod", "sync")] == 1
    assert c[("Pod", "launch")] == 4 and c[("Pod", "fetch")] == 4
    sim._ensure_synced()  # nothing pending, nothing stale: no phase runs
    assert counts() == c
    # past the rebase threshold the next macro-tick rebases first
    sim._now_host = REBASE_AT_MS
    sim._soa = sim._soa._replace(now=torch.tensor(REBASE_AT_MS, dtype=torch.int32))
    sim.tick_many(100, 8)
    c2 = counts()
    assert c2[("Pod", "rebase")] == 1
    # the host mirror was current: the rebase downloaded nothing
    assert c2[("Pod", "sync")] == 1 and c2[("Pod", "launch")] == 5
    assert c2[("Pod", "upload")] == 2  # the rebase drops the device SoA
    assert sim.now_ms == 800
    assert set(k for _, k in c2) <= set(PHASES)
    snap = simmod._H_PHASE.snapshot()
    assert all(d["sum"] >= 0 and sum(d["counts"]) == d["count"] for d in snap.values())


def test_compile_and_kernels_once_per_simulator_under_its_kind():
    pod_sim()
    pod_sim(seed=1)
    DeviceSimulator(default_node_stages(lease=True), capacity=8, device="cpu")
    assert counts() == {
        ("Pod", "kernels"): 2, ("Pod", "compile"): 2,
        ("Node", "kernels"): 1, ("Node", "compile"): 1,
    }


def test_upload_once_after_admit_bulk_and_flush_only_with_rows_pending():
    sim = pod_sim()
    sim.admit_bulk(pod(), 32)
    sim.to_device()
    sim.to_device()
    assert counts()[("Pod", "upload")] == 1
    assert ("Pod", "flush") not in counts()
    sim.tick_many(100, 4)
    assert ("Pod", "flush") not in counts()
    row = sim.admit(pod(7))
    sim.refresh_row(row)  # one row pending, flushed once
    sim.tick_many(100, 4)
    assert counts()[("Pod", "flush")] == 1
    assert counts()[("Pod", "upload")] == 1


def test_per_tick_branch_counts_calls_not_ticks():
    """Past 126 stages tick_many ticks one tick at a time; its launch and
    fetch are still one observation a call, and so are its fetched int32
    bytes (``host`` on the CPU: nothing is copied)."""
    stages = load_builtin("pod-general")
    for g in range(5):
        for v in range(26):
            stages.append(type(stages[0]).from_dict({
                "metadata": {"name": f"custom-{g}-{v}"},
                "spec": {
                    "resourceRef": {"kind": "Pod"},
                    "selector": {"matchLabels": {f"custom.stage.kwok.x-k8s.io/g{g}": f"v{v}"}},
                    "next": {"statusTemplate": f"reason: custom-{g}-{v}"},
                },
            }))
    sim = DeviceSimulator(stages, capacity=8, device="cpu")
    assert sim.num_stages_over_int8()
    sim.admit(pod())
    for _ in range(2):
        out, _ = sim.tick_many(100, 5)
        assert out.shape == (5, 8)
    c = counts()
    assert c[("Pod", "launch")] == 2 and c[("Pod", "fetch")] == 2
    fetched = simmod._H_FETCH.snapshot()
    assert list(fetched) == [("Pod", "host")]
    assert fetched[("Pod", "host")]["count"] == 2
    assert fetched[("Pod", "host")]["sum"] == 2 * 5 * 8 * 4


def run(seed):
    sim = pod_sim(seed=seed, capacity=256)
    sim.admit_bulk(pod(labels=CHAOS), 200)
    fired = []
    for i in range(12):
        if i == 5:
            sim.admit(pod(999))
        fired.append(sim.tick_many(250, 8)[0])
    sim._ensure_synced()
    return fired, sim


@pytest.mark.parametrize("seed", [0, 3_000_000_007])
def test_fired_stages_and_soa_are_bit_identical_with_telemetry_off(seed):
    on, sim_on = run(seed)
    assert counts()[("Pod", "launch")] == 12
    telemetry.set_enabled(False)
    simmod._H_PHASE.clear()
    off, sim_off = run(seed)
    assert counts() == {}
    assert sum(int((f >= 0).sum()) for f in on) > 0
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for f in ("features", "stage", "fire_at", "active", "rematch", "del_ts"):
        assert np.array_equal(getattr(sim_on, f), getattr(sim_off, f)), f
    for f in sim_on._soa._fields:
        assert torch.equal(getattr(sim_on._soa, f), getattr(sim_off._soa, f)), f


def test_profiler_timeline_holds_the_phases(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    sim = pod_sim()
    sim.admit_bulk(pod(labels=CHAOS), 16)
    sim.to_device()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.tick_many(100, 8)
        sim.admit(pod(3))
        sim.tick_many(100, 8)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e for e in events if str(e.get("name")).startswith("kwok.sim.")]
    assert [e["name"] for e in ranges].count("kwok.sim.launch") == 2
    assert {e["name"] for e in ranges} == {"kwok.sim.launch", "kwok.sim.fetch", "kwok.sim.flush"}
    # host ranges of the trace, which the benchmark's reduction names idle time by
    assert all(e["cat"] == "cpu_op" and e["ph"] == "X" for e in ranges)
    # the spans also observe while the profiler records
    assert counts()[("Pod", "launch")] == 2
    # the tick's operators run inside the launch range, on its clock
    launch = next(e for e in ranges if e["name"] == "kwok.sim.launch")
    inside = [e["name"] for e in events if e.get("cat") == "cpu_op" and e is not launch
              and launch["ts"] <= e["ts"] <= launch["ts"] + launch["dur"]]
    assert inside and all(n.startswith("aten::") for n in inside)
    # phases never nest
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in ranges)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    entered = []
    fast = torch._C._profiler._RecordFunctionFast
    enter = torch.autograd.profiler.record_function.__enter__

    def counting_fast(name, *args):
        entered.append(name)
        return fast(name, *args)

    def counting_enter(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting_fast)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counting_enter)
    sim = pod_sim()
    sim.admit_bulk(pod(), 16)
    sim.to_device()
    sim.tick_many(100, 8)
    sim.admit(pod(3))
    sim.tick_many(100, 8)
    sim._ensure_synced()
    assert entered == []
    assert counts()[("Pod", "launch")] == 2
    # the counter sees the ranges while a profiler records
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        sim.tick_many(100, 8)
    assert entered == ["kwok.sim.launch", "kwok.sim.fetch"]


EXPOSITION = """\
# HELP kwok_sim_phase_seconds DeviceSimulator phase time
# TYPE kwok_sim_phase_seconds histogram
kwok_sim_phase_seconds_bucket{kind="Node",phase="launch",le="+Inf"} 100
kwok_sim_phase_seconds_sum{kind="Node",phase="launch"} 0.005
kwok_sim_phase_seconds_count{kind="Node",phase="launch"} 100
kwok_sim_phase_seconds_sum{kind="Pod",phase="launch"} 0.02
kwok_sim_phase_seconds_count{kind="Pod",phase="launch"} 100
kwok_sim_phase_seconds_sum{kind="Node",phase="fetch"} 0.01
kwok_sim_phase_seconds_count{kind="Node",phase="fetch"} 100
kwok_sim_phase_seconds_sum{kind="Pod",phase="fetch"} 0.07
kwok_sim_phase_seconds_count{kind="Pod",phase="fetch"} 100
kwok_sim_phase_seconds_sum{kind="Pod",phase="compile"} 1.5
kwok_sim_phase_seconds_count{kind="Pod",phase="compile"} 1
kwok_sim_phase_seconds_sum{kind="Node",phase="compile"} 0.25
kwok_sim_phase_seconds_count{kind="Node",phase="compile"} 1
kwok_sim_phase_seconds_sum{kind="Pod",phase="kernels"} 12.0
kwok_sim_phase_seconds_count{kind="Pod",phase="kernels"} 1
kwok_sim_phase_seconds_sum{kind="Node",phase="kernels"} 0.5
kwok_sim_phase_seconds_count{kind="Node",phase="kernels"} 1
kwok_sim_phase_seconds_sum{kind="Pod",phase="sync"} 3.0
kwok_sim_phase_seconds_count{kind="Pod",phase="sync"} 0
# TYPE kwok_tick_stage_seconds histogram
kwok_tick_stage_seconds_sum{kind="Pod",stage="device_tick"} 9.0
kwok_tick_stage_seconds_count{kind="Pod",stage="device_tick"} 3
"""

WITHOUT = """\
# TYPE kwok_tick_stage_seconds histogram
kwok_tick_stage_seconds_sum{kind="Pod",stage="device_tick"} 9.0
kwok_tick_stage_seconds_count{kind="Pod",stage="device_tick"} 3
# TYPE kwok_sim_phase_seconds histogram
"""

READERS = {
    # Pod 0.2 ms + Node 0.05 ms a call
    "simulator.launch_ms": 0.25,
    # Pod 0.7 ms + Node 0.1 ms a call
    "simulator.fetch_ms": 0.8,
    "setup.compile_s": 1.75,
    "setup.kernels_s": 12.5,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_synthetic_exposition(monkeypatch, name):
    read = spec.load_reader(spec.HERE, name)
    monkeypatch.setattr(simphase, "exposition", lambda: EXPOSITION)
    assert read({}) == pytest.approx(READERS[name], rel=1e-12)
    monkeypatch.setattr(simphase, "exposition", lambda: WITHOUT)
    assert read({}) is None
    monkeypatch.setattr(simphase, "exposition", lambda: "")
    assert read({}) is None


def test_readers_read_the_process_exposition():
    """In a run the readers read the program's own family, through the
    text /metrics serves."""
    sim = pod_sim()
    sim.admit_bulk(pod(), 16)
    sim.to_device()
    for _ in range(4):
        sim.tick_many(100, 8)
    snap = simmod._H_PHASE.snapshot()
    launch = spec.load_reader(spec.HERE, "simulator.launch_ms")({})
    assert launch == pytest.approx(snap[("Pod", "launch")]["sum"] / 4 * 1e3)
    compile_s = spec.load_reader(spec.HERE, "setup.compile_s")({})
    assert compile_s == pytest.approx(snap[("Pod", "compile")]["sum"]) and compile_s > 0
    # with the family present but empty (telemetry off all run) none reads
    simmod._H_PHASE.clear()
    assert spec.load_reader(spec.HERE, "setup.kernels_s")({}) is None


def test_the_benchmark_lists_the_readers_for_the_sim_cell():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["workloads"] == ["chaos-10k.sim"] and m["source"] == "host_clock"
        assert m["moves"] == ("setup_s" if name.startswith("setup.") else "sim_macro_tick_ms")
    cell = spec.load_cell("chaos-10k.sim")
    assert set(READERS) <= set(cell.readers)
