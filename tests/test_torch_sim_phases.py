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

PHASES = ("compile", "kernels", "admit", "explore", "upload", "flush", "sync", "rebase", "launch",
          "fetch")
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
    # a clean tick_many neither flushes nor downloads; the bulk admission
    # explored its one behaviour once
    assert counts() == {
        ("Pod", "kernels"): 1, ("Pod", "compile"): 1, ("Pod", "admit"): 1, ("Pod", "explore"): 1,
        ("Pod", "upload"): 1, ("Pod", "launch"): 3, ("Pod", "fetch"): 3,
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


def wide_stages():
    """pod-general and 130 more stages: past the 126 stage indices int8
    holds, so the simulator ticks one launch a tick."""
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
    return stages


def test_per_tick_branch_counts_calls_not_ticks():
    """Past 126 stages tick_many ticks one tick at a time; its launch and
    fetch are still one observation a call, and so are its fetched int32
    bytes (``host`` on the CPU: nothing is copied)."""
    sim = DeviceSimulator(wide_stages(), capacity=8, device="cpu")
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


@pytest.mark.parametrize("route", ["wide", "mesh"])
def test_per_tick_route_fetches_once_after_its_launches(monkeypatch, route):
    """The per-tick route launches its K ticks, then fetches: one copy of
    the stacked ticks on one device, each tick's rows in order on a mesh."""
    from kwok_tpu_torch.parallel.mesh import Rows, make_mesh

    if route == "wide":
        sim = DeviceSimulator(wide_stages(), capacity=8, device="cpu")
    else:
        sim = DeviceSimulator(load_builtin("pod-fast"), capacity=8, device="cpu",
                              mesh=make_mesh(devices=["cpu"] * 4))
    assert sim.per_tick
    sim.admit(pod())
    sim.to_device()
    calls = []
    tick_fn, to_host = sim._tick_fn, Rows.to_host

    def logged_tick_fn(dt_ms):
        fn = tick_fn(dt_ms)
        return lambda params, soa: calls.append("launch") or fn(params, soa)

    class LoggedFetch(simmod.Fetch):
        def __init__(self, stages):
            calls.append("fetch")
            super().__init__(stages)

    monkeypatch.setattr(sim, "_tick_fn", logged_tick_fn)
    monkeypatch.setattr(simmod, "Fetch", LoggedFetch)
    monkeypatch.setattr(Rows, "to_host", lambda rows: calls.append("fetch") or to_host(rows))
    for _ in range(2):
        calls.clear()
        out, _ = sim.tick_many(100, 5)
        assert out.shape == (5, 8) and out.dtype == np.int32
        assert calls == ["launch"] * 5 + ["fetch"] * (1 if route == "wide" else 5)
    c = counts()
    assert c[("Pod", "launch")] == 2 and c[("Pod", "fetch")] == 2


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
    # the admitted pod, without the chaos label, starts in a state its
    # behaviour had not been explored from
    assert {e["name"] for e in ranges} == {"kwok.sim.launch", "kwok.sim.fetch", "kwok.sim.flush",
                                           "kwok.sim.admit", "kwok.sim.explore"}
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


def placed(i, nodes=64):
    """A pod of one of four classes (plain, Job, init containers, chaos),
    of an owner of its own, on a node of its own."""
    cls = i % 4
    p = pod(i, labels={"app": f"app-{i // 8}", **(CHAOS if cls == 3 else {})})
    p["metadata"]["ownerReferences"] = [{"kind": "Job" if cls == 1 else "ReplicaSet",
                                         "name": f"o{i // 8}", "uid": f"ou{i // 8}"}]
    p["spec"]["nodeName"] = f"node-{i % nodes}"
    if cls == 2:
        p["spec"]["initContainers"] = [{"name": "i", "image": "img"}]
    return p


def test_admit_and_explore_are_observed_apart(monkeypatch):
    """Each admit or admit_bulk call is one ``admit`` observation, each
    exploration of a behaviour from a new state one ``explore``, and the
    admission's time leaves its explorations out."""
    from kwok_tpu_torch.engine.compiler import CompiledStageSet

    real = CompiledStageSet._explore

    def slow(self, table, obj):
        import time

        time.sleep(0.05)
        return real(self, table, obj)

    monkeypatch.setattr(CompiledStageSet, "_explore", slow)
    sim = pod_sim(capacity=256)
    for i in range(40):
        sim.admit(placed(i))
    sim.admit_bulk(placed(41), 8)
    c = counts()
    assert c[("Pod", "admit")] == 41
    assert c[("Pod", "explore")] == 4  # one a class: node, owner and app label explore nothing
    snap = simmod._H_PHASE.snapshot()
    assert snap[("Pod", "explore")]["sum"] >= 4 * 0.05
    assert snap[("Pod", "admit")]["sum"] < 0.05
    # a refresh from a state the behaviour was not explored from explores
    # outside any admission
    sim.objects[3] = dict(sim.objects[3], status={"phase": "Pending"})
    sim.refresh_row(3)
    assert counts()[("Pod", "explore")] == 5 and counts()[("Pod", "admit")] == 41


def test_admission_ranges_never_nest(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    sim = pod_sim(capacity=64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(8):
            sim.admit(placed(i))
        sim.to_device()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if str(e.get("name")).startswith("kwok.sim."))
    names = [n for _, _, n in ranges]
    assert names.count("kwok.sim.explore") == 4
    # an admission that explores is cut in two around its exploration
    assert names.count("kwok.sim.admit") == 8 + 4
    assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))
    assert names[:3] == ["kwok.sim.admit", "kwok.sim.explore", "kwok.sim.admit"]


def signatures_gauge():
    """{kind: value} of ``kwok_sim_signatures`` in the process exposition."""
    from kwokbench import promtext

    return {labels["kind"]: value for name, labels, value in
            promtext.iter_samples(telemetry.registry().expose()) if name == "kwok_sim_signatures"}


def test_signatures_gauge_holds_the_card_rows_after_each_upload():
    simmod._G_SIGNATURES.clear()
    sim = pod_sim(capacity=128)
    for i in range(0, 96, 4):  # plain pods only: 24 specs, one behaviour
        sim.admit(placed(i))
    assert "Pod" not in signatures_gauge()  # set at an upload, not before
    params, _ = sim.to_device()
    assert signatures_gauge()["Pod"] == 1 == params.eff_mode.shape[0]
    assert len(set(sim.sig[:24].tolist())) == 24
    for i in range(1, 4):
        sim.admit(placed(i))
    sim.tick_many(100, 8)
    assert signatures_gauge()["Pod"] == 4
    nodes = DeviceSimulator(default_node_stages(lease=True), capacity=8, device="cpu")
    for i in range(8):
        nodes.admit({"apiVersion": "v1", "kind": "Node",
                     "metadata": {"name": f"n{i}", "labels": {"kubernetes.io/hostname": f"n{i}"}},
                     "status": {}})
    nodes.to_device()
    assert signatures_gauge() == {"Pod": 4, "Node": 1}
    assert "# TYPE kwok_sim_signatures gauge" in telemetry.registry().expose()


@pytest.mark.parametrize("seed", [1, 3_000_000_019])
def test_admission_telemetry_off_leaves_outputs_bit_identical(seed):
    def placed_run():
        sim = pod_sim(seed=seed, capacity=128)
        for i in range(96):
            sim.admit(placed(i))
        fired = [sim.tick_many(500, 8)[0] for _ in range(10)]
        sim.admit(placed(100))
        fired += [sim.tick_many(500, 8)[0] for _ in range(4)]
        sim._ensure_synced()
        return fired, sim

    simmod._G_SIGNATURES.clear()
    on, sim_on = placed_run()
    assert counts()[("Pod", "admit")] == 97 and signatures_gauge() == {"Pod": 4}
    telemetry.set_enabled(False)
    simmod._H_PHASE.clear()
    simmod._G_SIGNATURES.clear()
    off, sim_off = placed_run()
    assert counts() == {} and signatures_gauge() == {}
    assert sum(int((f >= 0).sum()) for f in on) > 0
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for f in ("features", "sig", "behaviour", "ovc", "stage", "fire_at", "active", "rematch",
              "del_ts"):
        assert np.array_equal(getattr(sim_on, f), getattr(sim_off, f)), f
    assert sim_on.objects == sim_off.objects
    for f in sim_on._soa._fields:
        assert torch.equal(getattr(sim_on._soa, f), getattr(sim_off._soa, f)), f


ADMISSION = """\
# TYPE kwok_sim_phase_seconds histogram
kwok_sim_phase_seconds_sum{kind="Pod",phase="admit"} 41.5
kwok_sim_phase_seconds_count{kind="Pod",phase="admit"} 1000000
kwok_sim_phase_seconds_sum{kind="Node",phase="admit"} 0.5
kwok_sim_phase_seconds_count{kind="Node",phase="admit"} 10000
kwok_sim_phase_seconds_sum{kind="Pod",phase="explore"} 0.125
kwok_sim_phase_seconds_count{kind="Pod",phase="explore"} 4
kwok_sim_phase_seconds_sum{kind="Node",phase="explore"} 0.03
kwok_sim_phase_seconds_count{kind="Node",phase="explore"} 1
# HELP kwok_sim_signatures DeviceSimulator effect-table rows on the device (one per behaviour)
# TYPE kwok_sim_signatures gauge
kwok_sim_signatures{kind="Node"} 1
kwok_sim_signatures{kind="Pod"} 4
"""

ADMISSION_READERS = {"setup.admit_s": 42.0, "setup.explore_s": 0.155, "simulator.signatures": 5.0}


@pytest.mark.parametrize("name", sorted(ADMISSION_READERS))
def test_admission_reader_on_a_synthetic_exposition(monkeypatch, name):
    read = spec.load_reader(spec.HERE, name)
    monkeypatch.setattr(simphase, "exposition", lambda: ADMISSION)
    assert read({}) == pytest.approx(ADMISSION_READERS[name], rel=1e-12)
    # a program without the phases and the gauge (the parent) reads nothing
    for text in (WITHOUT, EXPOSITION, ""):
        monkeypatch.setattr(simphase, "exposition", lambda: text)
        assert read({}) is None


def test_admission_readers_read_the_process_exposition():
    simmod._G_SIGNATURES.clear()
    sim = pod_sim(capacity=64)
    for i in range(32):
        sim.admit(placed(i))
    sim.to_device()
    snap = simmod._H_PHASE.snapshot()
    read = {name: spec.load_reader(spec.HERE, name)({}) for name in ADMISSION_READERS}
    assert read["setup.admit_s"] == pytest.approx(snap[("Pod", "admit")]["sum"])
    assert read["setup.explore_s"] == pytest.approx(snap[("Pod", "explore")]["sum"])
    assert read["simulator.signatures"] == 4.0


def test_the_benchmark_lists_the_admission_readers_for_the_placed_cell():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in ADMISSION_READERS:
        m = entries[name]
        assert m["workloads"] == ["placed-mixed-10k.sim"] and m["source"] == "host_clock"
        assert m["moves"] == "setup_s" and m["layer"] == "setup"
    cell = spec.load_cell("placed-mixed-10k.sim")
    assert set(ADMISSION_READERS) | {"kernel.tick_collect.roofline", "device.idle_share.sim",
                                     "setup.admit_native_share",
                                     "simulator.fetch_mapped_share"} == set(cell.readers)
    assert {m.name for m in cell.end_to_end} == {"sim_macro_tick_ms", "setup_s"}
