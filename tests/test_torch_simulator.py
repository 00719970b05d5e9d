"""The port's DeviceSimulator equals kwok_tpu's, operation for operation.

Each scenario (mirroring tests/test_device_engine.py: trajectories,
delete paths, weighted choice, overrides, capacity growth mid-run, the
2**30 rebase, admit_bulk, release and reuse, macro-ticks, the per-tick
branch of stage sets past 126 stages) runs the same operations on a
JAX simulator and on a port simulator on the CPU, with the same seed.
After every operation the returned values, the drained Transitions, the
host mirror objects and the host arrays must be equal: the state is
integer-exact, so there is no tolerance.
"""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from kwok_tpu.api.types import Stage as JaxStage
from kwok_tpu.engine.simulator import REBASE_AT_MS as JAX_REBASE_AT_MS
from kwok_tpu.engine.simulator import DeviceSimulator as JaxSim
from kwok_tpu.engine.simulator import Transition as JaxTransition
from kwok_tpu.stages import default_node_stages as jax_node_stages
from kwok_tpu.stages import load_builtin as jax_load
from kwok_tpu_torch.api.types import Stage as TorchStage
from kwok_tpu_torch.engine.simulator import REBASE_AT_MS, DeviceSimulator as TorchSim
from kwok_tpu_torch.engine.simulator import Transition as TorchTransition
from kwok_tpu_torch.stages import default_node_stages as torch_node_stages
from kwok_tpu_torch.stages import load_builtin as torch_load

CHAOS = {"pod-container-running-failed.stage.kwok.x-k8s.io": "true"}
ARRAYS = ("features", "sig", "ovc", "stage", "fire_at", "active", "rematch", "del_ts")


def new_pod(i=0, owner_job=False, init_containers=False, labels=None, annotations=None):
    pod = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": f"p{i}", "namespace": "d", "uid": f"u{i}"},
        "spec": {"nodeName": "n0", "containers": [{"name": "c", "image": "img"}]},
        "status": {},
    }
    if owner_job:
        pod["metadata"]["ownerReferences"] = [{"kind": "Job", "name": "j"}]
    if init_containers:
        pod["spec"]["initContainers"] = [{"name": "ic", "image": "i2"}]
    if labels:
        pod["metadata"]["labels"] = labels
    if annotations:
        pod["metadata"]["annotations"] = annotations
    return pod


def new_node(i=0):
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": f"n{i}", "creationTimestamp": "2026-01-01T00:00:00Z"},
        "status": {},
    }


def weighted_stages(stage_cls):
    def make(name, weight):
        return stage_cls.from_dict(yaml.safe_load(f"""
metadata: {{name: {name}}}
spec:
  resourceRef: {{kind: Pod}}
  selector:
    matchExpressions:
    - key: '.status.phase'
      operator: 'DoesNotExist'
  weight: {weight}
  next:
    statusTemplate: 'phase: {name}'
"""))

    return [make("rare", 1), make("common", 9)]


def wide_stages(stage_cls, load):
    """pod-general plus 130 label-selected stages: past int8's 126."""
    stages = load("pod-general")
    for g in range(5):
        for v in range(26):
            stages.append(stage_cls.from_dict({
                "metadata": {"name": f"custom-{g}-{v}"},
                "spec": {
                    "resourceRef": {"kind": "Pod"},
                    "selector": {"matchLabels": {f"custom.stage.kwok.x-k8s.io/g{g}": f"v{v}"}},
                    "weight": 1,
                    "delay": {"durationMilliseconds": 300, "jitterDurationMilliseconds": 900},
                    "next": {"statusTemplate": f"reason: custom-{g}-{v}"},
                },
            }))
    return stages


def stage_set(name, pkg):
    load, node_stages, stage_cls = pkg
    if name == "node-lease":
        return node_stages(lease=True)
    if name == "weighted":
        return weighted_stages(stage_cls)
    if name == "wide":
        return wide_stages(stage_cls, load)
    return [s for part in name.split("+") for s in load(part)]


JAX = (jax_load, jax_node_stages, JaxStage)
TORCH = (torch_load, torch_node_stages, TorchStage)

WIDE_POD = new_pod(7, labels={"custom.stage.kwok.x-k8s.io/g4": "v25", **CHAOS})

# host writes between macro-ticks, each flushed unpadded: the first group
# by _ensure_synced and the next by to_device, back to back
FLUSH_OPS = [
    ("admit_bulk", new_pod(0, labels=CHAOS), 40), *[("tick_many", 200, 8)] * 3,
    ("admit", new_pod(41)), ("release", 3), ("request_delete", 7, 1000), ("sync",),
    ("admit", new_pod(42, owner_job=True)), ("release", 9), ("refresh_row", 11),
    ("request_delete", 12, 600), ("refresh_row", 13), ("to_device",),
    *[("tick_many", 200, 8)] * 4, ("release", 20), ("admit", new_pod(43)), ("refresh_row", 21),
    ("request_delete", 22, 400), *[("tick_many", 200, 8)] * 2,
]

# name: (stage set, capacity, seed, operations)
SCENARIOS = {
    "pod-fast-trajectories-and-idle": ("pod-fast", 8, 0, [
        ("admit", new_pod(0)), ("admit", new_pod(1, owner_job=True)), ("steps", 15, 100)]),
    "pod-fast-delete-path": ("pod-fast", 4, 0, [
        ("admit", new_pod(0)), ("steps", 5, 100), ("request_delete", 0, 500), ("steps", 5, 100)]),
    "pod-general-init-container-delays": ("pod-general", 4, 3, [
        ("admit", new_pod(0, init_containers=True)), ("steps", 60, 250)]),
    "pod-general-annotation-override": ("pod-general", 4, 0, [
        ("admit", new_pod(0)),
        ("admit", new_pod(1, annotations={"pod-create.stage.kwok.x-k8s.io/delay": "8s",
                                          "pod-create.stage.kwok.x-k8s.io/jitter-delay": "8s"})),
        ("steps", 40, 300)]),
    "pod-general-delete-with-finalizers": ("pod-general", 4, 1, [
        ("admit", new_pod(0)), ("steps", 40, 250), ("request_delete_now", 0), ("steps", 40, 250)]),
    "chaos-churn": ("pod-general+pod-chaos", 4, 5, [
        ("admit", new_pod(0, labels=CHAOS)), ("steps", 60, 500)]),
    "chaos-single-match-weight-zero": ("pod-general+pod-chaos", 4, 5, [
        ("admit", new_pod(0, labels=CHAOS, annotations={
            "pod-container-running-failed.stage.kwok.x-k8s.io/weight": "0"})),
        ("steps", 50, 500)]),
    "weighted-choice": ("weighted", 256, 11, [
        *[("admit", new_pod(i)) for i in range(256)], ("steps", 3, 100)]),
    "host-oracle-population": ("pod-general", 8, 9, [
        ("admit", new_pod(0)), ("admit", new_pod(1, owner_job=True)),
        ("admit", new_pod(2, init_containers=True)),
        ("admit", new_pod(3, owner_job=True, init_containers=True)), ("steps", 60, 500)]),
    "capacity-growth-mid-run": ("pod-fast", 4, 0, [
        ("admit", new_pod(0)), ("steps", 1, 100),
        *[op for i in range(1, 40) for op in
          ([("admit", new_pod(i))] + ([("steps", 1, 100)] if i % 7 == 0 else []))],
        ("steps", 30, 100)]),
    "rebase-before-int32-wrap": ("pod-fast", 4, 0, [
        ("admit", new_pod(0)), ("steps", 1, 100), ("fast_forward", REBASE_AT_MS + 123),
        ("steps", 1, 100), ("admit", new_pod(1)), ("steps", 20, 100)]),
    "clock-survives-mid-run-admit": ("pod-fast", 4, 0, [
        ("admit", new_pod(0)), ("steps", 50, 100), ("admit", new_pod(1)), ("steps", 1, 100)]),
    "admit-bulk": ("pod-general+pod-chaos", 16, 0, [
        ("admit_bulk", new_pod(0, labels=CHAOS), 8), ("steps", 30, 200)]),
    "admit-bulk-grows-copy-on-write": ("pod-fast", 4, 0, [
        ("admit_bulk", new_pod(0), 100), ("steps", 10, 100), ("request_delete", 0, 1500),
        ("steps", 20, 100)]),
    "release-and-reuse": ("pod-general", 8, 2, [
        *[("admit", new_pod(i, owner_job=i % 2 == 1)) for i in range(6)], ("steps", 20, 500),
        ("release", 2), ("release", 4), ("admit", new_pod(10)), ("admit", new_pod(11)),
        ("steps", 20, 500)]),
    "macro-ticks-with-host-ops": ("pod-general+pod-chaos", 64, 4, [
        ("admit_bulk", new_pod(0, labels=CHAOS), 60), *[("tick_many", 200, 8)] * 4,
        ("request_delete", 3, 1000), ("release", 5), ("admit", new_pod(70, owner_job=True)),
        *[("tick_many", 200, 8)] * 3]),
    "node-lease-macro-ticks": ("node-lease", 32, 1, [
        ("admit_bulk", new_node(), 32), *[("tick_many", 1000, 8)] * 5]),
    "back-to-back-flushes": ("pod-general+pod-chaos", 64, 6, FLUSH_OPS),
    "wide-set-per-tick-branch": ("wide", 32, 2, [
        ("admit_bulk", new_pod(6, labels=CHAOS), 16), ("admit_bulk", WIDE_POD, 16),
        *[("tick_many", 100, 8)] * 3, ("steps", 5, 100)]),
}


def event_key(e):
    return None if e is None else (e.type, e.reason, e.message)


def transitions_key(trs):
    return [(t.row, t.stage_idx, t.stage_name, t.t_ms, t.deleted, event_key(t.event)) for t in trs]


def run_op(sim, op, is_jax):
    kind = op[0]
    if kind == "admit":
        return sim.admit(op[1])
    if kind == "admit_bulk":
        return list(sim.admit_bulk(op[1], op[2]))
    if kind == "release":
        return sim.release(op[1])
    if kind == "request_delete":
        return sim.request_delete(op[1], op[2])
    if kind == "refresh_row":
        return sim.refresh_row(op[1])
    if kind == "sync":
        return sim._ensure_synced()
    if kind == "to_device":
        sim.to_device()
        return None
    if kind == "request_delete_now":
        return sim.request_delete(op[1], sim.now_ms)
    if kind == "fast_forward":
        sim._invalidate_device()
        sim._dev_now = jnp.int32(op[1]) if is_jax else torch.tensor(op[1], dtype=torch.int32)
        sim._now_host = op[1]
        return None
    if kind == "steps":
        out = []
        for _ in range(op[1]):
            trs = sim.step(dt_ms=op[2])
            sim.check_feature_parity([t.row for t in trs])
            out.append(transitions_key(trs))
        return out
    if kind == "tick_many":
        dt, k = op[1], op[2]
        stages, t0 = sim.tick_many(dt, k)
        # drain: materialize every transition in order, as the player does
        make = JaxTransition if is_jax else TorchTransition
        for tick, row in zip(*np.nonzero(stages >= 0)):
            s_idx = int(stages[tick, row])
            sim.materialize(make(int(row), s_idx, sim.cset.compiled[s_idx].name,
                                 t0 + (int(tick) + 1) * dt, bool(sim.cset.stage_delete[s_idx]),
                                 None))
        return stages.dtype, stages.tolist(), t0
    raise ValueError(kind)


def assert_same_host_state(j, t, what):
    assert j.objects == t.objects, what
    for f in ARRAYS:
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, f)
    assert (j.num_rows, j.capacity, j._free, j.now_ms, j.epoch) == (
        t.num_rows, t.capacity, t._free, t.now_ms, t.epoch), what


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_simulator_matches_jax(name):
    set_name, capacity, seed, ops = SCENARIOS[name]
    j = JaxSim(stage_set(set_name, JAX), capacity=capacity, seed=seed)
    t = TorchSim(stage_set(set_name, TORCH), capacity=capacity, seed=seed, device="cpu")
    fired = 0
    for i, op in enumerate(ops):
        rj, rt = run_op(j, op, True), run_op(t, op, False)
        assert rj == rt, (i, op[0])
        if op[0] == "steps":
            fired += sum(len(s) for s in rt)
        assert_same_host_state(j, t, (i, op[0]))
    j._ensure_synced()
    t._ensure_synced()
    assert_same_host_state(j, t, "synced")
    rows = [r for r in range(t.num_rows) if t.objects[r] is not None]
    t.check_feature_parity(rows)
    assert j.phase_counts() == t.phase_counts()
    assert REBASE_AT_MS == JAX_REBASE_AT_MS


def test_unpadded_flushes_leave_the_jax_soa(monkeypatch):
    """After every host write, the port's flush (one packed batch of the
    distinct pending rows, no padding) leaves the device SoA that the JAX
    simulator's padded scatter leaves."""
    import kwok_tpu_torch.engine.simulator as simulator

    flushed = []
    real = simulator.scatter_packed

    def recording(soa, batch):
        flushed.append(batch.layout.B)
        return real(soa, batch)

    monkeypatch.setattr(simulator, "scatter_packed", recording)
    j = JaxSim(stage_set("pod-general+pod-chaos", JAX), capacity=64, seed=6)
    t = TorchSim(stage_set("pod-general+pod-chaos", TORCH), capacity=64, seed=6, device="cpu")
    pending = set()
    for op in FLUSH_OPS:
        rj, rt = run_op(j, op, True), run_op(t, op, False)
        assert rj == rt, op
        if op[0] in ("admit", "release", "refresh_row", "request_delete"):
            pending.add(rt if op[0] == "admit" else op[1])
            continue
        if pending and op[0] != "admit_bulk":
            assert flushed[-1] == len(pending), op
            pending.clear()
        _, js = j.to_device()
        _, ts = t.to_device()
        for f in ARRAYS:
            assert np.array_equal(np.asarray(getattr(js, f)), getattr(ts, f).numpy()), (op, f)
        assert int(js.now) == int(ts.now)
    assert flushed == [3, 5, 3], flushed  # the reference pads to 4, 8 and 4


def test_rebase_moves_epoch_and_timers():
    sim = TorchSim(torch_load("pod-fast"), capacity=4, device="cpu")
    sim.admit(new_pod(0))
    sim.step(dt_ms=100)
    epoch0 = sim.epoch
    run_op(sim, ("fast_forward", REBASE_AT_MS + 123), False)
    sim.step(dt_ms=100)
    assert sim.now_ms == 100 and int(sim._soa.now) == 100
    assert sim.epoch - epoch0 == datetime.timedelta(milliseconds=REBASE_AT_MS + 123)


def test_mesh_is_not_ported_yet():
    """Only a parallel.mesh.Mesh is taken, of the device kind asked for;
    a CPU mesh pads the capacity to its shards (tests/test_torch_mesh.py
    holds the mesh path against JAX)."""
    from kwok_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(TypeError, match="Mesh"):
        TorchSim(torch_load("pod-fast"), capacity=4, device="cpu", mesh=object())
    mesh = make_mesh(devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="kind"):
        TorchSim(torch_load("pod-fast"), capacity=4, device="meta", mesh=mesh)
    sim = TorchSim(torch_load("pod-fast"), capacity=4, mesh=mesh)
    assert sim.mesh is mesh and sim.capacity == 6 and sim.device == torch.device("cpu")
