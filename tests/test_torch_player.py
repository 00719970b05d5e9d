"""The port's DeviceStagePlayer (kwok_tpu_torch.controllers.device_player)
on the CPU, where its simulator runs the kernels' plain versions:

- the scenarios of tests/test_fused_drain.py, tests/test_pipelined.py
  and tests/test_shutdown.py;
- a JAX player and a port player on one seed and the same objects,
  stepped by hand on a fake clock through ``step_batch``,
  ``step_pipelined`` and ``flush_pipeline``, leave equal store objects,
  equal events and equal ``transitions``/``patches`` counters.
"""

import os
import random
import subprocess
import sys
import time

import pytest

from kwok_tpu.cluster.informer import InformerEvent as JaxInformerEvent
from kwok_tpu.cluster.store import EventRecorder as JaxRecorder
from kwok_tpu.cluster.store import ResourceStore as JaxStore
from kwok_tpu.controllers.device_player import DeviceStagePlayer as JaxPlayer
from kwok_tpu.controllers.pod_controller import PodEnv as JaxPodEnv
from kwok_tpu.stages import load_builtin as jax_load
from kwok_tpu.utils.clock import FakeClock as JaxClock
from kwok_tpu_torch.cluster.informer import InformerEvent, WatchOptions
from kwok_tpu_torch.cluster.store import EventRecorder, ResourceStore
from kwok_tpu_torch.controllers.device_player import _FAST, DeviceStagePlayer
from kwok_tpu_torch.controllers.pod_controller import PodEnv
from kwok_tpu_torch.engine.simulator import DEFAULT_EPOCH
from kwok_tpu_torch.stages import load_builtin
from kwok_tpu_torch.utils.clock import FakeClock

from tests.test_controllers import make_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAOS = "pod-container-running-failed.stage.kwok.x-k8s.io"

needs_fused = pytest.mark.skipif(
    _FAST is None or not hasattr(_FAST, "fused_group"),
    reason="native fastdrain unavailable",
)


def chaos_pod(name):
    pod = make_pod(name)
    pod["metadata"]["labels"] = {CHAOS: "true"}
    return pod


# ------------------------------------------- scenarios of test_fused_drain.py


def chaos_player(store, capacity=16):
    env = PodEnv()
    return DeviceStagePlayer(
        store, "Pod", load_builtin("pod-general") + load_builtin("pod-chaos"),
        capacity=capacity, tick_ms=100, funcs_for=env.funcs, on_delete=env.release,
        seed=5, device="cpu",
    )


def watched(player):
    player.cache = player._informer.watch_with_cache(
        WatchOptions(), player.events, done=player._done
    )
    time.sleep(0.2)
    return player


def drive(player, rounds=8):
    for _ in range(rounds):
        player._drain_events()
        player.step_batch(100, 10)


@needs_fused
def test_fused_lane_commits_and_matches_store_state():
    store = ResourceStore()
    for i in range(4):
        store.create(chaos_pod(f"p{i}"))
    player = watched(chaos_player(store))
    assert player._fused, "the port player should take the fused native drain"
    drive(player)
    assert player.transitions >= 8
    for i in range(4):
        obj = store.get("Pod", f"p{i}", namespace="default")
        assert obj["status"]["phase"] in ("Running", "Failed")
        assert int(obj["metadata"]["resourceVersion"]) > 4
        row = player._rows[("default", f"p{i}")]
        assert player.sim.objects[row]["status"] == obj["status"]
    player._done.set()


@needs_fused
def test_fused_lane_denied_with_live_status_watcher():
    store = ResourceStore()
    for i in range(2):
        store.create(chaos_pod(f"p{i}"))
    player = chaos_player(store)
    w = store.watch("Pod")
    watched(player)
    drive(player)
    assert player.transitions >= 4
    assert any((ev.object.get("status") or {}).get("phase") == "Failed" for ev in list(w._events))
    w.stop()
    player._done.set()


@needs_fused
def test_fused_lane_releases_rows_gone_from_store():
    store = ResourceStore()
    store.create(chaos_pod("p0"))
    player = watched(chaos_player(store))
    drive(player, 4)
    assert ("default", "p0") in player._rows
    store.patch("Pod", "p0", {"metadata": {"finalizers": None}}, "merge", namespace="default")
    store.delete("Pod", "p0", namespace="default")
    player.events.drain()
    drive(player, 12)
    assert ("default", "p0") not in player._rows
    player._done.set()


@needs_fused
def test_fused_skips_stale_mirror_until_event_refreshes():
    store = ResourceStore()
    store.create(chaos_pod("p0"))
    player = watched(chaos_player(store))
    drive(player, 6)
    store.patch("Pod", "p0", {"metadata": {"annotations": {"x": "1"}}}, "merge",
                namespace="default")
    drive(player, 8)
    obj = store.get("Pod", "p0", namespace="default")
    assert obj["metadata"]["annotations"] == {"x": "1"}, "external write lost"
    assert obj["status"]["phase"] in ("Running", "Failed")
    player._done.set()


@needs_fused
def test_fused_drain_converges_under_external_interleaving():
    rng = random.Random(7)
    store = ResourceStore()
    n = 64
    for i in range(n):
        store.create(chaos_pod(f"p{i}"))
    player = watched(chaos_player(store, capacity=n + 16))
    drive(player, 4)
    deleted = set()
    for round_no in range(12):
        for _ in range(6):
            name = f"p{rng.randrange(n)}"
            op = rng.random()
            try:
                if op < 0.5:
                    store.patch("Pod", name, {"metadata": {"annotations": {"ext": str(round_no)}}},
                                "merge", namespace="default")
                elif op < 0.75 and name not in deleted:
                    store.patch("Pod", name, {"metadata": {"finalizers": None}}, "merge",
                                namespace="default")
                    store.delete("Pod", name, namespace="default")
                    deleted.add(name)
                elif name in deleted:
                    store.create(chaos_pod(name))
                    deleted.discard(name)
            except Exception:  # noqa: BLE001 — racing the drain is the point
                pass
        drive(player, 1)
    drive(player, 6)
    pods, _ = store.list("Pod")
    by_name = {p["metadata"]["name"]: p for p in pods}
    for (ns, name), row in list(player._rows.items()):
        assert name in by_name, f"row for deleted pod {name} leaked"
        mirror = player.sim.objects[row]
        assert mirror is not None
        assert mirror["status"] == by_name[name]["status"], name
        assert mirror["metadata"]["resourceVersion"] == by_name[name]["metadata"]["resourceVersion"]
    for name, p in by_name.items():
        if ("default", name) in player._rows:
            assert (p.get("status") or {}).get("phase") in ("Running", "Failed", "Pending"), name
    player._done.set()


# --------------------------------------------- scenarios of test_pipelined.py


def fast_player(store, n_pods=4, tick_ms=20):
    env = PodEnv()
    player = DeviceStagePlayer(
        store, "Pod", load_builtin("pod-fast"), capacity=max(n_pods, 4), tick_ms=tick_ms,
        funcs_for=env.funcs, on_delete=env.release, device="cpu",
    )
    for i in range(n_pods):
        pod = make_pod(f"pod-{i}")
        pod["metadata"]["uid"] = f"uid-pod-{i}"
        store.create(pod)
    return player


def admit_all(player, store, event_cls=InformerEvent):
    objs, _ = store.list("Pod")
    for obj in objs:
        player.events.add(event_cls("ADDED", obj))
    player._drain_events()


def phase(store, name):
    return (store.get("Pod", name, namespace="default").get("status") or {}).get("phase")


def test_mutations_land_one_macro_tick_late():
    store = ResourceStore()
    player = fast_player(store)
    admit_all(player, store)
    assert player.step_pipelined(20, 8) == 0
    assert player._inflight is not None
    assert player.transitions == 0, "drain must lag the dispatch by one call"
    assert player.step_pipelined(20, 8) > 0
    assert player.transitions > 0
    assert phase(store, "pod-0") == "Running"
    player.flush_pipeline()


def test_flush_pipeline_drains_final_batch():
    store = ResourceStore()
    player = fast_player(store)
    admit_all(player, store)
    player.step_pipelined(20, 8)
    assert player._inflight is not None
    assert player.flush_pipeline() > 0
    assert player._inflight is None
    assert player.transitions > 0
    assert player.flush_pipeline() == 0


def test_stop_flushes_in_flight_batch():
    store = ResourceStore()
    player = fast_player(store)
    admit_all(player, store)
    player.step_pipelined(20, 8)
    assert player._inflight is not None
    player.stop()
    assert player._inflight is None
    assert player.transitions > 0


def test_released_row_refiring_is_dropped():
    store = ResourceStore()
    player = fast_player(store)
    admit_all(player, store)
    player.step_pipelined(20, 8)
    for key in list(player._rows):
        with player._mut:
            player._release_locked(key)
    player.flush_pipeline()
    assert player.transitions == 0
    assert player.patches == 0
    for i in range(4):
        assert phase(store, f"pod-{i}") is None


def test_flavor_mixing_preserves_order():
    store = ResourceStore()
    player = fast_player(store)
    admit_all(player, store)
    player.step_pipelined(20, 8)
    assert player._inflight is not None
    player.step_batch(20, 1)
    assert player._inflight is None
    assert player.transitions > 0
    assert phase(store, "pod-0") == "Running"


def test_unpaced_start_runs_production_loop():
    store = ResourceStore()
    player = fast_player(store)
    player.start(paced=False)
    try:
        deadline = time.time() + 15
        while time.time() < deadline and player.transitions < 4:
            time.sleep(0.05)
        assert player.transitions >= 4
        assert phase(store, "pod-0") == "Running"
    finally:
        player.stop()
    assert player._inflight is None


def test_paced_loop_catches_up_with_macro_ticks():
    store = ResourceStore()
    player = fast_player(store, tick_ms=5)
    player.start(paced=True)
    try:
        deadline = time.time() + 15
        while time.time() < deadline and player.transitions < 4:
            time.sleep(0.05)
        assert player.transitions >= 4
    finally:
        player.stop()


def test_mesh_is_refused_until_ported():
    """A mesh that is not a parallel.mesh.Mesh is refused; on a CPU mesh
    the player shards its rows, and step_pipelined takes step_batch (the
    mesh path ticks one tick at a time and keeps nothing in flight)."""
    from kwok_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(TypeError, match="Mesh"):
        DeviceStagePlayer(ResourceStore(), "Pod", load_builtin("pod-fast"), mesh=object(),
                          device="cpu")
    store = ResourceStore()
    env = PodEnv()
    player = DeviceStagePlayer(
        store, "Pod", load_builtin("pod-fast"), capacity=5, tick_ms=20,
        funcs_for=env.funcs, on_delete=env.release, device="cpu",
        mesh=make_mesh(devices=["cpu"] * 4),
    )
    assert player.sim.capacity == 8
    for i in range(4):
        store.create(make_pod(f"pod-{i}"))
    admit_all(player, store)
    fired = sum(player.step_pipelined(20, 10) for _ in range(5))
    assert player._inflight is None and fired == player.transitions > 0
    assert all(phase(store, f"pod-{i}") == "Running" for i in range(4))


# ---------------------------------------------- scenarios of test_shutdown.py

SHUTDOWN_SCRIPT = r"""
import os, sys, time
sys.path.insert(0, %(repo)r)
sys.modules["jax"] = None  # the port must not need it

from kwok_tpu_torch.cluster.store import ResourceStore
from kwok_tpu_torch.controllers.device_player import DeviceStagePlayer
from kwok_tpu_torch.controllers.pod_controller import PodEnv
from kwok_tpu_torch.stages import load_builtin

N = 20000

class SlowStore(ResourceStore):
    # status commits crawl; the zero-copy lane is denied, so the drain
    # takes the staged path and a macro-tick outlives any bounded grace
    def status_lane(self, kind, exclude):
        from contextlib import nullcontext
        return nullcontext(None)
    def apply_status_batch(self, kind, items, exclude=None):
        time.sleep(1.0)
        return super().apply_status_batch(kind, items, exclude=exclude)

store = SlowStore()
env = PodEnv()
player = DeviceStagePlayer(
    store, "Pod", load_builtin("pod-general") + load_builtin("pod-chaos"), capacity=N,
    tick_ms=100, funcs_for=env.funcs, on_delete=env.release, seed=7, device="cpu",
)
pod = {
    "apiVersion": "v1", "kind": "Pod",
    "metadata": {"name": "p", "namespace": "default", "uid": "u",
                 "labels": {"pod-container-running-failed.stage.kwok.x-k8s.io": "true"}},
    "spec": {"nodeName": "n", "containers": [{"name": "c", "image": "x"}]},
    "status": {},
}
ops = []
for i in range(N):
    p = {k: (dict(v) if isinstance(v, dict) else v) for k, v in pod.items()}
    p["metadata"] = dict(pod["metadata"], name=f"p{i}")
    ops.append({"verb": "create", "data": p})
for i in range(0, N, 5000):
    store.bulk(ops[i:i+5000])
player.start(paced=False)
deadline = time.time() + 60
while len(player._rows) < N and time.time() < deadline:
    time.sleep(0.2)
while player.patches == 0 and time.time() < deadline:
    time.sleep(0.2)
if os.environ.get("MODE") == "crash":
    # the embedder crashes mid-drain and never calls stop(): the atexit
    # net must abort the drain and join the tick thread
    print("CRASHING", flush=True)
    raise SystemExit(3)
t0 = time.time()
player.stop()
took = time.time() - t0
alive = any(t.is_alive() for t in player._threads)
print(f"STOPPED in {took:.1f}s alive={alive}", flush=True)
assert not alive, "tick thread survived stop()"
assert took < 60, f"stop() took {took:.1f}s"
"""


@pytest.mark.parametrize("mode,rc", [("clean", 0), ("crash", 3)])
def test_stop_mid_drain_exits_clean(mode, rc):
    """Stopping (or crashing out of) a player whose tick thread is
    mid-drain ends the thread and exits with the program's own code,
    never the teardown abort (134)."""
    proc = subprocess.run(
        [sys.executable, "-c", SHUTDOWN_SCRIPT % {"repo": REPO}],
        capture_output=True, text=True, timeout=240,
        # one intra-op thread: the test shares the machine with other workers
        env=dict(os.environ, MODE=mode, OMP_NUM_THREADS="1"),
    )
    out = f"rc={proc.returncode}\n{proc.stdout}\n{proc.stderr[-2000:]}"
    assert proc.returncode == rc, out
    assert ("STOPPED" if mode == "clean" else "CRASHING") in proc.stdout, out
    assert "Aborted" not in proc.stderr and "terminate called" not in proc.stderr, out


# ------------------------------------------ both packages, stepped by hand


def run_hand_stepped(port: bool):
    """One player stepped by hand on a fake clock: 24 pods of
    pod-general + pod-chaos (half labelled for chaos), deletes between
    steps, every step flavor.  Returns the store's pods and events and
    the player's counters."""
    # the clock starts at the simulator's epoch, so deletionTimestamps
    # land in its virtual-ms range
    clock = (FakeClock if port else JaxClock)(start=DEFAULT_EPOCH.timestamp())
    store = (ResourceStore if port else JaxStore)(clock=clock)
    seq = iter(range(10**6))
    recorder = (EventRecorder if port else JaxRecorder)(
        store, source="kwok", clock=clock, suffix=lambda: f"{next(seq):06d}")
    env = (PodEnv if port else JaxPodEnv)()
    load = load_builtin if port else jax_load
    extra = {"device": "cpu"} if port else {}
    player = (DeviceStagePlayer if port else JaxPlayer)(
        store, "Pod", load("pod-general") + load("pod-chaos"), capacity=16, tick_ms=100,
        clock=clock, recorder=recorder, funcs_for=env.funcs, on_delete=env.release,
        seed=11, **extra)
    event = InformerEvent if port else JaxInformerEvent
    for i in range(24):  # 24 pods grow the 16-row SoA
        pod = chaos_pod(f"p{i}") if i % 2 else make_pod(f"p{i}")
        pod["metadata"]["uid"] = f"uid-{i}"
        store.create(pod)
    admit_all(player, store, event)

    def delete(name):
        store.delete("Pod", name, namespace="default")
        try:
            obj = store.get("Pod", name, namespace="default")
            player.events.add(event("MODIFIED", obj))
        except Exception:  # noqa: BLE001 — gone at once: no finalizer
            player.events.add(event("DELETED", {**make_pod(name)}))
        player._drain_events()

    counters = []
    player.step_batch(100, 1)
    player.step_batch(100, 8)
    for k in range(3):
        player.step_pipelined(100, 8)
        clock.advance(0.8)
    delete("p3"), delete("p4")
    player.step_pipelined(100, 4)
    player.flush_pipeline()
    counters.append((player.transitions, player.patches))
    player.step_batch(100, 16)
    delete("p5")
    for k in range(4):
        player.step_pipelined(100, 8)
    player.flush_pipeline()
    player.step_batch(100, 2)
    counters.append((player.transitions, player.patches))
    pods = sorted(store.list("Pod")[0], key=lambda o: o["metadata"]["name"])
    events = sorted(store.list("Event")[0], key=lambda o: o["metadata"]["name"])
    return pods, events, counters


def test_port_player_equals_jax_player_stepped_by_hand():
    jax_pods, jax_events, jax_counters = run_hand_stepped(port=False)
    pods, events, counters = run_hand_stepped(port=True)
    assert counters == jax_counters
    assert counters[-1][0] > 24, "too few transitions to compare"
    assert len(pods) < 24, "no delete reached the store"
    assert [p["metadata"]["name"] for p in pods] == [p["metadata"]["name"] for p in jax_pods]
    for got, want in zip(pods, jax_pods):
        assert got == want, got["metadata"]["name"]
    assert events == jax_events
