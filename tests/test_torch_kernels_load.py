"""The CUDA kernels are built and loaded once per process, outside every
lock, and a launch never builds one (``ops/kernels.py``).

On the CPU, ``nvcc`` is replaced by a fake compiler: a script that logs
each call and builds, with gcc, a shared library holding the kernels' C
entry points as stubs.  Two threads' first use at once builds each
source once, racing builds never share a temporary file, and the owners
of tensors (a device player's simulator, a lease lane) load the kernels
when they are built, so that their launches, made under their locks,
only read the loaded libraries.
"""

import shutil
import sys
import threading
from pathlib import Path

import pytest
import torch

from kwok_tpu_torch.cluster.store import ResourceStore
from kwok_tpu_torch.controllers.device_lease import DeviceLeaseLane
from kwok_tpu_torch.controllers.device_player import DeviceStagePlayer
from kwok_tpu_torch.controllers.node_lease_controller import NodeLeaseController
from kwok_tpu_torch.controllers.pod_controller import PodEnv
from kwok_tpu_torch.ops import kernels
from kwok_tpu_torch.ops import tick as T
from kwok_tpu_torch.parallel.mesh import ROW_FIELDS
from kwok_tpu_torch.stages import load_builtin

pytestmark = pytest.mark.skipif(shutil.which("gcc") is None, reason="the fake nvcc needs gcc")

STUB_C = """
#include <stddef.h>
int kwok_tick_rows(void *args, void *stream) { return 0; }
int kwok_threefry_draws(void *key, long n, void *pairs, void *u, void *stream) { return 0; }
size_t kwok_tick_smem_bytes(int S, int KC, int C) { return 0; }
int kwok_host_mapped(void *host) { return 1; }
int kwok_scatter_rows(void *args, void *stream) { return 0; }
int kwok_lease_tick(void *args, void *stream) { return 0; }
"""

FAKE_NVCC = """#!{python}
import os, subprocess, sys, threading, time
args = sys.argv[1:]
out, src = args[args.index("-o") + 1], args[-1]
with open(os.environ["FAKE_NVCC_LOG"], "a") as log:
    log.write(os.path.basename(src) + " " + out + "\\n")
time.sleep(0.5)  # long enough for a second caller to arrive mid-build
subprocess.run(["gcc", "-shared", "-fPIC", "-x", "c", "-o", out, os.environ["FAKE_NVCC_STUB"]],
               check=True)
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """``nvcc`` replaced by the fake compiler, building into ``tmp_path``
    with nothing loaded; returns a reader of its calls: (source, -o path)."""
    script, stub, log = tmp_path / "nvcc", tmp_path / "stub.c", tmp_path / "nvcc.log"
    script.write_text(FAKE_NVCC.format(python=sys.executable))
    script.chmod(0o755)
    stub.write_text(STUB_C)
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setenv("FAKE_NVCC_STUB", str(stub))
    build = tmp_path / "build"
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "BUILD_DIR", build)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(script))
    monkeypatch.setattr(kernels, "_lib_path", lambda src: build / f"{Path(src).stem}.so")

    def calls():
        if not log.exists():
            return []
        return [tuple(line.split()) for line in log.read_text().splitlines()]

    return calls


def at_once(*fns):
    """Run each function on a thread of its own, all released together."""
    barrier = threading.Barrier(len(fns))
    errors = []

    def run(fn):
        barrier.wait()
        try:
            fn()
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(fn,)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors


def test_two_threads_first_use_build_each_source_once(fake_nvcc):
    seen = []
    at_once(lambda: seen.append(kernels.load()), lambda: seen.append(kernels.load()))
    assert sorted(src for src, _ in fake_nvcc()) == sorted(kernels.SOURCES)
    assert set(kernels._libs) == set(kernels.SOURCES)
    assert kernels._lib("lease.cu") is kernels._libs["lease.cu"]
    # loaded: a third use builds nothing and returns at once
    assert kernels.load() < 0.1 and len(fake_nvcc()) == len(kernels.SOURCES)


def test_racing_builds_write_temporary_files_of_their_own(fake_nvcc):
    at_once(lambda: kernels.build(("lease.cu",)), lambda: kernels.build(("lease.cu",)))
    calls = fake_nvcc()
    assert [src for src, _ in calls] == ["lease.cu", "lease.cu"]
    tmps = [out for _, out in calls]
    assert len(set(tmps)) == 2 and all(t.endswith(".tmp") for t in tmps)
    assert kernels._lib_path("lease.cu").exists()
    assert not list(kernels.BUILD_DIR.glob("*.tmp"))


def test_a_launch_reads_a_loaded_library_and_never_builds(fake_nvcc):
    with pytest.raises(RuntimeError, match=r"load\(\)"):
        kernels._lib("tick.cu")
    assert fake_nvcc() == []


def _plain_launchers(monkeypatch):
    """The kernel branch of every wrapper taken on the CPU: each launcher
    reads its loaded library, as the real one does, then runs the plain
    version in its place."""
    monkeypatch.setattr(T, "_on_cuda", lambda t: True)

    def tick_rows(params, soa, dt_ms, num_ticks, mode, row_offset=0, host=None):
        kernels._lib("tick.cu")
        assert host is None  # a CPU simulator writes no pinned block
        if mode == kernels.MODE_COLLECT:
            out, outs = T._run_ticks_collect_impl(params, soa, dt_ms, num_ticks)
        elif mode == kernels.MODE_SINGLE:
            out, outs = T._tick_impl(params, soa, dt_ms)
            outs = tuple(outs)
        else:
            out, outs = T._run_ticks_impl(params, soa, dt_ms, num_ticks)
        for f in ROW_FIELDS:
            getattr(soa, f).copy_(getattr(out, f))
        return out.now, out.key, outs

    def scatter_rows(soa, batch, layout):
        kernels._lib("scatter.cu")
        T._scatter_rows_impl(soa, *(torch.from_numpy(v) for v in
                                    T.PackedBatch(layout, batch).segments()))

    def lease_tick(fire_at, key, now, renew_ms, jitter_ms):
        kernels._lib("lease.cu")
        lane, due, lag = T._lease_tick_impl(T.LeaseLane(fire_at, key), now, renew_ms, jitter_ms)
        return lane.fire_at, due, lag, lane.key

    monkeypatch.setattr(kernels, "tick_rows", tick_rows)
    monkeypatch.setattr(kernels, "scatter_rows", scatter_rows)
    monkeypatch.setattr(kernels, "lease_tick", lease_tick)


def test_owners_load_before_their_locks_and_launches_never_build(fake_nvcc, monkeypatch):
    _plain_launchers(monkeypatch)
    owners, held_at_build = [], []
    build = kernels.build

    def watched_build(sources=kernels.SOURCES):
        held_at_build.append([o._mut.locked() for o in owners])
        return build(sources)

    monkeypatch.setattr(kernels, "build", watched_build)
    store = ResourceStore()
    env = PodEnv()
    built = {}
    # the node lease lane and a pod player, built at once on two threads
    at_once(
        lambda: built.update(lane=DeviceLeaseLane(
            NodeLeaseController(store, "kwok-a"), capacity=16, device="cpu")),
        lambda: built.update(player=DeviceStagePlayer(
            store, "Pod", load_builtin("pod-general") + load_builtin("pod-chaos"),
            capacity=16, funcs_for=env.funcs, on_delete=env.release, device="cpu")),
    )
    lane, player = built["lane"], built["player"]
    owners += [lane, player]
    assert sorted(src for src, _ in fake_nvcc()) == sorted(kernels.SOURCES)
    assert len(held_at_build) == 1

    # launches under the owners' locks read the loaded libraries: pods
    # admitted once the state is on the device go up as a scattered batch
    T.reset_launches()
    for i in range(6):
        pod = {"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": f"p{i}", "namespace": "default", "uid": f"u{i}",
                            "labels": {"pod-container-running-failed.stage.kwok.x-k8s.io":
                                       "true"}},
               "spec": {"nodeName": "n0", "containers": [{"name": "c", "image": "i"}]}}
        store.create(pod)
        player.events.add(type("Event", (), {"type": "ADDED", "object": pod})())
        if i in (0, 5):
            player._drain_events()
            for _ in range(3):
                player.step_batch(100, 8)
    for name in ("n0", "n1"):
        lane.register(name)
    for k in range(1, 4):  # none due, then due (no Lease: handed back)
        lane.tick(k * lane.renew_ms // 2)
    launched = T.launches()
    assert launched["run_ticks_collect"] > 0 and launched["lease_tick"] > 0, launched
    assert launched["scatter_rows"] > 0, launched
    assert len(held_at_build) == 1 and not any(held_at_build[0])
    assert len(fake_nvcc()) == len(kernels.SOURCES)
    assert sorted(kernels._libs) == sorted(kernels.SOURCES)
