"""Entry points: a one-tick check and a sharded dry run of the port.

Counterparts of the JAX package's ``__graft_entry__.py``.  The
"flagship model" of this framework is the vectorized Stage-FSM tick
over the pod-general + pod-chaos stage set (the reference's most
feature-complete FSM: 9 stages, annotation overrides, weighted chaos,
finalizer/delete paths).

    python -m kwok_tpu_torch.graft_entry [N_SHARDS]

runs ``entry`` and then ``dryrun_multichip`` over N_SHARDS shards of
the card (4 by default).  Both run on the card unless given
``device="cpu"`` (``entry``) or CPU ``devices`` (``dryrun_multichip``).
"""

from __future__ import annotations

import functools
import sys
import time


def _build_sim(n_pods: int, chaos: bool = True, device=None):
    from kwok_tpu_torch.engine.simulator import DeviceSimulator
    from kwok_tpu_torch.stages import load_builtin

    stages = load_builtin("pod-general")
    if chaos:
        stages = stages + load_builtin("pod-chaos")
    sim = DeviceSimulator(stages, capacity=n_pods, seed=0, device=device)
    # homogeneous population → one feature extraction for all rows
    sim.admit_bulk(
        {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": "pod-{i}",
                "namespace": "default",
                "uid": "uid-{i}",
                "labels": {
                    "pod-container-running-failed.stage.kwok.x-k8s.io": "true"
                },
            },
            "spec": {
                "nodeName": "node-0",
                "containers": [{"name": "app", "image": "fake"}],
            },
            "status": {},
        },
        n_pods,
    )
    return sim


def entry(device=None):
    """One tick on the flagship FSM over a small pod population.
    Returns (fn, example_args): ``fn(*example_args)`` runs the tick."""
    from kwok_tpu_torch.ops.tick import tick

    sim = _build_sim(64, device=device)
    params, soa = sim.to_device()
    fn = functools.partial(tick, dt_ms=100)
    return fn, (params, soa)


def dryrun_multichip(n_devices: int, devices=None, n_rows: int = 65536) -> None:
    """Full sharded step over an ``n_devices`` mesh: row-sharded SoA
    (the framework's data-parallel axis, the analog of the reference's
    lease-sharded multi-instance scale-out), replicated stage tensors,
    ticks checked against an unsharded run, the multi-tick loop, then
    the full player drain with GC, checked against an unsharded player.

    The mesh is ``make_mesh(n_devices, devices)``: distinct cards, or
    the given device list, which may repeat a device (CPU shards, or
    several shards on one card)."""
    import numpy as np

    from kwok_tpu_torch.ops.tick import tick
    from kwok_tpu_torch.parallel.mesh import (
        make_mesh,
        pad_rows,
        place,
        sharded_run_ticks,
        sharded_tick,
    )

    mesh = make_mesh(n_devices, devices)
    device = mesh.devices[0]
    n_pods = pad_rows(n_rows, n_devices)
    sim = _build_sim(n_pods, device=device)
    params, soa = place(*sim.to_device(), mesh)

    step = sharded_tick(mesh, dt_ms=500)
    per_shard = [0] * n_devices
    total_sharded = 0
    n_ticks = 6
    for _ in range(n_ticks):
        soa, out = step(params, soa)
        total_sharded += int(out.fired_count)
        for i, part in enumerate(out.fired.parts):
            per_shard[i] += int(part.sum())

    # trajectory parity: the same population on ONE device must walk the
    # same FSM path (rows draw with their global index → identical draws)
    sim1 = _build_sim(n_pods, device=device)
    params1, soa1 = sim1.to_device()
    total_single = 0
    for _ in range(n_ticks):
        soa1, out1 = tick(params1, soa1, 500)
        total_single += int(out1.fired_count)
    stages_sharded = soa.column("stage").to_host().numpy()
    stages_single = soa1.stage.cpu().numpy()
    if total_sharded != total_single:
        raise AssertionError(f"sharded fired {total_sharded} != single-device {total_single}")
    if not np.array_equal(stages_sharded, stages_single):
        raise AssertionError("per-row stage assignments diverged between sharded and single")
    if total_sharded <= 0:
        raise AssertionError("no transitions fired in dry run")
    if sum(per_shard) != total_sharded:
        raise AssertionError(f"per-shard fires {per_shard} do not sum to {total_sharded}")

    # the multi-tick device loop (the bench path) also runs sharded
    loop = sharded_run_ticks(mesh, dt_ms=500, num_ticks=4)
    soa, count = loop(params, soa)
    loop_fired = int(count)

    lo, hi = min(per_shard), max(per_shard)
    print(
        f"dryrun_multichip: {n_devices} shards, {n_pods} rows, "
        f"{total_sharded} transitions, parity OK, "
        f"per-shard fired={per_shard} (min {lo} / max {hi}), "
        f"loop fired {loop_fired} more",
        flush=True,
    )

    # ---- full player drain, sharded: the whole DeviceStagePlayer
    # pipeline — store + informer admission + dirty-row drain +
    # ownerReference GC — over the mesh, with STORE-level status parity
    # against a single-device player.  Multi-instance semantics analog:
    # reference controller.go:286-296.
    drain_rows, drained, gc_reaped = _dryrun_player_drain(mesh, n_pods)
    print(
        f"dryrun_multichip: player drain sharded over {n_devices} shards, "
        f"{drain_rows} rows, {drained} transitions, store status parity OK, "
        f"gc reaped {gc_reaped} orphans",
        flush=True,
    )


def _dryrun_player_drain(mesh, n_rows: int) -> tuple:
    """Run the full drain pipeline sharded vs single-device and check
    that the two stores converge to identical pod statuses."""
    from kwok_tpu_torch.cluster.informer import WatchOptions
    from kwok_tpu_torch.cluster.store import NotFound, ResourceStore
    from kwok_tpu_torch.controllers.device_player import DeviceStagePlayer
    from kwok_tpu_torch.controllers.gc_controller import GCController
    from kwok_tpu_torch.controllers.pod_controller import PodEnv
    from kwok_tpu_torch.stages import load_builtin

    device = mesh.devices[0]

    def build(use_mesh):
        store = ResourceStore()
        ops = []
        for i in range(n_rows):
            ops.append(
                {
                    "verb": "create",
                    "data": {
                        "apiVersion": "v1",
                        "kind": "Pod",
                        "metadata": {
                            "name": f"pod-{i}",
                            "namespace": "default",
                            "labels": {
                                "pod-container-running-failed.stage.kwok.x-k8s.io": "true"
                            },
                        },
                        "spec": {
                            "nodeName": "node-0",
                            "containers": [{"name": "app", "image": "fake"}],
                        },
                        "status": {},
                    },
                }
            )
        for k in range(0, n_rows, 10000):
            store.bulk(ops[k : k + 10000])
        # one GC orphan: parent never exists, so the sharded run's kcm
        # seat must reap it while the drain churns.  A ConfigMap, not a
        # Pod: the GC delete is asymmetric (sharded store only), and a
        # Pod orphan would draw from the pod-IP pool and shift every
        # later allocation when reaped mid-wave.
        store.create(
            {
                "apiVersion": "v1",
                "kind": "ConfigMap",
                "metadata": {
                    "name": "orphan",
                    "namespace": "default",
                    "ownerReferences": [
                        {
                            "apiVersion": "v1",
                            "kind": "Pod",
                            "name": "no-such-parent",
                            "uid": "nope",
                        }
                    ],
                },
            }
        )
        env = PodEnv()
        stages = load_builtin("pod-general") + load_builtin("pod-chaos")
        player = DeviceStagePlayer(
            store,
            "Pod",
            stages,
            capacity=n_rows + 8,
            tick_ms=500,
            funcs_for=env.funcs,
            on_delete=env.release,
            seed=11,
            mesh=use_mesh,
            device=device,
        )
        player.cache = player._informer.watch_with_cache(
            WatchOptions(), player.events, done=player._done
        )
        return store, player

    store_m, player_m = build(mesh)
    store_1, player_1 = build(None)
    gc_ctrl = None
    try:
        # full admission FIRST: the reflector feeds rows asynchronously,
        # and stepping before both players hold the complete population
        # would start rows at different virtual times
        deadline = time.monotonic() + 180
        want = n_rows  # the orphan is a ConfigMap; the Pod player never sees it
        while (
            len(player_m._rows) < want or len(player_1._rows) < want
        ) and time.monotonic() < deadline:
            for player in (player_m, player_1):
                player._drain_events()
            time.sleep(0.2)
        if not len(player_m._rows) == want == len(player_1._rows):
            raise AssertionError(
                f"admission incomplete: {len(player_m._rows)}/{len(player_1._rows)} of {want}"
            )
        # the kcm seat joins once the population is stable, and reaps
        # the orphan while the churn below runs
        gc_ctrl = GCController(store_m).start()
        # identical virtual-time walks: same tick widths in lockstep
        for _ in range(6):
            for player in (player_m, player_1):
                player._drain_events()
                player.step_batch(500, 2)

        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                store_m.get("ConfigMap", "orphan", namespace="default")
            except NotFound:  # reaped
                break
            time.sleep(0.2)
    finally:
        if gc_ctrl is not None:
            gc_ctrl.stop()
        player_m._done.set()
        player_1._done.set()

    if player_m.transitions <= 0:
        raise AssertionError("sharded player drained nothing")
    # store-level status parity, the controller seam's ground truth
    items_m, _ = store_m.list("Pod", copy=False)
    items_1, _ = store_1.list("Pod", copy=False)
    by_name_m = {o["metadata"]["name"]: o.get("status") for o in items_m}
    by_name_1 = {o["metadata"]["name"]: o.get("status") for o in items_1}
    if len(by_name_m) != len(by_name_1):
        raise AssertionError(f"row counts diverged: {len(by_name_m)} vs {len(by_name_1)}")
    mismatch = [n for n, st in by_name_m.items() if by_name_1.get(n) != st]
    if mismatch:
        raise AssertionError(
            f"{len(mismatch)} rows diverged between sharded and single-device "
            f"players, e.g. {mismatch[:3]}"
        )
    reaped = 0
    try:
        store_m.get("ConfigMap", "orphan", namespace="default")
    except NotFound:
        reaped = 1
    if reaped != 1:
        raise AssertionError("GC controller did not reap the orphan mid-drain")
    return len(by_name_m), player_m.transitions, reaped


if __name__ == "__main__":
    import torch

    shards = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    fn, args = entry()
    soa, out = fn(*args)
    print("entry tick OK, fired:", int(out.fired_count))
    dryrun_multichip(shards, devices=[torch.device("cuda", 0)] * shards)
