"""kwok_tpu_torch.parallel.distributed: one logical simulator over a
2-process torch.distributed world on gloo.

The scenario of tests/test_distributed.py::test_two_process_global_mesh_parity
on the port: 2 processes x 4 CPU shards = one 8-shard rows mesh.  Each
process uploads only its own row block, ticks its own shards, reads
only its own rows, and joins the other in one all_reduce of the fired
count; its ticks fire as a single-device run of the same population
does.  This file is also the worker: pytest runs it in subprocesses
(``python tests/test_torch_distributed.py <pid> <nprocs> <port> <rows>``),
so torch.distributed is never initialized in the pytest process.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCAL_SHARDS = 4


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_global_mesh_parity():
    port = free_port()
    n_rows = 64
    env = {**os.environ, "PYTHONPATH": REPO}
    for k in ("KWOK_COORDINATOR", "KWOK_NUM_PROCESSES", "KWOK_PROCESS_ID"):
        env.pop(k, None)
    workers = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(pid), "2", str(port), str(n_rows)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for w in workers:
            out, _ = w.communicate(timeout=120)
            outs.append(out)
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait(timeout=10)
    for w, out in zip(workers, outs):
        assert w.returncode == 0, out
    lines = [line for out in outs for line in out.splitlines() if line.startswith("proc=")]
    assert len(lines) == 2, outs
    assert all("parity=OK" in line and "block_ok=True" in line for line in lines), lines
    # the two processes drained disjoint halves that sum to the total
    totals = [int(line.split("total=")[1].split()[0]) for line in lines]
    locals_ = [int(line.split("local_fired=")[1].split()[0]) for line in lines]
    assert totals[0] == totals[1] == sum(locals_)
    assert all(n > 0 for n in locals_)


def test_single_process_initialize_is_a_no_op():
    from kwok_tpu_torch.parallel import distributed

    assert distributed.initialize(None, None, None) is False
    assert distributed.initialize("127.0.0.1:1", 1, 0, device="cpu") is False
    with pytest.raises(ValueError, match="process id"):
        distributed.initialize("127.0.0.1:1", 2, None, device="cpu")
    # outside a world: one process holds every row
    assert distributed.process_row_block(64) == (0, 64)
    mesh = distributed.global_mesh(["cpu"] * 2)
    assert (mesh.size, mesh.process_count, list(mesh.local_shards)) == (2, 1, [0, 1])


def worker(pid: int, nprocs: int, port: int, n_rows: int) -> int:
    import numpy as np

    from kwok_tpu_torch.engine.simulator import DeviceSimulator
    from kwok_tpu_torch.ops.tick import tick
    from kwok_tpu_torch.parallel import distributed
    from kwok_tpu_torch.parallel.mesh import replicate, sharded_tick
    from kwok_tpu_torch.stages import load_builtin

    joined = distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=nprocs, process_id=pid,
        device="cpu",
    )
    import torch.distributed as dist

    assert joined and dist.get_world_size() == nprocs

    def build_sim():
        stages = load_builtin("pod-general") + load_builtin("pod-chaos")
        sim = DeviceSimulator(stages, capacity=n_rows, seed=0, device="cpu")
        sim.admit_bulk(
            {
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {
                    "name": "pod",
                    "namespace": "default",
                    "uid": "uid",
                    "labels": {"pod-container-running-failed.stage.kwok.x-k8s.io": "true"},
                },
                "spec": {"nodeName": "node-0", "containers": [{"name": "app", "image": "fake"}]},
                "status": {},
            },
            n_rows,
        )
        return sim

    try:
        mesh = distributed.global_mesh(["cpu"] * LOCAL_SHARDS)
        assert mesh.size == nprocs * LOCAL_SHARDS

        sim = build_sim()
        params, soa = sim.to_device()
        # replicate params / upload only this process's row block
        params = replicate(params, mesh)
        gsoa = distributed.make_global_soa(soa, mesh)

        step = sharded_tick(mesh, dt_ms=500)
        n_ticks = 5
        total = 0
        local_fired = 0
        for _ in range(n_ticks):
            gsoa, out = step(params, gsoa)
            total += int(out.fired_count)
            _, vals = distributed.local_rows(out.fired)
            local_fired += int(vals.sum())

        # single-device reference of the same population, local to this proc
        sim2 = build_sim()
        p1, s1 = sim2.to_device()
        ref_total = 0
        for _ in range(n_ticks):
            s1, out1 = tick(p1, s1, 500)
            ref_total += int(out1.fired_count)

        rows_idx, local_stage = distributed.local_rows(gsoa.column("stage"))
        lo, hi = distributed.process_row_block(n_rows)
        block_ok = bool((rows_idx == np.arange(lo, hi)).all())
        ref_stage = s1.stage.numpy()[lo:hi]
        parity = total == ref_total and bool((local_stage == ref_stage).all())

        print(
            f"proc={pid} total={total} local_fired={local_fired} "
            f"block={lo}:{hi} block_ok={block_ok} parity={'OK' if parity else 'FAIL'}",
            flush=True,
        )
        return 0 if parity and block_ok and total > 0 else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(worker(*(int(a) for a in sys.argv[1:5])))
