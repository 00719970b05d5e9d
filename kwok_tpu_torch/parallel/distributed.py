"""Multi-process scale-out: a torch.distributed world and cross-process
row sharding.

Port of ``kwok_tpu/parallel/distributed.py``.  Two cooperating layers
give kwok the reference's multi-instance scale-out (reference
pkg/kwok/controllers/controller.go:286-296: N kwok processes shard a
cluster by Lease ownership):

1. **Ownership plane (host)**: each process's NodeLeaseController
   acquires leases, and a node's rows (and its pods') live in the SoA of
   the process holding its lease.  Killing a process expires its leases
   and the survivors admit those rows; no collective is needed.

2. **Compute plane (device)**, this module: one *logical* simulator
   spanning the devices of several processes.  ``initialize`` joins the
   torch.distributed world (NCCL between cards, gloo between CPU
   processes), ``global_mesh`` builds a rows mesh over every process's
   devices, and ``make_global_soa`` places the struct-of-arrays so each
   process uploads only its own row block.  Every process runs the same
   sharded tick over its own shards; the one cross-process collective is
   the all_reduce of the fired count (``mesh.sharded_tick``).

The compute plane is static: if a participant dies, the world must be
rebuilt.  Elasticity therefore lives in the ownership plane: run one
mesh per process (the default) and let leases move rows between
processes; span processes with a global mesh only for throughput on a
stable fleet.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from kwok_tpu_torch.ops.device import resolve_device
from kwok_tpu_torch.parallel.mesh import Mesh, Rows, ShardedSoA, make_mesh, shard_rows

__all__ = [
    "initialize",
    "global_mesh",
    "process_row_block",
    "make_global_soa",
    "local_rows",
]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Join this process to a multi-process torch.distributed world.

    Falls back to env (``KWOK_COORDINATOR`` as ``host:port``,
    ``KWOK_NUM_PROCESSES``, ``KWOK_PROCESS_ID``) and no-ops
    single-process, so the same entrypoint serves laptops and fleets.
    The backend follows ``device`` (the card unless the caller names
    one): NCCL for CUDA shards, gloo for CPU shards.  Returns True when
    a multi-process world was joined."""
    coordinator_address = coordinator_address or os.environ.get("KWOK_COORDINATOR")
    if num_processes is None and os.environ.get("KWOK_NUM_PROCESSES"):
        num_processes = int(os.environ["KWOK_NUM_PROCESSES"])
    if process_id is None and os.environ.get("KWOK_PROCESS_ID"):
        process_id = int(os.environ["KWOK_PROCESS_ID"])
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    if process_id is None:
        # defaulting would silently give two hosts the same id and hang
        # the whole world at initialize — fail loudly instead
        raise ValueError(
            "multi-process world needs an explicit process id "
            "(KWOK_PROCESS_ID or process_id=)"
        )
    import torch.distributed as dist

    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend,
        init_method=coordinator_address,
        world_size=num_processes,
        rank=process_id,
    )
    return True


def _world() -> Tuple[int, int]:
    """(process count, process index): (1, 0) outside a world."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def global_mesh(local_devices=None) -> Mesh:
    """1-D rows mesh over every device of every process, in rank order.
    This process's shards are ``local_devices`` (every CUDA device it
    sees by default; a list may repeat a device, as in ``make_mesh``).
    Every process must bring the same number of shards."""
    local = make_mesh(devices=local_devices).local_devices
    pc, pid = _world()
    if pc == 1:
        return Mesh(local)
    import torch.distributed as dist

    names = [None] * pc
    dist.all_gather_object(names, [str(d) for d in local])
    if len({len(n) for n in names}) != 1:
        raise ValueError(f"processes bring different numbers of shards: {names}")
    # another process's devices are labels here; only local shards run
    devices = [d for n in names for d in n]
    devices[pid * len(local):(pid + 1) * len(local)] = local
    return Mesh(devices, process_index=pid, process_count=pc)


def process_row_block(n_rows: int) -> Tuple[int, int]:
    """[start, stop) of this process's contiguous row block when
    ``n_rows`` divide evenly over processes (pad with
    ``mesh.pad_rows(n, mesh.size)`` first)."""
    pc, pid = _world()
    per = n_rows // pc
    return pid * per, (pid + 1) * per


def make_global_soa(soa, mesh: Mesh) -> ShardedSoA:
    """Place a SoA on a (cross-process) mesh from this process's host
    copy: only this process's row blocks are read and uploaded, so rows
    of other processes need not hold real data.  ``now`` and ``key`` are
    replicated onto every local shard."""
    return shard_rows(soa, mesh)


def local_rows(rows: Rows) -> Tuple[np.ndarray, np.ndarray]:
    """(row_indices, values) of this process's shards of a row-sharded
    array — the drain path reads only what it owns."""
    if not rows.parts:
        return np.empty(0, np.int64), np.empty(0)
    idx = [np.arange(off, off + p.shape[0]) for p, off in zip(rows.parts, rows.offsets)]
    return np.concatenate(idx), np.concatenate([p.cpu().numpy() for p in rows.parts])
