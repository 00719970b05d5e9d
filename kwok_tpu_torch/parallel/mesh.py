"""Row sharding: the struct-of-arrays' rows split over a mesh of devices.

Port of ``kwok_tpu/parallel/mesh.py``.  The tick is row-parallel (no
row reads another), so a sharded tick is the same kernel run on each
shard's block of rows: every shard holds rows ``[i*N/n, (i+1)*N/n)``
of the SoA on its device with its own copy of the clock and key, the
stage tensors are replicated, and the one value that crosses shards is
the fired count, summed as XLA's psum sums it.  A row draws with its
global index (``row_offset + row``), so a sharded run equals an
unsharded one bit for bit.

Where the JAX package hands XLA one global array with a row sharding,
the port keeps the blocks itself: ``ShardedSoA`` holds one ``SoA`` per
shard, and the per-row outputs of a sharded tick are ``Rows``, one
tensor per shard.  Both carry each block's global row offset and read
back in row order.

``sharded_tick`` and ``sharded_run_ticks`` launch the kernel of
``csrc/tick.cu`` once per shard, on the shard's device's current
stream, and count each launch in their ``launches`` attribute; shards
on the CPU take the plain versions (``_sharded_tick_impl``,
``_sharded_run_ticks_impl``).  Nothing synchronizes the host between
shards.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from kwok_tpu_torch.ops import kernels
from kwok_tpu_torch.ops.tick import (
    SoA,
    TickOut,
    TickParams,
    _on_cuda,
    _run_ticks_impl,
    _tick_impl,
)

ROWS_AXIS = "rows"

#: the SoA fields split by row; ``now`` and ``key`` are replicated
ROW_FIELDS = tuple(f for f in SoA._fields if f not in ("now", "key"))


class Mesh:
    """A 1-D mesh over the row axis: one shard per entry of ``devices``
    (a numpy array of ``torch.device``), over every process of the
    world.  This process holds the shards ``local_shards``: all of them
    unless the mesh spans several processes (``parallel/distributed.py``)."""

    def __init__(self, devices: Sequence, process_index: int = 0, process_count: int = 1):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"a mesh takes CPU or CUDA devices of one kind, got {devs}")
        if len(devs) % process_count:
            raise ValueError(f"{len(devs)} shards do not split evenly over "
                             f"{process_count} processes")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.axis_names = (ROWS_AXIS,)
        self.process_index = process_index
        self.process_count = process_count

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def local_shards(self) -> range:
        per = self.size // self.process_count
        return range(self.process_index * per, (self.process_index + 1) * per)

    @property
    def local_devices(self):
        return [self.devices[i] for i in self.local_shards]

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"process {self.process_index} of {self.process_count})")


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the row axis.

    Without ``devices``: the first ``n_devices`` CUDA devices (all of
    them by default), each a distinct card.  Asking for more cards than
    PyTorch sees is a ``ValueError``, not a silent truncation: an
    operator who configured an 8-card mesh must not unknowingly run on
    one card.

    With ``devices``: that list, as given, which may repeat a device.
    This exists for the CPU tests (PyTorch has one CPU device, where XLA
    can fake eight) and for checks of several shards on one card."""
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = avail if n_devices is None else n_devices
        if n < 1 or avail < n:
            raise ValueError(f"mesh wants {n} devices but PyTorch sees {avail} CUDA devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif n_devices is not None and len(devices) != n_devices:
        raise ValueError(f"mesh wants {n_devices} devices but was given {len(devices)}")
    return Mesh(devices)


def pad_rows(n: int, n_shards: int) -> int:
    """Capacity padded so rows divide evenly across shards."""
    return ((n + n_shards - 1) // n_shards) * n_shards


class Rows(NamedTuple):
    """A row-sharded array: this process's blocks, in row order, and the
    global index of each block's first row."""

    parts: Tuple[torch.Tensor, ...]
    offsets: Tuple[int, ...]
    n_rows: int  # over the whole mesh

    def to_host(self) -> torch.Tensor:
        """Every row, in order, as one fresh CPU tensor.  Raises when
        other processes hold some of the rows (``distributed.local_rows``
        reads a process's own)."""
        held = sum(p.shape[0] for p in self.parts)
        if held != self.n_rows:
            raise ValueError(f"this process holds {held} of {self.n_rows} rows")
        return torch.cat([p.cpu() for p in self.parts])


class ShardedSoA(NamedTuple):
    """The SoA over a mesh: one ``SoA`` per local shard, each on its
    shard's device with its own copy of ``now`` and ``key``."""

    shards: Tuple[SoA, ...]
    offsets: Tuple[int, ...]
    n_rows: int  # over the whole mesh

    @property
    def now(self) -> torch.Tensor:
        return self.shards[0].now

    @property
    def key(self) -> torch.Tensor:
        return self.shards[0].key

    def column(self, name: str) -> Rows:
        return Rows(tuple(getattr(s, name) for s in self.shards), self.offsets, self.n_rows)


def replicate(params: TickParams, mesh: Mesh) -> Tuple[TickParams, ...]:
    """One TickParams per local shard, on the shard's device; shards on
    one device share one copy (the tick only reads them)."""
    per_device = {}
    for dev in mesh.local_devices:
        if dev not in per_device:
            per_device[dev] = TickParams(*(t.to(dev) for t in params))
    return tuple(per_device[dev] for dev in mesh.local_devices)


def shard_rows(soa, mesh: Mesh) -> ShardedSoA:
    """Copy each local shard's block of rows, and ``now`` and ``key``,
    onto the shard's device.  ``soa``'s fields may be tensors on any
    device or numpy arrays; only this process's blocks are read."""
    n = soa.features.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split evenly over {mesh.size} shards "
                         "(pad the capacity with pad_rows)")
    per = n // mesh.size

    def put(value, dev):
        return torch.as_tensor(value).to(dev, copy=True)

    shards = []
    for i in mesh.local_shards:
        dev = mesh.devices[i]
        block = slice(i * per, (i + 1) * per)
        shards.append(SoA(
            **{f: put(getattr(soa, f)[block], dev) for f in ROW_FIELDS},
            now=put(soa.now, dev), key=put(soa.key, dev)))
    return ShardedSoA(tuple(shards), tuple(i * per for i in mesh.local_shards), n)


def place(params: TickParams, soa, mesh: Mesh) -> Tuple[Tuple[TickParams, ...], ShardedSoA]:
    """Device-place params (replicated) and SoA (row-sharded)."""
    return replicate(params, mesh), shard_rows(soa, mesh)


# ------------------------------------------------------------------ the tick


def _sum_counts(mesh: Mesh, counts) -> torch.Tensor:
    """The fired count over every shard of the mesh, int32 and wrapping
    like XLA's psum: the local shards' counts added on the first one's
    device, then one all_reduce across the processes of the world."""
    total = counts[0]
    for c in counts[1:]:
        total = total + c.to(total.device)
    if mesh.process_count > 1:
        import torch.distributed as dist

        dist.all_reduce(total)
    return total


def _over_shards(mesh: Mesh, params, soa: ShardedSoA, one: Callable):
    """``one(params_i, shard_i, row_offset_i) -> (shard_i, out_i)`` over
    the local shards, in order: the new ShardedSoA and the outs."""
    if not len(params) == len(soa.shards) == len(mesh.local_shards):
        raise ValueError(f"{len(params)} params and {len(soa.shards)} shards "
                         f"for a mesh of {len(mesh.local_shards)} local shards")
    shards, outs = zip(*(one(p, s, off) for p, s, off in zip(params, soa.shards, soa.offsets)))
    return soa._replace(shards=tuple(shards)), outs


def _tick_out(mesh: Mesh, soa: ShardedSoA, outs) -> TickOut:
    def rows(f):
        return Rows(tuple(getattr(o, f) for o in outs), soa.offsets, soa.n_rows)

    return TickOut(fired=rows("fired"), fired_stage=rows("fired_stage"),
                   deleted=rows("deleted"),
                   fired_count=_sum_counts(mesh, [o.fired_count for o in outs]))


def _sharded_tick_impl(mesh: Mesh, params, soa: ShardedSoA, dt_ms: int):
    """Plain version of ``sharded_tick``'s step: ``_tick_impl`` on each
    shard at its row offset."""
    soa, outs = _over_shards(mesh, params, soa, lambda p, s, off: _tick_impl(p, s, dt_ms, off))
    return soa, _tick_out(mesh, soa, outs)


def _sharded_run_ticks_impl(mesh: Mesh, params, soa: ShardedSoA, dt_ms: int, num_ticks: int):
    """Plain version of ``sharded_run_ticks``' loop."""
    soa, counts = _over_shards(
        mesh, params, soa, lambda p, s, off: _run_ticks_impl(p, s, dt_ms, num_ticks, off))
    return soa, _sum_counts(mesh, counts)


def sharded_tick(mesh: Mesh, dt_ms: int = 100):
    """The tick over the mesh's row shards: returns ``step(params, soa)
    -> (soa, TickOut)`` for placed params and a ShardedSoA.  ``fired``,
    ``fired_stage`` and ``deleted`` are ``Rows``; ``fired_count`` is one
    int32 tensor, summed over every shard.  The shards' row columns are
    updated in place, where the JAX package donates the SoA."""

    def one(p, s, off):
        if not _on_cuda(s.features):
            return _tick_impl(p, s, dt_ms, off)
        now, key, outs = kernels.tick_rows(p, s, dt_ms, 1, kernels.MODE_SINGLE, off)
        sharded_tick.launches += 1
        return s._replace(now=now, key=key), TickOut(*outs)

    def step(params, soa: ShardedSoA):
        soa, outs = _over_shards(mesh, params, soa, one)
        return soa, _tick_out(mesh, soa, outs)

    return step


def sharded_run_ticks(mesh: Mesh, dt_ms: int = 100, num_ticks: int = 100):
    """Multi-tick device loop under the mesh (bench / steady-state):
    returns ``run(params, soa) -> (soa, count)``, the count summed over
    every shard and every tick."""

    def one(p, s, off):
        if not _on_cuda(s.features):
            return _run_ticks_impl(p, s, dt_ms, num_ticks, off)
        now, key, count = kernels.tick_rows(p, s, dt_ms, num_ticks, kernels.MODE_COUNT, off)
        sharded_run_ticks.launches += 1
        return s._replace(now=now, key=key), count

    def run(params, soa: ShardedSoA):
        soa, counts = _over_shards(mesh, params, soa, one)
        return soa, _sum_counts(mesh, counts)

    return run


sharded_tick.launches = 0
sharded_run_ticks.launches = 0
