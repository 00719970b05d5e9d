"""The vectorized stage-transition tick, on PyTorch and CUDA.

Port of ``kwok_tpu/ops/tick.py``.  One tick is one batched pass over
the struct-of-arrays, one row per object:

1. **fire**: rows whose timer elapsed (the delay-queue pop);
2. **effects**: feature-column updates gathered from the compiled
   effect tables;
3. **rematch**: masked predicate tests over all stages;
4. **choice**: weighted sampling by cumulative-sum inversion, with the
   zero-total fallback to uniform-among-matched;
5. **timers**: delay + jitter, with per-object annotation overrides and
   deletionTimestamp deadlines, giving the next fire time.

Everything is int32 (virtual milliseconds) apart from the two float32
draws, and the random bits are threefry2x32 reproduced bit for bit
(``ops/prng.py``), so the port equals the JAX package exactly.

Each public function (``tick``, ``run_ticks_collect``, ``run_ticks``,
``scatter_rows``, ``lease_tick``) takes its plain PyTorch version (the
``_*_impl`` functions) for tensors on the CPU and launches its CUDA
kernel (``csrc/tick.cu``, ``csrc/scatter.cu``, ``csrc/lease.cu``) for
tensors on a CUDA device;
any other device raises.  Each counts its kernel launches in its
``launches`` attribute; ``launches()`` also reads the row-sharded
wrappers of ``parallel/mesh.py``.

Where the reference donates the SoA to XLA, the port updates the SoA's
row columns in place: the returned SoA holds the same column tensors
and fresh ``now``/``key`` tensors.  A caller that needs the state
before a tick must clone it first.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from kwok_tpu_torch.engine.compiler import IDLE, NEVER, SENTINEL, CompiledStageSet
from kwok_tpu_torch.ops import kernels, prng
from kwok_tpu_torch.ops.device import resolve_device


class TickParams(NamedTuple):
    """Compiled stage-set tensors (static per stage set / signatures)."""

    cond_col: torch.Tensor  # [S, K] int32
    cond_mask: torch.Tensor  # [S, K] int32
    cond_neg: torch.Tensor  # [S, K] bool
    cond_valid: torch.Tensor  # [S, K] bool
    w_static: torch.Tensor  # [S] int32
    d_static: torch.Tensor  # [S] int32 ms
    j_static: torch.Tensor  # [S] int32 ms (SENTINEL = none)
    has_jitter: torch.Tensor  # [S] bool
    d_from_del_ts: torch.Tensor  # [S] bool
    j_from_del_ts: torch.Tensor  # [S] bool
    stage_delete: torch.Tensor  # [S] bool
    eff_mode: torch.Tensor  # [SIG, S, C] int32 (0 keep / 1 set)
    eff_val: torch.Tensor  # [SIG, S, C] int32
    ov_w: torch.Tensor  # [OVC, S] int32 (SENTINEL = no override)
    ov_d: torch.Tensor  # [OVC, S] int32
    ov_j: torch.Tensor  # [OVC, S] int32


class SoA(NamedTuple):
    """Device-resident simulation state: one row per object."""

    features: torch.Tensor  # [N, C] int32 bitmask columns
    sig: torch.Tensor  # [N] int32 signature id
    ovc: torch.Tensor  # [N] int32 override-class id
    stage: torch.Tensor  # [N] int32 current stage (IDLE = none)
    fire_at: torch.Tensor  # [N] int32 virtual ms (NEVER = idle)
    active: torch.Tensor  # [N] bool (admitted and not deleted)
    rematch: torch.Tensor  # [N] bool (host-forced re-evaluation)
    del_ts: torch.Tensor  # [N] int32 deletionTimestamp virtual ms (SENTINEL = absent)
    now: torch.Tensor  # [] int32 virtual ms
    key: torch.Tensor  # [2] uint32 threefry key


class LeaseLane(NamedTuple):
    """Device-resident lease-renewal timers: one slot per held node.
    All due leases of a tick drain as one batched write-back."""

    fire_at: torch.Tensor  # [N] int32 virtual ms; NEVER = empty slot
    key: torch.Tensor  # [2] uint32 threefry key (renewal jitter)


class TickOut(NamedTuple):
    fired: torch.Tensor  # [N] bool — rows that transitioned this tick
    fired_stage: torch.Tensor  # [N] int32 — stage that fired (IDLE otherwise)
    deleted: torch.Tensor  # [N] bool — rows deleted this tick
    fired_count: torch.Tensor  # [] int32


def _tensors(cls, d: Dict[str, np.ndarray], device) -> NamedTuple:
    dev = resolve_device(device)
    # np.array copies: torch.from_numpy alone would share the caller's
    # memory, and the tick updates these tensors in place
    return cls(**{f: torch.from_numpy(np.array(d[f])).to(dev) for f in cls._fields})


def params_from_numpy(d: Dict[str, np.ndarray], device=None) -> TickParams:
    """TickParams from numpy arrays keyed by field name, e.g. the JAX
    package's ``{k: np.asarray(v) for k, v in params._asdict().items()}``."""
    return _tensors(TickParams, d, device)


def soa_from_numpy(d: Dict[str, np.ndarray], device=None) -> SoA:
    """SoA from numpy arrays keyed by field name (copies them)."""
    return _tensors(SoA, d, device)


def params_from_compiled(cset: CompiledStageSet, device=None) -> TickParams:
    eff_mode, eff_val = cset.effect_tables()
    ov_w, ov_d, ov_j = cset.override_tables()
    d = {f: getattr(cset, f) for f in TickParams._fields if hasattr(cset, f)}
    d.update(eff_mode=eff_mode, eff_val=eff_val, ov_w=ov_w, ov_d=ov_d, ov_j=ov_j)
    return params_from_numpy(d, device)


# ---------------------------------------------------------------- plain versions


def match_stages(params: TickParams, features: torch.Tensor) -> torch.Tensor:
    """[N, S] bool: selector match per row per stage (Lifecycle.match)."""
    S, K = params.cond_col.shape
    cols = features.index_select(1, params.cond_col.reshape(-1).long())  # [N, S*K]
    test = (cols & params.cond_mask.reshape(-1)) != 0
    test = (test ^ params.cond_neg.reshape(-1)) | ~params.cond_valid.reshape(-1)
    return test.reshape(-1, S, K).all(dim=2)


def _weighted_choice(
    match: torch.Tensor, weights: torch.Tensor, u: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted among matched with weight>0 when that total is >0, else
    uniform among matched. Returns (stage_idx, any_match)."""
    wm = torch.where(match & (weights > 0), weights, 0)
    total = wm.sum(dim=1, dtype=torch.int32)
    probs = torch.where((total > 0)[:, None], wm, match.to(torch.int32))
    ptot = probs.sum(dim=1, dtype=torch.int32)
    any_match = ptot > 0
    # sample by cumulative-sum inversion: first index with cum > r
    r = (u * ptot.to(torch.float32)).to(torch.int32)  # r in [0, ptot)
    r = torch.minimum(r, torch.clamp_min(ptot - 1, 0))
    cum = torch.cumsum(probs, dim=1, dtype=torch.int32)
    # torch.argmax takes no bool; on ties it returns the first index
    choice = torch.argmax((cum > r[:, None]).to(torch.int32), dim=1).to(torch.int32)
    return torch.where(any_match, choice, IDLE), any_match


def _tick_impl(
    params: TickParams, soa: SoA, dt_ms: int, row_offset: int = 0
) -> Tuple[SoA, TickOut]:
    """Advance virtual time by dt_ms and run one transition pass.
    Updates the SoA's row columns in place.  ``row_offset`` is the global
    index of the SoA's first row when it is one shard of a larger SoA:
    a row draws with its global index."""
    S = params.w_static.shape[0]
    now = soa.now + dt_ms
    keys = prng.split(soa.key, 3)
    key, k_choice, k_jitter = keys[0], keys[1], keys[2]
    N = soa.features.shape[0]
    # in range by construction; clamped like XLA's gather, never read past
    sig = soa.sig.clamp(0, params.eff_mode.shape[0] - 1)
    ovc = soa.ovc.clamp(0, params.ov_w.shape[0] - 1)

    # 1. fire: delay elapsed
    fired = soa.active & (soa.stage >= 0) & (soa.fire_at <= now)
    stage_c = soa.stage.clamp(0, S - 1)

    # 2. effects: gather the compiled patch lowering for (sig, stage)
    mode = params.eff_mode[sig, stage_c]  # [N, C]
    val = params.eff_val[sig, stage_c]  # [N, C]
    features = torch.where(fired[:, None] & (mode == 1), val, soa.features)

    deleted_now = fired & params.stage_delete[stage_c]
    active = soa.active & ~deleted_now

    # 3. rematch rows: fresh transitions + host-forced
    rematch = (fired & active) | (soa.rematch & active)

    # 4. match + weighted choice
    match = match_stages(params, features)
    w_over = params.ov_w[ovc]  # [N, S]
    weights = torch.where(w_over != SENTINEL, w_over, params.w_static[None, :])
    u = prng.uniform(k_choice, N, row_offset)
    new_stage, any_match = _weighted_choice(match, weights, u)

    # 5. timers: delay + jitter for the chosen stage
    ns_c = new_stage.clamp(0, S - 1)
    d_over = params.ov_d[ovc, ns_c]
    j_over = params.ov_j[ovc, ns_c]
    d = torch.where(d_over != SENTINEL, d_over, params.d_static[ns_c])
    # deletionTimestamp deadline: duration = deadline - now
    has_dl = soa.del_ts != SENTINEL
    d = torch.where(params.d_from_del_ts[ns_c] & has_dl, soa.del_ts - now, d)

    j = torch.where(j_over != SENTINEL, j_over, params.j_static[ns_c])
    j = torch.where(params.j_from_del_ts[ns_c] & has_dl, soa.del_ts - now, j)
    has_j = params.has_jitter[ns_c] & (j != SENTINEL)

    uj = prng.uniform(k_jitter, N, row_offset)
    span = torch.clamp_min(j - d, 0)
    jittered = d + (uj * span.to(torch.float32)).to(torch.int32)
    delay = torch.where(has_j, torch.where(j < d, j, jittered), d)
    delay = torch.clamp_min(delay, 0)

    stage = torch.where(rematch, new_stage, soa.stage)
    fire_at = torch.where(
        rematch, torch.where(any_match, now + delay, NEVER), soa.fire_at
    )
    # deleted/idle rows never fire
    fire_at = torch.where(active, fire_at, NEVER)

    out = TickOut(
        fired=fired,
        fired_stage=torch.where(fired, soa.stage, IDLE),
        deleted=deleted_now,
        fired_count=fired.sum(dtype=torch.int32),
    )
    soa.features.copy_(features)
    soa.stage.copy_(stage)
    soa.fire_at.copy_(fire_at)
    soa.active.copy_(active)
    soa.rematch.zero_()
    return soa._replace(now=now, key=key), out


def _run_ticks_collect_impl(
    params: TickParams, soa: SoA, dt_ms: int, num_ticks: int
) -> Tuple[SoA, torch.Tensor]:
    """Macro-tick: ``num_ticks`` ticks, collecting the per-tick fired
    stage as one [K, N] int8 array (IDLE = not fired).  ``deleted`` is
    recomputed on host from stage_delete[stage]; sub-tick virtual times
    are now0 + (k+1)*dt."""
    stages = []
    for _ in range(num_ticks):
        soa, out = _tick_impl(params, soa, dt_ms)
        stages.append(out.fired_stage.to(torch.int8))
    if not stages:
        return soa, soa.features.new_empty((0, soa.features.shape[0]), dtype=torch.int8)
    return soa, torch.stack(stages)


def _run_ticks_impl(
    params: TickParams, soa: SoA, dt_ms: int, num_ticks: int, row_offset: int = 0
) -> Tuple[SoA, torch.Tensor]:
    """Multi-tick loop (bench path): returns the total fires."""
    count = torch.zeros((), dtype=torch.int32, device=soa.features.device)
    for _ in range(num_ticks):
        soa, out = _tick_impl(params, soa, dt_ms, row_offset)
        count = count + out.fired_count
    return soa, count


def _scatter_rows_impl(
    soa: SoA,
    rows: torch.Tensor,
    features: torch.Tensor,
    sig: torch.Tensor,
    ovc: torch.Tensor,
    stage: torch.Tensor,
    fire_at: torch.Tensor,
    active: torch.Tensor,
    rematch: torch.Tensor,
    del_ts: torch.Tensor,
) -> SoA:
    """Write a batch of host-mutated rows into the SoA in place: the
    host->device half of the "only dirty rows cross the boundary"
    contract.  Duplicate rows must carry equal values."""
    idx = rows.long()
    soa.features[idx] = features
    soa.sig[idx] = sig
    soa.ovc[idx] = ovc
    soa.stage[idx] = stage
    soa.fire_at[idx] = fire_at
    soa.active[idx] = active
    soa.rematch[idx] = rematch
    soa.del_ts[idx] = del_ts
    return soa


def _int32(name: str, v) -> int:
    v = int(v)
    if not -(2**31) <= v < 2**31:
        raise ValueError(f"{name} {v} does not fit int32")
    return v


def _lease_tick_impl(
    lane: LeaseLane, now: int, renew_ms: int, jitter_ms: int
) -> Tuple[LeaseLane, torch.Tensor, torch.Tensor]:
    """One pass: slots whose renewal is due, their lag, and rescheduled
    fire times (renew interval + one-sided jitter).  Returns a new lane
    (fresh ``fire_at`` and ``key``), ``due`` [N] bool and ``lag`` [N]
    int32."""
    keys = prng.split(lane.key, 2)
    key, k = keys[0], keys[1]
    dev = lane.fire_at.device
    now_t = torch.tensor(_int32("now", now), dtype=torch.int32, device=dev)
    renew_t = torch.tensor(_int32("renew_ms", renew_ms), dtype=torch.int32, device=dev)
    jitter_f = torch.tensor(_int32("jitter_ms", jitter_ms), dtype=torch.int32,
                            device=dev).to(torch.float32)
    due = lane.fire_at <= now_t
    u = prng.uniform(k, lane.fire_at.shape[0])
    nxt = now_t + renew_t + (u * jitter_f).to(torch.int32)
    lag = torch.where(due, now_t - lane.fire_at, 0)
    fire_at = torch.where(due, nxt, lane.fire_at)
    return LeaseLane(fire_at=fire_at, key=key), due, lag


# ------------------------------------------------------------------- wrappers


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {t.device}")


def tick(params: TickParams, soa: SoA, dt_ms: int) -> Tuple[SoA, TickOut]:
    """One tick.  Updates the SoA's row columns in place."""
    if not _on_cuda(soa.features):
        return _tick_impl(params, soa, dt_ms)
    now, key, outs = kernels.tick_rows(params, soa, dt_ms, 1, kernels.MODE_SINGLE)
    tick.launches += 1
    return soa._replace(now=now, key=key), TickOut(*outs)


def run_ticks_collect(
    params: TickParams, soa: SoA, dt_ms: int, num_ticks: int
) -> Tuple[SoA, torch.Tensor]:
    """``num_ticks`` ticks; returns the SoA (row columns updated in
    place) and a fresh [K, N] int8 fired-stage tensor."""
    if not _on_cuda(soa.features):
        return _run_ticks_collect_impl(params, soa, dt_ms, num_ticks)
    now, key, stages = kernels.tick_rows(
        params, soa, dt_ms, num_ticks, kernels.MODE_COLLECT
    )
    run_ticks_collect.launches += 1
    return soa._replace(now=now, key=key), stages


def run_ticks(
    params: TickParams, soa: SoA, dt_ms: int, num_ticks: int
) -> Tuple[SoA, torch.Tensor]:
    """``num_ticks`` ticks; returns the SoA (row columns updated in
    place) and the total fired count as an int32 scalar tensor."""
    if not _on_cuda(soa.features):
        return _run_ticks_impl(params, soa, dt_ms, num_ticks)
    now, key, count = kernels.tick_rows(params, soa, dt_ms, num_ticks, kernels.MODE_COUNT)
    run_ticks.launches += 1
    return soa._replace(now=now, key=key), count


class PackedBatch(NamedTuple):
    """A batch packed by ``pack_batch``: its layout and the host buffer
    that holds it."""

    layout: kernels.BatchLayout
    host: torch.Tensor  # uint8 [layout.nbytes]; pinned for a SoA on the card

    def segments(self):
        """numpy views of the batch's segments, in ``BATCH_FIELDS`` order."""
        array = self.host.numpy()
        out = []
        for f, off in zip(kernels.BATCH_FIELDS, self.layout.offsets):
            dtype, shape = _segment(f, self.layout.B, self.layout.C)
            size = int(np.prod(shape)) * np.dtype(dtype).itemsize
            out.append(array[off:off + size].view(dtype).reshape(shape))
        return out


def _segment(f: str, rows: int, C: int):
    """The numpy dtype and shape of field ``f`` over ``rows`` rows."""
    dtype = np.bool_ if f in kernels.BATCH_FLAGS else np.int32
    return dtype, ((rows, C) if f == "features" else (rows,))


def _check_rows(rows: np.ndarray, n: int) -> None:
    lo, hi = int(rows.min()), int(rows.max())
    if lo < 0 or hi >= n:
        raise IndexError(f"scatter_rows: rows span [{lo}, {hi}], outside [0, {n})")


def pack_batch(rows: np.ndarray, columns, n: int, device, take: bool = False) -> PackedBatch:
    """Pack ``rows`` (int32 [B]) and the eight columns (``features``
    [*, C], ``sig``, ``ovc``, ``stage``, ``fire_at`` int32, ``active``,
    ``rematch`` bool, ``del_ts`` int32) into one host buffer for a SoA of
    n rows on ``device``, after checking on the host that every row lies
    in [0, n).  The columns are the batch itself, one entry per row, or
    with ``take`` whole host columns of n rows that the batch is gathered
    from.  For a CUDA device the buffer is pinned: it comes from
    PyTorch's pinned-memory caching allocator, which sizes its blocks in
    powers of two and, as the copy out of a block records an event on the
    copy's stream, hands a block out again only once that copy has run."""
    rows = np.asarray(rows)
    if rows.ndim != 1 or rows.dtype != np.int32:
        raise TypeError(f"rows: expected int32 [B], got {rows.dtype}{rows.shape}")
    B, C = rows.shape[0], np.shape(columns[0])[-1]
    if B == 0:
        raise ValueError("scatter_rows needs at least one row")
    _check_rows(rows, n)
    for f, col in zip(kernels.BATCH_FIELDS[1:], columns):
        dtype, shape = _segment(f, n if take else B, C)
        if col.dtype != dtype or col.shape != shape:
            raise TypeError(f"{f}: expected {np.dtype(dtype)}{shape}, got {col.dtype}{col.shape}")
    layout = kernels.batch_layout(B, C)
    pinned = torch.device(device).type == "cuda"
    batch = PackedBatch(layout, torch.empty(layout.nbytes, dtype=torch.uint8, pin_memory=pinned))
    segs = batch.segments()
    segs[0][...] = rows
    if take:
        idx = rows.astype(np.intp)
        for seg, col in zip(segs[1:], columns):
            # in range, checked above: "clip" writes out unbuffered
            np.take(col, idx, axis=0, out=seg, mode="clip")
    else:
        for seg, col in zip(segs[1:], columns):
            seg[...] = col
    return batch


def scatter_packed(soa: SoA, batch: PackedBatch) -> SoA:
    """Write a packed batch into the SoA in place.  For a CUDA SoA: one
    asynchronous copy of the pinned buffer to the card and one launch of
    csrc/scatter.cu, both on the current stream, which the next tick runs
    on; no host-device sync.  For a CPU SoA: the plain version on the
    batch's segments."""
    if not _on_cuda(soa.features):
        return _scatter_rows_impl(soa, *(torch.from_numpy(v) for v in batch.segments()))
    staged = torch.empty(batch.layout.nbytes, dtype=torch.uint8, device=soa.features.device)
    staged.copy_(batch.host, non_blocking=True)
    kernels.scatter_rows(soa, staged, batch.layout)
    scatter_rows.launches += 1
    return soa


def _host(name: str, a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(
                f"scatter_rows: batch {name} lies on {a.device}; the batch is given in host "
                "memory (numpy arrays or CPU tensors) and crosses to the card in one copy")
        return a.numpy()
    return np.asarray(a)


def scatter_rows(
    soa: SoA,
    rows,
    features,
    sig,
    ovc,
    stage,
    fire_at,
    active,
    rematch,
    del_ts,
) -> SoA:
    """Write a batch of rows into the SoA in place.  The batch lies in host
    memory (numpy arrays or CPU tensors); every row must lie in [0, N),
    which is checked on the host before anything is written; an empty
    batch leaves the SoA as it is.  For a CUDA SoA the batch is packed
    into a pinned buffer (``pack_batch``) and written by
    ``scatter_packed``."""
    batch = [_host(f, a) for f, a in zip(kernels.BATCH_FIELDS, (
        rows, features, sig, ovc, stage, fire_at, active, rematch, del_ts))]
    if batch[0].size == 0:
        return soa
    n = soa.features.shape[0]
    if not _on_cuda(soa.features):
        _check_rows(batch[0], n)
        return _scatter_rows_impl(soa, *(torch.as_tensor(a) for a in batch))
    return scatter_packed(soa, pack_batch(batch[0], batch[1:], n, soa.features.device))


def lease_tick(
    lane: LeaseLane, now: int, renew_ms: int, jitter_ms: int
) -> Tuple[LeaseLane, torch.Tensor, torch.Tensor]:
    """One lease-lane pass at virtual ``now``; returns ``(lane, due,
    lag)`` with a fresh lane.  The integers must fit int32."""
    if not _on_cuda(lane.fire_at):
        return _lease_tick_impl(lane, now, renew_ms, jitter_ms)
    fire_at, due, lag, key = kernels.lease_tick(
        lane.fire_at, lane.key, _int32("now", now), _int32("renew_ms", renew_ms),
        _int32("jitter_ms", jitter_ms))
    lease_tick.launches += 1
    return LeaseLane(fire_at=fire_at, key=key), due, lag


tick.launches = 0
run_ticks_collect.launches = 0
run_ticks.launches = 0
scatter_rows.launches = 0
lease_tick.launches = 0

#: the kernel wrappers of this module, each with its ``launches`` count
KERNEL_WRAPPERS = (tick, run_ticks_collect, run_ticks, scatter_rows, lease_tick)


def kernel_wrappers():
    """This module's wrappers and the row-sharded ones of
    ``parallel/mesh.py``, which launch csrc/tick.cu once per shard."""
    # imported here: parallel/mesh.py imports this module
    from kwok_tpu_torch.parallel import mesh

    return KERNEL_WRAPPERS + (mesh.sharded_tick, mesh.sharded_run_ticks)


def reset_launches() -> None:
    for fn in kernel_wrappers():
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}

