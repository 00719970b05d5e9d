"""DeviceSimulator: the GPU execution backend behind the Stage API.

Port of ``kwok_tpu/engine/simulator.py`` to PyTorch: the SoA lives in
torch tensors on a CUDA device (or on the CPU when the caller passes
``device="cpu"``, where the kernels' plain versions run), and the tick
kernels are those of ``kwok_tpu_torch/ops/tick.py``; with a ``mesh``,
its rows are split over the mesh's devices and the tick is
``parallel/mesh.py``'s ``sharded_tick``.

Owns the device-resident SoA and the host-side object mirror. The
division of labor mirrors the Go<->device bridge mandated by the north
star (SURVEY.md:202-218 §2.9, §7): objects are admitted/updated/deleted on the
host (feature extraction + signature/override classing), the tick
kernel advances the FSM on device, and only *dirty rows* come back —
the host then materializes their full JSON status with the same
renderer the CPU backend uses, which is what makes device/host parity
checkable feature-by-feature.

Virtual time: int32 milliseconds since ``epoch`` (a wall-clock
datetime); ~24 days of simulated time per run, which bounds nothing in
practice since runs are restartable from snapshots.
"""

from __future__ import annotations

import datetime
import hashlib
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kwok_tpu_torch.api.types import Stage
from kwok_tpu_torch.engine.compiler import (
    IDLE,
    NEVER,
    SENTINEL,
    CompiledStageSet,
    StageCompileError,
)
from kwok_tpu_torch.engine.lifecycle import to_json_standard
from kwok_tpu_torch.ops.prng import prng_key
from kwok_tpu_torch.ops.tick import (
    SoA,
    TickParams,
    params_from_compiled,
    resolve_device,
    run_ticks_collect,
    scatter_rows,
    tick,
)
from kwok_tpu_torch.parallel.mesh import (
    ROW_FIELDS,
    Mesh,
    pad_rows,
    replicate,
    shard_rows,
    sharded_tick,
)
from kwok_tpu_torch.utils.patch import apply_patch

DEFAULT_EPOCH = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)

#: virtual-clock rebase threshold (~12.4 days of simulated ms).  int32
#: virtual time would collide with NEVER/SENTINEL semantics near 2^31
#: (VERDICT r01 weak #6); once ``now`` passes this, the simulator shifts
#: epoch forward and rebases every timer column so long record/replay
#: runs never approach the edge.
REBASE_AT_MS = 2**30


def default_env_funcs() -> Dict[str, Callable]:
    """Deterministic NodeIP/PodIP-style funcs for materialization
    (reference: node_controller.go:521-531, pod_controller.go:559-615
    derive these from the node IP pool; here they are hash-derived)."""

    def node_ip(name: str = "") -> str:
        h = int(hashlib.sha1(name.encode()).hexdigest(), 16)
        return f"10.{(h >> 16) % 256}.{(h >> 8) % 256}.{h % 254 + 1}"

    def pod_ip(*args: Any) -> str:
        h = int(hashlib.sha1(json.dumps([str(a) for a in args]).encode()).hexdigest(), 16)
        return f"10.{64 + (h >> 16) % 64}.{(h >> 8) % 256}.{h % 254 + 1}"

    return {
        "NodeIP": lambda: "10.0.0.1",
        "NodeName": lambda: "kwok-node",
        "NodePort": lambda: 10250,
        "NodeIPWith": node_ip,
        "PodIP": lambda: pod_ip("default"),
        "PodIPWith": pod_ip,
    }


class Transition:
    """One materializable FSM transition drained from the device."""

    __slots__ = ("row", "stage_idx", "stage_name", "t_ms", "deleted", "event")

    def __init__(self, row, stage_idx, stage_name, t_ms, deleted, event):
        self.row = row
        self.stage_idx = stage_idx
        self.stage_name = stage_name
        self.t_ms = t_ms
        self.deleted = deleted
        self.event = event

    def __repr__(self):
        return (
            f"Transition(row={self.row}, stage={self.stage_name!r}, "
            f"t_ms={self.t_ms}, deleted={self.deleted})"
        )


class DeviceSimulator:
    """Vectorized Stage-FSM simulator for one resource class."""

    def __init__(
        self,
        stages: List[Stage],
        capacity: int,
        epoch: datetime.datetime = DEFAULT_EPOCH,
        seed: int = 0,
        env_funcs: Optional[Dict[str, Callable]] = None,
        mesh=None,
        device=None,
    ):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
        #: optional Mesh: rows sharded across its devices, stage tensors
        #: replicated.  The tick is row-parallel, so the only value that
        #: crosses shards is the fired count.
        self.mesh = mesh
        self._n_shards = 1 if mesh is None else mesh.size
        self._sharded_ticks: Dict[int, Callable] = {}
        #: torch device of the SoA (of its first shard on a mesh): the
        #: card unless the caller or the mesh names one
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = mesh.local_devices[0]
            if device is not None and torch.device(device).type != self.device.type:
                raise ValueError(f"device {device} is not the mesh's kind: {mesh}")
            capacity = pad_rows(capacity, self._n_shards)
        self.cset = CompiledStageSet(stages)
        self.capacity = capacity
        self.epoch = epoch
        self.env_funcs = dict(env_funcs) if env_funcs is not None else default_env_funcs()
        C = self.cset.C

        # host-side row storage (numpy until to_device)
        self.features = np.zeros((capacity, C), np.int32)
        self.sig = np.zeros(capacity, np.int32)
        self.ovc = np.zeros(capacity, np.int32)
        self.stage = np.full(capacity, IDLE, np.int32)
        self.fire_at = np.full(capacity, NEVER, np.int32)
        self.active = np.zeros(capacity, np.bool_)
        self.rematch = np.zeros(capacity, np.bool_)
        self.del_ts = np.full(capacity, SENTINEL, np.int32)

        self.objects: List[Optional[dict]] = [None] * capacity
        self.num_rows = 0  # high-water mark
        self._free: List[int] = []  # released rows available for reuse
        self._seed = seed
        self._admit_cache: Dict[str, Tuple[int, int, np.ndarray]] = {}
        # The admit fast path caches (sig, ovc, features) by content hash.
        # It is sound only when every feature column reads fields the
        # cache key covers: spec/status plus the well-known metadata
        # fields. A selector on any other metadata field (creationTimestamp,
        # generateName, ...) disables the cache.
        self._cacheable = all(
            c.path_prefix
            and (
                c.path_prefix[0] in ("spec", "status")
                or c.path_prefix[:2]
                in (
                    ("metadata", "labels"),
                    ("metadata", "annotations"),
                    ("metadata", "deletionTimestamp"),
                    ("metadata", "finalizers"),
                    ("metadata", "ownerReferences"),
                )
            )
            for c in self.cset.schema.columns
        )

        self._soa: Optional[SoA] = None
        self._params: Optional[TickParams] = None
        self._params_version = -1
        self._dev_now = None  # preserved virtual clock across re-uploads
        self._dev_key = None  # preserved PRNG state across re-uploads
        self._rematch_pending = False
        self._host_synced = True
        #: host mirror of the device virtual clock — ticks advance it
        #: deterministically, so reading now_ms never costs a device
        #: round-trip
        self._now_host = 0
        #: rows mutated on host since the last device upload; flushed as
        #: one scatter_rows call instead of a full SoA re-upload
        self._pending: set = set()

    # ------------------------------------------------------------------ host ops

    def _classify(self, obj: dict) -> Tuple[int, int, np.ndarray]:
        """(sig, ovc, features) for an object, via the content-hash
        cache when the stage set's feature columns allow it. Shared by
        admit and refresh_row — the churn steady state revisits the
        same object states cyclically, so the cache turns the per-row
        re-extraction into one json.dumps."""
        cache_key = None
        if self._cacheable:
            meta = obj.get("metadata") or {}
            content = {
                "spec": obj.get("spec"),
                "labels": meta.get("labels"),
                "annotations": meta.get("annotations"),
                "ownerReferences": meta.get("ownerReferences"),
                "status": obj.get("status"),
                "deletionTimestamp": meta.get("deletionTimestamp"),
                "finalizers": meta.get("finalizers"),
                # template-read projection (e.g. creationTimestamp for the
                # node stages): objects differing here must re-explore
                "proj": self.cset.state_projection(obj),
            }
            cache_key = hashlib.sha1(
                json.dumps(content, sort_keys=True, default=str).encode()
            ).hexdigest()
            hit = self._admit_cache.get(cache_key)
            if hit is not None:
                return hit
        sig = self.cset.signature_for(obj)
        ovc = self.cset.override_class_for(obj)
        feats = self.cset.extract_features(obj)
        if cache_key is not None:
            if len(self._admit_cache) >= 4_000_000:
                self._admit_cache.clear()  # coarse bound; keys are
                # per-object-state (podIP makes them per-pod), so the
                # cache is O(pods x FSM states) without it
            self._admit_cache[cache_key] = (sig, ovc, feats)
        return sig, ovc, feats

    def admit(self, obj: dict) -> int:
        """Add an object; returns its row index. Reuses released rows;
        grows the SoA (2x, device re-upload) when full. The row's new
        host values reach the device as part of the next tick's batched
        scatter (see _flush_pending) — no full re-upload."""
        obj = to_json_standard(obj)
        self._pre_mutate()
        if self._free:
            row = self._free.pop()
        else:
            if self.num_rows >= self.capacity:
                self.ensure_capacity(self.num_rows + 1)
            row = self.num_rows
            self.num_rows += 1
        sig, ovc, feats = self._classify(obj)
        self.sig[row] = sig
        self.ovc[row] = ovc
        self.features[row] = feats
        self.stage[row] = IDLE
        self.fire_at[row] = NEVER
        self._finish_admit(row, obj)
        self._mark_pending(row)
        return row

    def admit_bulk(self, obj: dict, count: int) -> range:
        """Admit ``count`` copies of one object as a contiguous row range
        with a single feature extraction (the scale/bench path —
        VERDICT r01 #8). All rows share the same host mirror dict, which
        is sound because every patch path is copy-on-write
        (utils/patch.apply_patch) and per-row divergence replaces
        ``objects[row]``; in-place mutators must copy first (see
        request_delete)."""
        if count <= 0:
            return range(0, 0)
        obj = to_json_standard(obj)
        start = self.num_rows
        self.ensure_capacity(start + count)
        if self._soa is not None:
            # bulk admits are setup-path; a full re-upload beats a
            # giant scatter here
            self._invalidate_device()
        sl = slice(start, start + count)
        self.sig[sl] = self.cset.signature_for(obj)
        self.ovc[sl] = self.cset.override_class_for(obj)
        self.features[sl] = self.cset.extract_features(obj)[None, :]
        self.stage[sl] = IDLE
        self.fire_at[sl] = NEVER
        self.active[sl] = True
        self.rematch[sl] = True
        self.del_ts[sl] = self.cset.deletion_ts_ms(obj, self.epoch)
        self.objects[start : start + count] = [obj] * count
        self.num_rows = start + count
        return range(start, start + count)

    def _finish_admit(self, row: int, obj: dict) -> None:
        self.objects[row] = obj
        self.active[row] = True
        self.rematch[row] = True
        self.del_ts[row] = self.cset.deletion_ts_ms(obj, self.epoch)

    def _pre_mutate(self) -> None:
        """Mesh path only: pull device progress BEFORE host row writes
        (the full re-upload on next to_device would otherwise clobber
        them on sync).  The single-device path instead scatters the
        touched rows after the writes (_mark_pending)."""
        if self._soa is not None and self.mesh is not None:
            self._invalidate_device()

    def _mark_pending(self, row: int) -> None:
        """Record a host-mutated row for the next batched device scatter.
        With no live device SoA the next to_device() uploads everything
        anyway; the mesh path keeps the full re-upload."""
        if self._soa is not None and self.mesh is None:
            self._pending.add(row)

    def _flush_pending(self) -> None:
        """Scatter pending host rows into the live device SoA (one kernel
        launch; rows padded to a power of two as the reference pads them
        to bound its recompiles)."""
        if not self._pending:
            return
        if self._soa is None:
            self._pending.clear()
            return
        rows = np.fromiter(self._pending, np.int32, len(self._pending))
        self._pending.clear()
        k = len(rows)
        pad = 1 << max(k - 1, 0).bit_length()
        if pad > k:
            # duplicate scatters carry identical values, so padding with
            # a repeated real row is deterministic
            rows = np.concatenate([rows, np.full(pad - k, rows[0], np.int32)])
        self._soa = scatter_rows(
            self._soa,
            *(
                self._upload(a)
                for a in (
                    rows,
                    self.features[rows],
                    self.sig[rows],
                    self.ovc[rows],
                    self.stage[rows],
                    self.fire_at[rows],
                    self.active[rows],
                    self.rematch[rows],
                    self.del_ts[rows],
                )
            ),
        )
        self._rematch_pending = True

    def _invalidate_device(self) -> None:
        """Pull device progress into the host arrays (so a host mutation
        + re-upload does not lose it) and preserve the virtual clock and
        PRNG state across the re-upload."""
        if self._soa is not None:
            self._ensure_synced()
            self._dev_now = self._soa.now
            self._dev_key = self._soa.key
            self._soa = None
        self._pending.clear()

    def release(self, row: int) -> None:
        """Retire a row (object gone from the cluster); the row is
        recycled by the next admit."""
        if self.objects[row] is None and not self.active[row]:
            return
        self._pre_mutate()
        self.objects[row] = None
        self.active[row] = False
        self.stage[row] = IDLE
        self.fire_at[row] = NEVER
        self.rematch[row] = False
        self.del_ts[row] = SENTINEL
        self._free.append(row)
        self._mark_pending(row)

    def ensure_capacity(self, n: int) -> None:
        """Grow the SoA to hold at least n rows (amortized doubling)."""
        if n <= self.capacity:
            return
        new_cap = pad_rows(max(self.capacity * 2, n, 64), self._n_shards)
        self._invalidate_device()
        grow = new_cap - self.capacity

        def pad(arr, fill):
            ext = np.full((grow,) + arr.shape[1:], fill, arr.dtype)
            return np.concatenate([arr, ext], axis=0)

        self.features = pad(self.features, 0)
        self.sig = pad(self.sig, 0)
        self.ovc = pad(self.ovc, 0)
        self.stage = pad(self.stage, IDLE)
        self.fire_at = pad(self.fire_at, NEVER)
        self.active = pad(self.active, False)
        self.rematch = pad(self.rematch, False)
        self.del_ts = pad(self.del_ts, SENTINEL)
        self.objects.extend([None] * grow)
        self.capacity = new_cap

    def request_delete(self, row: int, at_ms: int) -> None:
        """External delete request: set deletionTimestamp and re-evaluate
        (the apiserver's graceful-delete path)."""
        obj = self.objects[row]
        if obj is None:
            return
        ts = self.epoch + datetime.timedelta(milliseconds=int(at_ms))
        # copy-on-write: rows from admit_bulk share one mirror dict
        obj = dict(obj)
        meta = dict(obj.get("metadata") or {})
        meta["deletionTimestamp"] = (
            ts.isoformat(timespec="milliseconds").replace("+00:00", "Z")
        )
        obj["metadata"] = meta
        self.objects[row] = obj
        self.refresh_row(row)

    def refresh_row(self, row: int) -> None:
        """Re-extract features after an external mutation and force
        rematch.  The row's armed timer is reset (stage IDLE, fire_at
        NEVER): the reference re-enqueues a changed object with a fresh
        delay, replacing the old queue entry (pod_controller.go:205-214
        resourceVersion dedup + addStageJob), so a reset, not a carried
        timer, is the parity-correct behavior."""
        self._pre_mutate()
        obj = self.objects[row]
        sig, ovc, feats = self._classify(obj)
        self.features[row] = feats
        self.ovc[row] = ovc
        self.sig[row] = sig
        self.stage[row] = IDLE
        self.fire_at[row] = NEVER
        self.del_ts[row] = self.cset.deletion_ts_ms(obj, self.epoch)
        self.rematch[row] = True
        self._mark_pending(row)

    def confirm_row(self, row: int, obj: dict, ignore_finalizers: bool = False) -> bool:
        """Adopt the store's echo of OUR OWN single status-class patch
        without re-extraction and — critically — without invalidating
        the device SoA (a full re-upload per firing tick breaks the
        "only dirty rows cross the boundary" contract at 1M rows).

        Sound because the tick already applied this (sig, stage)'s
        feature deltas on device, and the effect tables are derived
        from the same host renderer (compiler docstring; parity pinned
        by check_feature_parity tests).  Returns False — caller falls
        back to :meth:`refresh_row` — when the echo differs anywhere
        that feeds signature/override/deadline classification, i.e. a
        writer interleaved with something beyond our status patch.
        External *status* writers are not detected here; in this
        framework status is controller-owned (the reference makes the
        same assumption: kubelet/kwok owns status).

        ``ignore_finalizers``: the caller's op group included its OWN
        finalizer patch — finalizer effects are lowered into feature
        columns by the compiler (finalizer columns exist and effect
        exploration drives the same host engine), so the device already
        reflects the change and the finalizer delta is expected."""
        old = self.objects[row]
        if old is None:
            return False
        om = old.get("metadata") or {}
        nm = obj.get("metadata") or {}
        if (
            old.get("spec") != obj.get("spec")
            or om.get("labels") != nm.get("labels")
            or om.get("annotations") != nm.get("annotations")
            or om.get("ownerReferences") != nm.get("ownerReferences")
            or om.get("deletionTimestamp") != nm.get("deletionTimestamp")
        ):
            return False
        if not ignore_finalizers and om.get("finalizers") != nm.get("finalizers"):
            return False
        self.objects[row] = obj
        return True

    # ---------------------------------------------------------------- device ops

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of a host array on the device (never a view: the tick
        updates the SoA in place, and the host mirror must not move)."""
        return torch.from_numpy(np.array(arr)).to(self.device)

    def to_device(self):
        """``(params, soa)`` on the device, uploading what is stale.  On
        a mesh: params replicated per shard and a ``ShardedSoA``."""
        if self._params is None or self._params_version != self.cset.version:
            self._params = params_from_compiled(self.cset, self.device)
            if self.mesh is not None:
                self._params = replicate(self._params, self.mesh)
            self._params_version = self.cset.version
        if self._soa is not None:
            self._flush_pending()
        if self._soa is None:
            now = (
                self._dev_now
                if self._dev_now is not None
                else torch.zeros((), dtype=torch.int32, device=self.device)
            )
            key = self._dev_key if self._dev_key is not None else prng_key(self._seed, self.device)
            if self.mesh is None:
                self._soa = SoA(
                    **{f: self._upload(getattr(self, f)) for f in ROW_FIELDS}, now=now, key=key
                )
            else:
                # shard_rows copies each block onto its shard's device
                host = {f: torch.from_numpy(getattr(self, f)) for f in ROW_FIELDS}
                self._soa = shard_rows(SoA(**host, now=now, key=key), self.mesh)
            self._rematch_pending = bool(self.rematch.any())
        return self._params, self._soa

    def _tick_fn(self, dt_ms: int):
        if self.mesh is None:
            return lambda p, s: tick(p, s, dt_ms)
        fn = self._sharded_ticks.get(dt_ms)
        if fn is None:
            fn = self._sharded_ticks[dt_ms] = sharded_tick(self.mesh, dt_ms)
        return fn

    def tick_many(self, dt_ms: int, n_ticks: int) -> Tuple[np.ndarray, int]:
        """Advance ``n_ticks`` device ticks; returns (fired_stage [K, N]
        int8 with IDLE = not fired, t0_ms = virtual now before the first
        tick).  ONE dispatch + ONE device->host transfer for the whole
        macro-tick, in place of a blocking read per tick.  Sub-tick k
        (0-based) fired at virtual time t0_ms + (k+1)*dt_ms; deleted
        rows are stage_delete[fired_stage] (host table).

        Host mirror of device row state is pulled LAZILY: a firing tick
        only marks it stale; the actual full download happens on the
        next _ensure_synced.  Steady-state churn with the fast drain
        moves only this [K, N] int8 across the boundary — "only dirty
        rows come back" at 1M rows.

        On a mesh, and for stage sets past int8, it ticks one tick at a
        time and returns int32 [K, N], every row in order."""
        if self.mesh is not None or self.num_stages_over_int8():
            if self.now_ms >= REBASE_AT_MS:
                self._rebase()
            t0_ms = self._now_host
            params, soa = self.to_device()
            # int32 here on purpose: this branch exists (in part)
            # because int8 cannot hold >126 stage indices
            outs = []
            for _ in range(n_ticks):
                soa, out = self._tick_fn(dt_ms)(params, soa)
                fired = out.fired_stage
                outs.append((fired.cpu() if self.mesh is None else fired.to_host()).numpy())
            self._soa = soa
            stages_np = np.stack(outs) if outs else np.empty((0, 0), np.int32)
            self._now_host = t0_ms + dt_ms * n_ticks
            if (stages_np >= 0).any() or self._rematch_pending:
                self._host_synced = False
                self._rematch_pending = False
            return stages_np, t0_ms
        stages, t0_ms = self.tick_many_async(dt_ms, n_ticks)
        return stages.cpu().numpy(), t0_ms

    def num_stages_over_int8(self) -> bool:
        return len(self.cset.compiled) > 126

    def tick_many_async(self, dt_ms: int, n_ticks: int):
        """Like tick_many, but returns the [K, N] int8 fired-stage DEVICE
        tensor without blocking — the caller overlaps the device compute
        with host work (drain of the previous macro-tick) and fetches it
        (``.cpu()``) when ready.  Each call returns a fresh tensor, so a
        later dispatch never overwrites a batch the caller still reads.
        Single-device path only, and not for >int8 stage sets (the
        caller uses tick_many there); tick_many's int8 branch is this +
        the blocking fetch."""
        if self.mesh is not None or self.num_stages_over_int8():
            raise ValueError(
                "tick_many_async is the single-device path for stage sets of at most 126 stages"
            )
        if self.now_ms >= REBASE_AT_MS:
            self._rebase()
        t0_ms = self._now_host
        params, soa = self.to_device()
        new_soa, stages = run_ticks_collect(params, soa, dt_ms, n_ticks)
        self._soa = new_soa
        self._now_host = t0_ms + dt_ms * n_ticks
        # pessimistic: fired rows are not visible until the fetch
        self._host_synced = False
        self._rematch_pending = False
        return stages, t0_ms

    def step(self, dt_ms: int = 100, materialize: bool = True) -> List[Transition]:
        """One tick; drains and (optionally) materializes transitions."""
        stages_np, t0_ms = self.tick_many(dt_ms, 1)
        st = stages_np[0]
        t_ms = t0_ms + dt_ms
        transitions: List[Transition] = []
        for row in np.nonzero(st >= 0)[0]:
            s_idx = int(st[row])
            cs = self.cset.compiled[s_idx]
            event = None
            eid = int(self.cset.stage_event[s_idx])
            if eid >= 0:
                event = self.cset.events[eid]
            tr = Transition(
                row=int(row),
                stage_idx=s_idx,
                stage_name=cs.name,
                t_ms=t_ms,
                deleted=bool(self.cset.stage_delete[s_idx]),
                event=event,
            )
            transitions.append(tr)
            if materialize:
                self.materialize(tr)
        return transitions

    def _rebase(self) -> None:
        """Shift epoch forward by the current virtual now and restart
        the clock at 0, adjusting every timer column (guard against the
        int32 wrap at ~24.8 days; NEVER/SENTINEL rows stay put)."""
        self._invalidate_device()  # pulls device state; stashes now/key
        delta = int(self._dev_now) if self._dev_now is not None else 0
        if delta <= 0:
            return
        self.epoch = self.epoch + datetime.timedelta(milliseconds=delta)
        live = self.fire_at != NEVER
        self.fire_at[live] = self.fire_at[live] - delta
        dl = self.del_ts != SENTINEL
        self.del_ts[dl] = self.del_ts[dl] - delta
        self._dev_now = torch.zeros((), dtype=torch.int32, device=self.device)
        self._now_host = 0

    def _ensure_synced(self) -> None:
        if self._soa is None:
            self._pending.clear()
            return
        # pending host rows must reach the device BEFORE the download,
        # or the download would clobber them with stale device values
        self._flush_pending()
        if self._host_synced:
            return
        soa = self._soa

        # copies, never views: on the CPU .numpy() shares the SoA's memory,
        # which the tick updates in place and the host mutates on
        # refresh_row/admit.  A mesh's shards are read in row order.
        def column(name: str) -> np.ndarray:
            if self.mesh is not None:
                return soa.column(name).to_host().numpy()
            return getattr(soa, name).cpu().numpy().copy()

        self.stage = column("stage")
        self.fire_at = column("fire_at")
        self.active = column("active")
        self.features = column("features")
        # the true device value, NOT zeros: rows scattered with
        # rematch=True that have not ticked yet must keep the flag
        # across a re-upload or they never arm (found as stuck rows
        # admitted right before a capacity growth)
        self.rematch = column("rematch")
        self._host_synced = True

    # ------------------------------------------------------------- materialization

    @property
    def now_ms(self) -> int:
        """Current virtual time in ms (0 before the first tick).  Host
        mirror — never a device read (see tick_many)."""
        return self._now_host

    def now_string(self, t_ms: int) -> str:
        t = self.epoch + datetime.timedelta(milliseconds=int(t_ms))
        return t.isoformat(timespec="microseconds").replace("+00:00", "Z")

    def materialize(self, tr: Transition) -> Optional[dict]:
        """Apply a drained transition to the host mirror object with the
        same renderer the CPU backend uses (virtual-time Now)."""
        obj = self.objects[tr.row]
        if obj is None:
            return None
        cs = self.cset.compiled[tr.stage_idx]
        effects = self.cset.lifecycle.effects(cs)
        if effects is None:
            return obj
        meta = obj.get("metadata") or {}
        fin = effects.finalizers_patch(meta.get("finalizers") or [])
        if fin is not None:
            obj = apply_patch(obj, fin.data, fin.type)
        if tr.deleted or effects.delete:
            self.objects[tr.row] = None
            return None
        funcs = dict(self.env_funcs)
        funcs["Now"] = lambda: self.now_string(tr.t_ms)
        for p in effects.patches(obj, funcs):
            obj = apply_patch(obj, p.data, p.type)
        self.objects[tr.row] = obj
        return obj

    def check_feature_parity(self, rows) -> None:
        """Assert device feature rows == features re-extracted from the
        host-materialized mirror objects (the core parity invariant)."""
        self._ensure_synced()
        for row in rows:
            obj = self.objects[row]
            if obj is None:
                continue
            expect = self.cset.extract_features(obj)
            got = self.features[row]
            if not np.array_equal(expect, got):
                cols = [
                    (c.key, int(expect[i]), int(got[i]))
                    for i, c in enumerate(self.cset.schema.columns)
                    if expect[i] != got[i]
                ]
                raise AssertionError(
                    f"feature parity violation on row {row}: {cols}"
                )

    # --------------------------------------------------------------------- stats

    def phase_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for obj in self.objects[: self.num_rows]:
            if obj is None:
                counts["<deleted>"] = counts.get("<deleted>", 0) + 1
                continue
            phase = (obj.get("status") or {}).get("phase", "<none>")
            counts[phase] = counts.get(phase, 0) + 1
        return counts
