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

import collections
import datetime
import functools
import hashlib
import json
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from kwok_tpu_torch.api.types import Stage
from kwok_tpu_torch.engine.behaviour import ITER, Regions
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
    load_kernels,
    pack_batch,
    params_from_compiled,
    resolve_device,
    run_ticks_collect,
    scatter_packed,
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
from kwok_tpu_torch.utils import telemetry as _telemetry
from kwok_tpu_torch.utils.patch import apply_patch

DEFAULT_EPOCH = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)

#: virtual-clock rebase threshold (~12.4 days of simulated ms).  int32
#: virtual time would collide with NEVER/SENTINEL semantics near 2^31
#: (VERDICT r01 weak #6); once ``now`` passes this, the simulator shifts
#: epoch forward and rebases every timer column so long record/replay
#: runs never approach the edge.
REBASE_AT_MS = 2**30

#: observed time of each phase of a simulator's work, by resource kind:
#: set-up (``compile``, ``kernels``), admission (``admit``: an ``admit`` or
#: ``admit_bulk`` call less the explorations inside it; ``explore``: one
#: exploration of a behaviour from a state not explored before, in an
#: admission or a ``refresh_row``), a macro-tick (``launch``: argument
#: checks, output and pinned block allocation and the launch; ``fetch``:
#: the wait until the fired stages are in host memory, on the card the
#: wait for the kernel that writes them there, see
#: ``kwok_sim_fetch_bytes``), and the host
#: mirror's full ``upload``/``sync``, ``flush`` and ``rebase``, which
#: break the "only dirty rows cross the boundary" contract when they
#: recur.  A phase is observed only when it does work, so each series'
#: ``_count`` counts it.  Phases never nest.  The buckets start at 10 us
#: (a launch) and reach a kernel build with nvcc.
_H_PHASE = _telemetry.histogram(
    "kwok_sim_phase_seconds",
    help="DeviceSimulator phase time (compile/kernels/admit/explore/upload/flush/sync/rebase/launch/fetch)",
    buckets=(
        1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 0.01, 0.025,
        0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
    ),
    labelnames=("kind", "phase"),
)


#: bytes of fired stages a ``tick_many`` call brings to the host, by
#: resource kind and by the host memory they land in: ``mapped`` (the
#: card's int8 macro-tick: the row kernel writes them into a block of
#: torch's pinned-memory caching allocator itself), ``pinned`` (the
#: >126-stage per-tick route on the card: one copy of the stacked ticks
#: into such a block), ``pageable`` (a mesh on the card) or ``host`` (a
#: CPU simulator: the fired stages already are in host memory, nothing is
#: copied).  Observed once a call, beside the ``fetch`` phase, so each
#: ``_count`` counts the calls that took that way.
_H_FETCH = _telemetry.histogram(
    "kwok_sim_fetch_bytes",
    help="DeviceSimulator fired-stage bytes fetched a tick_many call, by host memory (mapped/pinned/pageable/host)",
    buckets=(1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9),
    labelnames=("kind", "memory"),
)


class _Gauge:
    """A gauge family in the process's telemetry registry, so every
    ``/metrics`` that serves the registry serves it: one value a label
    set, set (not observed) and exposed as a Prometheus gauge.  Setting is
    stopped with the rest of the telemetry (``KWOK_TELEMETRY=0``)."""

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._values: Dict[Tuple[str, ...], float] = {}
        registry = _telemetry.registry()
        with registry._mut:
            registry._families.setdefault(name, self)

    def set(self, value: float, *labelvalues: str) -> None:
        if _telemetry.enabled():
            self._values[tuple(str(v) for v in labelvalues)] = float(value)

    def snapshot(self) -> Dict[Tuple[str, ...], float]:
        return dict(self._values)

    def expose_lines(self) -> List[str]:
        values = self.snapshot()
        if not values:
            return []
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.TYPE}"]
        for lv in sorted(values):
            labels = ",".join(f'{k}="{v}"' for k, v in zip(self.labelnames, lv))
            lines.append(f"{self.name}{{{labels}}} {self._text(values[lv])}")
        return lines

    TYPE = "gauge"

    @staticmethod
    def _text(value: float) -> str:
        return f"{value:g}"

    # the registry's summary and reset read every family alike
    def total_count(self) -> int:
        return 0

    def quantile(self, q: float) -> Optional[float]:
        return None

    def clear(self) -> None:
        self._values.clear()


class _Counter(_Gauge):
    """A counter family in the process's telemetry registry: whole counts
    a label set, only ever incremented, exposed as a Prometheus counter."""

    TYPE = "counter"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        super().__init__(name, help, labelnames)
        self._mut = threading.Lock()

    def inc(self, *labelvalues: str) -> None:
        if _telemetry.enabled():
            with self._mut:
                self._values[labelvalues] = self._values.get(labelvalues, 0) + 1

    @staticmethod
    def _text(value: int) -> str:
        return str(value)


#: the admission keys (signature and regions, ``_classify``) a simulator
#: built, by resource kind and by the path they took: ``native`` (one pass
#: of ``native/admitkeys.c`` over the object) or ``plain`` (the object's
#: JSON-standard walk and ``json.dumps`` of each key, for objects the pass
#: refuses or where the extension is not built).  A ``plain`` count that
#: grows says objects, or a machine with no toolchain, miss the fast path.
_C_ADMIT_KEYS = _Counter(
    "kwok_sim_admit_keys_total",
    "DeviceSimulator admission keys built, by path (native/plain)",
    ("kind", "path"),
)


#: the effect-table rows the card holds for a simulator's tick, by
#: resource kind: one a behaviour (``engine/behaviour.py``), however many
#: distinct object specs were admitted; set at each upload of the tables
_G_SIGNATURES = _Gauge(
    "kwok_sim_signatures",
    "DeviceSimulator effect-table rows on the device (one per behaviour)",
    ("kind",),
)


class Fetch:
    """The fired stages of one launch on their way to host memory:
    :meth:`wait` returns them once written, and ``memory`` names the
    memory they land in (a label of ``kwok_sim_fetch_bytes``).

    ``Fetch(stages)``: on the card, one non-blocking copy into a fresh
    tensor from torch's pinned-memory caching allocator, on the launch's
    stream, and an event recorded after it; on the CPU the tensor already
    is the host copy.  :meth:`mapped`: a pinned block that the kernel just
    launched writes itself, and an event recorded after that kernel.
    :meth:`wait` waits on the event (that stream alone, not the whole
    device).  The array keeps its pinned block until the caller drops it,
    so no later launch writes into an array the caller holds; freed blocks
    stay cached for the life of the process."""

    __slots__ = ("_host", "_done", "memory")

    def __init__(self, stages: torch.Tensor):
        self._host, self._done, self.memory = stages, None, "host"
        if stages.device.type != "cuda":
            return
        self._host = torch.empty(stages.shape, dtype=stages.dtype, pin_memory=True)
        self._host.copy_(stages, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record(torch.cuda.current_stream(stages.device))
        self.memory = "pinned"

    @classmethod
    def mapped(cls, host: torch.Tensor, device: torch.device) -> "Fetch":
        """The fetch of ``host``, written by the kernel last launched on
        ``device``'s current stream."""
        fetch = cls.__new__(cls)
        fetch._host, fetch.memory = host, "mapped"
        fetch._done = torch.cuda.Event()
        fetch._done.record(torch.cuda.current_stream(device))
        return fetch

    def written(self) -> bool:
        """Whether the bytes are in host memory, without waiting."""
        return self._done is None or self._done.query()

    def wait(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()


class _Span:
    """Times one phase into ``kwok_sim_phase_seconds`` and, while a
    ``torch.profiler`` records, marks it as the range ``kwok.sim.<phase>``
    on the profiler's timeline, the clock of the kernels and copies it
    issues.  With no profiler recording it enters no range.  Observation
    only: nothing it measures feeds back into the simulator.

    The range is torch's C++ ``RecordFunctionFast`` (what its compiler
    marks kernels with; a ``cpu_op`` in the trace): on an H100's host it
    costs 1.8 us a range, ``record_function``'s Python wrapper 11 us, most
    of it outside the range, where the trace charges it to the caller."""

    __slots__ = ("kind", "phase", "_range", "_t0")

    def __init__(self, kind: str, phase: str):
        self.kind = kind
        self.phase = phase

    def __enter__(self) -> None:
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch._C._profiler._RecordFunctionFast("kwok.sim." + self.phase)
            self._range.__enter__()
        else:
            self._range = None
        self._t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        _H_PHASE.observe(seconds, self.kind, self.phase)


class _Admission(_Span):
    """The ``admit`` phase of one ``admit`` or ``admit_bulk`` call: its
    time less that of the explorations inside it, which :meth:`pause`
    and :meth:`resume` cut out of its range too, so phases never nest."""

    __slots__ = ("_sim", "_paused")

    def __init__(self, sim: "DeviceSimulator"):
        super().__init__(sim.kind, "admit")
        self._sim = sim

    def __enter__(self) -> None:
        self._paused = 0.0
        self._sim._admission = self
        super().__enter__()

    def pause(self) -> None:
        self._paused -= time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)

    def resume(self) -> None:
        if self._range is not None:
            self._range = torch._C._profiler._RecordFunctionFast("kwok.sim." + self.phase)
            self._range.__enter__()
        self._paused += time.perf_counter()

    def __exit__(self, *exc) -> None:
        seconds = time.perf_counter() - self._t0 - self._paused
        self._sim._admission = None
        if self._range is not None:
            self._range.__exit__(*exc)
        _H_PHASE.observe(seconds, self.kind, self.phase)


class _Exploration(_Span):
    """The ``explore`` phase of one exploration, cut out of the admission
    it runs in, if any."""

    __slots__ = ("_admission",)

    def __init__(self, sim: "DeviceSimulator"):
        super().__init__(sim.kind, "explore")
        self._admission = sim._admission

    def __enter__(self) -> None:
        if self._admission is not None:
            self._admission.pause()
        super().__enter__()

    def __exit__(self, *exc) -> None:
        super().__exit__(*exc)
        if self._admission is not None:
            self._admission.resume()


def _native_keys(regions: Regions) -> Optional[Callable[[dict], Optional[tuple]]]:
    """The native pass of ``_classify``'s keys over ``regions``' trie:
    ``obj -> (signature text, regions key)``, or None for an object it
    refuses; None where the extension is not built (``KWOK_TPU_NATIVE=0``
    or no toolchain) or the set has no regions key (no class cache: every
    object's row is extracted in Python anyway)."""
    if regions.trie is None:
        return None
    try:
        from kwok_tpu_torch.native.admitkeys import load

        mod = load()
    except ImportError:
        return None
    if mod is None:
        return None
    return functools.partial(mod.keys, mod.compile_trie(regions.trie, ITER))


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
        #: resource kind of the stages: the ``kind`` of the phase spans
        self.kind = stages[0].resource_ref.kind if stages else ""
        # the kernels are built now, not at a first tick under a caller's lock
        with _Span(self.kind, "kernels"):
            load_kernels(self.device)
        with _Span(self.kind, "compile"):
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

        #: the card row of each row's effect tables: its signature's
        #: behaviour (``engine/behaviour.py``).  What the device SoA's
        #: ``sig`` column holds; ``sig`` above stays the signature id.
        self.behaviour = np.zeros(capacity, np.int32)

        self.objects: List[Optional[dict]] = [None] * capacity
        self.num_rows = 0  # high-water mark
        self._free: List[int] = []  # released rows available for reuse
        self._seed = seed
        # The admit fast path caches (ovc, features, exploration state) by
        # the parts of an object they are read from (``Regions``): a pod's
        # node, name, owner names and unselected labels are not among them.
        self._regions = Regions(self.cset)
        self._native_keys = _native_keys(self._regions)
        self._class_cache: Dict[str, Tuple[int, np.ndarray, Any, Optional[str]]] = {}
        self._admission: Optional[_Admission] = None
        self.cset.behaviours.exploring = self._exploring

        self._soa: Optional[SoA] = None
        self._params: Optional[TickParams] = None
        self._params_version = -1
        self._dev_now = None  # preserved virtual clock across re-uploads
        self._dev_key = None  # preserved PRNG state across re-uploads
        self._rematch_pending = False
        self._host_synced = True
        #: the newest int8 launch on the card, (its device output, the
        #: fetch of the pinned block its kernel writes), until
        #: :meth:`tick_many` or :meth:`start_fetch` takes it
        self._newest: Optional[Tuple[torch.Tensor, Fetch]] = None
        #: the fetches whose kernel may still write its pinned block,
        #: oldest first.  torch's host allocator knows nothing of a
        #: kernel's writes, so a block goes back to it, when its caller
        #: drops it, only once it has left this queue
        self._writing: Deque[Fetch] = collections.deque()
        #: host mirror of the device virtual clock — ticks advance it
        #: deterministically, so reading now_ms never costs a device
        #: round-trip
        self._now_host = 0
        #: rows mutated on host since the last device upload; flushed as
        #: one scatter_packed call instead of a full SoA re-upload
        self._pending: set = set()

    # ------------------------------------------------------------------ host ops

    def _classify(self, obj: dict,
                  standardize: bool = False) -> Tuple[dict, int, int, np.ndarray, int]:
        """(obj, sig, ovc, features, behaviour) of an object, made
        JSON-standard first when ``standardize``.  Shared by admit and
        refresh_row.  The signature is the spec's, as the reference numbers
        it; the rest is cached by the parts of the object it is read from,
        so a pod that differs from one seen before only in its node, name,
        owner or unselected labels costs its two keys and no exploration.

        The keys come from one native pass over the object where it
        accepts it: an object it accepts is JSON-standard, and its texts are
        those the Python path hashes and compares, byte for byte.  An
        object it refuses takes the Python path as before."""
        cset = self.cset
        behaviours = cset.behaviours
        keys = None if self._native_keys is None else self._native_keys(obj)
        if keys is None:
            _C_ADMIT_KEYS.inc(self.kind, "plain")
            if standardize:
                obj = to_json_standard(obj)
            sig_key = cset._signature_key(obj)
            region = self._regions.key(obj)
        else:
            _C_ADMIT_KEYS.inc(self.kind, "native")
            text, region = keys
            sig_key = hashlib.sha1(text.encode()).hexdigest()
        hit = self._class_cache.get(region) if region is not None else None
        if hit is None:
            behaviour = None if behaviours.kept is None else behaviours.behaviour_key(obj, sig_key)
            hit = (cset.override_class_for(obj), cset.extract_features(obj), cset._state_key(obj),
                   behaviour)
            if region is not None:
                if len(self._class_cache) >= 1_000_000:
                    self._class_cache.clear()  # coarse bound: a key is a state
                self._class_cache[region] = hit
        ovc, feats, state, behaviour = hit
        sig = behaviours.bind(obj, sig_key, state, behaviour)
        return obj, sig, ovc, feats, behaviours.card_row(sig)

    def _exploring(self):
        """The ``explore`` phase around one exploration, cut out of the
        admission it happens in."""
        return _Exploration(self)

    def admit(self, obj: dict) -> int:
        """Add an object; returns its row index. Reuses released rows;
        grows the SoA (2x, device re-upload) when full. The row's new
        host values reach the device as part of the next tick's batched
        scatter (see _flush_pending) — no full re-upload."""
        with _Admission(self):
            obj, sig, ovc, feats, behaviour = self._classify(obj, standardize=True)
            self._pre_mutate()
            if self._free:
                row = self._free.pop()
            else:
                if self.num_rows >= self.capacity:
                    self.ensure_capacity(self.num_rows + 1)
                row = self.num_rows
                self.num_rows += 1
            self.sig[row] = sig
            self.behaviour[row] = behaviour
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
        with _Admission(self):
            obj, sig, ovc, feats, behaviour = self._classify(obj, standardize=True)
            start = self.num_rows
            self.ensure_capacity(start + count)
            if self._soa is not None:
                # bulk admits are setup-path; a full re-upload beats a
                # giant scatter here
                self._invalidate_device()
            sl = slice(start, start + count)
            self.sig[sl] = sig
            self.behaviour[sl] = behaviour
            self.ovc[sl] = ovc
            self.features[sl] = feats[None, :]
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
        """Scatter pending host rows into the live device SoA: gathered
        from the host columns into one (pinned) host buffer with their
        range checked on the host, then (on the card) one asynchronous
        copy and one kernel launch on the tick's stream, with no
        host-device sync.  Unpadded: the reference pads to a power of two
        only to bound its recompiles."""
        if not self._pending:
            return
        if self._soa is None:
            self._pending.clear()
            return
        with _Span(self.kind, "flush"):
            rows = np.fromiter(self._pending, np.int32, len(self._pending))
            self._pending.clear()
            columns = tuple(self._row_column(f) for f in ROW_FIELDS)
            batch = pack_batch(rows, columns, self._soa.features.shape[0], self.device, take=True)
            self._soa = scatter_packed(self._soa, batch)
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
        self.behaviour = pad(self.behaviour, 0)
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
        obj, sig, ovc, feats, behaviour = self._classify(self.objects[row])
        self.features[row] = feats
        self.ovc[row] = ovc
        self.sig[row] = sig
        self.behaviour[row] = behaviour
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

    def _row_column(self, field: str) -> np.ndarray:
        """The host column the device SoA's ``field`` is uploaded from: the
        card gathers effects by behaviour, so ``sig`` goes as ``behaviour``."""
        return self.behaviour if field == "sig" else getattr(self, field)

    def to_device(self):
        """``(params, soa)`` on the device, uploading what is stale.  On
        a mesh: params replicated per shard and a ``ShardedSoA``.  The
        params hold one effect-table row a behaviour; they are uploaded
        again only when a behaviour or an override class is added or a
        behaviour's tables grow, not for each new object spec."""
        behaviours = self.cset.behaviours
        version = (behaviours.version, len(self.cset._ov_rows))
        if self._params is None or self._params_version != version:
            effects = behaviours.card_tables()
            self._params = params_from_compiled(self.cset, self.device, effects=effects)
            if self.mesh is not None:
                self._params = replicate(self._params, self.mesh)
            self._params_version = version
            _G_SIGNATURES.set(effects[0].shape[0], self.kind)
        if self._soa is not None:
            self._flush_pending()
        if self._soa is None:
            with _Span(self.kind, "upload"):
                now = (
                    self._dev_now
                    if self._dev_now is not None
                    else torch.zeros((), dtype=torch.int32, device=self.device)
                )
                key = (
                    self._dev_key if self._dev_key is not None else prng_key(self._seed, self.device)
                )
                if self.mesh is None:
                    self._soa = SoA(
                        **{f: self._upload(self._row_column(f)) for f in ROW_FIELDS}, now=now, key=key
                    )
                else:
                    # shard_rows copies each block onto its shard's device
                    host = {f: torch.from_numpy(self._row_column(f)) for f in ROW_FIELDS}
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

    @property
    def per_tick(self) -> bool:
        """Whether this simulator ticks one launch a tick (``tick``, int32
        fired stages): on a mesh, or for a stage set past the 126 stage
        indices int8 holds.  Otherwise one ``run_ticks_collect`` launch
        runs a whole macro-tick into int8."""
        return self.mesh is not None or self.num_stages_over_int8()

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

        On the card the row kernel writes the fired stages into pinned
        host memory itself (:meth:`Fetch.mapped`), while it computes, and
        the fetch only waits for it: each call returns an array of its
        own, which keeps its pinned block until the caller drops it.

        On the :attr:`per_tick` route it launches one tick at a time and
        returns int32 [K, N], every row in order, fetched once after the
        K launches: stacked on the card into one pinned copy, or on a
        mesh each tick's rows into pageable memory."""
        if not self.per_tick:
            stages, t0_ms = self.tick_many_async(dt_ms, n_ticks)
            with _Span(self.kind, "fetch"):
                fetch = self.start_fetch(stages)
                fired = fetch.wait()
            _H_FETCH.observe(fired.nbytes, self.kind, fetch.memory)
            return fired, t0_ms
        ticks, t0_ms = self._launch(dt_ms, n_ticks)
        with _Span(self.kind, "fetch"):
            if self.mesh is None:
                fetch = Fetch(torch.stack(ticks))
                fired, memory = fetch.wait(), fetch.memory
            else:
                fired = np.stack([t.to_host().numpy() for t in ticks])
                memory = "host" if self.device.type == "cpu" else "pageable"
        _H_FETCH.observe(fired.nbytes, self.kind, memory)
        if (fired >= 0).any() or self._rematch_pending:
            self._host_synced = False
            self._rematch_pending = False
        return fired, t0_ms

    def num_stages_over_int8(self) -> bool:
        return len(self.cset.compiled) > 126

    def start_fetch(self, stages: torch.Tensor) -> Fetch:
        """The fetch of :meth:`tick_many_async`'s fired stages, for a
        caller that waits later, once it has launched the next macro-tick.
        On the card, the pinned block the newest launch's kernel writes:
        ``stages`` must be that launch's output, and its block is handed
        out once."""
        newest = self._newest
        if newest is not None and newest[0] is stages:
            self._newest = None
            return newest[1]
        if stages.device.type != "cuda":
            return Fetch(stages)
        raise ValueError(
            "start_fetch takes the fired stages of this simulator's newest tick_many_async, once")

    def tick_many_async(self, dt_ms: int, n_ticks: int):
        """Like tick_many, but returns the [K, N] int8 fired-stage DEVICE
        tensor without blocking — the caller overlaps the device compute
        with host work (drain of the previous macro-tick) and fetches it
        (:meth:`start_fetch`, before the next dispatch) when ready.  On
        the card the kernel also writes them into a pinned host block that
        the simulator keeps for that fetch.  Each call returns a fresh
        tensor, so a later dispatch never overwrites a batch the caller
        still reads.  Refused on the :attr:`per_tick` route (the caller
        uses tick_many there); tick_many's int8 route is this + the
        blocking fetch."""
        if self.per_tick:
            raise ValueError(
                "tick_many_async is the single-device path for stage sets of at most 126 stages"
            )
        stages, t0_ms = self._launch(dt_ms, n_ticks)
        # pessimistic: fired rows are not visible until the fetch
        self._host_synced = False
        self._rematch_pending = False
        return stages, t0_ms

    def _launch(self, dt_ms: int, n_ticks: int):
        """Launch ``n_ticks`` ticks under one ``launch`` span, after a
        rebase when due and the upload of what is stale, and advance the
        host clock; returns (the fired stages on the device, t0_ms): one
        int8 [K, N] tensor, or on the :attr:`per_tick` route a list of
        the K ticks' int32 fired stages.  On the card the int8 launch
        takes a fresh pinned block, which its kernel writes too, and
        becomes :attr:`_newest`."""
        if self.now_ms >= REBASE_AT_MS:
            self._rebase()
        t0_ms = self._now_host
        params, soa = self.to_device()
        tick_fn = self._tick_fn(dt_ms) if self.per_tick else None
        with _Span(self.kind, "launch"):
            if tick_fn is not None:
                stages = []
                for _ in range(n_ticks):
                    soa, out = tick_fn(params, soa)
                    stages.append(out.fired_stage)
            elif self.device.type != "cuda":
                soa, stages = run_ticks_collect(params, soa, dt_ms, n_ticks)
            else:
                # one stream: the kernels, so the fetches, end in order
                while self._writing and self._writing[0].written():
                    self._writing.popleft()
                host = torch.empty((n_ticks, soa.features.shape[0]), dtype=torch.int8,
                                   pin_memory=True)
                soa, stages = run_ticks_collect(params, soa, dt_ms, n_ticks, host=host)
                fetch = Fetch.mapped(host, self.device)
                self._writing.append(fetch)
                self._newest = (stages, fetch)
        self._soa = soa
        self._now_host = t0_ms + dt_ms * n_ticks
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
        # the download above is a ``sync`` of its own: phases never nest
        with _Span(self.kind, "rebase"):
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

        with _Span(self.kind, "sync"):
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
