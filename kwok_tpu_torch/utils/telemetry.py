"""SLO telemetry substrate: observed latency histograms + flight recorder.

The reference delegates real observability to the ecosystem — kwokctl
composes a prometheus scrape config and a Jaeger all-in-one around the
cluster (reference pkg/kwokctl/components/prometheus.go:49,
pkg/kwokctl/components/jaeger.go:42) and the components themselves only
expose what client-go/apiserver libraries emit.  This rebuild has no
library emitting request-duration series for it, so this module is the
in-tree substrate every control-plane hot path observes into:

- :class:`HistogramFamily` — a thread-safe *observed* (incremented, not
  CEL-set) latency histogram with a bounded label set, the counterpart
  of the settable CEL collectors in
  ``kwok_tpu/metrics/collectors.py:108``;
- :class:`Telemetry` — the process-global registry; every ``/metrics``
  endpoint in the process (apiserver, fake-kubelet server) appends
  :meth:`Telemetry.expose` to its existing exposition, so one scrape
  sees both the synthetic CR-driven metrics and the observed SLO
  series;
- :class:`FlightRecorder` — a bounded in-memory ring of recent
  per-tick stage breakdowns and slow-request samples (each carrying
  its trace id as an exemplar), served at ``/debug/flightrecorder`` so
  a slow window is diagnosable after the fact without a profiler
  attached.

Design constraints (the tentpole contract):

- **observation-only**: nothing read from a histogram or the recorder
  feeds back into control flow — deterministic-simulation runs
  (kwok_tpu_torch.dst) produce byte-identical trace digests with
  instrumentation armed vs disarmed;
- **monotonic time**: durations are measured with ``time.monotonic()``
  (the ``utils.clock.MonotonicClock`` discipline — never wall time,
  which the kwoklint ``wallclock-deadline`` rule polices in deadline
  arithmetic);
- **cardinality-safe**: label values must come from bounded sets
  (verbs, kinds, APF levels, shard indexes, stage names — never object
  names/uids/namespaces; the kwoklint ``metric-cardinality`` rule
  enforces this at the call sites).  As a runtime backstop a family
  caps its children at :data:`MAX_CHILDREN` and folds the overflow
  into one ``(other)`` series instead of growing without bound;
- **cheap when off**: ``set_enabled(False)`` turns every observe into
  one attribute check (the bench ``obs`` A/B measures the armed
  overhead at <=5% on the store bulk lane).
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

from kwok_tpu_torch.utils.locks import make_lock

__all__ = [
    "DEFAULT_BUCKETS",
    "FlightRecorder",
    "HistogramFamily",
    "JourneyRecorder",
    "Telemetry",
    "enabled",
    "flight_recorder",
    "histogram",
    "journey",
    "registry",
    "set_enabled",
]

#: default latency bounds (seconds): sub-ms store appends up to
#: multi-second catch-up macro-ticks
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
)

#: per-family child (label-set) cap — the runtime backstop under the
#: static ``metric-cardinality`` rule.  Hitting it means a call site is
#: feeding unbounded values; the overflow folds into one child so the
#: leak is visible (as ``(other)``) instead of eating memory
MAX_CHILDREN = 64

#: the label-value tuple the overflow folds into
_OTHER = "(other)"


class _Child:
    """One label-set's distribution; guarded by the family lock."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 = the +Inf bucket
        self.sum = 0.0
        self.count = 0


class HistogramFamily:
    """An observed histogram with a fixed label-name set.

    ``observe(value, *labelvalues)`` increments the matching child's
    bucket (bisect over the sorted bounds), sum and count under one
    short lock hold — safe from any thread, including under the store
    mutex (it acquires nothing else, so it can never participate in a
    lock cycle)."""

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        labelnames: Sequence[str] = (),
        max_children: int = MAX_CHILDREN,
    ):
        self.name = name
        self.help = (help or "").strip()
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b) for b in buckets))
        self.labelnames: Tuple[str, ...] = tuple(labelnames)
        #: per-family child cap; families whose legitimate label
        #: product is wide (verb x kind x level x shard) raise it at
        #: registration — the cap is a leak backstop, not a quota
        self.max_children = int(max_children)
        self._mut = make_lock("utils.telemetry.HistogramFamily._mut")
        self._children: Dict[Tuple[str, ...], _Child] = {}
        #: observations folded into the ``(other)`` overflow child
        self.overflowed = 0

    # ------------------------------------------------------------- observe

    def observe(self, value: float, *labelvalues: str) -> None:
        """Record one observation (seconds).  Extra/missing label
        values are normalized to the declared width so a bad call site
        degrades to a visible mismatch, not a crash on the hot path."""
        if not _STATE.enabled:
            return
        lv = tuple(str(v) for v in labelvalues)
        if len(lv) != len(self.labelnames):
            lv = (lv + ("",) * len(self.labelnames))[: len(self.labelnames)]
        v = float(value)
        if v < 0.0:
            # monotonic races (ring eviction, clock source swap in
            # tests) must not corrupt the distribution
            v = 0.0
        idx = bisect.bisect_left(self.bounds, v)
        with self._mut:
            child = self._children.get(lv)
            if child is None:
                if len(self._children) >= self.max_children:
                    self.overflowed += 1
                    lv = (_OTHER,) * len(self.labelnames) if self.labelnames else ()
                    child = self._children.get(lv)
                if child is None:
                    child = self._children[lv] = _Child(len(self.bounds))
            child.counts[idx] += 1
            child.sum += v
            child.count += 1

    # ------------------------------------------------------------ querying

    def snapshot(self) -> Dict[Tuple[str, ...], Dict[str, object]]:
        """{labelvalues: {"counts", "sum", "count"}} — a consistent
        copy for tests and summaries."""
        with self._mut:
            return {
                lv: {
                    "counts": list(c.counts),
                    "sum": c.sum,
                    "count": c.count,
                }
                for lv, c in self._children.items()
            }

    def total_count(self) -> int:
        with self._mut:
            return sum(c.count for c in self._children.values())

    def clear(self) -> None:
        """Drop every child's observations (tests / registry reset) —
        the family object itself stays live for its import-time
        references."""
        with self._mut:
            self._children.clear()
            self.overflowed = 0

    def quantile(self, q: float) -> Optional[float]:
        """Aggregate quantile estimate across every child (standard
        cumulative-bucket interpolation; the +Inf bucket reports the
        largest finite bound).  None with no observations."""
        with self._mut:
            agg = [0] * (len(self.bounds) + 1)
            total = 0
            for c in self._children.values():
                total += c.count
                for i, n in enumerate(c.counts):
                    agg[i] += n
        if total == 0:
            return None
        target = q * total
        run = 0.0
        for i, n in enumerate(agg):
            prev = run
            run += n
            if run >= target and n:
                if i >= len(self.bounds):
                    return self.bounds[-1] if self.bounds else 0.0
                lo = self.bounds[i - 1] if i else 0.0
                hi = self.bounds[i]
                return lo + (hi - lo) * ((target - prev) / n)
        return self.bounds[-1] if self.bounds else 0.0

    # ---------------------------------------------------------- exposition

    def expose_lines(self) -> List[str]:
        """Prometheus text lines (HELP/TYPE + per-child bucket/sum/
        count), cumulative per le like any real histogram."""
        snap = self.snapshot()
        lines: List[str] = []
        if self.help:
            esc = self.help.replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP {self.name} {esc}")
        lines.append(f"# TYPE {self.name} histogram")
        for lv in sorted(snap):
            data = snap[lv]
            base = ",".join(
                f'{k}="{_escape(v)}"' for k, v in zip(self.labelnames, lv)
            )
            run = 0
            for bound, n in zip(
                list(self.bounds) + [float("inf")], data["counts"]
            ):
                run += n
                le = "+Inf" if bound == float("inf") else _fmt(bound)
                sep = "," if base else ""
                lines.append(
                    f'{self.name}_bucket{{{base}{sep}le="{le}"}} {run}'
                )
            lab = f"{{{base}}}" if base else ""
            lines.append(f"{self.name}_sum{lab} {_fmt(data['sum'])}")
            lines.append(f"{self.name}_count{lab} {data['count']}")
        return lines


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# ------------------------------------------------------------------ recorder


class FlightRecorder:
    """Bounded ring of recent tick stage breakdowns + slow-request
    samples.

    Overwrite-oldest semantics (``deque(maxlen=N)``): the recorder
    always holds the most recent window, never grows, and costs one
    append per record.  Each slow-request sample carries the request's
    trace id (W3C ``traceparent`` / tracer span) as the exemplar
    linking the latency outlier to its distributed trace."""

    #: default ring depth per record kind
    SIZE = int(os.environ.get("KWOK_FLIGHT_RECORDER_N", "256"))

    def __init__(self, size: Optional[int] = None):
        n = self.SIZE if size is None else int(size)
        self.size = max(1, n)
        self._mut = make_lock("utils.telemetry.FlightRecorder._mut")
        self._ticks: deque = deque(maxlen=self.size)
        self._slow: deque = deque(maxlen=self.size)
        #: slow-request gate (seconds); samples below it are not
        #: recorded.  KWOK_SLOW_REQUEST_S overrides the default.
        self.slow_threshold_s = float(
            os.environ.get("KWOK_SLOW_REQUEST_S", "0.5")
        )
        #: requests inspected vs recorded (the gate's visibility)
        self.slow_seen = 0
        self.slow_recorded = 0

    def record_tick(
        self, kind: str, fired: int, stages: Dict[str, float]
    ) -> None:
        """One macro-tick's stage breakdown (seconds per stage)."""
        if not _STATE.enabled:
            return
        entry = {
            "t_mono": time.monotonic(),
            "kind": str(kind),
            "fired": int(fired),
            "stages": {k: round(float(v), 6) for k, v in stages.items()},
        }
        with self._mut:
            self._ticks.append(entry)

    def note_request(
        self,
        verb: str,
        path: str,
        level: str,
        seconds: float,
        trace_id: Optional[str] = None,
        status: Optional[int] = None,
    ) -> None:
        """Threshold-gated slow-request sample.  ``path`` may carry
        object names — the recorder is a bounded debug ring, not a
        metric label set, so per-object detail is exactly what it is
        for."""
        if not _STATE.enabled:
            return
        with self._mut:
            self.slow_seen += 1
            if seconds < self.slow_threshold_s:
                return
            self.slow_recorded += 1
            self._slow.append(
                {
                    "t_mono": time.monotonic(),
                    "verb": str(verb),
                    "path": str(path),
                    "level": str(level or ""),
                    "seconds": round(float(seconds), 6),
                    "trace_id": trace_id or "",
                    "status": status,
                }
            )

    def dump(self) -> Dict[str, object]:
        """The ``/debug/flightrecorder`` body: newest-last lists plus
        the ring geometry so a reader knows the window it is seeing.
        When the process exports to a trace collector, each slow
        sample's trace-id exemplar is rendered as a ``trace_url`` deep
        link into the collector's browser — the one-click hop from "a
        request was slow" to its distributed trace."""
        with self._mut:
            slow = [dict(s) for s in self._slow]
            out = {
                "size": self.size,
                "slow_threshold_s": self.slow_threshold_s,
                "slow_seen": self.slow_seen,
                "slow_recorded": self.slow_recorded,
                "ticks": list(self._ticks),
                "slow_requests": slow,
            }
        base = _collector_base()
        if base:
            for s in slow:
                tid = s.get("trace_id")
                if tid:
                    s["trace_url"] = f"{base}/trace/{tid}"
        return out

    def reset(self) -> None:
        with self._mut:
            self._ticks.clear()
            self._slow.clear()
            self.slow_seen = 0
            self.slow_recorded = 0


def _collector_base() -> str:
    """Base URL of the trace collector this process exports to, or ""
    (the flight recorder and journey surfaces render trace ids as deep
    links when — and only when — a collector is armed)."""
    from kwok_tpu_torch.utils.trace import peek_global

    tracer = peek_global()
    endpoint = (
        tracer.endpoint if tracer is not None and tracer.endpoint else ""
    ) or os.environ.get("KWOK_TRACE_ENDPOINT", "")
    if not endpoint:
        return ""
    return endpoint.split("/v1/traces")[0].rstrip("/")


# ------------------------------------------------------------------ journey


class JourneyRecorder:
    """Bounded per-object lifecycle timeline, keyed by uid.

    Fed observation-only from the store's commit hooks and the watch
    servers' delivery hooks (``cluster/store.py`` ``_note_commit`` /
    ``observe_watch_delivery``): every single-object commit appends one
    ``commit`` hop (rv, event type, phase, committing trace id) and
    every watch-burst flush appends one ``watch`` hop (delivery lag) —
    so ``/debug/journey?kind=&ns=&name=`` answers "what happened to
    THIS pod, when, and under which trace" without touching metric
    label space (per-object detail stays in this bounded ring; kwoklint
    ``metric-cardinality`` forbids it in labels).

    Bounds: at most ``SIZE`` objects (LRU-evicted, counted) with at
    most ``HOPS`` hops each (oldest-dropped, counted); both counters
    surface at ``/metrics`` so truncation is visible, never silent.
    The bulk drain lane deliberately bypasses this recorder (its
    per-batch commit note carries no object), keeping the 1M-pod hot
    path at PR 12's measured overhead."""

    SIZE = int(os.environ.get("KWOK_JOURNEY_N", "512"))
    HOPS = int(os.environ.get("KWOK_JOURNEY_HOPS", "64"))

    def __init__(self, size: Optional[int] = None, hops: Optional[int] = None):
        self.size = max(1, self.SIZE if size is None else int(size))
        self.hops = max(1, self.HOPS if hops is None else int(hops))
        self._mut = make_lock("utils.telemetry.JourneyRecorder._mut")
        #: uid -> {"uid","kind","namespace","name","hops": deque}
        self._objects: "OrderedDict[str, Dict[str, object]]" = OrderedDict()
        #: objects LRU-evicted by the SIZE bound (drop counter)
        self.evicted_objects = 0
        #: hops dropped by a full per-object ring (drop counter)
        self.dropped_hops = 0

    def record(
        self,
        uid: str,
        kind: str,
        namespace: str,
        name: str,
        hop: str,
        dedupe_rv: Optional[int] = None,
        **attrs,
    ) -> None:
        """Append one hop to an object's timeline.  ``dedupe_rv``
        collapses repeats of the same (hop, rv) — several watch streams
        deliver the same commit, and one ``watch`` hop per rv is the
        useful record.  The check scans a small recent window (not just
        the newest entries) because deliveries from independent streams
        interleave with newer commits."""
        if not _STATE.enabled or not uid:
            return
        entry = {
            "hop": str(hop),
            "t_wall": time.time(),
            "t_mono": time.monotonic(),
        }
        entry.update(attrs)
        with self._mut:
            obj = self._objects.get(uid)
            if obj is None:
                if len(self._objects) >= self.size:
                    self._objects.popitem(last=False)
                    self.evicted_objects += 1
                obj = self._objects[uid] = {
                    "uid": uid,
                    "kind": str(kind),
                    "namespace": str(namespace or ""),
                    "name": str(name),
                    "hops": deque(maxlen=self.hops),
                }
            else:
                self._objects.move_to_end(uid)
            ring: deque = obj["hops"]
            if dedupe_rv is not None:
                recent = 0
                for h in reversed(ring):
                    if h.get("hop") == entry["hop"] and h.get("rv") == dedupe_rv:
                        return
                    recent += 1
                    if recent >= 16:
                        break
            if len(ring) == ring.maxlen:
                self.dropped_hops += 1
            ring.append(entry)

    # ------------------------------------------------------------- querying

    @staticmethod
    def _render(obj: Dict[str, object]) -> Dict[str, object]:
        out = {k: v for k, v in obj.items() if k != "hops"}
        out["hops"] = [dict(h) for h in obj["hops"]]
        return out

    def lookup(
        self,
        kind: Optional[str] = None,
        namespace: Optional[str] = None,
        name: Optional[str] = None,
        uid: Optional[str] = None,
    ) -> Optional[Dict[str, object]]:
        """One object's timeline by uid, or by (kind, namespace, name)
        — newest match wins when a name was reused."""
        with self._mut:
            if uid:
                obj = self._objects.get(uid)
                return self._render(obj) if obj is not None else None
            k = (kind or "").lower()
            for obj in reversed(self._objects.values()):
                if k and str(obj["kind"]).lower() not in (
                    k,
                    k.rstrip("s"),
                ):
                    continue
                if namespace is not None and obj["namespace"] != namespace:
                    continue
                if name is not None and obj["name"] != name:
                    continue
                return self._render(obj)
        return None

    def journeys(
        self, kind: Optional[str] = None, limit: int = 20
    ) -> List[Dict[str, object]]:
        """Most-recently-touched timelines, newest first."""
        out: List[Dict[str, object]] = []
        k = (kind or "").lower()
        with self._mut:
            for obj in reversed(self._objects.values()):
                if k and str(obj["kind"]).lower() not in (k, k.rstrip("s")):
                    continue
                out.append(self._render(obj))
                if len(out) >= limit:
                    break
        return out

    def stats(self) -> Dict[str, int]:
        with self._mut:
            return {
                "objects": len(self._objects),
                "size": self.size,
                "hops_per_object": self.hops,
                "evicted_objects": self.evicted_objects,
                "dropped_hops": self.dropped_hops,
            }

    def reset(self) -> None:
        with self._mut:
            self._objects.clear()
            self.evicted_objects = 0
            self.dropped_hops = 0


# ------------------------------------------------------------------ registry


class Telemetry:
    """Process-global family registry + exposition."""

    def __init__(self):
        self._mut = make_lock("utils.telemetry.Telemetry._mut")
        self._families: Dict[str, HistogramFamily] = {}
        self.recorder = FlightRecorder()
        self.journey = JourneyRecorder()

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        labelnames: Sequence[str] = (),
        max_children: int = MAX_CHILDREN,
    ) -> HistogramFamily:
        """Get-or-create (idempotent by name: the first registration's
        geometry wins, so hot paths can call this unconditionally)."""
        with self._mut:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = HistogramFamily(
                    name,
                    help=help,
                    buckets=buckets,
                    labelnames=labelnames,
                    max_children=max_children,
                )
            return fam

    def families(self) -> List[HistogramFamily]:
        with self._mut:
            return list(self._families.values())

    def expose(self) -> str:
        """Prometheus text for every observed family (appended to the
        host process's existing /metrics exposition)."""
        lines: List[str] = []
        for fam in sorted(self.families(), key=lambda f: f.name):
            lines.extend(fam.expose_lines())
        return "\n".join(lines) + ("\n" if lines else "")

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Compact {family: {count, p50_s, p99_s}} for ``/stats`` and
        ``kwokctl get components`` — only families with observations."""
        out: Dict[str, Dict[str, float]] = {}
        for fam in self.families():
            n = fam.total_count()
            if not n:
                continue
            p50 = fam.quantile(0.5)
            p99 = fam.quantile(0.99)
            out[fam.name] = {
                "count": n,
                "p50_s": round(p50, 6) if p50 is not None else 0.0,
                "p99_s": round(p99, 6) if p99 is not None else 0.0,
            }
        return out

    def reset(self) -> None:
        """Clear every family's observations and the recorder contents
        (tests).  Families are cleared IN PLACE, never dropped: hot
        paths hold module-level references bound at import time, and
        replacing the objects would orphan every one of them (observing
        into series no scrape can see)."""
        for fam in self.families():
            fam.clear()
        self.recorder.reset()
        self.journey.reset()


class _State:
    __slots__ = ("enabled",)

    def __init__(self):
        self.enabled = os.environ.get("KWOK_TELEMETRY", "1") not in (
            "0",
            "false",
            "off",
        )


_STATE = _State()
_REGISTRY = Telemetry()


def registry() -> Telemetry:
    return _REGISTRY


def histogram(
    name: str,
    help: str = "",
    buckets: Sequence[float] = DEFAULT_BUCKETS,
    labelnames: Sequence[str] = (),
    max_children: int = MAX_CHILDREN,
) -> HistogramFamily:
    """Shortcut onto the process-global registry."""
    return _REGISTRY.histogram(
        name,
        help=help,
        buckets=buckets,
        labelnames=labelnames,
        max_children=max_children,
    )


def flight_recorder() -> FlightRecorder:
    return _REGISTRY.recorder


def journey() -> JourneyRecorder:
    return _REGISTRY.journey


def set_enabled(on: bool) -> bool:
    """Arm/disarm every observation in the process (the bench A/B and
    the DST neutrality test flip this); returns the previous state."""
    prev = _STATE.enabled
    _STATE.enabled = bool(on)
    return prev


def enabled() -> bool:
    return _STATE.enabled
