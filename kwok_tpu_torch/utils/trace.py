"""In-process tracer: spans, W3C context propagation, OTLP export.

The reference delegates tracing to the ecosystem: kwokctl launches a
Jaeger all-in-one (reference pkg/kwokctl/components/jaeger.go:42) and
configures kube-apiserver's OTLP exporter at full sampling
(reference pkg/kwokctl/k8s/kube_apiserver_tracing_config.go:34-47);
kwok itself only exposes pprof.  This rebuild has no external binaries
to lean on, so the tracer is built in:

- :class:`Tracer` — cheap spans (trace/span ids, wall ns, attributes,
  status), thread-local current-span context, bounded in-memory buffer
  flushed by a background exporter thread;
- W3C ``traceparent`` header helpers so a trace crosses the
  client→apiserver process boundary the way OTLP ecosystems expect;
- OTLP span **links** + ``context_of``/``current_context`` helpers —
  the rv→span stitch across the watch boundary rides these (the store
  stamps each commit with the writing thread's context; watch-driven
  consumers continue/link it);
- OTLP/HTTP JSON export (``resourceSpans`` shape) to a collector URL —
  the bundled collector (cmd/tracing.py, the Jaeger seat) or any real
  OTLP endpoint;
- journey/critical-path analysis over collector-format spans
  (``build_journey`` / ``critical_path``) shared by the collector's
  ``/api/journey``+``/api/critical-path`` endpoints and the
  ``python -m kwok_tpu_torch.utils.trace --critical-path`` CLI.

Disabled (no endpoint) the tracer is a few dict lookups per span; the
device tick's inner loop is never traced per-row — spans wrap whole
batched operations, keeping observability off the hot path.
"""

from __future__ import annotations

import json
import os
import secrets
import threading
import time
import urllib.request
from typing import Any, Dict, List, Optional

__all__ = [
    "Span",
    "Tracer",
    "context_of",
    "current_context",
    "get_tracer",
    "peek_global",
    "set_global",
    "traceparent",
    "from_traceparent",
]


class Span:
    __slots__ = (
        "trace_id",
        "span_id",
        "parent_id",
        "name",
        "start_ns",
        "end_ns",
        "attributes",
        "links",
        "status_ok",
        "_tracer",
        "_token",
    )

    def __init__(self, tracer, name, trace_id, span_id, parent_id):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.attributes: Dict[str, Any] = {}
        #: OTLP span links — causal references to spans in OTHER traces
        #: (or other branches of this one): the watch-boundary stitch
        #: records the causing write's context here when the reconcile
        #: span cannot simply continue that trace
        self.links: List[tuple] = []
        self.status_ok = True
        self._token = None

    def set(self, key: str, value: Any) -> "Span":
        self.attributes[key] = value
        return self

    def add_link(self, trace_id: Optional[str], span_id: Optional[str]) -> "Span":
        """Record a causal link to another span context (OTLP link).
        None components are ignored, so callers can pass a possibly-
        missing watch-event ctx without guarding."""
        if trace_id and span_id:
            self.links.append((trace_id, span_id))
        return self

    def error(self, message: str) -> "Span":
        self.status_ok = False
        self.attributes["error.message"] = message
        return self

    def end(self) -> None:
        self.end_ns = time.time_ns()
        self._tracer._finish(self)

    # context-manager sugar: `with tracer.span("x") as sp:`
    def __enter__(self) -> "Span":
        self._token = self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.error(str(exc))
        self._tracer._pop(self._token)
        self.end()


class Tracer:
    """One per process/component; export is best-effort and bounded."""

    MAX_BUFFER = 8192
    FLUSH_EVERY = 2.0

    def __init__(
        self,
        service: str,
        endpoint: Optional[str] = None,
        resource: Optional[Dict[str, Any]] = None,
    ):
        self.service = service
        self.endpoint = endpoint  # e.g. http://127.0.0.1:4318/v1/traces
        self.resource = dict(resource or {})
        self._local = threading.local()
        self._buf: List[Span] = []
        self._mut = threading.Lock()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.dropped = 0
        self.exported = 0
        #: True while the collector is unreachable — the log-once gate:
        #: the first failed flush of an outage logs a warning (with the
        #: running drop count), the first successful one logs recovery;
        #: everything in between drops silently-but-counted
        self._outage = False
        #: separate edge for buffer overpressure (spans produced faster
        #: than FLUSH_EVERY drains them, collector possibly healthy):
        #: logged once per overpressure episode, cleared only after a
        #: full flush cycle with zero drops — never recycled per batch,
        #: and never conflated with collector reachability
        self._buf_logged = False
        self._dropped_since_flush = 0
        if endpoint:
            self._thread = threading.Thread(
                target=self._flush_loop, daemon=True, name=f"trace-{service}"
            )
            self._thread.start()

    @property
    def enabled(self) -> bool:
        return self.endpoint is not None

    # ----------------------------------------------------------------- spans

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def span(
        self,
        name: str,
        parent: Optional[Span] = None,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
    ) -> Span:
        """New span.  Parent defaults to the thread's current span;
        pass trace_id/parent_id (e.g. from a traceparent header) to
        continue a remote trace."""
        if parent is None and trace_id is None:
            parent = self.current()
        if parent is not None:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        if trace_id is None:
            trace_id = secrets.token_hex(16)
        return Span(self, name, trace_id, secrets.token_hex(8), parent_id)

    def _push(self, span: Span):
        st = self._stack()
        st.append(span)
        return len(st) - 1

    def _pop(self, token) -> None:
        st = self._stack()
        if token is not None and token < len(st):
            del st[token:]

    def _finish(self, span: Span) -> None:
        if not self.enabled:
            return
        log_edge = False
        with self._mut:
            if len(self._buf) >= self.MAX_BUFFER:
                self.dropped += 1
                self._dropped_since_flush += 1
                # edge check-and-set under the mutex: two threads
                # overflowing concurrently must produce ONE warning,
                # not a race on the log-once flag
                if not self._buf_logged:
                    self._buf_logged = True
                    log_edge = True
            else:
                self._buf.append(span)
        if log_edge:
            # a full buffer with a healthy exporter means spans arrive
            # faster than FLUSH_EVERY drains them — say so once per
            # overpressure episode instead of silently shedding forever
            self._log_drop("span buffer full; dropping spans")

    # ---------------------------------------------------------------- export

    def _flush_loop(self) -> None:
        while not self._done.wait(self.FLUSH_EVERY):
            self.flush()
        self.flush()

    def flush(self) -> None:
        with self._mut:
            batch, self._buf = self._buf, []
            # a full flush cycle with zero drops ends the overpressure
            # episode: the NEXT buffer-full is a new edge worth a line.
            # Sustained overpressure (drops every cycle) keeps the edge
            # set, so the warn stays once-per-episode, never per batch.
            if self._dropped_since_flush == 0:
                self._buf_logged = False
            self._dropped_since_flush = 0
        if not batch or not self.endpoint:
            return
        try:
            payload = json.dumps(self._otlp(batch)).encode()
            req = urllib.request.Request(
                self.endpoint,
                data=payload,
                headers={"Content-Type": "application/json"},
            )
            urllib.request.urlopen(req, timeout=5).read()
            with self._mut:
                self.exported += len(batch)
                recovered = self._outage
                self._outage = False
            if recovered:
                self._log_drop(
                    "collector reachable again; resuming span export",
                    recovered=True,
                )
        except Exception as exc:  # noqa: BLE001 — a dead collector must
            # not break the traced component; spans from this batch are
            # lost, counted, and the outage is logged ONCE (edge
            # check-and-set under the mutex, like _finish's)
            with self._mut:
                self.dropped += len(batch)
                log_edge = not self._outage
                self._outage = True
            if log_edge:
                self._log_drop(f"collector unreachable: {exc}")

    def _log_drop(self, message: str, recovered: bool = False) -> None:
        """One line per outage edge (never per batch — a dead collector
        at FLUSH_EVERY cadence would otherwise spam forever)."""
        from kwok_tpu_torch.utils.log import get_logger

        log = get_logger("tracer")
        if recovered:
            log.info(message, service=self.service, dropped_total=self.dropped)
        else:
            log.warn(
                message,
                service=self.service,
                endpoint=self.endpoint,
                dropped_total=self.dropped,
            )

    def stats(self) -> dict:
        """Exporter health counters (scraped into /metrics as
        ``kwok_tracer_dropped_spans_total`` etc.)."""
        with self._mut:
            return {
                "dropped": self.dropped,
                "exported": self.exported,
                "buffered": len(self._buf),
                "outage": self._outage,
            }

    def _otlp(self, batch: List[Span]) -> dict:
        def attr(k, v):
            if isinstance(v, bool):
                return {"key": k, "value": {"boolValue": v}}
            if isinstance(v, int):
                return {"key": k, "value": {"intValue": str(v)}}
            if isinstance(v, float):
                return {"key": k, "value": {"doubleValue": v}}
            return {"key": k, "value": {"stringValue": str(v)}}

        res_attrs = [attr("service.name", self.service)] + [
            attr(k, v) for k, v in self.resource.items()
        ]
        spans = []
        for s in batch:
            rec = {
                "traceId": s.trace_id,
                "spanId": s.span_id,
                "parentSpanId": s.parent_id or "",
                "name": s.name,
                "kind": 1,
                "startTimeUnixNano": str(s.start_ns),
                "endTimeUnixNano": str(s.end_ns),
                "attributes": [attr(k, v) for k, v in s.attributes.items()],
                "status": {"code": 1 if s.status_ok else 2},
            }
            if s.links:
                rec["links"] = [
                    {"traceId": t, "spanId": p} for t, p in s.links
                ]
            spans.append(rec)
        return {
            "resourceSpans": [
                {
                    "resource": {"attributes": res_attrs},
                    "scopeSpans": [
                        {"scope": {"name": "kwok-tpu"}, "spans": spans}
                    ],
                }
            ]
        }

    def stop(self) -> None:
        self._done.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


# ------------------------------------------------------------- propagation


def traceparent(span: Optional[Span]) -> Optional[str]:
    """W3C traceparent header for outgoing requests."""
    if span is None:
        return None
    return f"00-{span.trace_id}-{span.span_id}-01"


def from_traceparent(header: Optional[str]):
    """(trace_id, parent_span_id) out of an incoming header, or
    (None, None)."""
    if not header:
        return None, None
    parts = header.strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None, None
    return parts[1], parts[2]


def context_of(span: Optional[Span]) -> Optional[tuple]:
    """``(trace_id, span_id)`` of a span, or None — the side-channel
    shape the store's commit ring carries per rv."""
    if span is None:
        return None
    return (span.trace_id, span.span_id)


def current_context() -> Optional[tuple]:
    """The calling thread's live span context on the process-global
    tracer, or None (tracer unset, disabled, or no span open).  The
    store's commit path reads this to stamp each rv with the committing
    write's context — pure observation, nothing control-flow."""
    tr = peek_global()
    if tr is None or not tr.enabled:
        return None
    return context_of(tr.current())


# ------------------------------------------------------------ global tracer

_global: Optional[Tracer] = None
_global_mut = threading.Lock()


def set_global(tracer: Optional[Tracer]) -> None:
    """Install (or with None, reset) the process-global tracer."""
    global _global
    with _global_mut:
        _global = tracer


def peek_global() -> Optional[Tracer]:
    """The installed global tracer, or None — without creating one
    (metrics exposition reads drop counters from whatever the process
    already configured; it must not instantiate a tracer as a side
    effect of a scrape)."""
    with _global_mut:
        return _global


def get_tracer(service: str = "kwok") -> Tracer:
    """Process-wide tracer; configured from ``KWOK_TRACE_ENDPOINT`` on
    first use (how kwokctl components inherit the collector address)."""
    global _global
    with _global_mut:
        if _global is None:
            _global = Tracer(
                service=os.environ.get("KWOK_TRACE_SERVICE", service),
                endpoint=os.environ.get("KWOK_TRACE_ENDPOINT") or None,
            )
        return _global


# ------------------------------------------------- journey / critical path
#
# Pure analysis over collector-format span dicts (cmd/tracing.py's
# storage shape): stitch one object's causally-linked spans into an
# ordered journey and attribute its end-to-end latency to the
# control-plane stages the PR 12 histograms only report in aggregate.
# Shared by the collector's /api/journey and /api/critical-path
# endpoints and the ``python -m kwok_tpu_torch.utils.trace`` CLI.

#: span-name prefix -> critical-path stage bucket.  BOUNDED by
#: construction: every traced hot path names its spans from this
#: vocabulary, and anything else folds into "other".
_STAGE_PREFIXES = (
    ("client.", "client"),
    ("apiserver.", "commit"),
    ("schedule.", "sched"),
    ("gang.", "sched"),
    ("play.", "stage"),
)

#: attribution categories in waterfall order
STAGES = ("client", "queue", "commit", "watch", "sched", "stage", "other")


def classify_span(name: str) -> str:
    for prefix, stage in _STAGE_PREFIXES:
        if name.startswith(prefix):
            return stage
    return "other"


def span_attr(span: dict, key: str):
    """One attribute value out of a collector-format span, or None."""
    for a in span.get("attributes") or []:
        if a.get("key") == key:
            vals = a.get("value") or {}
            for v in vals.values():
                return v
    return None


def _span_ns(span: dict, field: str) -> int:
    try:
        return int(span.get(field) or 0)
    except (TypeError, ValueError):
        return 0


def linked_trace_ids(spans: List[dict]) -> set:
    """Every trace id reachable from these spans through OTLP links
    (one hop — links carry the causing write's context, so one
    expansion covers the watch-boundary stitch)."""
    out = set()
    for s in spans:
        for ln in s.get("links") or []:
            tid = ln.get("traceId")
            if tid:
                out.add(tid)
    return out


#: attribution priority when spans overlap: the innermost work wins
#: the instant (an apiserver PATCH nested inside a bind span is commit
#: work; the remainder of the bind is scheduling work)
_ATTRIBUTION_PRIORITY = ("commit", "sched", "stage", "client", "other")


def build_journey(spans: List[dict]) -> dict:
    """Order one object's causally-linked spans into a waterfall.

    Returns ``{"hops", "breakdown_s", "total_s", "t0_ns"}`` where each
    hop is ``{name, service, stage, start_s, duration_s, trace_id,
    span_id, parent_id}`` (start relative to the journey's first span)
    and ``breakdown_s`` partitions the total extent — every instant is
    attributed to exactly ONE stage, so the breakdown sums to
    ``total_s``: ``queue`` is the APF admission wait (apiserver spans'
    ``apf.wait_s`` attribute, carved out of ``commit``), ``commit`` the
    apiserver handling, ``watch`` the uncovered gaps (rv-commit ->
    consumer-pickup: delivery lag plus consumer queueing and stage
    delays), ``sched``/``stage``/``client`` the respective spans' own
    busy time with nested-span instants going to the innermost work
    (priority commit > sched > stage > client)."""
    spans = [s for s in spans if _span_ns(s, "startTimeUnixNano") > 0]
    spans.sort(key=lambda s: _span_ns(s, "startTimeUnixNano"))
    if not spans:
        return {"hops": [], "breakdown_s": {}, "total_s": 0.0, "t0_ns": 0}
    t0 = _span_ns(spans[0], "startTimeUnixNano")
    t_end = max(_span_ns(s, "endTimeUnixNano") for s in spans)
    hops = []
    intervals: List[tuple] = []  # (start_ns, end_ns, stage)
    queue_s = 0.0
    for s in spans:
        start = _span_ns(s, "startTimeUnixNano")
        end = max(_span_ns(s, "endTimeUnixNano"), start)
        stage = classify_span(str(s.get("name") or ""))
        hops.append(
            {
                "name": str(s.get("name") or ""),
                "service": str(s.get("service") or ""),
                "stage": stage,
                "start_s": round((start - t0) / 1e9, 6),
                "duration_s": round((end - start) / 1e9, 6),
                "trace_id": str(s.get("traceId") or ""),
                "span_id": str(s.get("spanId") or ""),
                "parent_id": str(s.get("parentSpanId") or ""),
            }
        )
        intervals.append((start, end, stage))
        if stage == "commit":
            try:
                queue_s += float(span_attr(s, "apf.wait_s") or 0.0)
            except (TypeError, ValueError):
                pass

    # boundary sweep: between each pair of adjacent span boundaries
    # exactly one stage wins the segment (innermost-work priority), and
    # segments no span covers are the watch-boundary gaps — so the
    # breakdown PARTITIONS the extent and sums to total_s
    rank = {st: i for i, st in enumerate(_ATTRIBUTION_PRIORITY)}
    bounds = sorted({b for a, e, _ in intervals for b in (a, e)})
    breakdown = {st: 0.0 for st in STAGES}
    for a, b in zip(bounds, bounds[1:]):
        if b <= a:
            continue
        active = [st for (s0, s1, st) in intervals if s0 <= a and b <= s1]
        seg = (b - a) / 1e9
        if active:
            breakdown[min(active, key=lambda st: rank.get(st, 99))] += seg
        else:
            breakdown["watch"] += seg
    total_s = (t_end - t0) / 1e9
    queue_s = min(queue_s, breakdown["commit"])
    breakdown["queue"] = round(queue_s, 6)
    breakdown["commit"] = round(breakdown["commit"] - queue_s, 6)
    for st in breakdown:
        breakdown[st] = round(breakdown[st], 6)
    return {
        "hops": hops,
        "breakdown_s": breakdown,
        "total_s": round(total_s, 6),
        "t0_ns": t0,
    }


def critical_path(journeys: List[dict]) -> dict:
    """Aggregate N journeys (``build_journey`` outputs) into a
    time-to-running budget: per-stage mean/max seconds plus each
    stage's share of the summed extent — ROADMAP item 1's ``host_build``
    wall generalized into an attributed breakdown."""
    n = len(journeys)
    if n == 0:
        return {"journeys": 0, "stages": {}, "total_s": {"mean": 0.0, "max": 0.0}}
    sums = {st: 0.0 for st in STAGES}
    maxes = {st: 0.0 for st in STAGES}
    totals = [float(j.get("total_s") or 0.0) for j in journeys]
    for j in journeys:
        for st in STAGES:
            v = float((j.get("breakdown_s") or {}).get(st) or 0.0)
            sums[st] += v
            maxes[st] = max(maxes[st], v)
    grand = sum(totals) or 1.0
    stages = {
        st: {
            "mean_s": round(sums[st] / n, 6),
            "max_s": round(maxes[st], 6),
            "share": round(sums[st] / grand, 4),
        }
        for st in STAGES
        if sums[st] > 0.0 or st in ("commit", "watch")
    }
    return {
        "journeys": n,
        "stages": stages,
        "total_s": {
            "mean": round(sum(totals) / n, 6),
            "max": round(max(totals), 6),
        },
    }


def _cli_main(argv=None) -> int:
    """``python -m kwok_tpu_torch.utils.trace --critical-path`` — query the
    collector's journey surface and render the time-to-running budget
    (the offline twin of ``GET /api/critical-path``)."""
    import argparse
    import json as _json

    p = argparse.ArgumentParser(
        prog="kwok-tpu-trace",
        description="critical-path attribution over collected journeys",
    )
    p.add_argument(
        "--critical-path",
        action="store_true",
        help="aggregate recent journeys into a per-stage latency budget",
    )
    p.add_argument(
        "--collector",
        default=os.environ.get("KWOK_TRACE_ENDPOINT", "http://127.0.0.1:4318"),
        help="collector base URL (KWOK_TRACE_ENDPOINT also accepted)",
    )
    p.add_argument("--limit", type=int, default=50, help="journeys to aggregate")
    p.add_argument("--json", action="store_true", help="raw JSON output")
    args = p.parse_args(argv)
    if not args.critical_path:
        p.error("nothing to do: pass --critical-path")
    base = args.collector.split("/v1/traces")[0].rstrip("/")
    url = f"{base}/api/critical-path?limit={args.limit}"
    try:
        data = _json.loads(urllib.request.urlopen(url, timeout=10).read())
    except OSError as exc:
        print(f"collector unreachable at {base}: {exc}")
        return 1
    if args.json:
        print(_json.dumps(data, indent=2))
        return 0
    n = data.get("journeys", 0)
    tot = data.get("total_s") or {}
    print(
        f"critical path over {n} journeys "
        f"(time-to-running mean {tot.get('mean', 0):.3f}s, "
        f"max {tot.get('max', 0):.3f}s)"
    )
    stages = data.get("stages") or {}
    for st in STAGES:
        row = stages.get(st)
        if row is None:
            continue
        bar = "#" * int(40 * float(row.get("share") or 0.0))
        print(
            f"  {st:<7} {row.get('mean_s', 0):>9.4f}s mean  "
            f"{row.get('max_s', 0):>9.4f}s max  "
            f"{100 * float(row.get('share') or 0):>5.1f}%  {bar}"
        )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_cli_main())
