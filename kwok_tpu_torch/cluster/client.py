"""REST client for the apiserver facade — the rebuild's client-go.

Implements the same duck-type as :class:`ResourceStore` (create / get /
list / update / patch / delete / watch / register_type / resource_type /
kinds / count / resource_version), so informers, controllers, and the
device player run unchanged against a remote cluster: pass a
``ClusterClient`` wherever a store is expected.  This is the boundary
client-go occupies in the reference (SURVEY §2.9: watch streams in,
PATCH/DELETE + Events out; pkg/utils/client clientset factory,
pkg/utils/client/clientset.go).

Transport: plain ``http.client`` with one keep-alive connection per
thread for unary calls (the patch path is request/response-heavy), plus
one dedicated connection per watch stream (NDJSON until either side
closes, mirroring one-HTTP/2-stream-per-watch in client-go).

Impersonation: pass ``as_user=`` on mutating verbs; sent as the
``Impersonate-User`` header (reference stage_controller.go:341-378).
"""

from __future__ import annotations

import http.client
import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from kwok_tpu_torch.cluster.store import (
    Conflict,
    CrossShardTransaction,
    Expired,
    NotFound,
    ResourceType,
    Selector,
)
from kwok_tpu_torch.utils.backoff import Backoff
from kwok_tpu_torch.utils.queue import Queue

__all__ = [
    "ClusterClient",
    "RemoteWatcher",
    "APIError",
    "ApiUnavailable",
    "RetryPolicy",
    "parse_retry_after",
]

_PATCH_CT = {
    "merge": "application/merge-patch+json",
    "json": "application/json-patch+json",
    "strategic": "application/strategic-merge-patch+json",
}


class APIError(RuntimeError):
    def __init__(self, code: int, reason: str, message: str):
        super().__init__(f"{reason} ({code}): {message}")
        self.code = code
        self.reason = reason


class ApiUnavailable(RuntimeError):
    """Terminal transport error: the apiserver stayed unreachable or
    overloaded past the retry budget.  Replaces the raw ``OSError`` /
    ``HTTPException`` leak callers used to see — carries how hard the
    client tried (``attempts``) and the last HTTP status observed
    (``last_status``; None when the failure was at the socket layer),
    so daemon loops can log one structured line and back off."""

    def __init__(
        self,
        message: str,
        attempts: int = 1,
        last_status: Optional[int] = None,
    ):
        detail = f"{message} (attempts={attempts}"
        if last_status is not None:
            detail += f", last_status={last_status}"
        super().__init__(detail + ")")
        self.attempts = attempts
        self.last_status = last_status


@dataclass
class RetryPolicy:
    """Unified transport retry schedule (client-go's rest.Request
    backoff seat, reference pkg/utils/client/clientset.go:1): jittered
    exponential backoff between attempts, a wall-clock retry budget,
    and Retry-After honoring on 429/503.

    429/503 are pre-processing rejections in kube-apiserver semantics,
    so they are safe to retry for every verb; socket-level send
    failures never reached the server and retry too.  A response lost
    *after* a mutating request went out is terminal (the server may
    have applied it) — that stays the caller's problem, surfaced as
    :class:`ApiUnavailable`.

    ``seed`` makes the jitter schedule reproducible under a chaos seed
    (the rng is instance-local; there is no global-random fallback).
    """

    max_attempts: int = 5
    budget_s: float = 10.0
    backoff: Backoff = field(
        default_factory=lambda: Backoff(duration=0.1, cap=2.0)
    )
    retry_statuses: Tuple[int, ...] = (429, 503)
    honor_retry_after: bool = True
    seed: Optional[int] = None

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def delay(self, attempt: int, retry_after: Optional[float]) -> float:
        """Seconds to sleep before attempt ``attempt + 1``."""
        d = self.backoff.delay(attempt, self._rng)
        if retry_after is not None and self.honor_retry_after:
            d = max(d, retry_after)
        return d


#: health probes and other latency-sensitive callers: one fresh-socket
#: retry (the legacy behavior), no sleeping
NO_RETRY = RetryPolicy(
    max_attempts=2, budget_s=1.0, backoff=Backoff(duration=0.0, cap=0.0)
)

#: readiness probes must SEE the 503, not retry it — a degraded
#: apiserver answers /readyz with 503 + a machine-readable reason, and
#: the caller (wait_writable, the supervisor) owns the poll loop
READY_PROBE = RetryPolicy(
    max_attempts=1,
    budget_s=1.0,
    backoff=Backoff(duration=0.0, cap=0.0),
    retry_statuses=(),
)


def parse_retry_after(raw: Optional[str]) -> Optional[float]:
    """Seconds to wait from a ``Retry-After`` header value.

    Accepts both RFC 7231 forms: delay-seconds (including the
    fractional values this framework's servers emit) and an absolute
    HTTP-date, converted to a non-negative delta from now.  Returns
    None for absent or unparseable values."""
    if not raw:
        return None
    try:
        return max(0.0, float(raw))
    except ValueError:
        pass
    from email.utils import parsedate_to_datetime

    try:
        dt = parsedate_to_datetime(raw)
    except (TypeError, ValueError):
        return None
    if dt is None:
        return None
    if dt.tzinfo is None:
        import datetime as _dt

        dt = dt.replace(tzinfo=_dt.timezone.utc)
    # an HTTP-date Retry-After is wall-clock BY DEFINITION (RFC 7231
    # delta against the server's notion of now); monotonic time has no
    # epoch to compare it to
    return max(0.0, dt.timestamp() - time.time())  # kwoklint: disable=wallclock-deadline


def _raise_for(code: int, payload: Any) -> None:
    reason = (payload or {}).get("reason", "Unknown")
    msg = (payload or {}).get("error", "")
    if code == 404:
        raise NotFound(msg)
    if code == 409:
        if reason == "CrossShard":
            # the sharded router's typed refusal of a multi-shard
            # atomic batch — surfaced as the same exception type the
            # in-process store raises (index unknown over the wire)
            raise CrossShardTransaction(-1, msg)
        raise Conflict(msg)
    if code == 410:
        raise Expired(msg)
    raise APIError(code, reason, msg)


@dataclass
class WireEvent:
    """One decoded watch-stream event — duck-compatible with
    ``store.WatchEvent`` (``type``/``object``/``rv``) plus the optional
    ``ctx`` side channel: the committing span's (trace_id, span_id)
    the apiserver resolved from its commit ring at delivery, so a
    remote consumer can continue/link the causing write's trace."""

    type: str
    object: dict
    rv: int = 0
    ctx: Optional[Tuple[str, str]] = None


class RemoteWatcher:
    """Client end of a watch stream; same surface as store.Watcher
    (next/stop/stopped/iteration).

    Backpressure twin of the server's watcher high-water: a consumer
    that stops draining ``next()`` would otherwise grow ``_queue``
    without bound while the pump keeps reading the socket.  Past
    ``HIGH_WATER`` undelivered events the stream self-evicts (pump
    stops, connection closes); the informer reflector then resumes at
    its last delivered resourceVersion."""

    #: undelivered-event bound before the stream self-evicts
    HIGH_WATER = 100_000

    def __init__(self, conn: http.client.HTTPConnection, resp: http.client.HTTPResponse):
        self._conn = conn
        self._resp = resp
        self._queue: Queue = Queue()
        self._stopped = threading.Event()
        #: True when the high-water cutoff ended the stream
        self.evicted = False
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self) -> None:
        try:
            while not self._stopped.is_set():
                line = self._resp.readline()
                if not line:
                    break
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if ev.get("type") == "BOOKMARK":
                    continue
                self._queue.add(ev)
                if len(self._queue) > self.HIGH_WATER:
                    # slow consumer: stop buffering history; the owner
                    # reconnects from its last rv instead
                    self.evicted = True
                    break
        except (OSError, http.client.HTTPException):
            pass
        finally:
            self._stopped.set()
            try:
                self._conn.close()
            except OSError:
                pass

    @staticmethod
    def _decode(ev: dict) -> WireEvent:
        ctx = ev.get("ctx")
        return WireEvent(
            type=ev["type"],
            object=ev["object"],
            rv=ev.get("rv", 0),
            ctx=tuple(ctx) if isinstance(ctx, (list, tuple)) and len(ctx) == 2 else None,
        )

    def next(self, timeout: Optional[float] = 0.5):
        ev, ok = self._queue.get_or_wait(timeout=timeout)
        if not ok or ev is None:
            return None
        return self._decode(ev)

    def drain(self):
        """Pop every currently-buffered event without blocking (same
        surface as store.Watcher.drain — the informer batches on it)."""
        out = []
        while True:
            ev, ok = self._queue.get()
            if not ok:
                return out
            out.append(self._decode(ev))

    def __iter__(self):
        while True:
            ev = self.next(timeout=0.5)
            if ev is not None:
                yield ev
            elif self.stopped:
                return

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._conn.sock and self._conn.sock.close()  # unblock readline
        except OSError:
            pass

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set() and len(self._queue) == 0


class ClusterClient:
    """Store-compatible client for a remote :class:`APIServer`."""

    #: default page size for list_paged (the reference's snapshot pager
    #: bounds responses the same way)
    LIST_PAGE_SIZE = 5000

    def __init__(
        self,
        url: str,
        timeout: float = 30.0,
        ca_cert: Optional[str] = None,
        client_cert: Optional[str] = None,
        client_key: Optional[str] = None,
        retry: Optional[RetryPolicy] = None,
        client_id: Optional[str] = None,
        fence_provider: Optional[Callable[[], Optional[str]]] = None,
        clock=None,
    ):
        self._https = url.startswith("https://")
        if "://" in url:
            url = url.split("://", 1)[1]
        self._hostport = url.rstrip("/")
        self._timeout = timeout
        self._retry = retry or RetryPolicy()
        #: injectable clock (utils.clock Clock duck type) for the retry
        #: backoff / readiness-poll sleeps, so simulated-time runs can
        #: virtualize them; RealClock's wait_signal on a never-set
        #: event is exactly time.sleep.
        from kwok_tpu_torch.utils.clock import RealClock

        self._clock = clock or RealClock()
        self._sleep_wake = threading.Event()
        self._clock.subscribe(self._sleep_wake)
        #: identifies this client to the apiserver (X-Kwok-Client) on
        #: EVERY verb — flow control classifies on it and chaos
        #: partitions target it.  Defaults to the component name the
        #: runtime exports; standalone callers (kwokctl, tests, REPLs)
        #: fall back to "kwok-client", which the default flow schema
        #: ranks as operator traffic rather than anonymous best-effort.
        self.client_id = (
            client_id
            or os.environ.get("KWOK_COMPONENT_NAME")
            or "kwok-client"
        )
        #: leader-fence seam (cluster/election.py): a callable returning
        #: the current X-Kwok-Leader-Fence token, or None when the
        #: owning component is not leading.  Stamped on every mutating
        #: verb so the apiserver can reject stale-generation writes
        #: with 409 (split-brain guard).  Elector clients leave this
        #: unset — lease CAS is their own fence.
        self.fence_provider = fence_provider
        self._local = threading.local()
        self._types: Dict[str, ResourceType] = {}
        self._types_mut = threading.Lock()
        #: retry accounting by cause — degraded-storage 503s counted
        #: distinctly from APF overload 429s and plain unavailability,
        #: so operators (and tests) can tell WHY a client was backing
        #: off; read with :meth:`retry_stats`
        self._retry_mut = threading.Lock()
        self._retry_counts: Dict[str, int] = {
            "overload": 0,       # 429 (APF shed)
            "degraded": 0,       # 503 with reason StorageDegraded
            "unavailable": 0,    # other 503s
            "transport": 0,      # socket-level send failures
        }
        self._ssl_ctx = None
        if self._https:
            import ssl

            # full verification even against the private CA — the
            # generated server certs carry localhost/127.0.0.1 SANs, so
            # hostname checks pass and a leaked client cert cannot
            # impersonate the apiserver
            ctx = ssl.create_default_context(cafile=ca_cert)
            if client_cert and client_key:
                ctx.load_cert_chain(client_cert, client_key)
            self._ssl_ctx = ctx

    # ---------------------------------------------------------- transport

    def _conn(self) -> http.client.HTTPConnection:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = self._fresh_conn()
            self._local.conn = c
        return c

    def _fresh_conn(self, timeout: Optional[float] = None) -> http.client.HTTPConnection:
        t = timeout if timeout is not None else self._timeout
        if self._https:
            return http.client.HTTPSConnection(
                self._hostport, timeout=t, context=self._ssl_ctx
            )
        return http.client.HTTPConnection(self._hostport, timeout=t)

    def _drop_conn(self, conn: http.client.HTTPConnection) -> None:
        try:
            conn.close()
        except OSError:
            pass
        self._local.conn = None

    def _request(
        self,
        method: str,
        path: str,
        body: Any = None,
        headers: Optional[Dict[str, str]] = None,
        retry: Optional[RetryPolicy] = None,
    ) -> Any:
        """One API call under the client's :class:`RetryPolicy`.

        Retries (with jittered backoff, honoring Retry-After) on:
        socket-level send failures for any verb (the request never
        reached the server), lost responses for idempotent reads, and
        429/503 statuses for any verb (pre-processing rejections).
        Terminal failures surface as :class:`ApiUnavailable`; a lost
        response after a mutating request went out is terminal
        immediately (the server may have applied it)."""
        policy = retry if retry is not None else self._retry
        hdrs = {"Content-Type": "application/json"}
        if self.client_id:
            hdrs["X-Kwok-Client"] = self.client_id
        if headers:
            hdrs.update(headers)
        tracer = None
        orig_span = None
        trace_hdr_ours = False
        if method != "GET":
            # propagate the caller's trace across the process boundary
            # (W3C traceparent; the apiserver continues the trace)
            from kwok_tpu_torch.utils.trace import get_tracer, traceparent

            tr = get_tracer()
            if tr.enabled:
                tracer = tr
                orig_span = tr.current()
            tp = traceparent(orig_span)
            if tp and "traceparent" not in hdrs:
                hdrs["traceparent"] = tp
                trace_hdr_ours = True
            if self.fence_provider is not None:
                fence = self.fence_provider()
                if fence:
                    from kwok_tpu_torch.cluster.election import FENCE_HEADER

                    hdrs.setdefault(FENCE_HEADER, fence)
        payload = json.dumps(body) if body is not None else None
        start = time.monotonic()
        attempts = 0
        last_status: Optional[int] = None
        #: anchor for retry-attempt spans when the caller has no live
        #: span: the first retry becomes the trace root so ALL attempts
        #: of one logical request still share ONE trace
        retry_root = None

        def _wait_or_raise(message: str, retry_after=None, cause=None):
            # decide between sleeping into the next attempt and raising
            # the typed terminal error
            if attempts >= policy.max_attempts:
                raise ApiUnavailable(message, attempts, last_status) from cause
            delay = policy.delay(attempts - 1, retry_after)
            if time.monotonic() + delay > start + policy.budget_s:
                raise ApiUnavailable(
                    f"{message} (retry budget exhausted)", attempts, last_status
                ) from cause
            if delay > 0:
                # through the injected clock so a simulated-time run
                # can virtualize the backoff; cleared first because a
                # fake clock's advance() latches subscribed events
                # (under RealClock nothing sets it: exactly time.sleep)
                self._sleep_wake.clear()
                self._clock.wait_signal(self._sleep_wake, delay)

        while True:
            attempts += 1
            aspan = None
            if tracer is not None and attempts > 1:
                # traceparent continuity across retries: every retry
                # attempt is a CHILD span of the originating client
                # span (or of the first retry, for span-less callers),
                # so a 429/503-then-success sequence reads as ONE trace
                # with its attempts visible, never N disconnected ones
                aspan = tracer.span("client.retry", parent=orig_span or retry_root)
                if orig_span is None and retry_root is None:
                    retry_root = aspan
                aspan.set("attempt", attempts)
                aspan.set("http.method", method)
                aspan.set("http.path", path)
                if trace_hdr_ours:
                    from kwok_tpu_torch.utils.trace import traceparent

                    hdrs["traceparent"] = traceparent(aspan)
            conn = self._conn()
            try:
                conn.request(method, path, body=payload, headers=hdrs)
            except (OSError, http.client.HTTPException) as exc:
                # send failed → the request never reached the server, so
                # a retry on a fresh socket is safe for any verb (typical
                # cause: the server closed an idle keep-alive connection,
                # or a chaos reset/partition)
                if aspan is not None:
                    aspan.error(str(exc)).end()
                self._drop_conn(conn)
                self._note_retry("transport")
                _wait_or_raise(f"{method} {path}: {exc}", cause=exc)
                continue
            try:
                resp = conn.getresponse()
                raw = resp.read()
            except (OSError, http.client.HTTPException) as exc:
                # response lost after the request went out: the server
                # may have applied the mutation, so only idempotent
                # reads retry
                if aspan is not None:
                    aspan.error(str(exc)).end()
                self._drop_conn(conn)
                if method not in ("GET", "HEAD"):
                    raise ApiUnavailable(
                        f"{method} {path}: response lost after send: {exc}",
                        attempts,
                        last_status,
                    ) from exc
                _wait_or_raise(f"{method} {path}: {exc}", cause=exc)
                continue
            if aspan is not None:
                aspan.set("http.status", resp.status).end()
            if resp.status in policy.retry_statuses:
                last_status = resp.status
                retry_after = parse_retry_after(resp.getheader("Retry-After"))
                # classify the rejection for retry accounting: APF
                # overload (429) vs degraded storage (503 with reason
                # StorageDegraded) vs plain unavailability — the
                # Retry-After of each is honored identically, but WHY
                # the client is waiting must stay distinguishable
                reason = None
                if raw:
                    try:
                        reason = (json.loads(raw) or {}).get("reason")
                    except ValueError:
                        reason = None
                if resp.status == 429:
                    self._note_retry("overload")
                elif reason == "StorageDegraded":
                    self._note_retry("degraded")
                else:
                    self._note_retry("unavailable")
                # a shed/reject response closes the connection (the
                # server broke keep-alive framing on purpose); start
                # the retry on a fresh socket
                self._drop_conn(conn)
                _wait_or_raise(
                    f"{method} {path}: HTTP {resp.status}", retry_after
                )
                continue
            data = json.loads(raw) if raw else None
            if resp.status >= 400:
                _raise_for(resp.status, data)
            return data

    @staticmethod
    def _q(**params) -> str:
        from urllib.parse import urlencode

        clean = {k: v for k, v in params.items() if v}
        return ("?" + urlencode(clean)) if clean else ""

    @staticmethod
    def _esc(segment: str) -> str:
        """Path-escape an object name; the in-process store accepts any
        name, so the wire form must too."""
        from urllib.parse import quote

        return quote(segment, safe="")

    @staticmethod
    def _sel(sel: Selector) -> Optional[str]:
        if sel is None:
            return None
        if isinstance(sel, dict):
            return ",".join(f"{k}={v}" for k, v in sel.items())
        return str(sel)

    @staticmethod
    def _user_hdr(as_user: Optional[str]) -> Optional[Dict[str, str]]:
        return {"Impersonate-User": as_user} if as_user else None

    # ------------------------------------------------------------ registry

    def register_type(self, rtype: ResourceType) -> None:
        self._request(
            "POST",
            "/apis",
            body={
                "api_version": rtype.api_version,
                "kind": rtype.kind,
                "plural": rtype.plural,
                "namespaced": rtype.namespaced,
            },
        )
        with self._types_mut:
            self._types = {}  # refresh lazily

    def _registry(self) -> Dict[str, ResourceType]:
        with self._types_mut:
            cached = self._types
        if cached:
            return cached
        # fetch outside the lock so a slow /apis doesn't serialize every
        # thread's CRUD verb behind one network call
        data = self._request("GET", "/apis")
        fresh: Dict[str, ResourceType] = {}
        for t in data.get("resources", []):
            rt = ResourceType(
                api_version=t["api_version"],
                kind=t["kind"],
                plural=t["plural"],
                namespaced=t["namespaced"],
            )
            fresh[rt.kind.lower()] = rt
            fresh[rt.plural.lower()] = rt
        with self._types_mut:
            self._types = fresh
            return self._types

    def resource_type(self, kind: str) -> ResourceType:
        rt = self._registry().get(kind.lower())
        if rt is None:
            with self._types_mut:
                self._types = {}
            rt = self._registry().get(kind.lower())
        if rt is None:
            raise NotFound(f"unknown resource type {kind!r}")
        return rt

    def kinds(self) -> List[ResourceType]:
        seen: List[ResourceType] = []
        for rt in self._registry().values():
            if rt not in seen:
                seen.append(rt)
        return seen

    # ---------------------------------------------------------------- CRUD

    def create(
        self, obj: dict, namespace: Optional[str] = None, as_user: Optional[str] = None
    ) -> dict:
        plural = self.resource_type(obj.get("kind") or "").plural
        return self._request(
            "POST",
            f"/r/{plural}" + self._q(namespace=namespace),
            body=obj,
            headers=self._user_hdr(as_user),
        )

    def get(self, kind: str, name: str, namespace: Optional[str] = None) -> dict:
        plural = self.resource_type(kind).plural
        return self._request(
            "GET", f"/r/{plural}/{self._esc(name)}" + self._q(namespace=namespace)
        )

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Selector = None,
        field_selector: Selector = None,
    ) -> Tuple[List[dict], int]:
        """Single-request list: one consistent snapshot under the store
        lock, which informers REQUIRE (the returned resourceVersion
        must cover every item, or watch-from-rv misses events).  Use
        :meth:`list_paged` for bulk exports where bounded response
        sizes matter more than snapshot consistency."""
        plural = self.resource_type(kind).plural
        data = self._request(
            "GET",
            f"/r/{plural}"
            + self._q(
                namespace=namespace,
                labelSelector=self._sel(label_selector),
                fieldSelector=self._sel(field_selector),
            ),
        )
        return data.get("items", []), int(data.get("resourceVersion", 0))

    def list_paged(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Selector = None,
        field_selector: Selector = None,
        page_size: Optional[int] = None,
    ) -> Tuple[List[dict], int]:
        """Paged list via limit/continue: bounds each response, but the
        pages are independent reads — mutations between pages can skip
        or duplicate items (see ResourceStore.list_page)."""
        plural = self.resource_type(kind).plural
        items: List[dict] = []
        rv = 0
        cont: Optional[str] = None
        size = page_size or self.LIST_PAGE_SIZE
        while True:
            data = self._request(
                "GET",
                f"/r/{plural}"
                + self._q(
                    namespace=namespace,
                    labelSelector=self._sel(label_selector),
                    fieldSelector=self._sel(field_selector),
                    limit=str(size),
                    **({"continue": cont} if cont else {}),
                ),
            )
            items.extend(data.get("items", []))
            rv = int(data.get("resourceVersion", 0))
            cont = data.get("continue")
            if not cont:
                return items, rv

    def update(
        self, obj: dict, subresource: str = "", as_user: Optional[str] = None
    ) -> dict:
        plural = self.resource_type(obj.get("kind") or "").plural
        name = (obj.get("metadata") or {}).get("name") or ""
        return self._request(
            "PUT",
            f"/r/{plural}/{self._esc(name)}" + self._q(subresource=subresource),
            body=obj,
            headers=self._user_hdr(as_user),
        )

    def patch(
        self,
        kind: str,
        name: str,
        data: Any,
        patch_type: str = "merge",
        namespace: Optional[str] = None,
        subresource: str = "",
        as_user: Optional[str] = None,
        expect: Optional[Dict[str, Any]] = None,
    ) -> dict:
        plural = self.resource_type(kind).plural
        if expect:
            # the legacy PATCH route carries no precondition; route a
            # guarded patch through /bulk, which does (store duck-type:
            # same expect semantics as ResourceStore.patch)
            res = self.bulk(
                [
                    {
                        "verb": "patch",
                        "kind": kind,
                        "name": name,
                        "namespace": namespace,
                        "data": data,
                        "patch_type": patch_type,
                        "subresource": subresource,
                        "as_user": as_user,
                        "expect": expect,
                    }
                ]
            )[0]
            if res.get("status") == "ok":
                return res.get("object")
            _raise_for(
                {"NotFound": 404, "Conflict": 409, "Expired": 410}.get(
                    res.get("reason"), 400
                ),
                res,
            )
        headers = {"Content-Type": _PATCH_CT.get(patch_type, _PATCH_CT["merge"])}
        user = self._user_hdr(as_user)
        if user:
            headers.update(user)
        return self._request(
            "PATCH",
            f"/r/{plural}/{self._esc(name)}"
            + self._q(namespace=namespace, subresource=subresource),
            body=data,
            headers=headers,
        )

    def scale(
        self,
        kind: str,
        name: str,
        replicas: int,
        namespace: Optional[str] = None,
        as_user: Optional[str] = None,
    ) -> dict:
        """Set a workload's ``spec.replicas`` — the client side of the
        k8s ``/scale`` subresource (same end state: one merge patch on
        the parent, fanned out by the workload controllers)."""
        return self.patch(
            kind,
            name,
            {"spec": {"replicas": int(replicas)}},
            patch_type="merge",
            namespace=namespace,
            as_user=as_user,
        )

    def delete(
        self, kind: str, name: str, namespace: Optional[str] = None, as_user: Optional[str] = None
    ) -> Optional[dict]:
        plural = self.resource_type(kind).plural
        return self._request(
            "DELETE",
            f"/r/{plural}/{self._esc(name)}" + self._q(namespace=namespace),
            headers=self._user_hdr(as_user),
        )

    # ---------------------------------------------------------- raw state

    def dump_state(self) -> dict:
        """Raw store snapshot from a live cluster (etcd-save analog)."""
        return self._request("GET", "/state")

    def stats(self) -> dict:
        """The apiserver's /stats block: resourceVersion, per-kind
        counts, and (when a WAL is attached) the storage-integrity
        health surface (``wal``: segments/bytes/last-fsync age plus
        recovery counters)."""
        return self._request("GET", "/stats")

    def fleet(self, tenant: Optional[str] = None) -> dict:
        """The fleet-host report (``GET /fleet``): tenant lifecycle
        counts, cold-start latency quantiles, and per-tenant rows
        (state/shard/request p50-p99).  With ``tenant``, that tenant's
        deep view — journeys and the critical-path budget scoped to its
        object space.  404s (NotFound) when the apiserver hosts no
        fleet."""
        return self._request("GET", "/fleet" + self._q(tenant=tenant))

    def debug_journey(
        self,
        kind: Optional[str] = None,
        namespace: Optional[str] = None,
        name: Optional[str] = None,
        uid: Optional[str] = None,
    ) -> dict:
        """One object's journey timeline from the apiserver's bounded
        uid-keyed ring (``GET /debug/journey`` — commit/watch hops with
        committing trace ids); without a name/uid, the recent-journeys
        listing plus ring stats.  ``kwokctl trace`` joins this with the
        collector's span view."""
        return self._request(
            "GET",
            "/debug/journey"
            + self._q(kind=kind, ns=namespace, name=name, uid=uid),
        )

    def restore_state(self, state: dict) -> int:
        """Load a raw snapshot into a live cluster (etcd-restore
        analog); watchers see ADDED for every restored object."""
        return int(self._request("PUT", "/state", body=state)["restored"])

    # ---------------------------------------------------------------- bulk

    def bulk(self, ops, as_user: Optional[str] = None) -> list:
        """One round-trip for many mutations (the device backend's
        dirty-row drain; see ResourceStore.bulk for the op format).
        ``as_user`` stamps the HTTP audit line (each op's own
        ``as_user`` still attributes the in-store audit entries), so
        log consumers can tell a workload-controller wave from the
        device drain."""
        data = self._request(
            "POST",
            "/bulk",
            body={"ops": list(ops)},
            headers=self._user_hdr(as_user),
        )
        return data.get("results", [])

    def transact(self, ops, as_user: Optional[str] = None) -> list:
        """All-or-nothing sibling of :meth:`bulk` (``POST /txn``): the
        gang-scheduling commit lane (ResourceStore.transact).  The
        whole batch applies atomically or a 409 Conflict surfaces —
        with the failing op named in the message — and nothing was
        mutated."""
        data = self._request(
            "POST",
            "/txn",
            body={"ops": list(ops)},
            headers=self._user_hdr(as_user),
        )
        return data.get("results", [])

    # --------------------------------------------------------------- watch

    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        since_rv: Optional[int] = None,
        label_selector: Selector = None,
        field_selector: Selector = None,
    ) -> RemoteWatcher:
        plural = self.resource_type(kind).plural
        path = f"/r/{plural}" + self._q(
            watch="1",
            namespace=namespace,
            resourceVersion=str(since_rv) if since_rv is not None else None,
            labelSelector=self._sel(label_selector),
            fieldSelector=self._sel(field_selector),
        )
        # watch connections idle between events; no read timeout
        conn = self._fresh_conn(timeout=None)
        hdrs = {"Accept": "application/json"}
        if self.client_id:
            hdrs["X-Kwok-Client"] = self.client_id
        try:
            conn.request("GET", path, headers=hdrs)
            resp = conn.getresponse()
        except (OSError, http.client.HTTPException) as exc:
            # same typed terminal error as _request — watch setup has
            # no retry loop of its own (the informer reflector owns it)
            try:
                conn.close()
            except OSError:
                pass
            raise ApiUnavailable(f"watch {plural}: {exc}", 1) from exc
        if resp.status >= 400:
            raw = resp.read()
            conn.close()
            _raise_for(resp.status, json.loads(raw) if raw else None)
        return RemoteWatcher(conn, resp)

    # --------------------------------------------------------------- stats

    @property
    def resource_version(self) -> int:
        return int(self._request("GET", "/stats")["resourceVersion"])

    def count(self, kind: str) -> int:
        plural = self.resource_type(kind).plural
        return int(self._request("GET", "/stats")["counts"].get(plural, 0))

    def _note_retry(self, cause: str) -> None:
        with self._retry_mut:
            self._retry_counts[cause] = self._retry_counts.get(cause, 0) + 1

    def retry_stats(self) -> Dict[str, int]:
        """Retry accounting by cause: ``overload`` (429 shed),
        ``degraded`` (503 with reason StorageDegraded), ``unavailable``
        (other 503s), ``transport`` (socket-level send failures)."""
        with self._retry_mut:
            return dict(self._retry_counts)

    def healthy(self) -> bool:
        try:
            # NO_RETRY: a health probe must answer fast; its caller owns
            # the poll loop (wait_ready, the component supervisor)
            return (
                self._request("GET", "/healthz", retry=NO_RETRY).get("status")
                == "ok"
            )
        except Exception:  # noqa: BLE001 — health probe
            return False

    def readiness(self) -> Tuple[bool, Optional[str]]:
        """``(ready, reason)`` from the apiserver's /readyz.  Ready
        means storage accepts writes; a degraded server answers 503
        with reason ``StorageDegraded`` (alive but read-only — the
        supervisor must NOT treat this as crashed).  ``reason`` is None
        when ready or unreachable."""
        try:
            data = self._request("GET", "/readyz", retry=READY_PROBE)
            return (data or {}).get("status") == "ok", None
        except APIError as exc:
            return False, exc.reason
        except Exception:  # noqa: BLE001 — readiness probe
            return False, None

    def ready(self) -> bool:
        """True when the apiserver is serving AND storage is armed."""
        return self.readiness()[0]

    def wait_ready(self, timeout: float = 30.0) -> bool:
        """Poll /healthz with backoff (reference kwok waits for the
        apiserver the same way, pkg/kwok/cmd/root.go:434-460)."""
        return self._poll(self.healthy, timeout)

    def wait_writable(self, timeout: float = 30.0) -> bool:
        """The /readyz twin of :meth:`wait_ready`: poll until storage
        accepts writes again (degraded mode re-armed).  Each poll rides
        the server's throttled re-arm probe, so waiting IS probing."""
        return self._poll(self.ready, timeout)

    def _poll(self, probe: Callable[[], bool], timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        delay = 0.05
        while time.monotonic() < deadline:
            if probe():
                return True
            self._sleep_wake.clear()
            self._clock.wait_signal(self._sleep_wake, delay)
            delay = min(delay * 2, 1.0)
        return probe()
