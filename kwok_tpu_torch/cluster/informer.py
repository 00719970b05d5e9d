"""Generic informer: list+watch a resource into an event queue.

Mirrors the reference's three informer flavors
(reference: pkg/utils/informer/informer.go:33-319):

- ``watch_with_cache`` — reflector loop keeping a local cache; returns a
  ``CacheGetter`` (the store-backed Getter) and forwards every event.
- ``watch`` — cache-less: a dummy store, events forwarded only.
- ``sync`` — on-demand re-list, delivered as SYNC events (used to
  re-feed pods when their node becomes managed, reference
  controller.go:559-573).

Threading model: one daemon thread per informer doing list-then-drain;
an ``Expired`` resume triggers a fresh re-list (reflector behavior).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from kwok_tpu_torch.cluster.store import (
    ADDED,
    DELETED,
    MODIFIED,
    SYNC,
    Expired,
    ResourceStore,
    Selector,
)
from kwok_tpu_torch.utils.locks import make_lock
from kwok_tpu_torch.utils.queue import Queue

# drain accelerator (native/kwok_fastdrain.c); None -> pure Python
from kwok_tpu_torch.native.fastdrain import load as _load_fastdrain

_FAST = _load_fastdrain()


@dataclass
class InformerEvent:
    type: str  # ADDED | MODIFIED | DELETED | SYNC
    object: dict
    #: committing span context ``(trace_id, span_id)`` resolved across
    #: the watch boundary (store commit ring / wire ``ctx`` side
    #: channel), or None — consumers open their reconcile span as a
    #: continuation of / link to the write that caused this event.
    #: Lists and re-syncs carry none (no single causing write).
    ctx: Optional[Tuple[str, str]] = None


@dataclass
class WatchOptions:
    namespace: Optional[str] = None
    label_selector: Selector = None
    field_selector: Selector = None
    #: client-side predicate applied after selectors (reference filters
    #: managed nodes in the controller, not the informer; this hook keeps
    #: the informer generic)
    predicate: Optional[Callable[[dict], bool]] = None
    #: False: this consumer does not need status-only batch events
    #: (Watcher.status_interest) — in-process stores then skip it on
    #: status commits and keep the zero-copy lane eligible; remote
    #: stores deliver everything (the wire has no such flag)
    status_interest: bool = True


class CacheGetter:
    """Read access to the informer's local mirror (informer.go Getter)."""

    def __init__(self):
        self._mut = make_lock("cluster.informer.CacheGetter._mut")
        self._items: Dict[Tuple[str, str], dict] = {}

    def get(self, name: str, namespace: str = "") -> Optional[dict]:
        with self._mut:
            obj = self._items.get((namespace, name))
            return obj

    def list(self):
        with self._mut:
            return list(self._items.values())

    def _apply(self, etype: str, obj: dict) -> None:
        meta = obj.get("metadata") or {}
        key = (meta.get("namespace") or "", meta.get("name") or "")
        with self._mut:
            if etype == DELETED:
                self._items.pop(key, None)
            else:
                self._items[key] = obj

    def _apply_batch(self, pairs) -> None:
        """Apply many (etype, obj) under one lock hold (the reflector
        forwards store batches; a lock per event was measurable at
        drain rates)."""
        with self._mut:
            items = self._items
            for etype, obj in pairs:
                meta = obj.get("metadata") or {}
                key = (meta.get("namespace") or "", meta.get("name") or "")
                if etype == DELETED:
                    items.pop(key, None)
                else:
                    items[key] = obj

    def __len__(self) -> int:
        with self._mut:
            return len(self._items)


class StoreBackedGetter:
    """Getter duck-type of :class:`CacheGetter` that reads the store
    directly instead of keeping a mirror.  For an in-process store the
    mirror is pure overhead: maintaining 1M mirror entries per drain
    tick was ~25% of the e2e cost, while direct reads are always fresh
    and only pay on actual use (the device player's getter consumers
    are rare: debug endpoints, catch-up paths)."""

    def __init__(self, store: ResourceStore, kind: str):
        self._store = store
        self._kind = kind

    def get(self, name: str, namespace: str = ""):
        try:
            return self._store.get(self._kind, name, namespace=namespace or None)
        except KeyError:
            return None

    def list(self):
        # stored instances by reference — consumers are read-only by
        # the handed-out-by-reference contract (ResourceStore.list)
        return self._store.list(self._kind, copy=False)[0]

    def __len__(self) -> int:
        return self._store.count(self._kind)


class Informer:
    """List/watch one resource kind from a ResourceStore."""

    def __init__(self, store: ResourceStore, kind: str):
        self._store = store
        self._kind = kind
        self._threads = []
        #: the live Watcher of the most recent watch() stream — lets a
        #: consumer that re-absorbs its own writes ask the store to skip
        #: delivering them (store.apply_status_batch(exclude=...)).
        #: May lag a re-list briefly; excluding a stale (stopped)
        #: watcher is harmless and the echoes then flow normally.
        self.active_watcher = None
        #: reflector self-metrics: full list+replace cycles vs. watch
        #: streams resumed at the last delivered resourceVersion with
        #: no re-list (the chaos e2e asserts recovery rides resumes)
        self.relists = 0
        self.resumes = 0
        # duck-typed remote stores (ClusterClient) have no copy kwarg
        import inspect

        try:
            self._list_no_copy = (
                "copy" in inspect.signature(store.list).parameters
            )
        except (TypeError, ValueError):
            self._list_no_copy = False
        try:
            self._watch_has_interest = (
                "status_interest" in inspect.signature(store.watch).parameters
            )
        except (TypeError, ValueError):
            self._watch_has_interest = False

    def _list(self, opt: WatchOptions):
        kw = {}
        if self._list_no_copy:
            # in-process store: stored instances by reference (the
            # informer's consumers are read-only by contract)
            kw["copy"] = False
        items, rv = self._store.list(
            self._kind,
            namespace=opt.namespace,
            label_selector=opt.label_selector,
            field_selector=opt.field_selector,
            **kw,
        )
        if opt.predicate is not None:
            items = [o for o in items if opt.predicate(o)]
        return items, rv

    def sync(self, opt: WatchOptions, events: Queue) -> int:
        """Re-list matching objects as SYNC events (informer.go Sync)."""
        items, _ = self._list(opt)
        for obj in items:
            events.add(InformerEvent(SYNC, obj))
        return len(items)

    def watch(
        self,
        opt: WatchOptions,
        events: Queue,
        done: Optional[threading.Event] = None,
        cache: Optional[CacheGetter] = None,
    ) -> CacheGetter:
        """Start the reflector thread; returns the cache (empty-but-live
        for the cache-less flavor)."""
        getter = cache if cache is not None else CacheGetter()
        use_cache = cache is not None
        done = done or threading.Event()

        # cache-less flavor with a predicate: remember which keys have
        # passed it, so an object LEAVING the predicate set still
        # surfaces as DELETED (the mirror used to provide this; a bare
        # key set is all the state that contract actually needs)
        seen: set = set()

        def loop():
            backoff = 0.1
            #: highest resourceVersion delivered to the consumer; a
            #: dead stream reconnects from here (reflector resume)
            #: instead of paying a full re-list — the re-list only
            #: happens when the store answers Expired (history gap)
            last_rv: Optional[int] = None
            wkw = {}
            if not opt.status_interest and self._watch_has_interest:
                wkw["status_interest"] = False
            while not done.is_set():
                w = None
                if last_rv is not None:
                    try:
                        w = self._store.watch(
                            self._kind,
                            namespace=opt.namespace,
                            since_rv=last_rv,
                            label_selector=opt.label_selector,
                            field_selector=opt.field_selector,
                            **wkw,
                        )
                        self.resumes += 1
                    except Expired:
                        # the gap outgrew the history ring (or the
                        # store restarted past us): fall back to the
                        # list+replace path below
                        last_rv = None
                    except Exception:  # noqa: BLE001 — apiserver outage
                        done.wait(backoff)
                        backoff = min(backoff * 2, 5.0)
                        continue
                if w is None:
                    rv = self._relist_once(opt, events, getter, use_cache, seen)
                    if rv is None:
                        backoff = min(backoff * 2, 5.0)
                        done.wait(backoff)
                        continue
                    try:
                        w = self._store.watch(
                            self._kind,
                            namespace=opt.namespace,
                            since_rv=rv,
                            label_selector=opt.label_selector,
                            field_selector=opt.field_selector,
                            **wkw,
                        )
                    except Expired:
                        continue
                    except Exception:  # noqa: BLE001 — apiserver outage
                        done.wait(backoff)
                        backoff = min(backoff * 2, 5.0)
                        continue
                    last_rv = rv
                backoff = 0.1
                self.active_watcher = w
                try:
                    last_rv = self._pump_stream(
                        w, opt, events, done, getter, use_cache, seen, last_rv
                    )
                finally:
                    w.stop()

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        self._threads.append(t)
        return getter

    def _relist_once(self, opt, events, getter, use_cache, seen):
        """One list+replace cycle (reflector "replace" semantics).
        Returns the list's resourceVersion, or None on a transient
        failure (caller backs off).  The rv travels by return value,
        not instance state — one Informer may run several watch loops
        (self._threads), and a shared attribute would let loop A
        resume from loop B's newer rv, silently skipping events."""
        try:
            items, rv = self._list(opt)
        except Exception:  # noqa: BLE001 — transient apiserver outage
            # reflector retry-with-backoff: a dead apiserver must
            # not kill the watch thread (client-go reflectors
            # behave the same way)
            return None
        self.relists += 1
        if not use_cache and opt.predicate is not None:
            fresh_keys = set()
            for obj in items:
                meta = obj.get("metadata") or {}
                fresh_keys.add(
                    (meta.get("namespace") or "", meta.get("name") or "")
                )
            # objects that vanished (or left the predicate set)
            # during a watch gap must release their rows
            for key in seen - fresh_keys:
                events.add(
                    InformerEvent(
                        DELETED,
                        {"metadata": {"namespace": key[0], "name": key[1]}},
                    )
                )
            seen.clear()
            seen.update(fresh_keys)
        if use_cache:
            # reconcile: reflector "replace" semantics. Objects
            # that vanished during a watch gap surface as DELETED;
            # unchanged objects are not re-emitted.
            fresh = {}
            for obj in items:
                meta = obj.get("metadata") or {}
                fresh[(meta.get("namespace") or "", meta.get("name") or "")] = obj
            for stale in getter.list():
                meta = stale.get("metadata") or {}
                key = (meta.get("namespace") or "", meta.get("name") or "")
                if key not in fresh:
                    getter._apply(DELETED, stale)
                    events.add(InformerEvent(DELETED, stale))
            for obj in items:
                meta = obj.get("metadata") or {}
                prev = getter.get(meta.get("name") or "", meta.get("namespace") or "")
                if prev is not None and prev.get("metadata", {}).get(
                    "resourceVersion"
                ) == meta.get("resourceVersion"):
                    continue
                getter._apply(ADDED, obj)
                events.add(
                    InformerEvent(ADDED if prev is None else MODIFIED, obj)
                )
        else:
            for obj in items:
                events.add(InformerEvent(ADDED, obj))
        return rv

    def _pump_stream(
        self, w, opt, events, done, getter, use_cache, seen, last_rv
    ):
        """Forward one live watch stream until it dies or ``done`` is
        set; returns the highest delivered resourceVersion so the outer
        loop can resume there."""
        # rv→span resolution for in-process stores: with a tracer
        # armed, forwarded events carry the committing span's context
        # looked up from the store's commit ring — ONE batched lookup
        # per forwarded batch (remote streams already arrive with the
        # wire `ctx` side channel).  Tracing off — or a batch with no
        # traced writes, e.g. the bulk drain — keeps the native fast
        # path untouched.
        from kwok_tpu_torch.utils.trace import peek_global

        _tr = peek_global()
        resolve_many = (
            getattr(self._store, "commit_contexts", None)
            if _tr is not None and _tr.enabled
            else None
        )
        while not done.is_set():
            ev = w.next(timeout=0.2)
            if ev is None:
                if w.stopped:
                    # stream died underneath us (remote watch
                    # connection lost, chaos drop): the outer loop
                    # resumes at last_rv, re-listing only on Expired
                    break
                continue
            # drain everything already queued and forward it
            # as ONE batch: at device-drain rates the
            # per-event queue wakeups dominate this thread
            batch = [ev]
            batch.extend(w.drain())
            for bev in batch:
                brv = getattr(bev, "rv", 0) or 0
                if last_rv is None or brv > last_rv:
                    last_rv = brv
            ctxs = {}
            if resolve_many is not None:
                rvs = [r for r in (getattr(e, "rv", 0) or 0 for e in batch) if r]
                if rvs:
                    ctxs = resolve_many(rvs)
            if opt.predicate is None and _FAST is not None and not ctxs:
                # native fast path: update the cache mirror
                # in one pass and forward the store events
                # as-is (WatchEvent and InformerEvent are
                # duck-compatible: .type/.object; a remote
                # stream's events already carry .ctx).  A batch
                # with no traced writes — the bulk drain's shape —
                # stays on this path even with a tracer armed.
                if use_cache:
                    with getter._mut:
                        _FAST.cache_apply(getter._items, batch)
                events.extend(batch)
                continue
            out = []
            cache_ops = []
            for ev in batch:
                obj = ev.object
                meta = obj.get("metadata") or {}
                key = (
                    meta.get("namespace") or "",
                    meta.get("name") or "",
                )
                ctx = getattr(ev, "ctx", None)
                if ctx is None and ctxs:
                    ctx = ctxs.get(getattr(ev, "rv", 0) or 0)
                if opt.predicate is not None and not opt.predicate(obj):
                    # object left the predicate set: surface as
                    # a delete so controllers stop managing it
                    if use_cache:
                        if getter.get(key[1], key[0]):
                            cache_ops.append((DELETED, obj))
                            out.append(InformerEvent(DELETED, obj, ctx))
                    elif key in seen:
                        seen.discard(key)
                        out.append(InformerEvent(DELETED, obj, ctx))
                    continue
                if use_cache:
                    cache_ops.append((ev.type, obj))
                elif opt.predicate is not None:
                    if ev.type == DELETED:
                        seen.discard(key)
                    else:
                        seen.add(key)
                out.append(InformerEvent(ev.type, obj, ctx))
            if cache_ops:
                getter._apply_batch(cache_ops)
            events.extend(out)
        return last_rv

    def watch_with_cache(
        self, opt: WatchOptions, events: Queue, done: Optional[threading.Event] = None
    ) -> CacheGetter:
        return self.watch(opt, events, done=done, cache=CacheGetter())
