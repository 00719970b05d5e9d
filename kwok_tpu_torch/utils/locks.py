"""Runtime deadlock sentinel: named locks that learn the process-wide
acquisition order and fail loudly on an inversion.

The static half of the concurrency gate
(``kwok_tpu/analysis/lock_order.py``) derives the
may-hold-while-acquiring graph lexically; this is the dynamic
complement for the holds a lexical view cannot see — locks carried
across context-manager boundaries (``cluster/store.py`` ``_LaneGrant``
holds the store mutex from ``__enter__`` to ``__exit__``), receivers
too dynamic to type, and whatever the sharded-store refactor
(ROADMAP.md:53-82) wires up at runtime.  Modeled on what the reference
gets from ``go test -race`` in CI (PARITY.md:175): every chaos/DST run
doubles as a deadlock detector.

Usage: the shared-state lock sites (store, flowcontrol, election,
informer) create their mutexes through :func:`make_lock` /
:func:`make_rlock` instead of calling ``threading`` directly.  With
``KWOK_LOCK_SENTINEL`` unset the factories return the plain
``threading`` primitive — zero wrapping, zero overhead, byte-identical
behavior.  With ``KWOK_LOCK_SENTINEL=1`` they return instrumented
wrappers that record, per thread, which named lock classes were held
at each blocking acquire, merge those orders into one process-global
order graph, and raise :class:`LockInversion` at the acquire that
would close a cycle — BEFORE blocking on it, so the report fires
instead of the hang.

Determinism contract: the sentinel reads no clock and no RNG and emits
nothing into any trace, so DST runs produce byte-identical trace
digests sentinel-on vs sentinel-off (tests/test_locks.py pins this) —
which is what lets ``tools/check.sh`` keep its DST stage permanently
armed.

Lock identity is the NAME (the ``module.Class.attr`` lock class, same
granularity as the static analyzer), not the instance: holding
instance A of a class while acquiring instance B of the same class is
re-entrancy by name and records no edge, exactly like the static
rule's RLock self-edge exemption.

``KWOK_RACE_SENTINEL=1`` arms the second detector on the same
held-stack bookkeeping: an Eraser-style lockset checker.  The static
``guarded-by`` rule (kwok_tpu/analysis/guarded_by.py) proves lock
coverage lexically; :func:`guarded` is its runtime twin — a class
declares "this attribute is protected by that lock class" at
construction, and every subsequent get/set of the attribute is checked
against the accessing thread's held-set.  The per-attribute state
machine follows Eraser's ownership refinement: *fresh* (declared,
untouched) → *exclusive* (single owner thread — no lock required, so
single-threaded DST runs are violation-free by construction) →
*shared* (a second thread touched it — from then on EVERY access must
hold the declared lock or :class:`RaceWitness` fires with both access
sites).  Like the order sentinel it reads no clock and no RNG, so DST
trace digests stay byte-identical armed vs disarmed.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

__all__ = [
    "LockInversion",
    "RaceWitness",
    "guarded",
    "make_lock",
    "make_rlock",
    "make_condition",
    "sentinel_enabled",
    "race_sentinel_enabled",
    "reset_sentinel",
    "sentinel_order_graph",
]


class LockInversion(RuntimeError):
    """Two threads acquired the same lock classes in opposite orders.

    Raised in the acquiring thread before it blocks — the process gets
    a traceback naming both orders instead of a silent deadlock."""


class RaceWitness(RuntimeError):
    """A declared-guarded attribute was touched by multiple threads
    without the declared lock held.

    Raised in the accessing thread at the unguarded access — the
    report names the attribute, the missing lock class, this access
    site and the previous one, instead of silent corruption."""


def sentinel_enabled() -> bool:
    return os.environ.get("KWOK_LOCK_SENTINEL", "") == "1"


def race_sentinel_enabled() -> bool:
    return os.environ.get("KWOK_RACE_SENTINEL", "") == "1"


class _Registry:
    """Process-global acquisition-order graph.

    ``_edges[held][acquired]`` exists when some thread blocked on
    ``acquired`` while holding ``held``; the value is the first
    witness (thread name, held-stack snapshot).  A cycle can only
    appear at the instant its final edge is inserted, so the (locked)
    path check runs on NEW edges only — repeat acquisitions take the
    lock-free dict-hit fast path."""

    def __init__(self) -> None:
        self._mut = threading.Lock()
        self._edges: Dict[str, Dict[str, Tuple[str, Tuple[str, ...]]]] = {}
        self._local = threading.local()

    # ------------------------------------------------------- held stack

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    def push(self, name: str) -> None:
        self._stack().append(name)

    def pop(self, name: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                return
        # release of a lock this thread never tracked (cross-thread
        # release): nothing to unwind

    def holds(self, name: str) -> bool:
        """True when the CURRENT thread holds a lock of class ``name``
        (the race sentinel's lockset membership test)."""
        return name in self._stack()

    # ------------------------------------------------------ order graph

    def before_blocking_acquire(self, name: str) -> None:
        st = self._stack()
        if not st or name in st:
            # nothing held, or re-entrancy by name: no ordering fact
            return
        held = []
        seen = set()
        for h in st:
            if h not in seen:
                seen.add(h)
                held.append(h)
        snapshot = tuple(st)
        tname = threading.current_thread().name
        for h in held:
            bucket = self._edges.get(h)
            if bucket is not None and name in bucket:
                continue  # known-good order, lock-free fast path
            with self._mut:
                bucket = self._edges.setdefault(h, {})
                if name in bucket:
                    continue
                cycle = self._path(name, h)
                if cycle is not None:
                    # deliberately NOT recorded: if this raise is
                    # absorbed by a broad handler upstream, the next
                    # occurrence must miss the fast path and re-raise —
                    # otherwise retry number two blocks into the real
                    # deadlock with no diagnostic
                    raise LockInversion(
                        self._render(h, name, cycle, tname, snapshot)
                    )
                bucket[name] = (tname, snapshot)

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """Edge path src -> ... -> dst in the current graph, or None."""
        if src == dst:
            return [src]
        prev: Dict[str, str] = {}
        seen = {src}
        queue = [src]
        while queue:
            nxt: List[str] = []
            for n in queue:
                for m in self._edges.get(n, ()):
                    if m in seen:
                        continue
                    prev[m] = n
                    if m == dst:
                        path = [m]
                        while path[-1] != src:
                            path.append(prev[path[-1]])
                        return list(reversed(path))
                    seen.add(m)
                    nxt.append(m)
            queue = nxt
        return None

    def _render(self, held: str, acquiring: str, cycle: List[str],
                tname: str, snapshot: Tuple[str, ...]) -> str:
        lines = [
            f"lock order inversion: thread {tname!r} holds {held} "
            f"(stack: {' -> '.join(snapshot)}) and is acquiring {acquiring},",
            "but the opposite order is already established: "
            + " -> ".join(cycle),
        ]
        for a, b in zip(cycle, cycle[1:]):
            wt, wstack = self._edges[a][b]
            lines.append(
                f"  {a} -> {b} first seen in thread {wt!r} "
                f"(held: {' -> '.join(wstack) or '-'})"
            )
        lines.append(
            "one of these acquisition chains must reorder or narrow its hold"
        )
        return "\n".join(lines)

    def graph(self) -> Dict[str, Dict[str, Tuple[str, Tuple[str, ...]]]]:
        with self._mut:
            return {h: dict(b) for h, b in self._edges.items()}

    def reset(self) -> None:
        with self._mut:
            self._edges.clear()
        # per-thread held stacks intentionally survive: live holds are
        # still live; tests reset between scenarios on fresh threads


_registry = _Registry()


def sentinel_order_graph():
    """Snapshot of the learned order graph (diagnostics/tests)."""
    return _registry.graph()


def reset_sentinel() -> None:
    """Forget all learned edges (test isolation)."""
    _registry.reset()


class _SentinelLock:
    """Instrumented non-reentrant lock.  Held-stack bookkeeping always
    runs (both sentinels consume it); the order-graph check only when
    the lock sentinel proper is armed — a race-sentinel-only process
    wants locksets, not ordering edges."""

    _factory = staticmethod(threading.Lock)

    __slots__ = ("_name", "_inner", "_order")

    def __init__(self, name: str):
        self._name = name
        self._inner = self._factory()
        self._order = sentinel_enabled()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking and self._order:
            # raises LockInversion BEFORE blocking when this acquire
            # would close an order cycle
            _registry.before_blocking_acquire(self._name)
        # this IS the lock implementation: release pairs in release(),
        # driven by the caller's with/try-finally
        ok = self._inner.acquire(blocking, timeout)  # kwoklint: disable=lock-discipline
        if ok:
            _registry.push(self._name)
        return ok

    def release(self) -> None:
        self._inner.release()
        _registry.pop(self._name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        # the context-manager face of the wrapper — __exit__ releases
        self.acquire()  # kwoklint: disable=lock-discipline
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debug surface
        return f"<{type(self).__name__} {self._name} {self._inner!r}>"


class _SentinelRLock(_SentinelLock):
    """Instrumented re-entrant lock.  The ``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` trio keeps
    ``threading.Condition`` working on top of it (wait() fully
    releases the hold, and the held-stack follows suit so no false
    edges are recorded while waiting)."""

    _factory = staticmethod(threading.RLock)

    __slots__ = ()

    def _release_save(self):
        state = self._inner._release_save()
        _registry.pop(self._name)
        return state

    def _acquire_restore(self, state) -> None:
        self._inner._acquire_restore(state)
        _registry.push(self._name)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


def make_lock(name: str):
    """A ``threading.Lock`` — instrumented when either sentinel is
    armed (KWOK_LOCK_SENTINEL=1 / KWOK_RACE_SENTINEL=1).

    ``name`` is the lock class, conventionally the static analyzer's
    identity ``module.Class.attr`` without the ``kwok_tpu_torch.`` prefix."""
    if sentinel_enabled() or race_sentinel_enabled():
        return _SentinelLock(name)
    return threading.Lock()


def make_rlock(name: str):
    """A ``threading.RLock`` — instrumented when either sentinel is armed."""
    if sentinel_enabled() or race_sentinel_enabled():
        return _SentinelRLock(name)
    return threading.RLock()


def make_condition(name: str):
    """A ``threading.Condition`` whose inner RLock is instrumented
    when either sentinel is armed."""
    if sentinel_enabled() or race_sentinel_enabled():
        return threading.Condition(_SentinelRLock(name))
    return threading.Condition()


# --------------------------------------------------------------------------
# race sentinel: Eraser-style lockset checking on declared attributes


#: per-attribute ownership states (Eraser's refinement, minus the
#: read-shared stage: a control plane's guarded state is read/write)
_FRESH = 0       # declared, no access yet — next toucher owns it
_EXCLUSIVE = 1   # single owner thread; no lock needed
_SHARED = 2      # multiple threads have touched it; lock required


def _access_site() -> str:
    """``file:line (thread)`` of the code touching the guarded
    attribute: three frames up — site -> descriptor hook -> _check ->
    here."""
    fr = sys._getframe(3)
    return (
        f"{fr.f_code.co_filename}:{fr.f_lineno}"
        f" (thread {threading.current_thread().name!r})"
    )


class _GuardedAttr:
    """Data descriptor the race sentinel installs over a declared
    attribute.  Value storage delegates to the class's own slot
    descriptor when there is one, else shadows into the instance
    ``__dict__`` under a private key (a data descriptor wins the
    lookup, so plain attribute syntax keeps working).  Only instances
    explicitly registered via :func:`guarded` are checked — and only
    while KWOK_RACE_SENTINEL=1, so a class that once armed in-process
    stays behaviorally inert for later unarmed code."""

    __slots__ = ("_attr", "_lock_name", "_base", "_shadow", "_skey", "_states")

    def __init__(self, attr: str, lock_name: str, base):
        self._attr = attr
        self._lock_name = lock_name
        self._base = base  # slot member descriptor, or None (dict class)
        self._shadow = f"_kwok_guarded_value__{attr}"
        self._skey = f"_kwok_guarded_state__{attr}"
        #: id(obj) -> (obj, [state, owner_ident, last_site]) for
        #: SLOTTED owners (no instance dict to stash in).  The strong
        #: reference is deliberate: it pins registered ids so a dead
        #: instance's address can never resurface as a different
        #: registered object carrying stale SHARED state (the sentinel
        #: only runs in tests/DST, and adopted slotted objects are
        #: small and few).  Dict-based owners keep state in their own
        #: ``__dict__`` so it dies with them.
        self._states: Dict[int, tuple] = {}

    # ------------------------------------------------------------ state

    def _register(self, obj) -> None:
        st = [_FRESH, 0, "<declared>"]
        if self._base is None:
            obj.__dict__[self._skey] = st
        else:
            self._states[id(obj)] = (obj, st)

    def _state(self, obj):
        if self._base is None:
            return obj.__dict__.get(self._skey)
        ent = self._states.get(id(obj))
        if ent is None or ent[0] is not obj:
            return None  # unregistered instance (or pre-register init write)
        return ent[1]

    def _check(self, obj) -> None:
        if not race_sentinel_enabled():
            return
        st = self._state(obj)
        if st is None:
            return  # never declared on this instance
        ident = threading.get_ident()
        if st[0] == _FRESH:
            st[0] = _EXCLUSIVE
            st[1] = ident
            st[2] = _access_site()
            return
        if st[0] == _EXCLUSIVE and st[1] == ident:
            st[2] = _access_site()
            return
        # second thread arrived (or already shared): lockset check
        st[0] = _SHARED
        if not _registry.holds(self._lock_name):
            here = _access_site()
            raise RaceWitness(
                f"unguarded access to {type(obj).__name__}.{self._attr}: "
                f"declared guarded by {self._lock_name}, which this "
                "thread does not hold\n"
                f"  this access:     {here}\n"
                f"  previous access: {st[2]}\n"
                "hold the lock around the access, or drop the "
                "guarded() declaration if the attribute is deliberately "
                "lock-free (then suppress the static guarded-by rule "
                "with the invariant that makes that safe)"
            )
        st[2] = _access_site()

    # ------------------------------------------------------- descriptor

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self._check(obj)
        if self._base is not None:
            return self._base.__get__(obj, objtype)
        try:
            return obj.__dict__[self._shadow]
        except KeyError:
            raise AttributeError(
                f"{type(obj).__name__!r} object has no attribute "
                f"{self._attr!r}"
            ) from None

    def __set__(self, obj, value) -> None:
        self._check(obj)
        if self._base is not None:
            self._base.__set__(obj, value)
        else:
            obj.__dict__[self._shadow] = value

    def __delete__(self, obj) -> None:
        self._check(obj)
        if self._base is not None:
            self._base.__delete__(obj)
        else:
            try:
                del obj.__dict__[self._shadow]
            except KeyError:
                raise AttributeError(
                    f"{type(obj).__name__!r} object has no attribute "
                    f"{self._attr!r}"
                ) from None


_guard_install_mut = threading.Lock()


def guarded(obj, attr: str, lock_name: str) -> None:
    """Declare that ``obj.<attr>`` is protected by lock class
    ``lock_name`` (the ``module.Class.attr`` identity the lock was
    created under).  No-op unless KWOK_RACE_SENTINEL=1.

    Call it from ``__init__`` right after the attribute first exists —
    the adopted sites (store/flowcontrol/election/fleet) pair each
    declaration with the matching static-rule contract, so the lexical
    ``guarded-by`` analyzer and this runtime checker enforce the same
    invariant from two sides.  Once any thread other than the owner
    touches the attribute, every access without the declared lock held
    raises :class:`RaceWitness` naming both access sites."""
    if not race_sentinel_enabled():
        return
    cls = type(obj)
    with _guard_install_mut:
        cur = cls.__dict__.get(attr)
        if isinstance(cur, _GuardedAttr):
            desc = cur
        else:
            base = cur if hasattr(cur, "__set__") else None
            desc = _GuardedAttr(attr, lock_name, base)
            if base is None and attr in getattr(obj, "__dict__", {}):
                # instance predates the descriptor: its value sits in
                # the instance dict, which the data descriptor would
                # mask — migrate it to the shadow slot
                obj.__dict__[desc._shadow] = obj.__dict__.pop(attr)
            setattr(cls, attr, desc)
        desc._register(obj)
