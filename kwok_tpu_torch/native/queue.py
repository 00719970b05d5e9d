"""WeightDelayingQueue on the C++ delay heap.

Same surface and scheduling semantics as the pure-Python
:class:`kwok_tpu_torch.utils.queue.WeightDelayingQueue` (itself mirroring
reference weight_delaying_queue.go:29-163): ``add_weight_after``
schedules, due items promote into weight buckets (lower weight served
first), ``cancel`` removes pending items.  The deadline bookkeeping —
the O(log n) hot path at 100k+ in-flight timers — lives in native code;
Python only keeps the id↔item table and the blocking FIFO face.

Cancellation matches the controllers' usage pattern (one scheduled
entry per object key, cancelled by the same item instance — reference
delayQueueMapping, pod_controller.go:205-214): cancel removes every
pending entry scheduled for an item that compares equal (hashable
items) or identical (unhashable).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple, TypeVar

from kwok_tpu_torch.native import NativeDelayHeap, available
from kwok_tpu_torch.utils.clock import Clock, RealClock
from kwok_tpu_torch.utils.queue import WeightQueue

T = TypeVar("T")

__all__ = ["NativeWeightDelayingQueue", "native_available"]


def native_available() -> bool:
    return available()


def _key(item) -> object:
    try:
        hash(item)
        return item
    except TypeError:
        return id(item)


class NativeWeightDelayingQueue(WeightQueue[T]):
    """Drop-in WeightDelayingQueue backed by the C++ heap."""

    def __init__(self, clock: Optional[Clock] = None):
        super().__init__()
        self._clock = clock or RealClock()
        self._heap = NativeDelayHeap()
        self._entries: Dict[int, Tuple[T, int]] = {}  # id -> (item, weight)
        self._ids_by_item: Dict[object, List[int]] = {}
        self._next_id = 0
        self._hmut = threading.Lock()
        self._hsignal = threading.Event()
        self._clock.subscribe(self._hsignal)
        self._stopped = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # ----------------------------------------------------------- scheduling

    def add_weight_after(self, item: T, weight: int, delay: float) -> None:
        if delay <= 0:
            self.add_weight(item, weight)
            return
        deadline = self._clock.now() + delay
        with self._hmut:
            self._next_id += 1
            eid = self._next_id
            self._entries[eid] = (item, weight)
            self._ids_by_item.setdefault(_key(item), []).append(eid)
            self._heap.add(eid, weight, deadline)
        self._hsignal.set()

    def add_after(self, item: T, delay: float) -> None:
        self.add_weight_after(item, 0, delay)

    def cancel(self, item: T) -> bool:
        with self._hmut:
            removed = False
            for eid in self._ids_by_item.pop(_key(item), []):
                if self._entries.pop(eid, None) is not None:
                    self._heap.cancel(eid)
                    removed = True
        return self.remove(item) or removed

    # --------------------------------------------------------------- worker

    def _drop_entry(self, eid: int) -> Optional[Tuple[T, int]]:
        entry = self._entries.pop(eid, None)
        if entry is None:
            return None
        key = _key(entry[0])
        ids = self._ids_by_item.get(key)
        if ids is not None:
            try:
                ids.remove(eid)
            except ValueError:
                pass
            if not ids:
                del self._ids_by_item[key]
        return entry

    def _loop(self) -> None:
        while not self._stopped:
            now = self._clock.now()
            promoted: List[Tuple[T, int]] = []
            with self._hmut:
                self._heap.promote(now)
                for eid in self._heap.pop_ready():
                    entry = self._drop_entry(eid)
                    if entry is not None:
                        promoted.append(entry)
                nxt = self._heap.next_deadline()
            for item, weight in promoted:
                self.add_weight(item, weight)
            if promoted:
                continue
            wait = 10.0 if nxt is None else min(max(nxt - now, 0.0), 10.0)
            self._clock.wait_signal(self._hsignal, wait)
            self._hsignal.clear()

    def stop(self) -> None:
        self._stopped = True
        self._hsignal.set()

    # __len__ deliberately inherits WeightQueue's (promoted items only,
    # excluding not-yet-due delayed entries) to match the pure-Python
    # WeightDelayingQueue exactly; pending_count exposes the rest.

    @property
    def pending_count(self) -> int:
        """Scheduled-but-not-yet-due entries (native heap residents)."""
        with self._hmut:
            return len(self._entries)
