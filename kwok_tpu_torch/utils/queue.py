"""Thread-safe FIFO / weighted / delaying queues.

Semantics mirror the reference scheduling structures
(reference: pkg/utils/queue/{queue,weight_queue,delaying_queue,
weight_delaying_queue}.go):

- ``Queue``: FIFO with blocking get (queue.go:25-113).
- ``WeightQueue``: weight 0 is the main (highest-priority) queue;
  weights 1..n live in buckets that are drained into the main queue on
  demand, ``weight`` items per step, highest numeric weight first
  (weight_queue.go:84-110).
- ``DelayingQueue``: heap of (deadline, item) + a timer worker that
  promotes due items (delaying_queue.go:59-125).
- ``WeightDelayingQueue`` — the controllers' scheduling structure:
  ``add_weight_after(item, weight, delay)``; due items promote into
  the weight buckets; ``cancel`` removes not-yet-due items
  (weight_delaying_queue.go:29-163).

These back the *host* (slow/fallback) stage path and the lease
controller; the device path replaces them with the fire_at column in
the tick kernel (SURVEY.md §2.9).
"""

from __future__ import annotations

import heapq
import itertools
import threading
from collections import deque
from typing import Dict, Generic, List, Optional, Tuple, TypeVar

from kwok_tpu_torch.utils.clock import Clock, RealClock

T = TypeVar("T")


class Queue(Generic[T]):
    """FIFO queue with blocking get."""

    def __init__(self):
        self._items: deque = deque()
        self._mut = threading.Lock()
        self._signal = threading.Event()

    def add(self, item: T) -> None:
        with self._mut:
            self._items.append(item)
        self._signal.set()

    def extend(self, items) -> None:
        """Enqueue many items with one lock hold and one wakeup (the
        informer's batched event delivery)."""
        if not items:
            return
        with self._mut:
            self._items.extend(items)
        self._signal.set()

    def get(self) -> Tuple[Optional[T], bool]:
        with self._mut:
            if self._items:
                return self._items.popleft(), True
        return None, False

    def drain(self) -> List[T]:
        """Pop everything queued under one lock hold."""
        with self._mut:
            if not self._items:
                return []
            items = list(self._items)
            self._items.clear()
        return items

    def remove(self, item: T) -> bool:
        """Remove a not-yet-consumed item from the FIFO."""
        with self._mut:
            try:
                self._items.remove(item)
                return True
            except ValueError:
                return False

    def get_or_wait(self, timeout: Optional[float] = None, done: Optional[threading.Event] = None) -> Tuple[Optional[T], bool]:
        """Block until an item is available, ``done`` is set, or timeout."""
        while True:
            item, ok = self.get()
            if ok:
                return item, True
            if done is not None and done.is_set():
                return None, False
            self._signal.clear()
            # re-check after clear to avoid a lost wakeup
            item, ok = self.get()
            if ok:
                return item, True
            if not self._signal.wait(timeout if timeout is not None else 0.5):
                if timeout is not None:
                    return None, False

    def __len__(self) -> int:
        with self._mut:
            return len(self._items)


class WeightQueue(Queue[T]):
    """Weight-bucketed queue (weight_queue.go).

    Weight 0 goes straight to the main FIFO (highest priority); weights
    1..n are drained ``weight`` items at a time, highest weight first.
    """

    def __init__(self):
        super().__init__()
        self._buckets: Dict[int, deque] = {}

    def add_weight(self, item: T, weight: int) -> None:
        if weight <= 0:
            self.add(item)
            return
        with self._mut:
            self._buckets.setdefault(weight, deque()).append(item)
        self._signal.set()

    def remove(self, item: T) -> bool:
        """Remove from the main FIFO or any weight bucket."""
        with self._mut:
            try:
                self._items.remove(item)
                return True
            except ValueError:
                pass
            for bucket in self._buckets.values():
                try:
                    bucket.remove(item)
                    return True
                except ValueError:
                    continue
        return False

    def _step(self) -> bool:
        """Drain buckets into the main queue; returns True if anything moved."""
        added = False
        for weight in sorted(self._buckets, reverse=True):
            bucket = self._buckets[weight]
            for _ in range(weight):
                if not bucket:
                    break
                self._items.append(bucket.popleft())
                added = True
        return added

    def get(self) -> Tuple[Optional[T], bool]:
        with self._mut:
            if self._items:
                return self._items.popleft(), True
            if self._step():
                return self._items.popleft(), True
        return None, False

    def __len__(self) -> int:
        with self._mut:
            return len(self._items) + sum(len(b) for b in self._buckets.values())


class _Heap(Generic[T]):
    """Deadline heap keyed by (deadline, insertion-seq). ``remove`` is an
    O(n) scan + heapify — cancels are rare (reference heap.Heap pays the
    same), the hot path is push/peek/pop."""

    def __init__(self):
        self._heap: List[Tuple[float, int, T]] = []

    def push(self, deadline: float, item: T) -> None:
        heapq.heappush(self._heap, (deadline, next(_seq), item))

    def peek(self) -> Tuple[float, Optional[T], bool]:
        if not self._heap:
            return 0.0, None, False
        deadline, _, item = self._heap[0]
        return deadline, item, True

    def pop(self) -> Tuple[float, Optional[T], bool]:
        if not self._heap:
            return 0.0, None, False
        deadline, _, item = heapq.heappop(self._heap)
        return deadline, item, True

    def remove(self, item: T) -> bool:
        for i, (_, _, it) in enumerate(self._heap):
            if it == item:
                self._heap[i] = self._heap[-1]
                self._heap.pop()
                heapq.heapify(self._heap)
                return True
        return False

    def __len__(self) -> int:
        return len(self._heap)


_seq = itertools.count()


class DelayingQueue(Queue[T]):
    """FIFO + add_after(item, delay_seconds) via a timer worker."""

    def __init__(self, clock: Optional[Clock] = None):
        super().__init__()
        self._clock = clock or RealClock()
        self._heap: _Heap[T] = _Heap()
        self._hmut = threading.Lock()
        self._hsignal = threading.Event()
        self._clock.subscribe(self._hsignal)
        self._stopped = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def add_after(self, item: T, delay: float) -> None:
        if delay <= 0:
            self._promote(item, 0)
            return
        deadline = self._clock.now() + delay
        with self._hmut:
            self._heap.push(deadline, item)
        self._hsignal.set()

    def cancel(self, item: T) -> bool:
        """Remove an item whether still delayed or already promoted."""
        with self._hmut:
            removed = self._heap.remove(item)
        return self.remove(item) or removed

    def _promote(self, item: T, weight: int) -> None:
        self.add(item)

    def _next(self) -> Tuple[Optional[T], int, bool, Optional[float]]:
        now = self._clock.now()
        with self._hmut:
            deadline, item, ok = self._heap.peek()
            if not ok:
                return None, 0, False, None
            if deadline <= now:
                self._heap.pop()
                return item, 0, True, None
            return None, 0, False, deadline - now

    def _loop(self) -> None:
        while not self._stopped:
            item, weight, ok, wait = self._next()
            if ok:
                self._promote(item, weight)
                continue
            delay = 10.0 if wait is None else min(wait, 10.0)
            self._clock.wait_signal(self._hsignal, delay)
            self._hsignal.clear()

    def stop(self) -> None:
        self._stopped = True
        self._hsignal.set()


def new_weight_delaying_queue(clock: Optional[Clock] = None) -> "WeightDelayingQueue":
    """Preferred constructor: the C++-backed queue when the native
    library is available (KWOK_TPU_NATIVE=0 forces pure Python), else
    the pure-Python implementation. Both present the same surface."""
    import os

    if os.environ.get("KWOK_TPU_NATIVE", "1") != "0":
        try:
            from kwok_tpu_torch.native.queue import (
                NativeWeightDelayingQueue,
                native_available,
            )

            if native_available():
                return NativeWeightDelayingQueue(clock)  # type: ignore[return-value]
        except Exception:  # noqa: BLE001 — toolchain missing: fall back
            pass
    return WeightDelayingQueue(clock)


class WeightDelayingQueue(WeightQueue[T]):
    """add_weight_after: the controllers' retry/delay scheduler.

    Items become due on their deadline and enter the weight bucket they
    were scheduled with (weight 0 = fresh work, served before retries at
    weight 1 — reference pod_controller.go:660-671).

    Not built on DelayingQueue: the WeightQueue/DelayingQueue diamond
    would let cooperative ``super().__init__`` start the timer worker
    before this class's state exists. Owns its own heaps + worker.
    """

    def __init__(self, clock: Optional[Clock] = None):
        super().__init__()
        self._clock = clock or RealClock()
        self._heap: _Heap[T] = _Heap()
        self._wheaps: Dict[int, _Heap[T]] = {}
        self._hmut = threading.Lock()
        self._hsignal = threading.Event()
        self._clock.subscribe(self._hsignal)
        self._stopped = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _loop(self) -> None:
        while not self._stopped:
            item, weight, ok, wait = self._next()
            if ok:
                self.add_weight(item, weight)
                continue
            delay = 10.0 if wait is None else min(wait, 10.0)
            self._clock.wait_signal(self._hsignal, delay)
            self._hsignal.clear()

    def stop(self) -> None:
        self._stopped = True
        self._hsignal.set()

    def add_weight_after(self, item: T, weight: int, delay: float) -> None:
        if delay <= 0:
            self.add_weight(item, weight)
            return
        deadline = self._clock.now() + delay
        with self._hmut:
            if weight <= 0:
                self._heap.push(deadline, item)
            else:
                self._wheaps.setdefault(weight, _Heap()).push(deadline, item)
        self._hsignal.set()

    def add_after(self, item: T, delay: float) -> None:
        self.add_weight_after(item, 0, delay)

    def cancel(self, item: T) -> bool:
        """Remove an item whether still delayed or already promoted."""
        with self._hmut:
            removed = self._heap.remove(item)
            for h in self._wheaps.values():
                if h.remove(item):
                    removed = True
        return self.remove(item) or removed

    def _next(self) -> Tuple[Optional[T], int, bool, Optional[float]]:
        now = self._clock.now()
        wait: Optional[float] = None
        with self._hmut:
            deadline, item, ok = self._heap.peek()
            if ok:
                if deadline <= now:
                    self._heap.pop()
                    return item, 0, True, None
                wait = deadline - now
            for weight in sorted(self._wheaps, reverse=True):
                h = self._wheaps[weight]
                deadline, item, ok = h.peek()
                if not ok:
                    continue
                if deadline <= now:
                    h.pop()
                    return item, weight, True, None
                if wait is None or deadline - now < wait:
                    wait = deadline - now
        return None, 0, False, wait
