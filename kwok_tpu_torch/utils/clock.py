"""Clock abstraction: real and fake (virtual) time.

The reference injects ``clock.Clock`` everywhere for testability
(reference: pkg/kwok/controllers/controller.go:102, queue Clock iface
pkg/utils/queue/delaying_queue.go:27-31). Here the same seam also
carries the record/replay speed scaling (reference: pkg/kwokctl/
recording/speed.go:24-62): a ``ScaledClock`` over the real clock plays
time faster/slower, and ``FakeClock`` drives deterministic tests and
the device tick's virtual-time column.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import List, Optional


def wall_age(rfc3339: Optional[str]) -> Optional[float]:
    """Seconds elapsed since an RFC3339 wall-clock timestamp (the
    Lease ``renewTime`` display format written by
    ``cluster.election`` / ``controllers.node_lease_controller``),
    clamped at 0; None for absent/unparseable values.  Display-only —
    lease *expiry* decisions use locally-observed monotonic time, never
    this (see MonotonicClock)."""
    if not rfc3339:
        return None
    import datetime

    try:
        t = datetime.datetime.fromisoformat(
            str(rfc3339).replace("Z", "+00:00")
        )
    except ValueError:
        return None
    if t.tzinfo is None:
        t = t.replace(tzinfo=datetime.timezone.utc)
    now = datetime.datetime.now(datetime.timezone.utc)
    return max(0.0, (now - t).total_seconds())


class Clock:
    """Monotonic-ish wall clock in float seconds."""

    def now(self) -> float:
        raise NotImplementedError

    def wait_signal(self, signal: threading.Event, timeout: Optional[float]) -> None:
        """Block until ``signal`` is set or ``timeout`` *clock* seconds
        elapse (the Go ``select { <-After(d); <-signal }``)."""
        raise NotImplementedError

    def subscribe(self, signal: threading.Event) -> None:
        """Register a signal to be pinged when virtual time advances
        (no-op for real clocks)."""


class RealClock(Clock):
    def now(self) -> float:
        return time.time()

    def wait_signal(self, signal: threading.Event, timeout: Optional[float]) -> None:
        signal.wait(timeout)

    def subscribe(self, signal: threading.Event) -> None:
        pass


class MonotonicClock(Clock):
    """``time.monotonic``-based clock for deadline/lease arithmetic.

    Leader-election and lease-expiry math must be immune to wall-clock
    skew (NTP steps, suspend/resume): client-go measures lease expiry
    from a *locally observed* monotonic timestamp, never from the
    renewTime written in the record (leaderelection.go:61-73 "is
    susceptible to clock skew" caveat).  The kwoklint
    ``wallclock-deadline`` rule points offenders here."""

    def now(self) -> float:
        return time.monotonic()

    def wait_signal(self, signal: threading.Event, timeout: Optional[float]) -> None:
        signal.wait(timeout)

    def subscribe(self, signal: threading.Event) -> None:
        pass


class ScaledClock(Clock):
    """Real time scaled by a live-adjustable factor (replay speed).

    ``now`` advances at ``speed`` × real rate from the moment the speed
    was last changed; ``speed=0`` pauses (reference: recording/handle.go
    pause/speed keyboard control).
    """

    def __init__(self, speed: float = 1.0, base: Optional[Clock] = None):
        self._base = base or RealClock()
        self._speed = speed
        self._origin_real = self._base.now()
        self._origin_virtual = 0.0
        self._mut = threading.Lock()

    @property
    def speed(self) -> float:
        with self._mut:
            return self._speed

    def set_speed(self, speed: float) -> None:
        with self._mut:
            now = self._now_locked()
            self._origin_virtual = now
            self._origin_real = self._base.now()
            self._speed = max(0.0, speed)

    def _now_locked(self) -> float:
        return self._origin_virtual + (self._base.now() - self._origin_real) * self._speed

    def now(self) -> float:
        with self._mut:
            return self._now_locked()

    def wait_signal(self, signal: threading.Event, timeout: Optional[float]) -> None:
        if timeout is None:
            signal.wait(None)
            return
        with self._mut:
            speed = self._speed
        # virtual timeout -> real timeout; when paused, poll slowly
        real = timeout / speed if speed > 0 else 0.5
        signal.wait(min(real, 10.0))

    def subscribe(self, signal: threading.Event) -> None:
        pass


class FakeClock(Clock):
    """Manually advanced virtual clock for deterministic tests."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self._mut = threading.Lock()
        self._subscribers: List[threading.Event] = []

    def now(self) -> float:
        with self._mut:
            return self._now

    def subscribe(self, signal: threading.Event) -> None:
        with self._mut:
            self._subscribers.append(signal)

    def advance(self, dt: float) -> None:
        with self._mut:
            self._now += dt
            subs = list(self._subscribers)
        for s in subs:
            s.set()

    def set(self, t: float) -> None:
        with self._mut:
            self._now = max(self._now, t)
            subs = list(self._subscribers)
        for s in subs:
            s.set()

    def wait_signal(self, signal: threading.Event, timeout: Optional[float]) -> None:
        # Virtual timeouts only elapse via advance(); advance pings all
        # subscribed signals, so just wait on the signal (bounded so a
        # missing advance in a test cannot hang forever).
        signal.wait(5.0)


class VirtualClock(FakeClock):
    """Deterministic-simulation clock (the DST harness,
    :mod:`kwok_tpu_torch.dst`): FakeClock plus a registry of parked timeout
    deadlines, so the simulation scheduler can see the earliest instant
    any waiter is due to wake (:meth:`next_deadline`) and advance
    virtual time exactly there.  Time moves only when the simulation
    steps — a thread parked in :meth:`wait_signal` wakes when its
    signal fires or its *virtual* deadline passes, never because wall
    time elapsed.

    ``poll_s`` bounds the real-time wait per wakeup check: ``advance``
    pings every subscribed signal, and an un-advanced clock must never
    hang a waiter forever (the FakeClock posture, kept here).
    """

    def __init__(self, start: float = 0.0, poll_s: float = 0.02):
        super().__init__(start)
        self.poll_s = poll_s
        #: min-heap of virtual instants some waiter is due to wake at
        self._deadlines: List[float] = []

    #: real-seconds bound on one wait: a clock nobody advances anymore
    #: must not hang a waiter forever (the FakeClock 5s posture)
    REAL_WAIT_CAP_S = 5.0

    def wait_signal(self, signal: threading.Event, timeout: Optional[float]) -> None:
        if timeout is None:
            # no virtual deadline to honor: wake on advance() pings
            signal.wait(self.poll_s)
            return
        with self._mut:
            deadline = self._now + timeout
            heapq.heappush(self._deadlines, deadline)
        give_up = time.monotonic() + self.REAL_WAIT_CAP_S
        while (
            not signal.is_set()
            and self.now() < deadline
            and time.monotonic() < give_up
        ):
            signal.wait(self.poll_s)

    def next_deadline(self) -> Optional[float]:
        """Earliest still-pending parked deadline, or None.  Deadlines
        at/below the current instant are expired and dropped."""
        with self._mut:
            while self._deadlines and self._deadlines[0] <= self._now:
                heapq.heappop(self._deadlines)
            return self._deadlines[0] if self._deadlines else None

    def advance_to_next(self, limit: Optional[float] = None) -> bool:
        """Advance to the earliest parked deadline (bounded by
        ``limit``); returns False when there is none (or it lies past
        the limit).  The step-the-world primitive for tests migrating
        off wall-clock sleeps."""
        nxt = self.next_deadline()
        if nxt is None or (limit is not None and nxt > limit):
            return False
        self.set(nxt)
        return True
