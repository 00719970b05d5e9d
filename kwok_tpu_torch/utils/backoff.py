"""Capped exponential backoff with jitter — the one retry schedule
shared by stage retries, the REST client's RetryPolicy, and the
component supervisor (reference pkg/kwok/controllers/utils.go:133-143
defaultBackoff/backoffDelayByStep: 1s × 2ⁿ, jitter 0.2, cap 32 min).

Lives in ``utils`` (layer 0) so both ``cluster`` and ``controllers``
can share it without a layering edge; ``controllers.utils`` re-exports
for its historical importers.

The jitter source is an *explicit* ``random.Random``: there is
deliberately no fallback to the global ``random`` module, so retry
schedules are reproducible under a chaos seed and tracer-safe by
construction (kwoklint's tracer-safety rule bans stdlib randomness in
jitted code; an explicit instance can never leak in ambiently).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Hashable, Tuple


@dataclass
class Backoff:
    """``delay(steps, rng)`` = ``min(duration·factorˢᵗᵉᵖˢ, cap)``
    stretched by up to ``jitter`` of itself."""

    duration: float = 1.0
    factor: float = 2.0
    jitter: float = 0.2
    cap: float = 32 * 60.0

    def delay(self, steps: int, rng: random.Random) -> float:
        d = min(self.duration * (self.factor**steps), self.cap)
        return d * (1.0 + self.jitter * rng.random())


@dataclass
class WarnGate:
    """Per-key deduplicated warning cadence: first emission immediate,
    then the interval doubles per emission up to ``cap_s`` — the
    event-flood guard shared by the scheduler's per-pod
    ``FailedScheduling`` stream and the gang engine's per-gang one.

    ``ready(key, now)`` is True when a warning may be emitted for
    ``key`` (and advances the schedule); ``clear(key)`` forgets the
    key once its condition resolves.  Clock-free and rng-free — the
    caller passes ``now`` from its injected clock, so gated event
    streams stay DST-deterministic.  Not thread-safe: multi-threaded
    callers hold their own lock around ``ready``."""

    base_s: float = 2.0
    cap_s: float = 60.0

    def __post_init__(self) -> None:
        self._next: Dict[Hashable, Tuple[float, float]] = {}

    def ready(self, key: Hashable, now: float) -> bool:
        next_t, interval = self._next.get(key, (0.0, self.base_s))
        if now < next_t:
            return False
        self._next[key] = (now + interval, min(interval * 2.0, self.cap_s))
        return True

    def clear(self, key: Hashable) -> None:
        self._next.pop(key, None)

    def __len__(self) -> int:
        """Keys with live cadence state (0 = nothing pending)."""
        return len(self._next)


__all__ = ["Backoff", "WarnGate"]
