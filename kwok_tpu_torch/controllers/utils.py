"""Controller support: IP pools, retry backoff, stage jobs.

(reference: pkg/kwok/controllers/utils.go:40-160)
"""

from __future__ import annotations

import ipaddress
import threading
from dataclasses import dataclass, field
from typing import Optional, Set

from kwok_tpu_torch.engine.lifecycle import CompiledStage

# canonical implementation moved to utils (layer 0) so cluster/client's
# RetryPolicy shares the same schedule; re-exported here because
# controller code historically imports it from this module
from kwok_tpu_torch.utils.backoff import Backoff  # noqa: F401


class IPPool:
    """Sequential allocator over a CIDR with recycle
    (reference utils.go:48-114 ipPool)."""

    def __init__(self, cidr: str):
        iface = ipaddress.ip_interface(cidr)
        self._net = iface.network
        # allocate from the CIDR's host address + 1: skips the network
        # address and the conventional node IP (e.g. 10.0.0.1/24 -> pods
        # start at 10.0.0.2, never colliding with hostIP)
        self._base = iface.ip
        self._mut = threading.Lock()
        self._used: Set[str] = set()
        self._usable: Set[str] = set()
        self._index = 1

    def _new(self) -> str:
        while True:
            ip = str(self._base + self._index)
            self._index += 1
            if ip in self._used:
                continue
            self._used.add(ip)
            return ip

    def get(self) -> str:
        with self._mut:
            if self._usable:
                ip = next(iter(self._usable))
                self._usable.discard(ip)
            else:
                ip = self._new()
            self._used.add(ip)
            return ip

    def put(self, ip: str) -> None:
        """Recycle an IP allocated from THIS pool. Callers record the
        owning pool at allocation time (PodEnv), so no membership check
        — an over-capacity allocation past the CIDR end (the pool never
        deadlocks) is recycled like any other."""
        with self._mut:
            self._used.discard(ip)
            self._usable.add(ip)

    def use(self, ip: str) -> None:
        with self._mut:
            try:
                if ipaddress.ip_address(ip) not in self._net:
                    return
            except ValueError:
                return
            self._used.add(ip)


@dataclass
class StageJob:
    """One queued transition (reference utils.go:123-130
    resourceStageJob[T])."""

    resource: dict
    stage: CompiledStage
    key: str
    retry_count: int = 0
    #: causing write's span context (watch-boundary stitch) — the play
    #: span continues/links it so one trace follows the object through
    #: every stage transition
    ctx: object = None

    # jobs are queue items; identity (not value) equality lets the queue
    # cancel a superseded job by reference
    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


def should_retry(err: Exception) -> bool:
    """Retry only connection/timeout-ish failures (utils.go:146-160).
    The in-process store can only fail transiently on Conflict; the
    REST client surfaces exhausted transport retries as the typed
    ApiUnavailable, which is transient by definition (the stage retry
    backoff then spaces out the next attempt)."""
    from kwok_tpu_torch.cluster.client import ApiUnavailable
    from kwok_tpu_torch.cluster.store import Conflict

    return isinstance(err, (ConnectionError, TimeoutError, Conflict, ApiUnavailable))
