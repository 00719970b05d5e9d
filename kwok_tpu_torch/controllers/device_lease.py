"""Device lease lanes: lease renewals ride the node player's tick.

The reference renews each node's Lease from N host workers popping a
delay queue (reference node_lease_controller.go:108-143 under
pkg/kwok/controllers/, renew = duration/4 + 4% one-sided jitter,
controller.go:245-249).  At 10k nodes that is a steady stream of single-object
round-trips.  Here the cadence lives ON DEVICE as a fire-time column
(`ops/tick.py::LeaseLane`) ticked in the node player's step: every
lease due in a tick drains as one batch through
``NodeLeaseController.renew_batch`` (one ``store.bulk`` round-trip),
and per-renewal lag feeds the p99 heartbeat-lag metric (SURVEY §7
step 5; BASELINE.json).

Division of labor: the host :class:`NodeLeaseController` keeps
*ownership* — acquisition, takeover-on-expiry, multi-instance
arbitration (its ``_sync`` path) — and hands a node to the lane only
once held; any write-back failure hands the node straight back to the
host path to re-acquire.  Host-only operation remains the fallback for
the host backend.

Port of ``kwok_tpu/controllers/device_lease.py``: the lane is a
:class:`~kwok_tpu_torch.ops.tick.LeaseLane` of torch tensors on
``device`` (the card unless the caller names one), ticked by the port's
``lease_tick`` (``csrc/lease.cu`` on the card); ``due``, ``lag`` and the
rescheduled fire times come to the host with ``.cpu()``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from kwok_tpu_torch.engine.compiler import NEVER
from kwok_tpu_torch.ops.device import resolve_device
from kwok_tpu_torch.ops.prng import prng_key
from kwok_tpu_torch.ops.tick import LeaseLane, lease_tick

__all__ = ["DeviceLeaseLane"]


class DeviceLeaseLane:
    """Vectorized renewal timers for the leases this instance holds."""

    def __init__(self, lease_ctrl, capacity: int = 1024, seed: int = 0, device=None):
        self.ctrl = lease_ctrl
        #: torch device of the lane: the card unless the caller names one
        self.device = resolve_device(device)
        self.renew_ms = max(1, int(lease_ctrl.renew_interval * 1000))
        self.jitter_ms = int(self.renew_ms * lease_ctrl.renew_jitter)
        cap = max(16, capacity)
        self._fire_np = np.full(cap, NEVER, np.int32)
        self._names: List[Optional[str]] = [None] * cap
        self._slots: Dict[str, int] = {}
        self._free: List[int] = list(range(cap - 1, -1, -1))
        self._key = prng_key(seed, self.device)
        self._lane: Optional[LeaseLane] = None  # device copy; None = dirty
        self._mut = threading.Lock()
        self._last_now = 0
        #: subtracted from incoming tick times (int32 wrap guard)
        self._base = 0
        #: recent per-renewal lag samples (seconds past the scheduled
        #: fire time, virtual clock) — p99 surfaces in self-metrics
        self.renew_lags = deque(maxlen=4096)
        self.renew_count = 0

    # ------------------------------------------------------------- membership

    def register(self, name: str) -> None:
        """Start renewing this node's lease on the lane (called by the
        lease controller once it holds the lease — which also just
        renewed it, so the first lane renewal is one interval out)."""
        with self._mut:
            if name in self._slots:
                return
            if not self._free:
                self._grow()
            slot = self._free.pop()
            self._slots[name] = slot
            self._names[slot] = name
            self._fire_np[slot] = self._last_now + self.renew_ms
            self._lane = None

    def unregister(self, name: str) -> None:
        with self._mut:
            slot = self._slots.pop(name, None)
            if slot is None:
                return
            self._names[slot] = None
            self._fire_np[slot] = NEVER
            self._free.append(slot)
            self._lane = None

    def _grow(self) -> None:
        old = len(self._fire_np)
        new = old * 2
        fire = np.full(new, NEVER, np.int32)
        fire[:old] = self._fire_np
        self._fire_np = fire
        self._names.extend([None] * (new - old))
        self._free.extend(range(new - 1, old - 1, -1))

    def __len__(self) -> int:
        with self._mut:
            return len(self._slots)

    # ------------------------------------------------------------------- tick

    def tick(self, now_ms: int) -> int:
        """Advance the lane to the node player's virtual now; renew all
        due leases in one batch.  Returns the number renewed."""
        with self._mut:
            now_ms -= self._base
            if now_ms >= 2**30:
                # int32 guard (same rebase idea as the simulator clock):
                # the caller's wall anchor only resets on restart, so
                # shift fire times down before arithmetic can wrap
                self._base += now_ms
                live = self._fire_np != NEVER
                self._fire_np[live] = np.maximum(self._fire_np[live] - now_ms, 0)
                self._lane = None  # device copy rebuilt from the mirror
                now_ms = 0
            self._last_now = now_ms
            if not self._slots:
                return 0
            if self._lane is None:
                self._lane = LeaseLane(
                    fire_at=torch.from_numpy(self._fire_np.copy()).to(self.device),
                    key=self._key,
                )
            lane, due, lag = lease_tick(
                self._lane, now_ms, self.renew_ms, self.jitter_ms
            )
            self._lane = lane
            self._key = lane.key
            due_np = due.cpu().numpy()
            if not due_np.any():
                return 0
            # pull the rescheduled times into the host mirror so a later
            # membership change re-uploads current state
            self._fire_np = lane.fire_at.cpu().numpy().copy()
            lag_np = lag.cpu().numpy()
            names = []
            for slot in np.nonzero(due_np)[0]:
                name = self._names[slot]
                if name is None:
                    continue
                names.append(name)
                self.renew_lags.append(float(lag_np[slot]) / 1000.0)
        if not names:
            return 0
        failed = self.ctrl.renew_batch(names)
        with self._mut:
            self.renew_count += len(names) - len(failed)
        for name in failed:
            # lease vanished or was taken: hand back to the host
            # acquisition path (it re-registers on success)
            self.unregister(name)
            self.ctrl.reacquire(name)
        return len(names) - len(failed)
