"""NodeLeaseController: simulated kubelet heartbeat + multi-instance
node ownership.

(reference: pkg/kwok/controllers/node_lease_controller.go:39-338)

Each managed node gets a ``coordination.k8s.io/Lease`` in
``kube-node-lease``, renewed every leaseDuration/4 with one-sided
jitter 0.04 (controller.go:245-249). Holding the lease IS owning the
node: a node whose lease another instance holds is read-only to us
(controller.go:286-296), which is how multiple simulator instances
shard a cluster — and the host-side analog of sharding SoA rows
across device shards (SURVEY.md §2.9).
"""

from __future__ import annotations

import datetime
import random
import threading
from typing import Callable, Dict, List, Optional, Set

from kwok_tpu_torch.cluster.store import Conflict, NotFound, ResourceStore
from kwok_tpu_torch.utils.clock import Clock, RealClock
from kwok_tpu_torch.utils.queue import DelayingQueue

NAMESPACE_NODE_LEASE = "kube-node-lease"


def _parse_micro(ts: str) -> Optional[datetime.datetime]:
    try:
        return datetime.datetime.fromisoformat(ts.replace("Z", "+00:00"))
    except (ValueError, AttributeError):
        return None


class NodeLeaseController:
    def __init__(
        self,
        store: ResourceStore,
        holder_identity: str,
        lease_duration_seconds: int = 40,
        parallelism: int = 4,
        clock: Optional[Clock] = None,
        on_node_managed: Optional[Callable[[str], None]] = None,
        mutate_lease: Optional[Callable[[dict], dict]] = None,
        rng: Optional[random.Random] = None,
    ):
        self.store = store
        self.holder = holder_identity
        self.lease_duration = lease_duration_seconds
        self.renew_interval = lease_duration_seconds / 4.0
        self.renew_jitter = 0.04  # one-sided (reference controller.go:245-249)
        self.clock = clock or RealClock()
        self._on_node_managed = on_node_managed
        self._mutate = mutate_lease
        self.rng = rng or random.Random()

        self._holding: Set[str] = set()
        self._wanted: Set[str] = set()
        #: names currently cycling through the queue/worker — guards
        #: against double entries when a node is re-managed while its
        #: old entry is still in flight
        self._queued: Set[str] = set()
        self._mut = threading.Lock()
        self._queue: DelayingQueue = DelayingQueue(self.clock)
        self._done = threading.Event()
        self._threads: List[threading.Thread] = []
        self._parallelism = parallelism
        self.renew_count = 0
        #: per-node last renew lag (seconds past due) — feeds the p99
        #: heartbeat-lag metric in BASELINE.json
        self.renew_lag: Dict[str, float] = {}
        #: optional DeviceLeaseLane: once a lease is held, its renewal
        #: cadence moves onto the device tick (SURVEY §7 step 5); this
        #: controller keeps acquisition/takeover/multi-instance logic
        self._lane = None

    def attach_device_lane(self, lane) -> None:
        """Move renewal cadence for held leases onto a device lane.
        Re-attaching (player rebuild on a Stage-CR change) re-registers
        everything currently held so no lease strands on a dead lane."""
        self._lane = lane
        for name in self.held_nodes():
            lane.register(name)

    def detach_device_lane(self) -> None:
        """Tear down lane delegation (e.g. the Node kind demoted to the
        host backend): every held node's renewal cadence returns to the
        host workers so no lease strands on a lane whose tick stopped."""
        self._lane = None
        with self._mut:
            resume = [
                n
                for n in self._holding
                if n in self._wanted and n not in self._queued
            ]
            self._queued.update(resume)
        for name in resume:
            self._queue.add(name)

    def start(self) -> None:
        for _ in range(self._parallelism):
            t = threading.Thread(target=self._sync_worker, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._done.set()
        self._queue.stop()

    # ---------------------------------------------------------------- ownership

    def try_hold(self, name: str) -> None:
        """Start trying to acquire/renew this node's lease
        (node_lease_controller.go:150-162 TryHold)."""
        with self._mut:
            if name in self._wanted:
                return
            self._wanted.add(name)
            if name in self._queued:
                return  # old entry still cycling; it will renew
            self._queued.add(name)
        self._queue.add(name)

    def release_hold(self, name: str) -> None:
        with self._mut:
            was_held = name in self._holding
            self._wanted.discard(name)
            self._holding.discard(name)
            if self._queue.cancel(name):
                self._queued.discard(name)
            # else: the worker holds it; it will drop it on next pop
        if self._lane is not None:
            self._lane.unregister(name)
        if was_held:
            # proactive handoff: null the holder instead of letting the
            # lease dangle until expiry, so another instance (a peer
            # shard or the next elected leader) takes the node over
            # immediately.  CAS on our own identity — a peer that
            # already took over legitimately must not be stomped.
            self._null_holder(name)

    def _null_holder(self, name: str) -> None:
        """Best-effort CAS release of one lease we held."""
        try:
            self.store.patch(
                "Lease",
                name,
                {"spec": {"holderIdentity": None}},
                patch_type="merge",
                namespace=NAMESPACE_NODE_LEASE,
                expect={"spec.holderIdentity": self.holder},
            )
        except Exception:  # noqa: BLE001 — releasing is best-effort:
            # NotFound/Conflict mean the lease moved on without us, and
            # a transport failure just leaves the expiry path in charge
            pass

    def release_all(self) -> None:
        """Null the holder of every lease we hold (graceful-shutdown
        handoff; the elected-leader step-down path calls this so node
        ownership transfers in one retry interval, not one expiry)."""
        with self._mut:
            held = sorted(self._holding)
            self._holding.clear()
            self._wanted.clear()
        for name in held:
            if self._lane is not None:
                self._lane.unregister(name)
            self._null_holder(name)

    def reacquire(self, name: str) -> None:
        """Re-enter the host acquisition path for a node whose lane
        renewal failed (lease gone or taken)."""
        with self._mut:
            self._holding.discard(name)
            if name not in self._wanted or name in self._queued:
                return
            self._queued.add(name)
        self._queue.add(name)

    def held(self, name: str) -> bool:
        """(node_lease_controller.go:164-171)"""
        with self._mut:
            return name in self._holding

    def held_nodes(self) -> Set[str]:
        with self._mut:
            return set(self._holding)

    # -------------------------------------------------------------------- sync

    def _sync_worker(self) -> None:
        while not self._done.is_set():
            name, ok = self._queue.get_or_wait(timeout=0.2)
            if not ok:
                continue
            with self._mut:
                if name not in self._wanted:
                    self._queued.discard(name)
                    continue
            try:
                next_try = self._sync(name)
            except Exception:  # noqa: BLE001
                import traceback

                traceback.print_exc()
                next_try = self.renew_interval
            # snapshot the lane; detach_device_lane may race this (the
            # handoff must be atomic with the _queued bookkeeping or a
            # node can strand on a dead lane with no queue entry)
            lane = self._lane
            if lane is not None:
                with self._mut:
                    hand_off = name in self._holding and self._lane is lane
                    if hand_off:
                        self._queued.discard(name)
                if hand_off:
                    lane.register(name)
                    continue
            self._queue.add_after(name, next_try)

    def _now(self) -> datetime.datetime:
        return datetime.datetime.fromtimestamp(self.clock.now(), datetime.timezone.utc)

    def _micro(self, t: datetime.datetime) -> str:
        return t.isoformat(timespec="microseconds").replace("+00:00", "Z")

    def _sync(self, name: str) -> float:
        """Renew or acquire; returns seconds until next try
        (node_lease_controller.go:174-214 sync + :322-338
        nextTryDuration)."""
        now = self._now()
        try:
            lease = self.store.get("Lease", name, namespace=NAMESPACE_NODE_LEASE)
        except NotFound:
            lease = None

        if lease is not None:
            spec = lease.get("spec") or {}
            holder = spec.get("holderIdentity")
            if holder and holder != self.holder:
                # someone else's LIVE lease: take over only once expired
                # (node_lease_controller.go:293-306 tryAcquireOrRenew).
                # An empty holder is a proactive release (release_hold/
                # release_all nulled it) — free to claim right now.
                renew = _parse_micro(spec.get("renewTime") or "")
                dur = spec.get("leaseDurationSeconds") or self.lease_duration
                if renew is not None and renew + datetime.timedelta(seconds=dur) > now:
                    with self._mut:
                        self._holding.discard(name)
                    expire = renew + datetime.timedelta(seconds=dur)
                    return max((expire - now).total_seconds(), 0.1)
            else:
                renew = _parse_micro(spec.get("renewTime") or "")
                if renew is not None:
                    due = renew + datetime.timedelta(seconds=self.renew_interval)
                    lag = (now - due).total_seconds()
                    if lag > 0:
                        self.renew_lag[name] = lag
            lease["spec"] = dict(lease.get("spec") or {})
            lease["spec"]["holderIdentity"] = self.holder
            lease["spec"]["leaseDurationSeconds"] = self.lease_duration
            lease["spec"]["renewTime"] = self._micro(now)
            if self._mutate is not None:
                lease = self._mutate(lease)
            try:
                self.store.update(lease)
            except (Conflict, NotFound):
                return 0.1  # re-read immediately
        else:
            lease = {
                "apiVersion": "coordination.k8s.io/v1",
                "kind": "Lease",
                "metadata": {"name": name, "namespace": NAMESPACE_NODE_LEASE},
                "spec": {
                    "holderIdentity": self.holder,
                    "leaseDurationSeconds": self.lease_duration,
                    "acquireTime": self._micro(now),
                    "renewTime": self._micro(now),
                },
            }
            if self._mutate is not None:
                lease = self._mutate(lease)
            try:
                self.store.create(lease)
            except Conflict:
                return 0.1

        first = False
        with self._mut:
            if name not in self._holding:
                self._holding.add(name)
                first = True
        self.renew_count += 1
        if first and self._on_node_managed is not None:
            self._on_node_managed(name)

        # renewInterval + one-sided jitter in [iv, iv*(1+0.04)]
        return self.renew_interval * (1.0 + self.renew_jitter * self.rng.random())

    # ------------------------------------------------------------ lane renewals

    def renew_batch(self, names: List[str]) -> List[str]:
        """Renew many held leases in one store round-trip (the device
        lane's write-back; amortizes what syncWorker does per node,
        node_lease_controller.go:174-214).  Returns the names whose
        renewal failed (lease gone/taken) — callers hand those back to
        the acquisition path."""
        ts = self._micro(self._now())
        with self._mut:
            held = [n for n in names if n in self._holding and n in self._wanted]
        if not held:
            return list(names)
        data = {
            "spec": {
                "holderIdentity": self.holder,
                "leaseDurationSeconds": self.lease_duration,
                "renewTime": ts,
            }
        }
        # CAS guard: only renew leases we still hold ON THE SERVER — a
        # peer that legitimately took over after our stall must not be
        # stomped (the host _sync path reads + backs off the same way;
        # tryAcquireOrRenew, node_lease_controller.go:293-306)
        expect = {"spec.holderIdentity": self.holder}
        ops = [
            {
                "verb": "patch",
                "kind": "Lease",
                "name": n,
                "namespace": NAMESPACE_NODE_LEASE,
                "data": data,
                "patch_type": "merge",
                "expect": expect,
            }
            for n in held
        ]
        held_set = set(held)
        failed = [n for n in names if n not in held_set]
        if hasattr(self.store, "bulk"):
            try:
                results = self.store.bulk(ops)
            except Exception:  # noqa: BLE001 — transport failure: the
                # lane already rescheduled a full interval out, so hand
                # everything back for an immediate host-path retry
                # rather than silently burning an expiry margin
                return list(names)
            for n, res in zip(held, results):
                if res.get("status") == "ok":
                    self.renew_count += 1
                else:
                    failed.append(n)
        else:
            for n in held:
                try:
                    self.store.patch(
                        "Lease",
                        n,
                        data,
                        patch_type="merge",
                        namespace=NAMESPACE_NODE_LEASE,
                        expect=expect,
                    )
                    self.renew_count += 1
                except (NotFound, Conflict):
                    failed.append(n)
        return failed
