"""Lease-based leader election — the client-go LeaderElector seat.

Mirrors ``vendor/k8s.io/client-go/tools/leaderelection/leaderelection.go``
semantics over this repo's store duck-type (a :class:`ResourceStore` or
:class:`~kwok_tpu_torch.cluster.client.ClusterClient`):

- the election record is a ``coordination.k8s.io/v1 Lease`` in
  ``kube-system`` (resourcelock/leaselock.go:41-126); acquire/renew are
  CAS writes — create on absence, update with the read
  ``resourceVersion`` otherwise — so two contenders can never both
  observe success for the same generation,
- expiry is measured on a **local monotonic clock** from the moment the
  observed record last *changed* (leaderelection.go:61-73: trusting the
  remote ``renewTime`` is "susceptible to clock skew"; we keep
  ``observed_at = clock.now()`` and never parse the peer's timestamp
  for deadline math),
- a follower retries acquisition, and a leader renews, every jittered
  ``leaseDuration/3`` (the reference's JitterUntil(retryPeriod) loop,
  leaderelection.go:244-263, with the interval pinned to the duration
  the way kube-controller-manager derives its defaults),
- a leader that cannot renew within ``renewDeadline`` voluntarily
  steps down (leaderelection.go:265-304 renew → Until cancel) and
  re-enters the acquire loop as a follower,
- takeover bumps ``spec.leaseTransitions`` and stamps a fresh
  ``acquireTime`` (leaderelection.go:330-392 tryAcquireOrRenew);
  ``on_started_leading`` / ``on_stopped_leading`` / ``on_new_leader``
  callbacks mirror LeaderCallbacks (leaderelection.go:91-107),
- ``release()`` (graceful shutdown, ReleaseOnCancel semantics,
  leaderelection.go:306-328) CAS-nulls the holder so a standby takes
  over in ~one retry interval instead of waiting out leaseDuration.

**Write fencing** (the split-brain guard the reference gets from etcd
resourceVersion semantics, generalized here to every mutation): while
leading, :meth:`LeaderElector.fence` returns a
``namespace/name/holder/transitions`` token for the
``X-Kwok-Leader-Fence`` header; the apiserver re-validates it against
the live Lease on every mutating verb and rejects mismatches with 409,
so a paused-then-resumed ex-leader (SIGSTOP/SIGCONT) cannot write with
a stale generation even before its elector notices the deposition.
"""

from __future__ import annotations

import datetime
import random
import threading
from typing import Callable, Optional, Tuple

from kwok_tpu_torch.cluster.store import Conflict, NotFound
from kwok_tpu_torch.utils.clock import Clock, MonotonicClock
from kwok_tpu_torch.utils.locks import guarded, make_lock

__all__ = [
    "LeaderElector",
    "ELECTION_NAMESPACE",
    "FENCE_HEADER",
    "build_fence",
    "parse_fence",
    "validate_fence",
]

#: election Leases live where kube components put theirs
ELECTION_NAMESPACE = "kube-system"

#: mutating requests carry the leader's claimed generation here; the
#: apiserver validates it against the live Lease (cluster/apiserver.py)
FENCE_HEADER = "X-Kwok-Leader-Fence"

#: one-sided jitter factor on retry/renew sleeps (client-go
#: JitterUntil(retryPeriod, JitterFactor=1.2), leaderelection.go:252)
JITTER = 1.2


def build_fence(namespace: str, name: str, holder: str, transitions: int) -> str:
    """Serialize one leadership generation as a fence token."""
    return f"{namespace}/{name}/{holder}/{int(transitions)}"


def parse_fence(raw: str) -> Optional[Tuple[str, str, str, int]]:
    """``ns/name/holder/transitions`` → tuple, None when malformed.
    The holder segment may itself contain ``/`` (identities are
    free-form), so split greedily from both ends."""
    parts = (raw or "").split("/")
    if len(parts) < 4:
        return None
    try:
        transitions = int(parts[-1])
    except ValueError:
        return None
    return parts[0], parts[1], "/".join(parts[2:-1]), transitions


def validate_fence(store, token: str) -> Optional[str]:
    """The split-brain verdict, shared by every fence enforcement
    point (the apiserver's ``X-Kwok-Leader-Fence`` gate and the DST
    harness's in-process store boundary): check one fence token
    against the live election Lease; returns ``None`` when the
    writer's generation is current, else the stale-reason string the
    caller renders into its 409/Conflict."""
    parsed = parse_fence(token)
    if parsed is None:
        return "malformed fence token"
    ns, name, holder, transitions = parsed
    try:
        spec = (store.get("Lease", name, namespace=ns) or {}).get("spec") or {}
    except Exception:  # noqa: BLE001 — a vanished (or unreadable) lease
        # is a revoked generation, same verdict as a mismatch
        return f"election lease {ns}/{name} is gone"
    live_holder = spec.get("holderIdentity") or ""
    try:
        live_tr = int(spec.get("leaseTransitions") or 0)
    except (TypeError, ValueError):
        live_tr = 0
    if live_holder == holder and live_tr == transitions:
        return None
    return (
        f"lease {ns}/{name} is held by "
        f"{live_holder or '<nobody>'} at transition {live_tr}"
    )


class LeaderElector:
    """Campaign for (then keep renewing) one election Lease.

    Drive it with :meth:`start`/:meth:`stop` for the daemon thread, or
    synchronously with :meth:`try_acquire_or_renew`/:meth:`renew_once`
    from fake-clock tests — the state machine is the same either way.
    """

    def __init__(
        self,
        store,
        lease_name: str,
        identity: str,
        namespace: str = ELECTION_NAMESPACE,
        lease_duration: float = 15.0,
        renew_deadline: Optional[float] = None,
        retry_period: Optional[float] = None,
        clock: Optional[Clock] = None,
        rng: Optional[random.Random] = None,
        record_clock: Optional[Clock] = None,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
        on_new_leader: Optional[Callable[[str], None]] = None,
    ):
        if lease_duration <= 0:
            raise ValueError("lease_duration must be positive")
        self.store = store
        self.lease_name = lease_name
        self.identity = identity
        self.namespace = namespace
        self.lease_duration = float(lease_duration)
        #: a leader that has not renewed for this long steps down
        #: (client-go default: 2/3 of the lease, 10s of 15s)
        self.renew_deadline = (
            float(renew_deadline)
            if renew_deadline is not None
            else self.lease_duration * 2.0 / 3.0
        )
        #: follower acquire cadence AND leader renew cadence (jittered
        #: one-sided up to ×JITTER)
        self.retry_period = (
            float(retry_period)
            if retry_period is not None
            else self.lease_duration / 3.0
        )
        self.clock = clock or MonotonicClock()
        self.rng = rng or random.Random()
        #: clock for the *record's* display timestamps (acquireTime /
        #: renewTime).  None = wall clock, the production posture;
        #: simulated-time runs (kwok_tpu_torch.dst) inject their virtual
        #: clock so the written record is seed-deterministic.  Deadline
        #: math never reads these timestamps either way.
        self.record_clock = record_clock
        self._on_started = on_started_leading
        self._on_stopped = on_stopped_leading
        self._on_new_leader = on_new_leader

        self._mut = make_lock("cluster.election.LeaderElector._mut")
        self._leading = False
        #: last-generation fence token (see :meth:`fence`)
        self._fence_value: Optional[str] = None
        #: transitions value of OUR current generation (valid while
        #: leading; stamped into the fence token)
        self.transitions = 0
        #: voluntary renew-deadline step-downs (metrics)
        self.stepdowns = 0
        #: clock.now() of the last successful acquire/renew
        self._last_renew = 0.0
        #: locally observed record: (holder, renewTime, transitions)
        #: and the monotonic instant it last changed
        self._observed_key: Optional[Tuple] = None
        self._observed_at = 0.0
        self._observed_holder = ""
        self._observed_duration = self.lease_duration
        # the elector thread and is_leader()/status callers share the
        # observed record — declared to the runtime race sentinel
        guarded(self, "_observed_key", "cluster.election.LeaderElector._mut")

        self._done = threading.Event()
        self._wake = threading.Event()
        self.clock.subscribe(self._wake)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- inspection

    def is_leader(self) -> bool:
        """Locally-believed leadership, deadline-checked: a paused
        (SIGSTOP) process that resumes past its renew deadline answers
        False immediately, before the elector thread even wakes."""
        with self._mut:
            return self._leading and (
                self.clock.now() - self._last_renew < self.renew_deadline
            )

    def leader_identity(self) -> str:
        """Last observed holder ('' when the lease is unheld/unseen)."""
        with self._mut:
            return self._observed_holder

    def last_renew_age(self) -> Optional[float]:
        """Seconds since our last successful renew; None off-lead."""
        with self._mut:
            if not self._leading:
                return None
            return max(0.0, self.clock.now() - self._last_renew)

    def fence(self) -> Optional[str]:
        """Fence token for mutating writes; None until first elected.

        Deliberately neither deadline-checked nor cleared on step-down:
        once this instance has led, every later write keeps carrying
        its LAST generation — straggler writes racing the teardown, or
        a SIGSTOP/SIGCONT zombie, then present a stale token and the
        apiserver rejects them against the live Lease.  Returning None
        there instead would let exactly those writes through unfenced.
        Re-election refreshes the token to the new generation."""
        with self._mut:
            return self._fence_value

    # ---------------------------------------------------------- state machine

    def _now_rfc3339(self) -> str:
        # wall-clock timestamp for the *record* (human/display
        # consumers); deadline math never parses it back
        if self.record_clock is not None:
            t = datetime.datetime.fromtimestamp(
                self.record_clock.now(), datetime.timezone.utc
            )
        else:
            t = datetime.datetime.now(datetime.timezone.utc)
        return t.isoformat(timespec="microseconds").replace("+00:00", "Z")

    def _observe(self, spec: dict) -> None:
        """Track record changes on the local monotonic clock (the
        leaderelection.go:368-375 observedRecord/observedTime pair)."""
        holder = spec.get("holderIdentity") or ""
        key = (
            holder,
            spec.get("renewTime"),
            spec.get("leaseTransitions"),
        )
        new_leader = None
        with self._mut:
            if key != self._observed_key:
                self._observed_key = key
                self._observed_at = self.clock.now()
                if holder != self._observed_holder:
                    self._observed_holder = holder
                    new_leader = holder
            try:
                self._observed_duration = float(
                    spec.get("leaseDurationSeconds") or self.lease_duration
                )
            except (TypeError, ValueError):
                self._observed_duration = self.lease_duration
        if new_leader and self._on_new_leader is not None:
            self._on_new_leader(new_leader)

    def try_acquire_or_renew(self) -> bool:
        """One CAS attempt at the record (leaderelection.go:330-392).
        Returns True when we hold the lease afterwards."""
        now = self.clock.now()
        try:
            lease = self.store.get(
                "Lease", self.lease_name, namespace=self.namespace
            )
        except NotFound:
            lease = None
        except Exception:  # noqa: BLE001 — transport trouble: count as
            # a failed attempt; the renew deadline bounds how long we
            # coast on the old generation
            return False

        if lease is None:
            fresh = {
                "apiVersion": "coordination.k8s.io/v1",
                "kind": "Lease",
                "metadata": {
                    "name": self.lease_name,
                    "namespace": self.namespace,
                },
                "spec": {
                    "holderIdentity": self.identity,
                    "leaseDurationSeconds": int(round(self.lease_duration)),
                    "acquireTime": self._now_rfc3339(),
                    "renewTime": self._now_rfc3339(),
                    "leaseTransitions": 0,
                },
            }
            try:
                created = self.store.create(fresh)
            except Conflict:
                return False  # lost the create race
            except Exception:  # noqa: BLE001 — transport trouble
                return False
            self._observe(created.get("spec") or fresh["spec"])
            self._won(transitions=0, at=now)
            return True

        spec = dict(lease.get("spec") or {})
        holder = spec.get("holderIdentity") or ""
        self._observe(spec)
        with self._mut:
            observed_at = self._observed_at
            observed_duration = self._observed_duration
        if holder and holder != self.identity:
            if now < observed_at + observed_duration:
                # live foreign leader: defer (tryAcquireOrRenew's
                # "lock is held and has not yet expired" branch);
                # renew_once/_run own the deposition bookkeeping
                return False

        try:
            transitions = int(spec.get("leaseTransitions") or 0)
        except (TypeError, ValueError):
            transitions = 0
        if holder != self.identity:
            # takeover (or claim of a released/expired lease)
            transitions += 1
            spec["acquireTime"] = self._now_rfc3339()
        spec["holderIdentity"] = self.identity
        spec["leaseDurationSeconds"] = int(round(self.lease_duration))
        spec["renewTime"] = self._now_rfc3339()
        spec["leaseTransitions"] = transitions
        updated = dict(lease)
        updated["spec"] = spec
        try:
            out = self.store.update(updated)
        except (Conflict, NotFound):
            return False  # CAS lost: someone moved the record first
        except Exception:  # noqa: BLE001 — transport trouble
            return False
        self._observe((out or updated).get("spec") or spec)
        self._won(transitions=transitions, at=now)
        return True

    def _won(self, transitions: int, at: float) -> None:
        with self._mut:
            first = not self._leading
            self._leading = True
            self.transitions = transitions
            self._last_renew = at
            self._fence_value = build_fence(
                self.namespace, self.lease_name, self.identity, transitions
            )
        if first and self._on_started is not None:
            self._on_started()

    def _step_down(self, voluntary: bool = True) -> None:
        with self._mut:
            if not self._leading:
                return
            self._leading = False
            if voluntary:
                self.stepdowns += 1
        if self._on_stopped is not None:
            self._on_stopped()

    def renew_once(self) -> bool:
        """One leading-side renew attempt, with the renew-deadline
        step-down applied on failure.  Returns True while still leader
        (possibly coasting inside the deadline)."""
        if self.try_acquire_or_renew():
            return True
        now = self.clock.now()
        with self._mut:
            leading = self._leading
            blown = now - self._last_renew >= self.renew_deadline
            foreign = bool(
                self._observed_holder
                and self._observed_holder != self.identity
                and now < self._observed_at + self._observed_duration
            )
        if not leading:
            return False
        if foreign:
            # a live peer holds OUR lease: deposed hard (takeover)
            self._step_down(voluntary=False)
            return False
        if blown:
            self._step_down(voluntary=True)
            return False
        return True

    def release(self) -> bool:
        """CAS-null the holder so a standby acquires without waiting
        out the lease (leaderelection.go:306-328 release).  Returns
        True when the record was released by us."""
        with self._mut:
            if not self._leading:
                return False
        try:
            lease = self.store.get(
                "Lease", self.lease_name, namespace=self.namespace
            )
        except Exception:  # noqa: BLE001 — best-effort on the way out
            return False
        spec = dict(lease.get("spec") or {})
        if (spec.get("holderIdentity") or "") != self.identity:
            return False
        spec["holderIdentity"] = None
        spec["renewTime"] = self._now_rfc3339()
        updated = dict(lease)
        updated["spec"] = spec
        try:
            self.store.update(updated)
        except Exception:  # noqa: BLE001 — best-effort on the way out
            return False
        return True

    # ------------------------------------------------------------- run loop

    def _sleep(self, seconds: float) -> None:
        deadline = self.clock.now() + seconds
        while not self._done.is_set():
            remain = deadline - self.clock.now()
            if remain <= 0:
                return
            self._wake.clear()
            self.clock.wait_signal(self._wake, remain)

    def _jittered(self, base: float) -> float:
        # one-sided jitter in [base, base*JITTER) — contenders desync
        return base * (1.0 + (JITTER - 1.0) * self.rng.random())

    def _run(self) -> None:
        while not self._done.is_set():
            with self._mut:
                leading = self._leading
                blown = leading and (
                    self.clock.now() - self._last_renew >= self.renew_deadline
                )
            if blown:
                # the deadline can also pass mid-sleep (or across a
                # SIGSTOP): step down before attempting anything else
                self._step_down(voluntary=True)
                continue
            if not leading:
                if not self.try_acquire_or_renew():
                    self._sleep(self._jittered(self.retry_period))
                continue
            self._sleep(self._jittered(self.retry_period))
            if self._done.is_set():
                return
            self.renew_once()

    def start(self) -> "LeaderElector":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self, release: bool = True) -> None:
        """Stop campaigning; by default release the lease when held
        (the SIGTERM path — a standby takes over in ~one retry
        interval instead of a full leaseDuration)."""
        self._done.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if release:
            self.release()
        self._step_down(voluntary=False)
