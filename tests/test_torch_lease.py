"""The port's lease lane against the JAX package's.

- ``kwok_tpu_torch.ops.tick.lease_tick`` (its plain version, on the
  CPU) equals ``kwok_tpu.ops.tick.lease_tick`` bit for bit: fire times,
  due flags, lags and the advanced key, on NEVER slots, slots due
  exactly now, zero jitter, clocks near 2**30 and a lane grown 16 -> 32.
- ``kwok_tpu_torch.controllers.device_lease.DeviceLeaseLane`` runs the
  scenarios of tests/test_device_lease.py on the CPU, and two lanes of
  the two packages on one seed and renew schedule keep equal fire times
  and renew the same leases with the same lags after every tick.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwok_tpu.controllers.device_lease import DeviceLeaseLane as JaxLane
from kwok_tpu.ctl.scale import scale
from kwok_tpu.ops import tick as J
from kwok_tpu_torch.api.config import KwokConfiguration
from kwok_tpu_torch.cluster.store import Conflict, NotFound, ResourceStore
from kwok_tpu_torch.controllers.controller import Controller
from kwok_tpu_torch.controllers.device_lease import DeviceLeaseLane
from kwok_tpu_torch.controllers.node_lease_controller import (
    NAMESPACE_NODE_LEASE,
    NodeLeaseController,
)
from kwok_tpu_torch.engine.compiler import NEVER
from kwok_tpu_torch.ops import prng
from kwok_tpu_torch.ops import tick as T
from kwok_tpu_torch.stages import default_node_stages, default_pod_stages

CPU = "cpu"

# ---------------------------------------------------------- lease_tick parity


def both(fire_at: np.ndarray, seed: int, now: int, renew: int, jitter: int):
    """(jax, port) results of one lease_tick as numpy:
    (fire_at, due, lag, key)."""
    jl, jd, jg = J.lease_tick(
        J.LeaseLane(fire_at=jnp.asarray(fire_at), key=jax.random.PRNGKey(seed)),
        jnp.int32(now), jnp.int32(renew), jnp.int32(jitter))
    tl, td, tg = T.lease_tick(
        T.LeaseLane(fire_at=torch.from_numpy(fire_at.copy()), key=prng.prng_key(seed, CPU)),
        now, renew, jitter)
    jax_out = tuple(np.asarray(a) for a in (jl.fire_at, jd, jg, jl.key))
    port_out = (tl.fire_at.numpy(), td.numpy(), tg.numpy(), tl.key.numpy())
    return jax_out, port_out


def assert_same(jax_out, port_out):
    for name, a, b in zip(("fire_at", "due", "lag", "key"), jax_out, port_out):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def lane_state(n: int, now: int, seed: int) -> np.ndarray:
    """Slot fire times around ``now``: NEVER slots, slots due exactly now,
    overdue and future slots."""
    rng = np.random.default_rng(seed)
    fire = (now + rng.integers(-20_000, 20_000, n)).astype(np.int32)
    fire[rng.random(n) < 0.25] = NEVER
    fire[rng.random(n) < 0.1] = now
    return fire


@pytest.mark.parametrize(
    "now,renew,jitter",
    [
        (50_000, 10_000, 400),  # the default 40 s lease: renew 10 s, 4% jitter
        (50_000, 10_000, 0),  # no jitter
        (2**30 - 1, 10_000, 400),  # just below the lane's rebase point
        (2**30 - 7, 2**30, 2**29),  # sums that pass int32's top and wrap
        (0, 1, 1),
    ],
)
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_lease_tick_matches_jax(now, renew, jitter, seed):
    fire = lane_state(1000, now, seed % 1000)
    assert (fire == NEVER).any() and (fire == now).any()
    jax_out, port_out = both(fire, seed, now, renew, jitter)
    assert_same(jax_out, port_out)
    due = port_out[1]
    assert not due[fire == NEVER].any(), "an empty slot came due"
    assert due[fire == now].all()


def test_lease_tick_chained_matches_jax():
    """Ticks fed the lane the last one left, as the lane does."""
    fire = lane_state(300, 0, 3)
    jl = J.LeaseLane(fire_at=jnp.asarray(fire), key=jax.random.PRNGKey(5))
    tl = T.LeaseLane(fire_at=torch.from_numpy(fire.copy()), key=prng.prng_key(5, CPU))
    for now in range(0, 60_000, 1_700):
        jl, jd, jg = J.lease_tick(jl, jnp.int32(now), jnp.int32(10_000), jnp.int32(400))
        tl, td, tg = T.lease_tick(tl, now, 10_000, 400)
        assert_same((np.asarray(jl.fire_at), np.asarray(jd), np.asarray(jg), np.asarray(jl.key)),
                    (tl.fire_at.numpy(), td.numpy(), tg.numpy(), tl.key.numpy()))


def test_lease_tick_draws_do_not_move_when_the_lane_grows():
    """Slot i's draw depends only on the key and i: a lane grown from 16
    to 32 slots (empty slots appended) renews its first 16 exactly as
    before, and both sizes equal JAX."""
    now = 30_000
    small = lane_state(16, now, 11)
    grown = np.concatenate([small, np.full(16, NEVER, np.int32)])
    s_jax, s_port = both(small, 9, now, 10_000, 400)
    g_jax, g_port = both(grown, 9, now, 10_000, 400)
    assert_same(s_jax, s_port)
    assert_same(g_jax, g_port)
    for a, b in zip(s_port[:3], g_port[:3]):
        np.testing.assert_array_equal(a, b[:16])
    np.testing.assert_array_equal(s_port[3], g_port[3])
    assert not g_port[1][16:].any()


def test_lease_tick_refuses_values_outside_int32():
    lane = T.LeaseLane(fire_at=torch.zeros(4, dtype=torch.int32), key=prng.prng_key(0, CPU))
    with pytest.raises(ValueError, match="int32"):
        T.lease_tick(lane, 2**31, 1, 0)


def test_lease_tick_counts_no_launch_on_the_cpu():
    T.reset_launches()
    lane = T.LeaseLane(fire_at=torch.zeros(4, dtype=torch.int32), key=prng.prng_key(0, CPU))
    T.lease_tick(lane, 10, 1, 0)
    assert T.launches()["lease_tick"] == 0


# ------------------------------------------- both lanes on one renew schedule


class FakeLeaseCtrl:
    """What the lane needs of a NodeLeaseController: the cadence, and a
    batched renewal that records the names and fails the given ones."""

    renew_interval = 10.0
    renew_jitter = 0.04

    def __init__(self, failing=()):
        self.failing = set(failing)
        self.batches = []
        self.reacquired = []

    def renew_batch(self, names):
        self.batches.append(list(names))
        return [n for n in names if n in self.failing]

    def reacquire(self, name):
        self.reacquired.append(name)


def test_lanes_of_both_packages_agree_tick_by_tick():
    jctrl, tctrl = FakeLeaseCtrl(failing={"n7"}), FakeLeaseCtrl(failing={"n7"})
    jlane = JaxLane(jctrl, capacity=16, seed=3)
    tlane = DeviceLeaseLane(tctrl, capacity=16, seed=3, device=CPU)
    rng = np.random.default_rng(0)
    names = [f"n{i}" for i in range(40)]
    now = 0
    for step in range(60):
        # membership churn between ticks, the same on both lanes; the
        # 40 names of the first step grow the lane from 16 slots to 64
        for name in (names if step == 0 else rng.choice(names, 3, replace=False).tolist()):
            if step == 0 or rng.random() < 0.7:
                jlane.register(name), tlane.register(name)
            else:
                jlane.unregister(name), tlane.unregister(name)
        now += int(rng.integers(0, 4_000))
        if step == 45:
            now = 2**30 + 123  # crosses the rebase point
        assert jlane.tick(now) == tlane.tick(now)
        np.testing.assert_array_equal(jlane._fire_np, tlane._fire_np)
        assert jlane._names == tlane._names
        assert jctrl.batches == tctrl.batches  # the due leases, in slot order
        assert list(jlane.renew_lags) == list(tlane.renew_lags)  # their lags
        assert jlane._base == tlane._base
        np.testing.assert_array_equal(np.asarray(jlane._key), tlane._key.numpy())
    assert len(tlane._fire_np) == 64 and tlane.renew_count > 100
    assert jctrl.reacquired == tctrl.reacquired and "n7" in tctrl.reacquired


# ------------------------------------- the scenarios of tests/test_device_lease.py


def wait_until(cond, budget=10.0):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


@pytest.fixture()
def held_lane():
    store = ResourceStore()
    ctrl = NodeLeaseController(store, "inst-a", lease_duration_seconds=40)
    lane = DeviceLeaseLane(ctrl, capacity=16, seed=0, device=CPU)
    ctrl.attach_device_lane(lane)
    ctrl.start()
    for i in range(3):
        ctrl.try_hold(f"n{i}")
    assert wait_until(lambda: len(lane) == 3), "leases not handed to the lane"
    yield store, ctrl, lane
    ctrl.stop()


def renew_time(store, name):
    lease = store.get("Lease", name, namespace=NAMESPACE_NODE_LEASE)
    return (lease.get("spec") or {}).get("renewTime")


def test_lane_renews_on_schedule(held_lane):
    store, ctrl, lane = held_lane
    renew_ms = lane.renew_ms
    before = {f"n{i}": renew_time(store, f"n{i}") for i in range(3)}
    assert lane.tick(renew_ms // 2) == 0
    assert {f"n{i}": renew_time(store, f"n{i}") for i in range(3)} == before
    assert lane.tick(renew_ms + 100) == 3
    after = {f"n{i}": renew_time(store, f"n{i}") for i in range(3)}
    assert all(after[k] != before[k] for k in before)
    assert ctrl.renew_count >= 6
    now = renew_ms + 100
    assert lane.tick(now + renew_ms - 200) == 0
    assert lane.tick(now + int(renew_ms * 1.04) + 100) == 3
    assert len(lane.renew_lags) >= 6
    assert all(0 <= lag < 5.0 for lag in lane.renew_lags)


def test_lane_failure_hands_back_to_host_path(held_lane):
    store, ctrl, lane = held_lane
    store.delete("Lease", "n1", namespace=NAMESPACE_NODE_LEASE)
    try:
        store.delete("Lease", "n1", namespace=NAMESPACE_NODE_LEASE)
    except NotFound:
        pass
    assert store.count("Lease") == 2
    lane.tick(lane.renew_ms + 100)
    assert wait_until(
        lambda: store.count("Lease") == 3 and len(lane) == 3
    ), "lease not re-acquired after lane failure"
    assert ctrl.held("n1")


def test_lane_never_stomps_a_peers_takeover(held_lane):
    store, ctrl, lane = held_lane
    lease = store.get("Lease", "n1", namespace=NAMESPACE_NODE_LEASE)
    lease["spec"]["holderIdentity"] = "inst-b"
    store.update(lease)
    lane.tick(lane.renew_ms + 100)
    taken = store.get("Lease", "n1", namespace=NAMESPACE_NODE_LEASE)
    assert taken["spec"]["holderIdentity"] == "inst-b", "lease was stomped"
    assert lane.renew_count >= 2
    assert wait_until(lambda: "n1" not in ctrl.held_nodes())
    assert len(lane) == 2


def test_store_patch_expect_precondition():
    store = ResourceStore()
    store.create({
        "apiVersion": "coordination.k8s.io/v1",
        "kind": "Lease",
        "metadata": {"name": "l", "namespace": NAMESPACE_NODE_LEASE},
        "spec": {"holderIdentity": "a"},
    })
    with pytest.raises(Conflict):
        store.patch("Lease", "l", {"spec": {"holderIdentity": "b"}},
                    namespace=NAMESPACE_NODE_LEASE, expect={"spec.holderIdentity": "not-a"})
    assert store.get("Lease", "l", namespace=NAMESPACE_NODE_LEASE)["spec"]["holderIdentity"] == "a"
    out = store.patch("Lease", "l", {"spec": {"holderIdentity": "b"}},
                      namespace=NAMESPACE_NODE_LEASE, expect={"spec.holderIdentity": "a"})
    assert out["spec"]["holderIdentity"] == "b"
    res = store.bulk([{
        "verb": "patch", "kind": "Lease", "name": "l", "namespace": NAMESPACE_NODE_LEASE,
        "data": {"spec": {"holderIdentity": "c"}}, "expect": {"spec.holderIdentity": "zzz"},
    }])
    assert res[0]["status"] == "error" and res[0]["reason"] == "Conflict"


def test_unregister_on_release(held_lane):
    store, ctrl, lane = held_lane
    ctrl.release_hold("n1")
    assert len(lane) == 2
    before = renew_time(store, "n1")
    lane.tick(lane.renew_ms * 3)
    assert renew_time(store, "n1") == before


def test_detach_returns_renewals_to_host_path(held_lane):
    store, ctrl, lane = held_lane
    before = {f"n{i}": renew_time(store, f"n{i}") for i in range(3)}
    ctrl.detach_device_lane()
    assert wait_until(
        lambda: all(renew_time(store, f"n{i}") != before[f"n{i}"] for i in range(3))
    ), "host workers did not resume renewals after detach"
    assert all(ctrl.held(f"n{i}") for i in range(3))


def test_lane_grows_past_capacity():
    store = ResourceStore()
    ctrl = NodeLeaseController(store, "inst-a", lease_duration_seconds=40)
    lane = DeviceLeaseLane(ctrl, capacity=4, seed=0, device=CPU)
    ctrl.attach_device_lane(lane)
    ctrl.start()
    try:
        for i in range(40):
            ctrl.try_hold(f"n{i}")
        assert wait_until(lambda: len(lane) == 40)
        assert lane.tick(lane.renew_ms + 50) == 40
    finally:
        ctrl.stop()


def test_renew_batch_builds_its_held_set_once(monkeypatch):
    """The lane renews every due lease in one batch; the reference built
    the held set once per name, quadratic in the batch.  The port's copy
    builds it once and fails the same names as the reference."""
    from kwok_tpu.cluster.store import ResourceStore as JaxStore
    from kwok_tpu.controllers.node_lease_controller import NodeLeaseController as JaxCtrl
    from kwok_tpu_torch.controllers import node_lease_controller as port_module

    names = [f"n{i}" for i in range(300)]
    ctrls = [JaxCtrl(JaxStore(), "inst-a"), NodeLeaseController(ResourceStore(), "inst-a")]
    for ctrl in ctrls:
        for name in names:
            ctrl._wanted.add(name)
            ctrl._sync(name)
        assert ctrl.held_nodes() == set(names)
        ctrl.store.delete("Lease", "n7", namespace=NAMESPACE_NODE_LEASE)
    built = []

    def counting_set(*args):
        built.append(1)
        return set(*args)

    monkeypatch.setattr(port_module, "set", counting_set, raising=False)
    asked = names + ["not-held"]
    failed = [ctrl.renew_batch(asked) for ctrl in ctrls]
    assert sorted(failed[1]) == sorted(failed[0]) == ["n7", "not-held"]
    assert ctrls[1].renew_count == ctrls[0].renew_count == 2 * len(names) - 1
    assert len(built) <= 2, f"renew_batch built {len(built)} sets for {len(asked)} names"


def test_device_backend_lease_lanes_under_churn():
    store = ResourceStore()
    ctr = Controller(
        store,
        KwokConfiguration(
            manage_all_nodes=True,
            backend="device",
            device_tick_ms=20,
            node_lease_duration_seconds=4,
        ),
        local_stages={"Node": default_node_stages(lease=True), "Pod": default_pod_stages()},
        seed=0,
        device=CPU,
    )
    ctr.start()
    try:
        scale(store, "node", 40)
        assert wait_until(
            lambda: store.count("Lease") == 40 and len(ctr.node_leases.held_nodes()) == 40,
            20.0,
        )
        lane = ctr.node_leases._lane
        assert isinstance(lane, DeviceLeaseLane)
        assert wait_until(lambda: len(lane) == 40, 10.0), "held leases not migrated onto the lane"
        scale(store, "node", 10, name_prefix="late")
        for i in range(5):
            store.delete("Node", f"node-{i}")
        assert wait_until(lambda: len(lane) == 45, 20.0), len(lane)
        gone = {f"node-{i}" for i in range(5)}

        def renew_times():
            return {
                (ln.get("metadata") or {}).get("name"): (ln.get("spec") or {}).get("renewTime")
                for ln in store.list("Lease")[0]
            }

        before = {k: v for k, v in renew_times().items() if k not in gone}

        def all_renewed():
            after = renew_times()
            return all(after.get(k) != v for k, v in before.items())

        assert wait_until(all_renewed, 15.0), "leases stopped renewing"
        lags = sorted(lane.renew_lags)
        assert lags, "no lag samples recorded"
        assert lags[int(0.99 * (len(lags) - 1))] < 3.0, lags[-5:]
    finally:
        ctr.stop()
