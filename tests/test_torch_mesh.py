"""kwok_tpu_torch.parallel.mesh equals kwok_tpu.parallel.mesh bit for bit.

The scenarios of tests/test_parallel.py, run on the port's 8-shard CPU
mesh (PyTorch has one CPU device, so the mesh repeats it) against JAX's
``make_mesh(8)`` over the 8 host devices tests/conftest.py gives XLA,
from the same numpy state and seed: the sharded tick and multi-tick
loop, the row layout, the simulator's trajectory with host churn
between ticks, capacity rounding, and the Controller on a mesh.  The
FSM is int32 and the PRNG bit-exact, so every comparison is exact
(``np.array_equal``).  A missing row offset would only show on shards
past the first, so the offset has its own test.
"""

import time

import jax
import numpy as np
import pytest
import torch

from kwok_tpu.engine.simulator import DeviceSimulator as JaxSim
from kwok_tpu.parallel import mesh as jm
from kwok_tpu.stages import load_builtin
from kwok_tpu_torch.api.config import KwokConfiguration
from kwok_tpu_torch.cluster.store import ResourceStore
from kwok_tpu_torch.controllers.controller import Controller
from kwok_tpu_torch.engine.simulator import DeviceSimulator as TorchSim
from kwok_tpu_torch.ops import prng
from kwok_tpu_torch.ops import tick as tt
from kwok_tpu_torch.parallel import mesh as tm
from kwok_tpu_torch.stages import default_node_stages, default_pod_stages
from kwok_tpu_torch.stages import load_builtin as torch_load

from tests.test_torch_tick import CHAOS, POD_KINDS, np_dict, pod

SHARDS = 8
N = 64
ROW_FIELDS = ("features", "sig", "ovc", "stage", "fire_at", "active", "rematch", "del_ts")
SETS = {
    "pod-fast": ("pod-fast",),
    "pod-general+pod-chaos": ("pod-general", "pod-chaos"),
}


def stages(set_name, load):
    return [s for part in SETS[set_name] for s in load(part)]


def cpu_mesh(n=SHARDS):
    return tm.make_mesh(devices=[torch.device("cpu")] * n)


def jax_mesh():
    if len(jax.devices()) < SHARDS:
        pytest.skip("needs 8 XLA host devices (tests/conftest.py)")
    return jm.make_mesh(SHARDS)


def start(set_name, n=N, seed=3):
    """The same population on a JAX and a port mesh, from numpy."""
    sim = JaxSim(stages(set_name, load_builtin), capacity=n, seed=seed)
    for i in range(n):
        sim.admit(POD_KINDS[i % len(POD_KINDS)](i))
    jp, js = sim.to_device()
    pd, sd = np_dict(jp), np_dict(js)
    jax_placed = jm.place(jp, js, jax_mesh())
    port_placed = tm.place(tt.params_from_numpy(pd, "cpu"), tt.soa_from_numpy(sd, "cpu"), cpu_mesh())
    return jax_placed, port_placed, (pd, sd)


def assert_soa_same(jsoa, tsoa: tm.ShardedSoA, what=""):
    for f in ROW_FIELDS:
        a, b = np.asarray(getattr(jsoa, f)), tsoa.column(f).to_host().numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, f)
    for shard in tsoa.shards:
        assert int(shard.now) == int(jsoa.now), what
        assert np.array_equal(shard.key.numpy(), np.asarray(jsoa.key)), what


@pytest.mark.parametrize("set_name", list(SETS))
def test_sharded_tick_matches_jax_and_single_device(set_name):
    (jp, js), (tp, ts), (pd, sd) = start(set_name)
    single = tt.soa_from_numpy(sd, "cpu")
    sparams = tt.params_from_numpy(pd, "cpu")
    jstep = jm.sharded_tick(jax_mesh(), dt_ms=1000)
    tstep = tm.sharded_tick(cpu_mesh(), dt_ms=1000)
    totals = [0, 0]
    for t in range(5):
        js, jout = jstep(jp, js)
        ts, tout = tstep(tp, ts)
        single, sout = tt.tick(sparams, single, 1000)
        for f in ("fired", "fired_stage", "deleted"):
            a = np.asarray(getattr(jout, f))
            b = getattr(tout, f).to_host().numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (t, f)
            assert np.array_equal(b, getattr(sout, f).numpy()), (t, f)
        assert tout.fired_count.dtype == torch.int32
        assert int(tout.fired_count) == int(jout.fired_count) == int(sout.fired_count), t
        totals[0] += int(tout.fired_count)
        totals[1] += sum(int(p.sum()) for p in tout.fired.parts)
        assert_soa_same(js, ts, t)
    assert totals[0] == totals[1] > 0


def test_sharded_run_ticks_matches_jax():
    (jp, js), (tp, ts), _ = start("pod-general+pod-chaos")
    js, jcount = jm.sharded_run_ticks(jax_mesh(), dt_ms=500, num_ticks=20)(jp, js)
    ts, tcount = tm.sharded_run_ticks(cpu_mesh(), dt_ms=500, num_ticks=20)(tp, ts)
    assert tcount.dtype == torch.int32 and tcount.shape == ()
    assert int(tcount) == int(jcount) > 0
    assert_soa_same(js, ts)


def test_row_sharding_layout():
    (jp, js), (tp, ts), (pd, sd) = start("pod-fast")
    src = tt.soa_from_numpy(sd, "cpu")
    tp, ts = tm.place(tt.params_from_numpy(pd, "cpu"), src, cpu_mesh())
    src.features.fill_(-1)  # the shards are copies, not views of the source
    per = N // SHARDS
    # shard i holds rows [i*n/8, (i+1)*n/8), as XLA's row sharding does
    assert ts.offsets == tuple(range(0, N, per)) and ts.n_rows == N
    jshards = sorted(js.features.addressable_shards, key=lambda s: s.index[0].start or 0)
    assert len(ts.shards) == len(jshards) == SHARDS
    for i, (shard, jshard) in enumerate(zip(ts.shards, jshards)):
        rows = slice(i * per, (i + 1) * per)
        assert np.array_equal(shard.features.numpy(), np.asarray(jshard.data))
        for f in ROW_FIELDS:
            assert np.array_equal(getattr(shard, f).numpy(), sd[f][rows]), (i, f)
    # params on every shard, replicated
    assert len(tp) == SHARDS and len(jp.w_static.sharding.device_set) == SHARDS
    for p in tp:
        for f in p._fields:
            assert np.array_equal(getattr(p, f).numpy(), pd[f]), f


def churn_pods(start_i):
    return [pod(start_i + k, labels=CHAOS) for k in range(3)]


def pick_live(sim, t, n, avoid=()):
    """``n`` rows whose objects are live and not deleting, chosen from the
    JAX simulator's mirror.  Rows the FSM has deleted are never touched:
    a host write to such a row diverges between the mesh and the
    single-device paths in the JAX package as well (ROADMAP queue 3)."""
    rows = []
    r = (t * 13) % sim.num_rows
    while len(rows) < n:
        obj = sim.objects[r]
        if obj is not None and "deletionTimestamp" not in obj["metadata"] and r not in avoid:
            rows.append(r)
        r = (r + 7) % sim.num_rows
    return rows


def test_simulator_mesh_trajectory_matches_jax_and_single():
    """DeviceSimulator on a mesh (the device backend's multi-device mode),
    with admits, releases and deletes between ticks, against the JAX
    sharded simulator and the port's unsharded one."""
    jax_stages = stages("pod-general+pod-chaos", load_builtin)
    port_stages = stages("pod-general+pod-chaos", torch_load)
    j = JaxSim(jax_stages, capacity=N, seed=5, mesh=jax_mesh())
    m = TorchSim(port_stages, capacity=N, seed=5, mesh=cpu_mesh())
    s = TorchSim(port_stages, capacity=N, seed=5, device="cpu")
    sims = (j, m, s)
    for i in range(N - 8):
        obj = POD_KINDS[i % len(POD_KINDS)](i)
        for sim in sims:
            sim.admit(obj)
    fired = 0
    for t in range(40):
        keys = [[(tr.row, tr.stage_name, tr.t_ms, tr.deleted) for tr in sim.step(dt_ms=500)]
                for sim in sims]
        assert keys[0] == keys[1] == keys[2], t
        fired += len(keys[0])
        if t % 6 == 2:
            released = pick_live(j, t, 2)
            deleting = pick_live(j, t + 1, 2, avoid=released)
            admitted = []
            for sim in sims:
                for r in released:
                    sim.release(r)
                for r in deleting:
                    sim.request_delete(r, sim.now_ms + 1500)
                admitted.append([sim.admit(obj) for obj in churn_pods(1000 + 10 * t)])
            # released rows are reused first, in the same order
            assert admitted[0] == admitted[1] == admitted[2], t
            assert set(released) <= set(admitted[0]), t
    assert fired > N
    for sim in sims:
        sim._ensure_synced()
    for f in ROW_FIELDS:
        a, b, c = (getattr(sim, f) for sim in sims)
        assert np.array_equal(a, b) and np.array_equal(b, c), f
    assert j.objects == m.objects == s.objects
    assert (j.num_rows, j._free, j.now_ms) == (m.num_rows, m._free, m.now_ms) == (
        s.num_rows, s._free, s.now_ms)
    # the mesh simulator's device state, read shard by shard in row order
    _, soa = m.to_device()
    assert isinstance(soa, tm.ShardedSoA) and len(soa.shards) == SHARDS
    assert np.array_equal(soa.column("stage").to_host().numpy(), s.stage)


def test_simulator_mesh_capacity_rounds_to_shards():
    sim = TorchSim(torch_load("pod-fast"), capacity=10, seed=0, mesh=cpu_mesh())
    jsim = JaxSim(load_builtin("pod-fast"), capacity=10, seed=0, mesh=jax_mesh())
    assert sim.capacity == jsim.capacity and sim.capacity % SHARDS == 0
    # growth keeps divisibility
    sim.ensure_capacity(sim.capacity + 1)
    jsim.ensure_capacity(jsim.capacity + 1)
    assert sim.capacity == jsim.capacity and sim.capacity % SHARDS == 0
    with pytest.raises(ValueError, match="tick_many_async"):
        sim.tick_many_async(100, 8)


def test_controller_device_backend_on_mesh():
    """The Controller with the device backend sharded over 8 CPU shards:
    pods reach Running through sharded ticks."""
    store = ResourceStore()
    ctr = Controller(
        store,
        KwokConfiguration(
            manage_all_nodes=True,
            backend="device",
            device_mesh_devices=SHARDS,
            device_tick_ms=20,
            node_lease_duration_seconds=0,
        ),
        local_stages={"Node": default_node_stages(), "Pod": default_pod_stages()},
        seed=0,
        device="cpu",
    )
    tm.sharded_tick.launches = 0
    ctr.start()
    try:
        store.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n0"},
                      "spec": {}, "status": {}})
        for i in range(16):
            store.create({
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {"name": f"p{i}", "namespace": "default"},
                "spec": {"nodeName": "n0", "containers": [{"name": "c", "image": "i"}]},
                "status": {},
            })
        assert ctr.device_players, "device backend should be active"
        sim = ctr.device_players["Pod"].sim
        assert sim.mesh is not None and sim.mesh.size == SHARDS

        def all_running():
            pods, _ = store.list("Pod")
            return len(pods) == 16 and all(
                (p.get("status") or {}).get("phase") == "Running" for p in pods)

        deadline = time.monotonic() + 60
        while not all_running() and time.monotonic() < deadline:
            time.sleep(0.2)
        assert all_running(), [(p["metadata"]["name"], p.get("status", {}).get("phase"))
                               for p in store.list("Pod")[0]]
    finally:
        ctr.stop()
    # CPU shards take the plain version: no kernel launch is counted
    assert tm.sharded_tick.launches == 0


def test_row_offset_changes_draws():
    """Row i of a shard draws with its global index: the plain version
    with the offset equals JAX's draws of the same rows, and differs
    from the draws at offset 0."""
    key = prng.prng_key(17, "cpu")
    jkey = jax.random.PRNGKey(17)
    full = np.asarray(jax.random.uniform(jkey, (96,)))
    for off in (0, 8, 40):
        got = prng.uniform(key, 32, off).numpy()
        assert np.array_equal(got, full[off:off + 32]), off
        assert np.array_equal(prng.bits(key, 32, off).numpy().astype(np.uint32),
                              np.asarray(jax.random.bits(jkey, (96,)))[off:off + 32])
    assert not np.array_equal(prng.uniform(key, 32, 40).numpy(), full[:32])
    with pytest.raises(ValueError, match="uint32"):
        prng.uniform(key, 4, 2**32 - 2)

    # the tick: one shard at offset 32 of a 64-row state equals rows
    # 32..63 of JAX's unsharded tick, and not the same block ticked as
    # if it were rows 0..31
    sim = JaxSim(stages("pod-general+pod-chaos", load_builtin), capacity=N, seed=3)
    for i in range(N):
        sim.admit(pod(i, labels=CHAOS))
    jp, js = sim.to_device()
    pd, sd = np_dict(jp), np_dict(js)
    from kwok_tpu.ops.tick import tick as jtick

    for _ in range(3):
        js, jout = jtick(jp, js, 1000)
    want = np.asarray(js.stage)[32:]
    params = tt.params_from_numpy(pd, "cpu")
    block = {f: (v[32:] if f in ROW_FIELDS else v) for f, v in sd.items()}
    shard, plain = tt.soa_from_numpy(block, "cpu"), tt.soa_from_numpy(block, "cpu")
    for _ in range(3):
        shard, _ = tt._tick_impl(params, shard, 1000, row_offset=32)
        plain, _ = tt._tick_impl(params, plain, 1000)
    assert np.array_equal(shard.stage.numpy(), want)
    assert np.array_equal(shard.fire_at.numpy(), np.asarray(js.fire_at)[32:])
    assert not np.array_equal(plain.fire_at.numpy(), np.asarray(js.fire_at)[32:])


def test_make_mesh_guards():
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="mesh wants 2 devices"):
            tm.make_mesh(2)
    with pytest.raises(ValueError, match="at least one device"):
        tm.make_mesh(devices=[])
    with pytest.raises(ValueError, match="one kind"):
        tm.make_mesh(devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="given 3"):
        tm.make_mesh(2, devices=["cpu"] * 3)
    mesh = cpu_mesh(3)
    assert mesh.size == mesh.devices.size == 3 and list(mesh.local_shards) == [0, 1, 2]
    sim = TorchSim(torch_load("pod-fast"), capacity=4, device="cpu")
    params, soa = sim.to_device()
    with pytest.raises(ValueError, match="pad_rows"):
        tm.place(params, soa, mesh)
    four = cpu_mesh(4)
    with pytest.raises(ValueError, match="3 local shards"):
        tm.sharded_tick(mesh)(tm.replicate(params, four), tm.shard_rows(soa, four))
