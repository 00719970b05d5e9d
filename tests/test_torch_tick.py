"""kwok_tpu_torch.ops.tick equals kwok_tpu.ops.tick bit for bit.

Both packages start from the same state (the JAX simulator's params and
SoA carried across as numpy through params_from_numpy/soa_from_numpy)
and run tick, run_ticks_collect, run_ticks and scatter_rows; every
output field must be equal after every call.  The port runs on the CPU
here, i.e. the plain PyTorch versions of the kernels; chip_smoke.py
holds the CUDA kernels against the same plain versions on the card.

The trap tests pin the places where a port goes wrong quietly: float32
truncation, the uniform's bit recipe, argmax's first-true rule, int32
wrap (of clocks, of the weight total and of the running sum), the int8
fired stage, clamped gathers, the rematch flag, the clock and key,
memory shared between numpy and torch, and choices on both sides of
the kernel's 32-stage chunks.  The adversarial tables are the ones
chip_smoke.py holds the kernel against on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ADV_KC, ADV_S, ADV_WIDE_S, adversarial_tables
from kwok_tpu.engine.simulator import DeviceSimulator as JaxSim
from kwok_tpu.ops import tick as jt
from kwok_tpu.stages import default_node_stages, load_builtin
from kwok_tpu_torch.engine.compiler import IDLE, NEVER, SENTINEL
from kwok_tpu_torch.engine.simulator import DeviceSimulator as TorchSim
from kwok_tpu_torch.ops import tick as tt
from kwok_tpu_torch.stages import load_builtin as torch_load_builtin

N = 256
DT = 100


def pod(i, *, job=False, init=False, labels=None, annotations=None, deleting=False):
    meta = {"name": f"p{i}", "namespace": "d", "uid": f"u{i}"}
    if job:
        meta["ownerReferences"] = [{"kind": "Job", "name": "j"}]
    if labels:
        meta["labels"] = labels
    if annotations:
        meta["annotations"] = annotations
    if deleting:
        meta["deletionTimestamp"] = "2026-01-01T00:00:03Z"
        meta["finalizers"] = ["kwok.x-k8s.io/fake"]
    spec = {"nodeName": "n0", "containers": [{"name": "c", "image": "img"}]}
    if init:
        spec["initContainers"] = [{"name": "ic", "image": "img"}]
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta, "spec": spec, "status": {}}


CHAOS = {"pod-container-running-failed.stage.kwok.x-k8s.io": "true"}
OVERRIDES = {
    "pod-create.stage.kwok.x-k8s.io/delay": "2s",
    "pod-create.stage.kwok.x-k8s.io/jitter-delay": "7s",
    "pod-ready.stage.kwok.x-k8s.io/weight": "3",
    "pod-init-container-running.stage.kwok.x-k8s.io/delay": "250ms",
}

POD_KINDS = [
    lambda i: pod(i),
    lambda i: pod(i, job=True),
    lambda i: pod(i, init=True),
    lambda i: pod(i, labels=CHAOS),
    lambda i: pod(i, annotations=OVERRIDES),
    lambda i: pod(i, labels=CHAOS, annotations=OVERRIDES, init=True),
    lambda i: pod(i, deleting=True),
    lambda i: pod(i, job=True, deleting=True),
]


def node(i):
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": f"n{i}", "creationTimestamp": "2026-01-01T00:00:00Z"},
        "status": {},
    }


SETS = {
    "pod-fast": lambda: load_builtin("pod-fast"),
    "pod-general": lambda: load_builtin("pod-general"),
    "pod-general+pod-chaos": lambda: load_builtin("pod-general") + load_builtin("pod-chaos"),
    "node-default-lease": lambda: default_node_stages(lease=True),
}


def np_dict(nt):
    return {k: np.array(v) for k, v in nt._asdict().items()}


def start(set_name, n=N, seed=3):
    """JAX params/SoA for a mixed population, plus their numpy copies."""
    sim = JaxSim(SETS[set_name](), capacity=n, seed=seed)
    for i in range(n):
        sim.admit(node(i) if set_name.startswith("node") else POD_KINDS[i % len(POD_KINDS)](i))
    jp, js = sim.to_device()
    return jp, js, np_dict(jp), np_dict(js)


def to_torch(pd, sd):
    return tt.params_from_numpy(pd, "cpu"), tt.soa_from_numpy(sd, "cpu")


def to_jax(d, cls):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def assert_same(jax_nt, torch_nt, what=""):
    for f in jax_nt._fields:
        a = np.asarray(getattr(jax_nt, f))
        b = getattr(torch_nt, f).numpy()
        assert a.dtype == b.dtype, (what, f, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, f, np.argwhere(a != b)[:5])


def mid_run_batch(soa, rng):
    """Admits (copies of other rows), deletes (deadline 1.5 s ahead) and
    host rematches, padded to a power of two by repeating the first row."""
    n = soa.features.shape[0]
    k = 24
    rows = rng.choice(n, k, replace=False).astype(np.int32)
    src = rng.choice(n, k)
    now = int(soa.now)
    kind = np.arange(k) % 3  # 0 admit, 1 delete, 2 host rematch
    feats = soa.features.numpy()
    b = dict(
        rows=rows,
        features=np.where((kind == 0)[:, None], feats[src], feats[rows]),
        sig=np.where(kind == 0, soa.sig.numpy()[src], soa.sig.numpy()[rows]),
        ovc=np.where(kind == 0, soa.ovc.numpy()[src], soa.ovc.numpy()[rows]),
        stage=np.full(k, IDLE),
        fire_at=np.full(k, NEVER),
        active=np.ones(k, bool),
        rematch=np.ones(k, bool),
        del_ts=np.where(kind == 1, now + 1500, soa.del_ts.numpy()[rows]),
    )
    pad = np.concatenate([np.arange(k), np.zeros(32 - k, np.int64)])
    return [np.ascontiguousarray(b[f][pad]).astype(
        np.bool_ if f in ("active", "rematch") else np.int32) for f in b]


def scatter_both(js, ts, batch):
    js = jt.scatter_rows(js, *[jnp.asarray(a) for a in batch])
    ts = tt.scatter_rows(ts, *[torch.from_numpy(a) for a in batch])
    assert_same(js, ts, "scatter_rows")
    return js, ts


@pytest.mark.parametrize("set_name", list(SETS))
def test_tick_matches_jax(set_name):
    jp, js, pd, sd = start(set_name)
    tp, ts = to_torch(pd, sd)
    rng = np.random.default_rng(0)
    fired = 0
    for t in range(60):
        if t in (15, 35):
            js, ts = scatter_both(js, ts, mid_run_batch(ts, rng))
        js, jo = jt.tick(jp, js, DT)
        ts, to = tt.tick(tp, ts, DT)
        assert_same(jo, to, f"tick {t} out")
        assert_same(js, ts, f"tick {t} soa")
        fired += int(to.fired_count)
    assert fired > 0


@pytest.mark.parametrize("set_name", list(SETS))
def test_run_ticks_collect_matches_jax(set_name):
    jp, js, pd, sd = start(set_name, seed=11)
    tp, ts = to_torch(pd, sd)
    rng = np.random.default_rng(1)
    for m in range(7):
        if m == 3:
            js, ts = scatter_both(js, ts, mid_run_batch(ts, rng))
        js, jst = jt.run_ticks_collect(jp, js, DT, 8)
        ts, tst = tt.run_ticks_collect(tp, ts, DT, 8)
        assert tst.dtype == torch.int8 and tst.shape == (8, N)
        assert np.array_equal(np.asarray(jst), tst.numpy()), m
        assert_same(js, ts, f"macro {m}")


@pytest.mark.parametrize("set_name", list(SETS))
def test_run_ticks_matches_jax(set_name):
    jp, js, pd, sd = start(set_name, seed=5)
    tp, ts = to_torch(pd, sd)
    js, jc = jt.run_ticks(jp, js, DT, 50)
    ts, tc = tt.run_ticks(tp, ts, DT, 50)
    assert tc.dtype == torch.int32 and int(tc) == int(jc) > 0
    assert_same(js, ts, "run_ticks")


@pytest.mark.parametrize("KC", ADV_KC)
@pytest.mark.parametrize("S", ADV_S + (ADV_WIDE_S,))
def test_adversarial_table_matches_jax(S, KC):
    """Hand-built tables: stage counts on both sides of the row kernel's
    segment widths and 32-stage chunks, one and seven conditions a
    stage, weights that are 0, negative, overridden, SENTINEL or large
    enough to wrap the total, several signatures and override classes
    with effects, a ragged row count."""
    pd, sd = adversarial_tables(S, KC, 300, 100 * S + KC)
    ts, _ = tick_both(pd, sd, ticks=3)
    jp, js = to_jax(pd, jt.TickParams), to_jax(sd, jt.SoA)
    tp, ts = to_torch(pd, sd)
    js, jst = jt.run_ticks_collect(jp, js, DT, 8)
    ts, tst = tt.run_ticks_collect(tp, ts, DT, 8)
    assert np.array_equal(np.asarray(jst), tst.numpy())
    assert_same(js, ts, "run_ticks_collect")
    if S <= 33:  # XLA compiles the fori loop for ~14 s on a CPU at 126 x 7
        js, jc = jt.run_ticks(jp, js, DT, 20)
        ts, tc = tt.run_ticks(tp, ts, DT, 20)
        assert int(jc) == int(tc) > 0
        assert_same(js, ts, "run_ticks")


# ------------------------------------------------------------------- traps


def hand_params(S, K=1, C=1, **over):
    d = dict(
        cond_col=np.zeros((S, K), np.int32),
        cond_mask=np.zeros((S, K), np.int32),
        cond_neg=np.zeros((S, K), bool),
        cond_valid=np.zeros((S, K), bool),
        w_static=np.ones(S, np.int32),
        d_static=np.zeros(S, np.int32),
        j_static=np.full(S, SENTINEL, np.int32),
        has_jitter=np.zeros(S, bool),
        d_from_del_ts=np.zeros(S, bool),
        j_from_del_ts=np.zeros(S, bool),
        stage_delete=np.zeros(S, bool),
        eff_mode=np.zeros((1, S, C), np.int32),
        eff_val=np.zeros((1, S, C), np.int32),
        ov_w=np.full((1, S), SENTINEL, np.int32),
        ov_d=np.full((1, S), SENTINEL, np.int32),
        ov_j=np.full((1, S), SENTINEL, np.int32),
    )
    d.update({k: np.asarray(v, d[k].dtype) for k, v in over.items()})
    return d


def hand_soa(n, C=1, now=0, seed=0, **over):
    d = dict(
        features=np.zeros((n, C), np.int32),
        sig=np.zeros(n, np.int32),
        ovc=np.zeros(n, np.int32),
        stage=np.full(n, IDLE, np.int32),
        fire_at=np.full(n, NEVER, np.int32),
        active=np.ones(n, bool),
        rematch=np.ones(n, bool),
        del_ts=np.full(n, SENTINEL, np.int32),
        now=np.array(now, np.int32),
        key=np.array([0, seed], np.uint32),
    )
    d.update({k: np.asarray(v, d[k].dtype) for k, v in over.items()})
    return d


def tick_both(pd, sd, ticks=1):
    jp, js = to_jax(pd, jt.TickParams), to_jax(sd, jt.SoA)
    tp, ts = to_torch(pd, sd)
    for t in range(ticks):
        js, jo = jt.tick(jp, js, DT)
        ts, to = tt.tick(tp, ts, DT)
        assert_same(jo, to, f"tick {t} out")
        assert_same(js, ts, f"tick {t} soa")
    return ts, to


def test_trap_float32_truncation_in_choice():
    """r = int32(u * float32(ptot)): float32(2**25 + 3) rounds up to
    2**25 + 4, so u = 0.5 gives r = 2**24 + 2 and picks stage 1, where
    exact arithmetic gives r = 2**24 + 1 and picks stage 0."""
    match = np.ones((1, 2), bool)
    weights = np.array([[2**24 + 2, 2**24 + 1]], np.int32)
    u = np.array([0.5], np.float32)
    js, _ = jt._weighted_choice(jnp.asarray(match), jnp.asarray(weights), jnp.asarray(u))
    ts, _ = tt._weighted_choice(torch.from_numpy(match), torch.from_numpy(weights), torch.from_numpy(u))
    assert int(js[0]) == int(ts[0]) == 1
    exact_r = int(np.float64(u[0]) * int(weights.sum()))
    assert int(np.argmax(np.cumsum(weights[0]) > exact_r)) == 0


def test_trap_float32_truncation_in_jitter():
    """jittered = d + int32(uj * float32(span)) with spans past float32's
    exact integers."""
    S = 1
    pd = hand_params(S, has_jitter=[True], d_static=[7], j_static=[2**24 + 11])
    tick_both(pd, hand_soa(512, seed=4), ticks=1)
    ts, _ = tick_both(pd, hand_soa(512, seed=9, now=5), ticks=1)
    assert (ts.fire_at.numpy() > 2**20).any()


def test_trap_argmax_first_true():
    """Ties in cum > r resolve to the first index; zero total weight falls
    back to uniform-among-matched; no match gives IDLE."""
    rng = np.random.default_rng(0)
    n, S = 512, 6
    match = rng.random((n, S)) < 0.5
    match[:32] = False
    weights = rng.integers(-2, 3, (n, S)).astype(np.int32)
    weights[32:64] = 0
    u = rng.random(n).astype(np.float32)
    ja, jm = jt._weighted_choice(jnp.asarray(match), jnp.asarray(weights), jnp.asarray(u))
    ta, tm = tt._weighted_choice(*(torch.from_numpy(x) for x in (match, weights, u)))
    assert np.array_equal(np.asarray(ja), ta.numpy()) and np.array_equal(np.asarray(jm), tm.numpy())
    assert (ta.numpy()[:32] == IDLE).all() and ta.dtype == torch.int32


def test_trap_int32_wrap():
    """now + delay and del_ts - now wrap in int32 as in XLA."""
    S = 2
    pd = hand_params(S, d_static=[2**31 - 10, 5], d_from_del_ts=[False, True],
                     w_static=[1, 1], has_jitter=[True, False], j_static=[2**31 - 1, SENTINEL])
    n = 64
    sd = hand_soa(n, now=2**31 - 250, seed=2,
                  del_ts=np.where(np.arange(n) % 2 == 0, -(2**31) + 10, SENTINEL))
    tick_both(pd, sd, ticks=4)


def test_trap_cumulative_weight_wrap():
    """The weight total and the running sum are int32 sums that wrap.
    Override class 0 weighs three matched stages [2**31 - 1, 2**31 - 1,
    5]: the total wraps to 3 > 0, so the choice is weighted, and the
    running sum [2**31 - 1, -2, 3] passes every r in [0, 3) at stage 0
    (exact sums would pick stage 1 for about half the rows).  Class 1
    weighs [2**31 - 1, 2, 0]: the total wraps to -(2**31) + 1 <= 0, so
    the choice falls back to uniform among the three matched stages."""
    S, n = 3, 512
    pd = hand_params(S, d_static=[100, 200, 300],
                     ov_w=[[2**31 - 1, 2**31 - 1, 5], [2**31 - 1, 2, 0]],
                     ov_d=np.full((2, S), SENTINEL), ov_j=np.full((2, S), SENTINEL))
    sd = hand_soa(n, seed=12, ovc=np.arange(n) % 2)
    ts, _ = tick_both(pd, sd, ticks=1)
    stage = ts.stage.numpy()
    assert (stage[0::2] == 0).all()
    assert set(stage[1::2].tolist()) == {0, 1, 2}


@pytest.mark.parametrize("S", [16, 17, 31, 32, 33, 64, 65])
def test_trap_choice_at_segment_boundary(S):
    """Only the stages on both sides of the kernel's 16- and 32-stage
    boundaries and the last two match; every one of them is chosen by
    some row, the same one on both packages."""
    hits = sorted({s for s in (15, 16, 31, 32, S - 2, S - 1) if s < S})
    mask = np.full((S, 1), 2, np.int32)
    mask[hits] = 1
    pd = hand_params(S, cond_valid=np.ones((S, 1), bool), cond_mask=mask,
                     w_static=np.arange(1, S + 1), d_static=np.full(S, 100, np.int32))
    n = 512
    ts, _ = tick_both(pd, hand_soa(n, seed=S, features=np.ones((n, 1))), ticks=1)
    assert sorted(set(ts.stage.numpy().tolist())) == hits


def test_trap_int8_fired_stage_and_idle():
    """run_ticks_collect stores the fired stage as int8 (stage 150 wraps
    to -106, as XLA's convert does) and IDLE as -1."""
    S = 200
    w = np.zeros(S, np.int32)
    w[150] = 1
    pd = hand_params(S, w_static=w, d_static=np.full(S, 100, np.int32))
    sd = hand_soa(8, seed=1, active=[True] * 7 + [False])
    jp, js = to_jax(pd, jt.TickParams), to_jax(sd, jt.SoA)
    tp, ts = to_torch(pd, sd)
    js, jst = jt.run_ticks_collect(jp, js, DT, 4)
    ts, tst = tt.run_ticks_collect(tp, ts, DT, 4)
    assert tst.dtype == torch.int8
    assert np.array_equal(np.asarray(jst), tst.numpy())
    assert set(tst.numpy().ravel().tolist()) == {IDLE, 150 - 256}
    assert_same(js, ts)


def test_trap_clamped_gathers_for_idle_and_unmatched_rows():
    """stage_c and ns_c clamp to [0, S-1] before every gather, also for
    IDLE rows and rows that match nothing."""
    S, C = 3, 2
    pd = hand_params(
        S, K=1, C=C, cond_valid=[[True]] * S, cond_col=[[1]] * S,
        cond_mask=[[1], [2], [4]], d_static=[10, 20, 30], stage_delete=[False, False, True],
        eff_mode=np.ones((1, S, C)), eff_val=[[[1, 2], [1, 4], [0, 0]]],
        ov_d=[[SENTINEL, 5, SENTINEL]],
    )
    n = 96
    rng = np.random.default_rng(3)
    sd = hand_soa(n, C=C, seed=6, features=rng.integers(0, 8, (n, C)),
                  stage=rng.integers(-1, S, n), fire_at=rng.integers(0, 300, n),
                  rematch=rng.random(n) < 0.5)
    tick_both(pd, sd, ticks=6)


def test_trap_rematch_cleared_now_and_key_advanced():
    jp, js, pd, sd = start("pod-fast", n=32)
    tp, ts = to_torch(pd, sd)
    assert ts.rematch.any()
    ts, _ = tt.run_ticks_collect(tp, ts, DT, 8)
    js, _ = jt.run_ticks_collect(jp, js, DT, 8)
    assert not ts.rematch.any()
    assert int(ts.now) == int(sd["now"]) + 8 * DT
    assert np.array_equal(np.asarray(js.key), ts.key.numpy())
    assert ts.key.dtype == torch.uint32


def test_trap_host_mirror_never_shares_memory():
    """to_device copies the host arrays and _ensure_synced copies back:
    the in-place plain tick must never move the host mirror."""
    sim = TorchSim(torch_load_builtin("pod-fast"), capacity=8, device="cpu")
    row = sim.admit(pod(0))
    _, soa = sim.to_device()
    for f in ("features", "stage", "fire_at", "active", "rematch"):
        assert not np.shares_memory(getattr(sim, f), getattr(soa, f).numpy()), f
    before = sim.stage.copy()
    sim.tick_many(DT, 1)  # arms pod-ready on the device
    assert np.array_equal(sim.stage, before)  # stale until synced
    sim._ensure_synced()
    for f in ("features", "stage", "fire_at", "active", "rematch"):
        assert not np.shares_memory(getattr(sim, f), getattr(sim._soa, f).numpy()), f
    assert sim.stage[row] != before[row]


def test_trap_fresh_output_per_macro_tick():
    sim = TorchSim(torch_load_builtin("pod-fast"), capacity=8, device="cpu")
    sim.admit(pod(0, job=True))
    a, _ = sim.tick_many_async(DT, 4)
    kept = a.clone()
    b, _ = sim.tick_many_async(DT, 4)
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, kept)


def test_scatter_rows_duplicates_and_empty_batch():
    jp, js, pd, sd = start("pod-general", n=64)
    tp, ts = to_torch(pd, sd)
    batch = mid_run_batch(ts, np.random.default_rng(7))
    assert len(set(batch[0].tolist())) < len(batch[0])
    scatter_both(js, ts, batch)
    empty = [a[:0] for a in batch]
    assert tt.scatter_rows(ts, *[torch.from_numpy(a) for a in empty]) is ts


@pytest.mark.parametrize("bad_row", [-1, 64, 2**31 - 1])
def test_scatter_rows_refuses_rows_outside_the_soa(bad_row):
    """Both routes raise on a row outside [0, N) before writing anything."""
    _, _, pd, sd = start("pod-general", n=64)
    _, ts = to_torch(pd, sd)
    batch = [torch.from_numpy(a) for a in mid_run_batch(ts, np.random.default_rng(7))]
    batch[0] = batch[0].clone()
    batch[0][-1] = bad_row
    before = [t.clone() for t in ts]
    with pytest.raises(IndexError, match="outside"):
        tt.scatter_rows(ts, *batch)
    assert all(torch.equal(a, b) for a, b in zip(before, ts))


# ------------------------------------------------------------ the packed batch

MIRROR = ("features", "sig", "ovc", "stage", "fire_at", "active", "rematch", "del_ts")


def scatter_case(n, C, B, seed):
    """A seeded SoA of n rows and C feature columns (numpy, by field) and
    a batch of B rows in any order: duplicate rows carry equal values, and
    both bool columns mix True and False."""
    rng = np.random.default_rng(seed)
    i32 = lambda *shape: rng.integers(-(2**31), 2**31, shape).astype(np.int32)  # noqa: E731
    sd = dict(features=i32(n, C), sig=i32(n), ovc=i32(n), stage=i32(n), fire_at=i32(n),
              active=rng.random(n) < 0.5, rematch=rng.random(n) < 0.5, del_ts=i32(n),
              now=np.array(5, np.int32), key=np.array([0, seed], np.uint32))
    uniq = rng.choice(n, max(1, B * 3 // 4), replace=False).astype(np.int32)
    pick = rng.integers(0, len(uniq), B)
    u = len(uniq)
    vals = [i32(u, C), i32(u), i32(u), i32(u), i32(u), rng.random(u) < 0.5,
            rng.random(u) < 0.5, i32(u)]
    return sd, [uniq[pick]] + [v[pick] for v in vals]


@pytest.mark.parametrize("C", [2, 13, 17])
@pytest.mark.parametrize("B", [1, 3, 4097])
def test_packed_batch_and_plain_version_match_jax(C, B):
    """The plain version (from numpy arrays and from CPU tensors) and the
    pack routine (the batch itself, and gathered from whole host columns)
    leave the SoA that JAX's _scatter_rows_impl leaves: unpadded, every
    segment 16-byte aligned."""
    n = 5_000
    sd, batch = scatter_case(n, C, B, seed=100 * C + B)
    assert B < 3 or len(set(batch[0].tolist())) < B  # duplicates
    want = jt._scatter_rows_impl(to_jax(sd, jt.SoA), *[jnp.asarray(a) for a in batch])
    assert_same(want, tt.scatter_rows(tt.soa_from_numpy(sd, "cpu"), *batch), "numpy batch")
    got = tt.scatter_rows(tt.soa_from_numpy(sd, "cpu"), *[torch.from_numpy(a) for a in batch])
    assert_same(want, got, "tensor batch")
    packed = tt.pack_batch(batch[0], batch[1:], n, "cpu")
    assert packed.layout.B == B and packed.layout.C == C
    assert all(off % 16 == 0 for off in packed.layout.offsets)
    assert_same(want, tt.scatter_packed(tt.soa_from_numpy(sd, "cpu"), packed), "packed")
    mirror = [sd[f].copy() for f in MIRROR]
    for col, v in zip(mirror, batch[1:]):
        col[batch[0]] = v
    packed = tt.pack_batch(batch[0], mirror, n, "cpu", take=True)
    assert_same(want, tt.scatter_packed(tt.soa_from_numpy(sd, "cpu"), packed), "gathered")


@pytest.mark.parametrize("bad_row", [-1, 64, 2**31 - 1])
def test_pack_refuses_rows_outside_the_soa(bad_row):
    """The host range check comes before anything is packed or copied."""
    sd, batch = scatter_case(64, 13, 16, seed=1)
    batch[0][5] = bad_row
    with pytest.raises(IndexError, match="outside"):
        tt.pack_batch(batch[0], batch[1:], 64, "cpu")
    with pytest.raises(IndexError, match="outside"):
        tt.pack_batch(batch[0], [sd[f] for f in MIRROR], 64, "cpu", take=True)


def test_pack_refuses_other_dtypes_and_shapes():
    sd, batch = scatter_case(64, 13, 16, seed=2)
    with pytest.raises(TypeError, match="rows"):
        tt.pack_batch(batch[0].astype(np.int64), batch[1:], 64, "cpu")
    with pytest.raises(TypeError, match="active"):
        tt.pack_batch(batch[0], batch[1:6] + [batch[6].astype(np.uint8)] + batch[7:], 64, "cpu")
    with pytest.raises(TypeError, match="features"):
        tt.pack_batch(batch[0], [sd[f] for f in MIRROR], 64, "cpu")  # whole columns, no take


def test_scatter_rows_refuses_a_batch_off_the_host():
    """The batch crosses to the card in the wrapper's one copy: a batch
    already on a device is refused, not moved (chip_smoke.py and
    tests/test_torch_isolation.py check a batch on the card)."""
    _, ts = to_torch(*start("pod-general", n=64)[2:])
    batch = [torch.from_numpy(a) for a in mid_run_batch(ts, np.random.default_rng(7))]
    batch[1] = batch[1].to("meta")
    with pytest.raises(ValueError, match="host memory"):
        tt.scatter_rows(ts, *batch)
