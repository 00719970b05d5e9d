#!/usr/bin/env python3
"""Start the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. environment: the card's name and power limit, torch and CUDA
   versions; build the kernels from ``kwok_tpu_torch/csrc`` with nvcc;
2. every kernel against its plain PyTorch version on the card, bit for
   bit (``torch.equal``: the FSM is integer-exact and the PRNG is
   reproduced), on seeded random states of three stage sets at
   N = 4,096 and N = 1,000,003;
3. the main path through ``DeviceSimulator`` at full width: 1,000,000
   pods of pod-general + pod-chaos and 10,000 nodes of the default lease
   node stages (as the reference ``bench.py`` builds them): macro-ticks
   of K=8 with admits, deletes and releases between them, every
   transition of 1,000 sampled rows materialized in order and their
   feature parity checked, a 1,000,000-pod simulator on a synthetic
   128-stage set (only to cover the per-tick int32 branch for more than
   126 stages), then macro-ticks timed for 10 s and a bench-style
   ``run_ticks`` window;
   every kernel's launch count must be positive;
4. each kernel timed at the main path's shapes beside its plain version
   and its bound, printed as one ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the ``kwok_tpu_torch`` package beside this file, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

N_PODS = 1_000_000
N_NODES = 10_000
DT_MS = 100
MACRO_K = 8
BENCH_TICKS = 600
TIMED_S = 10.0
CHURN = 10_000
SAMPLE = 1_000
WIDE_STAGES = 128
WIDE_TAGGED = 1_000
PARITY_NS = (4_096, 1_000_003)

# Least-time model: H100 SXM, 3.35 TB/s HBM.
# The integer pipe has 64 INT32 lanes per SM (Hopper white paper), half
# the float32 width behind the card's 67 TFLOP/s, with no FMA doubling:
# 132 SMs x 64 lanes x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# The operation count is a floor, so that the bound stays a least time:
# per row and tick the fire test (3: compare, two ands); per rematching
# row one match pass (3 per condition: and, compare with the negation
# folded in, and into the match) and one draw (threefry2x32: 2 + 20 rounds
# x 3 + 5 key injections x 2, then 3 to make the float).  The jitter draw
# and the choice pass are not counted.
DRAW_OPS = 2 + 20 * 3 + 5 * 2 + 3
COND_OPS = 3
ROW_TICK_OPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 1


def phase_environment():
    from kwok_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    secs = kernels.build()
    log(f"build: {secs:.1f} s for {', '.join(kernels.SOURCES)}")
    for src, text in kernels.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")
    return smi


# ------------------------------------------------------------------ phase 2


def new_pod(i=0, owner_job=False, init_containers=False, annotations=None):
    pod = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"pod-{i}",
            "namespace": "default",
            "uid": f"uid-{i}",
            "labels": {"pod-container-running-failed.stage.kwok.x-k8s.io": "true"},
        },
        "spec": {"nodeName": "node", "containers": [{"name": "app", "image": "fake"}]},
        "status": {},
    }
    if owner_job:
        pod["metadata"]["ownerReferences"] = [{"kind": "Job", "name": "job"}]
    if init_containers:
        pod["spec"]["initContainers"] = [{"name": "init", "image": "fake"}]
    if annotations:
        pod["metadata"]["annotations"] = annotations
    return pod


def new_node():
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": "node", "creationTimestamp": "2026-01-01T00:00:00Z"},
        "status": {},
    }


def compiled_set(name: str):
    """A compiled stage set with several signatures and override classes."""
    from kwok_tpu_torch.engine.compiler import CompiledStageSet
    from kwok_tpu_torch.stages import default_node_stages, load_builtin

    if name == "node-default-lease":
        cset = CompiledStageSet(default_node_stages(lease=True))
        cset.signature_for(new_node())
        cset.override_class_for(new_node())
        return cset
    stages = []
    for part in name.split("+"):
        stages += load_builtin(part)
    cset = CompiledStageSet(stages)
    ann_keys = sorted({k for sc in cset.scalars for k in (
        sc.weight_from_annotation, sc.duration_from_annotation, sc.jitter_from_annotation) if k})
    values = ("0", "2", "7", "1s", "3s", "250ms")
    for i, (job, init) in enumerate([(False, False), (True, False), (False, True), (True, True)]):
        ann = {k: values[(i + j) % len(values)] for j, k in enumerate(ann_keys)} if i else None
        pod = new_pod(i, owner_job=job, init_containers=init, annotations=ann)
        cset.signature_for(pod)
        cset.override_class_for(pod)
    return cset


def random_state(cset, n: int, seed: int, device):
    """Seeded SoA: random features, idle, armed and due rows, deadlines,
    host rematches, every signature and override class."""
    from kwok_tpu_torch.engine.compiler import IDLE, NEVER, SENTINEL
    from kwok_tpu_torch.ops.tick import params_from_compiled, soa_from_numpy

    params = params_from_compiled(cset, device)
    rng = np.random.default_rng(seed)
    S, C = cset.num_stages, cset.C
    SIG, OVC = params.eff_mode.shape[0], params.ov_w.shape[0]
    now = 100_000
    pick = rng.integers(0, 3, (n, C))
    one_bit = np.left_shift(1, rng.integers(0, 8, (n, C)))
    noise = rng.integers(-(2**31), 2**31, (n, C))
    stage = np.where(rng.random(n) < 0.3, IDLE, rng.integers(0, S, n))
    d = dict(
        features=np.where(pick == 0, 0, np.where(pick == 1, one_bit, noise)).astype(np.int32),
        sig=rng.integers(0, SIG, n).astype(np.int32),
        ovc=rng.integers(0, OVC, n).astype(np.int32),
        stage=stage.astype(np.int32),
        fire_at=np.where(stage == IDLE, NEVER, now + rng.integers(-500, 3000, n)).astype(np.int32),
        active=rng.random(n) < 0.9,
        rematch=rng.random(n) < 0.3,
        del_ts=np.where(rng.random(n) < 0.2, now + rng.integers(-2000, 8000, n),
                        SENTINEL).astype(np.int32),
        now=np.array(now, np.int32),
        key=np.array([0, seed], np.uint32),
    )
    return params, soa_from_numpy(d, device)


def clone_soa(soa):
    return type(soa)(*(t.clone() for t in soa))


def assert_equal(what: str, got, want) -> None:
    """torch.equal, with the first differing entry in the message."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} != {want.dtype}{tuple(want.shape)}")
    if got.dtype == torch.uint32:  # few uint32 ops exist on CUDA
        got, want = got.view(torch.int32), want.view(torch.int32)
    if not torch.equal(got, want):
        ne = (got != want).reshape(max(got.shape[0], 1) if got.dim() else 1, -1).any(dim=1)
        i = int(ne.nonzero()[0])
        g, w = (got[i], want[i]) if got.dim() else (got, want)
        raise AssertionError(
            f"{what}: {int((got != want).sum())} entries differ, first at [{i}]: "
            f"kernel {g.tolist()} plain {w.tolist()}")


def max_abs_err(pairs) -> int:
    err = 0
    for got, want in pairs:
        if got.dtype == torch.uint32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        err = max(err, int((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
    return err


def assert_soa_equal(what, got, want):
    for f in got._fields:
        assert_equal(f"{what} soa.{f}", getattr(got, f), getattr(want, f))


def phase_parity(device):
    from kwok_tpu_torch.ops import kernels, prng
    from kwok_tpu_torch.ops import tick as T

    t0 = time.perf_counter()
    for name in ("pod-fast", "pod-general+pod-chaos", "node-default-lease"):
        cset = compiled_set(name)
        for n in PARITY_NS:
            seed = 7 + n % 1000
            params, start = random_state(cset, n, seed, device)
            label = f"{name} N={n}"
            # tick, 50 times, every output field
            ks, ps = clone_soa(start), clone_soa(start)
            fired = 0
            for t in range(50):
                ks, ko = T.tick(params, ks, DT_MS)
                ps, po = T._tick_impl(params, ps, DT_MS)
                for f in ko._fields:
                    assert_equal(f"{label} tick {t} out.{f}", getattr(ko, f), getattr(po, f))
                assert_soa_equal(f"{label} tick {t}", ks, ps)
                fired += int(ko.fired_count)
            # run_ticks_collect K=8
            ks, ps = clone_soa(start), clone_soa(start)
            ks, kst = T.run_ticks_collect(params, ks, DT_MS, MACRO_K)
            ps, pst = T._run_ticks_collect_impl(params, ps, DT_MS, MACRO_K)
            assert_equal(f"{label} run_ticks_collect stages", kst, pst)
            assert_soa_equal(f"{label} run_ticks_collect", ks, ps)
            # run_ticks K=50
            ks, ps = clone_soa(start), clone_soa(start)
            ks, kc = T.run_ticks(params, ks, DT_MS, 50)
            ps, pc = T._run_ticks_impl(params, ps, DT_MS, 50)
            assert_equal(f"{label} run_ticks count", kc, pc)
            assert_soa_equal(f"{label} run_ticks", ks, ps)
            # scatter_rows: a padded batch whose padding repeats row 0
            ks, ps = clone_soa(start), clone_soa(start)
            batch = scatter_batch(start, cset, min(n // 4, 3000), seed, device)
            T.scatter_rows(ks, *batch)
            T._scatter_rows_impl(ps, *batch)
            assert_soa_equal(f"{label} scatter_rows", ks, ps)
            log(f"parity {label}: tick x50 (fired {fired}), run_ticks_collect K={MACRO_K}, "
                f"run_ticks K=50 (count {int(kc)}), scatter_rows B={batch[0].shape[0]}: equal")
    for seed in (0, 1, 42, 2**31 - 1):
        key = prng.prng_key(seed, device)
        for n in (1, 3, 4_097, 1_000_003):
            pairs, u = kernels.threefry_draws(key, n)
            assert_equal(f"threefry split seed={seed} n={n}", pairs, prng.split(key, n))
            assert_equal(f"threefry uniform seed={seed} n={n}", u.view(torch.int32),
                         prng.uniform(key, n).view(torch.int32))
    log(f"parity threefry split/uniform: equal; phase 2 took {time.perf_counter() - t0:.1f} s")


def scatter_batch(soa, cset, k: int, seed: int, device):
    from kwok_tpu_torch.engine.compiler import IDLE, NEVER, SENTINEL

    rng = np.random.default_rng(seed + 1)
    n = soa.features.shape[0]
    rows = rng.choice(n, size=k, replace=False).astype(np.int32)
    pad = 1 << max(k - 1, 0).bit_length()
    idx = np.concatenate([np.arange(k), np.zeros(pad - k, np.int64)])
    vals = dict(
        features=rng.integers(0, 2**20, (k, cset.C)).astype(np.int32),
        sig=rng.integers(0, soa.sig.max().item() + 1, k).astype(np.int32),
        ovc=rng.integers(0, soa.ovc.max().item() + 1, k).astype(np.int32),
        stage=np.full(k, IDLE, np.int32),
        fire_at=np.full(k, NEVER, np.int32),
        active=rng.random(k) < 0.8,
        rematch=rng.random(k) < 0.9,
        del_ts=np.where(rng.random(k) < 0.3, 123_000, SENTINEL).astype(np.int32),
    )
    out = [torch.from_numpy(rows[idx]).to(device)]
    out += [torch.from_numpy(np.ascontiguousarray(v[idx])).to(device) for v in vals.values()]
    return tuple(out)


# ------------------------------------------------------------------ phase 3


def wide_label(v: int) -> str:
    return f"custom.stage.kwok.x-k8s.io/group-{v // 30}"


def wide_stages():
    """pod-general + pod-chaos plus label-selected custom stages up to
    128 stages: the fewest that take the per-tick int32 branch of
    ``tick_many`` (more than 126) and hold a stage index above 126.  A
    synthetic set for branch coverage, not a user workload.  A label
    column holds at most 30 selector values, so the custom stages spread
    over one label key per 30."""
    from kwok_tpu_torch.api.types import Stage
    from kwok_tpu_torch.stages import load_builtin

    stages = load_builtin("pod-general") + load_builtin("pod-chaos")
    for v in range(WIDE_STAGES - len(stages)):
        stages.append(Stage.from_dict({
            "metadata": {"name": f"custom-{v}"},
            "spec": {
                "resourceRef": {"kind": "Pod"},
                "selector": {"matchLabels": {wide_label(v): f"custom-{v}"}},
                "weight": 1,
                "delay": {"durationMilliseconds": 1000},
                "next": {"statusTemplate": f"reason: custom-{v}"},
            },
        }))
    return stages


def drain(sim, stages_np, t0_ms, cols, rows=None, dt_ms=DT_MS) -> int:
    """Materialize, in order, the transitions in columns ``cols`` of a
    [K, N] fired-stage array, as the production drain does; column i is
    row ``rows[i]`` of the simulator (the column itself by default)."""
    from kwok_tpu_torch.engine.simulator import Transition

    rows = cols if rows is None else rows
    sub = stages_np[:, cols]
    ks, idx = np.nonzero(sub >= 0)
    for k, i in zip(ks.tolist(), idx.tolist()):
        s_idx = int(sub[k, i])
        sim.materialize(Transition(
            int(rows[i]), s_idx, sim.cset.compiled[s_idx].name, t0_ms + (k + 1) * dt_ms,
            bool(sim.cset.stage_delete[s_idx]), None))
    return len(ks)


def phase_main_path():
    from kwok_tpu_torch.engine.simulator import DeviceSimulator
    from kwok_tpu_torch.ops import tick as T
    from kwok_tpu_torch.stages import default_node_stages, load_builtin

    t_setup = time.perf_counter()
    pod_sim = DeviceSimulator(load_builtin("pod-general") + load_builtin("pod-chaos"),
                              capacity=N_PODS, seed=0)
    pod_sim.admit_bulk(new_pod(), N_PODS)
    node_sim = DeviceSimulator(default_node_stages(lease=True), capacity=N_NODES, seed=1)
    node_sim.admit_bulk(new_node(), N_NODES)
    wide_sim = DeviceSimulator(wide_stages(), capacity=N_PODS, seed=2)
    wide_sim.admit_bulk(new_pod(), N_PODS - WIDE_TAGGED)
    last = wide_sim.cset.compiled[-1].name  # custom-118, stage index 127
    tagged = new_pod(1)
    tagged["metadata"]["labels"][wide_label(int(last.split("-")[1]))] = last
    wide_sim.admit_bulk(tagged, WIDE_TAGGED)
    for sim in (pod_sim, node_sim, wide_sim):
        sim.to_device()
    torch.cuda.synchronize()
    log(f"main path setup: {time.perf_counter() - t_setup:.1f} s "
        f"(pods S={pod_sim.cset.num_stages} C={pod_sim.cset.C}, nodes S={node_sim.cset.num_stages} "
        f"C={node_sim.cset.C}, wide S={wide_sim.cset.num_stages} C={wide_sim.cset.C})")

    rng = np.random.default_rng(0)
    perm = rng.permutation(N_PODS)
    sample = np.sort(perm[:SAMPLE])
    released = perm[SAMPLE:SAMPLE + CHURN]
    deleting = perm[SAMPLE + CHURN:SAMPLE + 2 * CHURN]

    def macro(sim):
        st, t0 = sim.tick_many_async(DT_MS, MACRO_K)
        return st.cpu().numpy(), t0

    T.reset_launches()
    # warm-up: 13 macro-ticks, 104 ticks
    for _ in range(13):
        st, t0 = macro(pod_sim)
        drain(pod_sim, st, t0, sample)
        macro(node_sim)
    # host churn between macro-ticks: release, delete, admit into freed rows
    t_churn = time.perf_counter()
    for row in released.tolist():
        pod_sim.release(row)
    at = pod_sim.now_ms + 2_000
    for row in deleting.tolist():
        pod_sim.request_delete(row, at)
    new_rows = [pod_sim.admit(new_pod(N_PODS + i)) for i in range(CHURN)]
    if sorted(new_rows) != sorted(released.tolist()):
        raise AssertionError("admits did not reuse the released rows")
    log(f"churn: released, deleted and admitted {CHURN} rows each in "
        f"{time.perf_counter() - t_churn:.2f} s")
    deleted = 0
    for _ in range(40):  # 32 s of virtual time: deletes with 2 s deadlines land
        st, t0 = macro(pod_sim)
        drain(pod_sim, st, t0, sample)
        deleted += int(pod_sim.cset.stage_delete[st[:, deleting][st[:, deleting] >= 0]].sum())
        macro(node_sim)
    if deleted == 0:
        raise AssertionError("no requested delete reached its delete stage")
    admitted_live = sum(pod_sim.objects[r] is not None for r in new_rows)
    log(f"after churn: {deleted} deletes fired, {admitted_live} admitted rows live")

    # >126 stages: the per-tick int32 branch of tick_many
    wide_fired = high = 0
    for _ in range(5):
        st, _ = wide_sim.tick_many(DT_MS, MACRO_K)
        if st.dtype != np.int32 or st.shape != (MACRO_K, N_PODS):
            raise AssertionError(f"wide tick_many returned {st.dtype}{st.shape}")
        wide_fired += int(np.count_nonzero(st >= 0))
        high += int(np.count_nonzero(st > 126))
    if high == 0:
        raise AssertionError("no stage index above 126 fired on the wide set")
    log(f"wide set: {wide_fired} transitions in 40 ticks, {high} of stages above 126")

    # materialization: the sampled rows against the device features
    pod_sim.check_feature_parity(sample.tolist())
    phases = pod_sim.phase_counts()
    if not phases.get("Running") and not phases.get("Failed"):
        raise AssertionError(f"no pod reached Running or Failed: {phases}")
    log(f"feature parity of {SAMPLE} sampled rows: ok; pod phases {phases}; "
        f"node phases {node_sim.phase_counts()}")

    # timed macro-ticks, each fetched to the host as the player fetches
    # it.  The counts are made on the card and read after the window, so
    # the window holds the simulator's work and little else.  The sampled
    # rows' transitions of this window are not materialized: their
    # parity was checked above, and at this rate 10 s of wall time are
    # an hour and a half of virtual time, whose drain on the host would
    # take far longer than the window
    torch.cuda.synchronize()
    fired_dev = torch.zeros((), dtype=torch.int64, device=pod_sim.device)
    rows_dev = torch.zeros((), dtype=torch.int64, device=pod_sim.device)
    iters = 0
    dispatch = fetch = 0.0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < TIMED_S:
        t_i = time.perf_counter()
        pod_dev, _ = pod_sim.tick_many_async(DT_MS, MACRO_K)
        node_dev, _ = node_sim.tick_many_async(DT_MS, MACRO_K)
        hit = pod_dev >= 0
        fired_dev += hit.sum() + (node_dev >= 0).sum()
        rows_dev += hit.any(dim=0).sum()
        t_d = time.perf_counter()
        pod_dev.cpu(), node_dev.cpu()
        t_f = time.perf_counter()
        dispatch += t_d - t_i
        fetch += t_f - t_d
        iters += 1
    window = time.perf_counter() - t_start
    fired, rows_fired = int(fired_dev), int(rows_dev)
    if fired == 0:
        raise AssertionError("no transition fired in the timed window")
    log(f"macro-ticks: {iters} x K={MACRO_K} in a {window:.3f} s window: "
        f"{fired / window:.0f} transitions/s (pods+nodes), "
        f"{window / iters * 1e3:.4f} ms per pod+node macro-tick incl. fetch "
        f"(dispatch and on-card counts {dispatch / iters * 1e3:.4f}, "
        f"fetch {fetch / iters * 1e3:.4f}), "
        f"{rows_fired / (iters * N_PODS):.4f} of pod rows fired per macro-tick")

    # bench-style window: run_ticks over a copy of the live pod SoA (the
    # simulator's own state stays where its host mirror says it is)
    params, live = pod_sim.to_device()
    soa = clone_soa(live)
    torch.cuda.synchronize()
    t_w = time.perf_counter()
    soa, count = T.run_ticks(params, soa, DT_MS, BENCH_TICKS)
    n_fired = int(count)
    w = time.perf_counter() - t_w
    log(f"run_ticks window: {BENCH_TICKS} ticks x {N_PODS} pods in {w * 1e3:.2f} ms: "
        f"{n_fired / w:.0f} transitions/s ({n_fired} fired)")
    counts = T.launches()
    log(f"main path launches: {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return counts, pod_sim, wide_sim


# ------------------------------------------------------------------ phase 4


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def chained_ms(fn, soa, reps: int) -> float:
    """cuda_ms of ``soa = fn(soa)``: each call continues from the state,
    clock and key the last one left, as the simulator's calls do (a
    repeat from the same clock would find the rows already re-armed)."""
    state = [soa]

    def call():
        state[0] = fn(state[0])

    return cuda_ms(call, reps)


def row_bytes(C: int) -> int:
    read = C * 4 + 5 * 4 + 2  # features, sig ovc stage fire_at del_ts, active rematch
    written = C * 4 + 2 * 4 + 2  # features, stage fire_at, active rematch
    return read + written


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in params)


def tick_bound(params, n, ticks, rematches, out_bytes):
    """Least time of ``ticks`` ticks over ``n`` rows, ``rematches``
    of them rematching in all: (ms, "bytes" | "operations")."""
    S, KC = params.cond_col.shape
    C = params.eff_mode.shape[2]
    nbytes = n * row_bytes(C) + out_bytes + param_bytes(params)
    ops = n * ticks * ROW_TICK_OPS + rematches * (DRAW_OPS + S * KC * COND_OPS)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_measure(counts, pod_sim, wide_sim, smi):
    from kwok_tpu_torch.ops import kernels
    from kwok_tpu_torch.ops import tick as T

    entries = []
    src_tick = "kwok_tpu_torch/csrc/tick.cu"

    def entry(name, shape, source, replaces, ms, plain_ms, bound, err, library_ms=None):
        entries.append(dict(
            name=name, shape=shape, route="cuda", source=source, replaces=replaces,
            launches=counts[name], max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms))
        log(f"{name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
            f"({bound[1]}), max_abs_err {err}  [{smi}]")

    # run_ticks_collect at the production shape: 1M pods, K=8
    params, live = pod_sim.to_device()
    rematch0 = int(live.rematch.sum())
    ks, ps = clone_soa(live), clone_soa(live)
    ks, kst = T.run_ticks_collect(params, ks, DT_MS, MACRO_K)
    ps, pst = T._run_ticks_collect_impl(params, ps, DT_MS, MACRO_K)
    assert_equal("main-shape run_ticks_collect", kst, pst)
    assert_soa_equal("main-shape run_ticks_collect", ks, ps)
    err = max_abs_err([(kst, pst)] + list(zip(ks, ps)))
    fired = int((kst >= 0).sum())
    ms = chained_ms(lambda s: T.run_ticks_collect(params, s, DT_MS, MACRO_K)[0],
                    clone_soa(live), 20)
    plain_ms = chained_ms(lambda s: T._run_ticks_collect_impl(params, s, DT_MS, MACRO_K)[0],
                          clone_soa(live), 2)
    entry("run_ticks_collect", f"{N_PODS:,} pod rows, K=8 (the main path's macro-tick)",
          src_tick, "kwok_tpu/ops/tick.py:241", ms, plain_ms,
          tick_bound(params, N_PODS, MACRO_K, fired + rematch0, MACRO_K * N_PODS), err)

    # run_ticks at the bench window's shape: 1M pods, K=600
    ks, ps = clone_soa(live), clone_soa(live)
    ks, kc = T.run_ticks(params, ks, DT_MS, BENCH_TICKS)
    t0 = time.perf_counter()
    ps, pc = T._run_ticks_impl(params, ps, DT_MS, BENCH_TICKS)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert_equal("main-shape run_ticks count", kc, pc)
    assert_soa_equal("main-shape run_ticks", ks, ps)
    err = max_abs_err([(kc, pc)] + list(zip(ks, ps)))
    ms = chained_ms(lambda s: T.run_ticks(params, s, DT_MS, BENCH_TICKS)[0], clone_soa(live), 3)
    entry("run_ticks", f"{N_PODS:,} pod rows, K=600 (the bench-style window)",
          src_tick, "kwok_tpu/ops/tick.py:323", ms, plain_ms,
          tick_bound(params, N_PODS, BENCH_TICKS, int(kc) + rematch0, 4), err)

    # tick at the wide set's shape: 1M pods, S = 128 (branch coverage)
    wparams, wlive = wide_sim.to_device()
    rematch0 = int(wlive.rematch.sum())
    ks, ps = clone_soa(wlive), clone_soa(wlive)
    ks, ko = T.tick(wparams, ks, DT_MS)
    ps, po = T._tick_impl(wparams, ps, DT_MS)
    for f in ko._fields:
        assert_equal(f"main-shape tick out.{f}", getattr(ko, f), getattr(po, f))
    assert_soa_equal("main-shape tick", ks, ps)
    err = max_abs_err(list(zip(ko, po)) + list(zip(ks, ps)))
    ms = chained_ms(lambda s: T.tick(wparams, s, DT_MS)[0], clone_soa(wlive), 20)
    plain_ms = chained_ms(lambda s: T._tick_impl(wparams, s, DT_MS)[0], clone_soa(wlive), 3)
    entry("tick", f"{N_PODS:,} pod rows, S={WIDE_STAGES}: a synthetic set that covers "
          "the >126-stage branch, not a user workload",
          src_tick, "kwok_tpu/ops/tick.py:217", ms, plain_ms,
          tick_bound(wparams, N_PODS, 1, int(ko.fired_count) + rematch0, 6 * N_PODS + 4), err)

    # scatter_rows at the churn's shape: 30,000 rows padded to 32,768
    k = 3 * CHURN
    batch = scatter_batch(live, pod_sim.cset, k, 11, live.features.device)
    ks, ps = clone_soa(live), clone_soa(live)
    T.scatter_rows(ks, *batch)
    T._scatter_rows_impl(ps, *batch)
    assert_soa_equal("main-shape scatter_rows", ks, ps)
    err = max_abs_err(list(zip(ks, ps)))
    # the kernel against the plain version; the wrapper adds its range
    # check (one min/max reduction and one sync), timed on its own
    ms = cuda_ms(lambda: kernels.scatter_rows(ks, *batch), 50)
    plain_ms = cuda_ms(lambda: T._scatter_rows_impl(ps, *batch), 20)
    wrapper_ms = cuda_ms(lambda: T.scatter_rows(ks, *batch), 20)
    log(f"scatter_rows wrapper with its range check: {wrapper_ms:.4f} ms  [{smi}]")
    B, C = batch[1].shape
    nbytes = B * 4 + 2 * B * (C * 4 + 5 * 4 + 2)  # indices; batch read; rows written
    entry("scatter_rows", f"{B:,} rows (the churn's {k:,}, padded)",
          "kwok_tpu_torch/csrc/scatter.cu", "kwok_tpu/ops/tick.py:275",
          ms, plain_ms, (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"), err)
    order = ["tick", "run_ticks_collect", "run_ticks", "scatter_rows"]
    return sorted(entries, key=lambda e: order.index(e["name"]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import kwok_tpu_torch  # noqa: F401  (fails here when run without the repo)

    t0 = time.perf_counter()
    smi = phase_environment()
    device = torch.device("cuda")
    phase_parity(device)
    counts, pod_sim, wide_sim = phase_main_path()
    kernels_line = phase_measure(counts, pod_sim, wide_sim, smi)
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
