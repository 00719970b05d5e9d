#!/usr/bin/env python3
"""Start the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. environment: the card's name and power limit, torch and CUDA
   versions; build the kernels from ``kwok_tpu_torch/csrc`` with nvcc;
2. every kernel against its plain PyTorch version on the card, bit for
   bit (``torch.equal``: the FSM is integer-exact and the PRNG is
   reproduced), on seeded random states of three stage sets at
   N = 4,096 and N = 1,000,003, and the lease lane's ``lease_tick`` at
   16, 16,384 and 1,000,003 slots; and the row-sharded tick and
   multi-tick loop over 4 shards of the card, each shard launched with
   its global row offset, against the plain version of the whole state
   at N = 4,096 and 1,000,004 (1,000,003 padded to the shards); then
   hand-built adversarial tables (``adversarial_tables``) at N = 4,096
   and 1,000,003: S = 1, 2, 31, 32, 33 and 126 stages through
   ``run_ticks_collect``, ``run_ticks`` and both sharded kernels, S = 128
   through ``tick``, one and seven conditions a stage, weights that are
   0, negative, overridden, SENTINEL or large enough that the total and
   the running sum wrap int32, several signatures and override classes
   with effects, and signatures and override classes out of range (read
   as XLA's gather reads them: wrapped, then clamped); and
   ``scatter_rows`` from host batches (packed into a
   pinned buffer, one copy, ``csrc/scatter.cu``) at the feature widths of
   the node, pod and wide stage sets (C = 2, 13, 17), at 1, 31, 1,024,
   30,000 and 1,000,003 rows of a 1,000,003-row SoA (the last a
   permutation), with repeated rows, a batch of 1,024 rows given as
   int64 arrays, one with rows out of range (wrapped or dropped on the
   host, as the reference's scatter reads them), and two batches back
   to back with no sync between them while a kernel holds the stream;
3. the main path through ``DeviceSimulator`` at full width: 1,000,000
   pods of pod-general + pod-chaos and 10,000 nodes of the default lease
   node stages (as the reference ``bench.py`` builds them): macro-ticks
   of K=8 with admits, deletes and releases between them, every
   transition of 1,000 sampled rows materialized in order and their
   feature parity checked, a 1,000,000-pod simulator on a synthetic
   128-stage set (only to cover the per-tick int32 branch for more than
   126 stages), then macro-ticks timed for 10 s (each fetched through
   the pinned block its kernel writes, ``start_fetch``) and a
   bench-style ``run_ticks`` window; each of its kernels' launch counts
   must be positive; then, outside that count, the pinned host block of
   ``run_ticks_collect`` on the live state against its device output and
   the plain version;
3b. the row-sharded path (``parallel/mesh.py``) at the same width: the
   1,000,000-pod / 10,000-node simulators unsharded, on
   ``make_mesh(torch.cuda.device_count())`` (one shard per card) and on
   4 shards of one card, stepped in lockstep through 100 macro-ticks of
   K=8 with phase 3's churn every 10 (the macro-tick after a churn split
   into the host writes' flush and the rest); every tick's fired stages
   and the final SoA must be equal across the three.  Then ``sharded_run_ticks``
   over the 4 shards at 1M x K=600 against ``run_ticks`` on the same
   state, and ``graft_entry.dryrun_multichip`` (sharded ticks and the
   full player drain with GC, checked against unsharded) over 4 shards
   of the card at 65,536 rows.  Both sharded kernels must have been
   launched;
4. each kernel timed at the main path's shapes (CUDA events over
   chained calls, and its device time from torch.profiler) beside its
   plain version and its bound; for ``run_ticks_collect`` and
   ``run_ticks`` also the device time on an idle copy of the live state
   (no row due, none rematching: the streaming floor) and the key
   schedule's device time by kernel name; for ``scatter_rows`` at the
   churn's 30,000 rows also the wrapper from a host batch and the phase 3
   simulator's ``_flush_pending`` end to end, one flush of it under
   ``torch.cuda.set_sync_debug_mode("error")``;
5. the device backend of the Controller facade, in process: a
   ResourceStore of 10,000 Nodes and 20,000 Pods (pod-general +
   pod-chaos, labelled for container-failure chaos, 5 per node),
   ``Controller(backend="device")`` started paced, both kinds on device
   players and node leases renewed by the device lease lane; after every
   row's first transition, one timed window of three lease renewal
   periods (transitions/s, the pod player's time split, tick-lag and
   heartbeat-lag p99, renewals, launches).  It fails when a kind is not
   on a device player, no lane is attached, a kernel was not launched in
   the window, renewals fall short of the lease cadence, a lease is
   missing, unheld or expired at a sample of the window, or a tick loop
   printed a traceback;
6. the daemon as users run it: ``python -m kwok_tpu_torch.cmd.apiserver``
   as a subprocess, filled over HTTP with 10,000 Nodes and 20,000 of
   phase 5's pods (5 per node) in chunks of 10,000, then the port's
   ``kwok`` daemon as a subprocess (``--backend device`` on the card,
   phase 5's stages and device capacity in its ``--config``); after every
   Node is Ready, every node Lease held by the daemon and every pod past
   its first transition (read from the apiserver's watches), one timed
   window of three renewal periods: transitions/s and tick-lag and
   renew-lag p99 from the daemon's ``/metrics``, renewals counted as
   MODIFIED events of the Lease watch, the Leases read at each period's
   end.  It fails when a kind is not on the device backend, renewals fall
   short, a lease is missing, unheld or expired at a sample, the daemon
   prints a traceback or exits non-zero on SIGTERM, or the launch counts
   it prints on its way out lack ``run_ticks_collect``, ``lease_tick``
   or ``scatter_rows``;
7. kwokctl as users run it: ``python -m kwok_tpu_torch.cmd.kwokctl
   create cluster --backend device --enable-tracing`` in a home of its
   own starts the port's five components (the daemon must name
   ``cuda:0``); the upstream kwokctl CI benchmark's 2,000 nodes through
   ``kwokctl scale node`` (all Ready within 120 s) and 5,000 pods in 10
   ``kwokctl scale pod`` shards with ``nodeName`` (all Running within
   240 s), then 500 pods without a node that the scheduler must bind;
   phase 6's window and lease contract; ``kwokctl get components`` (five
   Running), ``kwokctl snapshot save`` (read back with the port's
   ``snapshot`` loader: 2,000 Nodes and, after phase 8, 6,000 Pods) and ``kwokctl
   delete cluster`` (exit 0, no component left); the daemon's log must
   show its kernels launched and no traceback up to phase 8;
8. a chaos run inside phase 7's cluster, before its ``get components``:
   phase 7's daemon restarted gracefully by ``python -m
   kwok_tpu_torch.chaos`` on a one-fault profile (its launch line read
   from its exit), then a seeded ChaosProfile through ``python -m
   kwok_tpu_torch.chaos --cluster smoke --supervise``: the daemon
   SIGKILLed at 1 s, the apiserver SIGKILLed at 30 s, the daemon
   SIGSTOPped for 5 s at 45 s, the supervisor restarting what dies.  It
   fails unless the faults and both restarts are reported, every
   recovery time is under the 40 s lease, the daemon's log shows a start
   line on ``cuda:0`` after the kill, no node Lease is missing, unheld or
   expired at any of the once-a-second reads from the plan's start until
   one renewal period after it ends, every Node is Ready, and 500 new
   placed pods reach Running through the restarted daemon; phase 7's
   snapshot then holds 2,000 Nodes and 6,000 Pods, and the restarted
   daemon's launch line at the delete shows its kernels launched.  From
   phase 8 on, the daemon's log may hold only the tracebacks its workers
   print, catch and retry while the apiserver is down (``OUTAGE_ERRORS``).

Then the ``{"kernels": [...]}`` line.
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the ``kwok_tpu_torch`` package beside this file, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import datetime
import json
import os
import re
import subprocess
import sys
import threading
import time
from collections import Counter

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
NODE_LEASE_NS = "kube-node-lease"

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
# phase 2's scatter batches: host batches of B rows into a SoA of
# SCATTER_N rows, the largest a permutation of all of them; 30,000 is the
# churn's flush (phase 3b's after-churn macro-tick and phase 4)
SCATTER_N = 1_000_003
SCATTER_BS = (1, 31, 1_024, 30_000, SCATTER_N)
# how long the back-to-back check holds the stream, in clocks (~20 ms at
# 1.98 GHz), so that both copies wait behind it
HOLD_CYCLES = 40_000_000
LEASE_PARITY_NS = (16, 16_384, 1_000_003)
# the facade and daemon phases: the lane has device_capacity slots.
# Their pods are cut from 1,000,000 to 20,000 each: the card's host
# warmed the facade's 10,000 nodes and 50,000 pods in ~150 s and the
# daemon's in ~260 s, and both must fit the budget beside phases 1-4 and
# phase 7, which is not cut.
LANE_CAPACITY = 1_048_576
FACADE_PODS = 20_000
DAEMON_PODS = 20_000
# A timed window is a whole number of lease renewal periods, so that
# renewals, which come in clumps, fall into it as often as the contract
# wants them: each held lease once a period (duration / 4, plus up to
# 4% jitter: controllers/node_lease_controller.py:51-52, :300).
RENEW_PERIODS = 3
# The whole script must end within 1,000 s.  Admission of every facade
# row and its first transition may take what is left of SCRIPT_BUDGET_S
# after the earlier phases, DAEMON_RESERVE_S for the daemon phase,
# KWOKCTL_RESERVE_S for the kwokctl phase and its chaos run (phases 7
# and 8), the timed window and FACADE_STOP_S for the controller's stop;
# the daemon's warming may take what is left after that but
# KWOKCTL_RESERVE_S, its window and DAEMON_STOP_S for its stop (it
# releases every node lease over HTTP).
SCRIPT_BUDGET_S = 950.0
FACADE_STOP_S = 40.0
DAEMON_RESERVE_S = 260.0
DAEMON_STOP_S = 60.0
KWOKCTL_RESERVE_S = 260.0

# the row-sharded phase: shards of one card, macro-ticks, churn cadence,
# and the reference dry run's rows (__graft_entry__.py:97)
MESH_SHARDS = 4
MESH_MACROS = 100
MESH_CHURN_EVERY = 10
DRYRUN_ROWS = 65_536

# phase 2's adversarial tables: stage counts at the row kernel's
# narrowest segments (2 lanes), on both sides of its widest (32 lanes),
# and up to the most the int8 collect path takes, 128 through the
# per-tick kernel; one and seven conditions a stage; several signatures
# and override classes
ADV_S = (1, 2, 31, 32, 33, 126)
ADV_WIDE_S = 128
ADV_KC = (1, 7)
ADV_C, ADV_SIG, ADV_OVC = 5, 3, 4

# Least-time model: H100 SXM, 3.35 TB/s HBM.
# 32-bit integer operations at the SM's issue rate: each of its four
# schedulers issues one warp instruction per clock, 128 lanes per SM,
# the width behind the card's 67 TFLOP/s float32 without the FMA
# doubling: 132 SMs x 128 lanes x 1.98 GHz.  The INT32 pipe alone has 64
# lanes per SM, but integer adds also issue to the FMA pipe (as IMAD),
# so 64 lanes are no ceiling: the threefry check below ran faster than
# they allow.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
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
    secs = kernels.load()
    log(f"build: {secs:.1f} s for {', '.join(kernels.SOURCES)}")
    for src, text in kernels.build_log.items():
        for line in ptxas_report(text):
            log(f"  ptxas {src} {line}")
    return smi


def ptxas_report(text: str):
    """Each kernel's registers, spills and static shared bytes from
    nvcc's ``-Xptxas -v`` output, named by the kernel (and its mode)."""
    name = "?"
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"([a-z_]+_kernel)(I(?:Li\d+E)+E)?", line)
            args = re.findall(r"Li(\d+)E", (m.group(2) or "") if m else "")
            name = (m.group(1) + (f"<{','.join(args)}>" if args else "")) if m else line
        elif "registers" in line or "spill" in line:
            yield f"{name}: {line.split('info    :')[-1].strip()}"


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


def run_collect(params, soa, k: int):
    """``run_ticks_collect`` as the simulator launches it on the card,
    into a fresh pinned host block besides its device output; returns
    ``(soa, stages, block)``."""
    from kwok_tpu_torch.ops import tick as T

    block = torch.empty((k, soa.features.shape[0]), dtype=torch.int8, pin_memory=True)
    soa, stages = T.run_ticks_collect(params, soa, DT_MS, k, host=block)
    return soa, stages, block


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


def clone_sharded(soa):
    return soa._replace(shards=tuple(clone_soa(s) for s in soa.shards))


def assert_sharded_equal(what, sharded, whole):
    """A ShardedSoA against an unsharded SoA: every row column in row
    order, and every shard's clock and key."""
    from kwok_tpu_torch.parallel.mesh import ROW_FIELDS

    for f in ROW_FIELDS:
        assert_equal(f"{what} soa.{f}", sharded.column(f).to_host(), getattr(whole, f).cpu())
    for i, shard in enumerate(sharded.shards):
        assert_equal(f"{what} shard {i} now", shard.now.cpu(), whole.now.cpu())
        assert_equal(f"{what} shard {i} key", shard.key.cpu(), whole.key.cpu())


def sharded_parity(params, start, label: str, device, ticks: int = 20, run_k: int = 50) -> None:
    """The sharded kernels over MESH_SHARDS shards of the card, each
    launched with its global row offset, against the plain version of
    the whole, unsharded state: a shard that drew from row 0 would
    differ on every shard past the first."""
    from kwok_tpu_torch.ops import tick as T
    from kwok_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh(devices=[device] * MESH_SHARDS)
    placed = M.replicate(params, mesh)
    ks, ps = M.shard_rows(start, mesh), clone_soa(start)
    step = M.sharded_tick(mesh, DT_MS)
    label = f"{label} over {MESH_SHARDS} shards"
    fired = 0
    for t in range(ticks):
        ks, ko = step(placed, ks)
        ps, po = T._tick_impl(params, ps, DT_MS)
        for f in ("fired", "fired_stage", "deleted"):
            assert_equal(f"{label} sharded_tick {t} out.{f}", getattr(ko, f).to_host(),
                         getattr(po, f).cpu())
        assert_equal(f"{label} sharded_tick {t} fired_count", ko.fired_count, po.fired_count)
        fired += int(ko.fired_count)
    assert_sharded_equal(f"{label} sharded_tick", ks, ps)
    ks, kc = M.sharded_run_ticks(mesh, DT_MS, run_k)(placed, ks)
    ps, pc = T._run_ticks_impl(params, ps, DT_MS, run_k)
    assert_equal(f"{label} sharded_run_ticks count", kc, pc)
    assert_sharded_equal(f"{label} sharded_run_ticks", ks, ps)
    log(f"parity {label} at offsets {list(ks.offsets)}: sharded_tick x{ticks} (fired {fired}), "
        f"sharded_run_ticks K={run_k} (count {int(kc)}) against the unsharded plain version: equal")


def phase_parity(device):
    from kwok_tpu_torch.ops import kernels, prng
    from kwok_tpu_torch.ops import tick as T
    from kwok_tpu_torch.parallel.mesh import pad_rows

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
            ks, kst, block = run_collect(params, ks, MACRO_K)
            ps, pst = T._run_ticks_collect_impl(params, ps, DT_MS, MACRO_K)
            assert_equal(f"{label} run_ticks_collect stages", kst, pst)
            assert_equal(f"{label} run_ticks_collect host block", block, pst.cpu())
            assert_soa_equal(f"{label} run_ticks_collect", ks, ps)
            # run_ticks K=50
            ks, ps = clone_soa(start), clone_soa(start)
            ks, kc = T.run_ticks(params, ks, DT_MS, 50)
            ps, pc = T._run_ticks_impl(params, ps, DT_MS, 50)
            assert_equal(f"{label} run_ticks count", kc, pc)
            assert_soa_equal(f"{label} run_ticks", ks, ps)
            # scatter_rows from a host batch with repeated rows
            ks, ps = clone_soa(start), clone_soa(start)
            batch = scatter_batch(n, cset.C, min(n // 4, 3000), seed)
            T.scatter_rows(ks, *batch)
            T._scatter_rows_impl(ps, *on_card(batch, device))
            assert_soa_equal(f"{label} scatter_rows", ks, ps)
            log(f"parity {label}: tick x50 (fired {fired}), run_ticks_collect K={MACRO_K}, "
                f"run_ticks K=50 (count {int(kc)}), scatter_rows B={batch[0].shape[0]}: equal")
            n_pad = pad_rows(n, MESH_SHARDS)
            sharded_parity(*random_state(cset, n_pad, seed, device), f"{name} N={n_pad}", device)
    adversarial_parity(device)
    scatter_parity(device)
    for seed in (0, 1, 42, 2**31 - 1):
        key = prng.prng_key(seed, device)
        for n in (1, 3, 4_097, 1_000_003):
            pairs, u = kernels.threefry_draws(key, n)
            assert_equal(f"threefry split seed={seed} n={n}", pairs, prng.split(key, n))
            assert_equal(f"threefry uniform seed={seed} n={n}", u.view(torch.int32),
                         prng.uniform(key, n).view(torch.int32))
    for n in LEASE_PARITY_NS:
        lease_parity(n, device)
    log(f"parity threefry split/uniform: equal; phase 2 took {time.perf_counter() - t0:.1f} s")


def adversarial_tables(S: int, KC: int, n: int, seed: int):
    """Hand-built TickParams and SoA of S stages, KC conditions a stage
    and n rows, as numpy dicts for ``params_from_numpy`` and
    ``soa_from_numpy``: random selectors (about three in four conditions
    pass), weights drawn from 0, negative, small and large values, so
    that a few matched large ones pass 2**31 and the total and the
    running sum wrap int32, SENTINEL as a weight (negative) and as an
    override (none), random delays, jitters and deadlines, rare delete
    stages, and ADV_SIG signatures and ADV_OVC override classes with
    effects; about one row in ten has a signature, and one in ten an
    override class, out of range (``odd_ids``).  The params depend on the
    seed alone, not on n."""
    from kwok_tpu_torch.engine.compiler import IDLE, NEVER, SENTINEL

    rng = np.random.default_rng(seed)
    C, SIG, OVC = ADV_C, ADV_SIG, ADV_OVC
    weights = np.array([0, -7, 1, 3, 2**30, 2**31 - 1, 2**30 + 12_345, SENTINEL], np.int64)

    def override(shape, values):
        return np.where(rng.random(shape) < 0.3, values, SENTINEL).astype(np.int32)

    params = dict(
        cond_col=rng.integers(0, C, (S, KC)).astype(np.int32),
        cond_mask=np.left_shift(1, rng.integers(0, 8, (S, KC))).astype(np.int32),
        cond_neg=rng.random((S, KC)) < 0.5,
        cond_valid=rng.random((S, KC)) < 0.5,
        w_static=rng.choice(weights, S).astype(np.int32),
        d_static=rng.integers(0, 3_000, S).astype(np.int32),
        j_static=np.where(rng.random(S) < 0.5, rng.integers(0, 6_000, S), SENTINEL).astype(np.int32),
        has_jitter=rng.random(S) < 0.5,
        d_from_del_ts=rng.random(S) < 0.2,
        j_from_del_ts=rng.random(S) < 0.2,
        stage_delete=rng.random(S) < 0.03,
        eff_mode=(rng.random((SIG, S, C)) < 0.3).astype(np.int32),
        eff_val=rng.integers(0, 256, (SIG, S, C)).astype(np.int32),
        ov_w=override((OVC, S), rng.choice(weights, (OVC, S))),
        ov_d=override((OVC, S), rng.integers(0, 3_000, (OVC, S))),
        ov_j=override((OVC, S), rng.integers(0, 6_000, (OVC, S))),
    )
    now = 100_000
    stage = np.where(rng.random(n) < 0.3, IDLE, rng.integers(0, S, n))
    soa = dict(
        features=rng.integers(0, 256, (n, C)).astype(np.int32),
        sig=rng.integers(0, SIG, n).astype(np.int32),
        ovc=rng.integers(0, OVC, n).astype(np.int32),
        stage=stage.astype(np.int32),
        fire_at=np.where(stage == IDLE, NEVER, now + rng.integers(-500, 3_000, n)).astype(np.int32),
        active=rng.random(n) < 0.9,
        rematch=rng.random(n) < 0.3,
        del_ts=np.where(rng.random(n) < 0.2, now + rng.integers(-2_000, 8_000, n),
                        SENTINEL).astype(np.int32),
        now=np.array(now, np.int32),
        key=np.array([0, seed], np.uint32),
    )
    for f, m in (("sig", SIG), ("ovc", OVC)):
        odd = rng.random(n) < 0.1
        soa[f] = np.where(odd, rng.choice(odd_ids(m), n), soa[f]).astype(np.int32)
    return params, soa


def odd_ids(m: int):
    """Ids out of range of m entries, as the reference's gathers read
    them: -1 and -m count from the end; -m-1, m and the int32 extremes
    are clamped after that."""
    return np.array([-(2**31), -m - 1, -m, -1, m, 2**31 - 1], np.int64)


def rows_out_of_range(batch, n: int):
    """``batch`` with its first five rows replaced by -n-1, -n, -1, n and
    n+1, as the reference's scatter reads them: -n and -1 count from the
    end (rows 0 and n-1), the others are dropped.  Any other entry for
    rows 0 or n-1 becomes n+2, dropped too, so that no row is written
    with two values."""
    rows = batch[0].copy()
    rows[np.isin(rows, (0, n - 1))] = n + 2
    rows[:5] = (-n - 1, -n, -1, n, n + 1)
    return [rows] + list(batch[1:])


def adversarial_parity(device) -> None:
    """Every mode of the row kernel on the adversarial tables against its
    plain version: ``run_ticks_collect`` K=8, then ``run_ticks`` K=20 on
    the state it left, and both sharded kernels from the start (over
    MESH_SHARDS shards, the rows padded to them); ``tick`` x5 for the
    128-stage tables."""
    from kwok_tpu_torch.ops import tick as T
    from kwok_tpu_torch.parallel.mesh import pad_rows

    t0 = time.perf_counter()
    for n in PARITY_NS:
        for S in ADV_S + (ADV_WIDE_S,):
            for KC in ADV_KC:
                seed = 100 * S + KC
                pd, sd = adversarial_tables(S, KC, n, seed)
                params, start = T.params_from_numpy(pd, device), T.soa_from_numpy(sd, device)
                label = f"adversarial S={S} KC={KC} N={n}"
                ks, ps = clone_soa(start), clone_soa(start)
                if S == ADV_WIDE_S:
                    fired = 0
                    for t in range(5):
                        ks, ko = T.tick(params, ks, DT_MS)
                        ps, po = T._tick_impl(params, ps, DT_MS)
                        for f in ko._fields:
                            assert_equal(f"{label} tick {t} out.{f}", getattr(ko, f), getattr(po, f))
                        assert_soa_equal(f"{label} tick {t}", ks, ps)
                        fired += int(ko.fired_count)
                    log(f"parity {label}: tick x5 (fired {fired}): equal")
                    continue
                ks, kst, block = run_collect(params, ks, MACRO_K)
                ps, pst = T._run_ticks_collect_impl(params, ps, DT_MS, MACRO_K)
                assert_equal(f"{label} run_ticks_collect stages", kst, pst)
                assert_equal(f"{label} run_ticks_collect host block", block, pst.cpu())
                assert_soa_equal(f"{label} run_ticks_collect", ks, ps)
                ks, kc = T.run_ticks(params, ks, DT_MS, 20)
                ps, pc = T._run_ticks_impl(params, ps, DT_MS, 20)
                assert_equal(f"{label} run_ticks count", kc, pc)
                assert_soa_equal(f"{label} run_ticks", ks, ps)
                log(f"parity {label}: run_ticks_collect K={MACRO_K} "
                    f"({int((kst >= 0).sum())} fired), run_ticks K=20 (count {int(kc)}): equal")
                n_pad = pad_rows(n, MESH_SHARDS)
                if n_pad != n:
                    pd, sd = adversarial_tables(S, KC, n_pad, seed)
                sharded_parity(T.params_from_numpy(pd, device), T.soa_from_numpy(sd, device),
                               f"adversarial S={S} KC={KC} N={n_pad}", device, ticks=3, run_k=10)
    log(f"parity adversarial tables: {time.perf_counter() - t0:.1f} s")


def lease_state(n: int, now: int, seed: int, device):
    """A seeded lease lane around ``now``: empty (NEVER) slots, slots due
    exactly now, overdue and future slots."""
    from kwok_tpu_torch.engine.compiler import NEVER
    from kwok_tpu_torch.ops import prng
    from kwok_tpu_torch.ops.tick import LeaseLane

    rng = np.random.default_rng(seed)
    fire = (now + rng.integers(-20_000, 20_000, n)).astype(np.int32)
    fire[rng.random(n) < 0.25] = NEVER
    fire[rng.random(n) < 0.1] = now
    fire[: min(n, 4)] = (NEVER, now, now - 1, now + 1)[: min(n, 4)]
    return LeaseLane(fire_at=torch.from_numpy(fire).to(device), key=prng.prng_key(seed, device))


def lease_parity(n: int, device) -> None:
    """lease_tick against its plain version: each call chained on the
    lane the last one left, over renew/jitter pairs that include no
    jitter and sums that wrap int32."""
    from kwok_tpu_torch.ops import tick as T

    now = 50_000
    k = p = lease_state(n, now, n % 1000, device)
    due_seen = 0
    for renew, jitter, step in ((10_000, 400, 0), (10_000, 0, 3_000), (2**30, 2**29, 4_000),
                                (10_000, 400, 20_000), (1, 1, 1)):
        now += step
        k, kd, kl = T.lease_tick(k, now, renew, jitter)
        p, pd, pl = T._lease_tick_impl(p, now, renew, jitter)
        label = f"lease_tick n={n} now={now} renew={renew} jitter={jitter}"
        assert_equal(f"{label} fire_at", k.fire_at, p.fire_at)
        assert_equal(f"{label} due", kd, pd)
        assert_equal(f"{label} lag", kl, pl)
        assert_equal(f"{label} key", k.key, p.key)
        due_seen += int(kd.sum())
    if due_seen == 0:
        raise AssertionError(f"lease_tick n={n}: no slot came due")
    log(f"parity lease_tick n={n}: 5 chained ticks ({due_seen} renewals): equal")


def scatter_batch(n: int, C: int, B: int, seed: int, repeats: bool = True):
    """A host batch (numpy, in ``scatter_rows``' argument order) of B rows
    of a SoA of n rows and C feature columns, in random order, both bool
    columns mixed.  With ``repeats`` about a quarter of the rows repeat
    an earlier one and carry its values; without, the rows are distinct
    (B = n: a permutation)."""
    from kwok_tpu_torch.engine.compiler import IDLE, NEVER, SENTINEL

    rng = np.random.default_rng(seed + 1)
    u = max(1, B * 3 // 4) if repeats else B
    uniq = rng.choice(n, size=u, replace=False).astype(np.int32)
    pick = rng.integers(0, u, B) if repeats else np.arange(B)
    vals = [
        rng.integers(0, 2**20, (u, C)).astype(np.int32),
        rng.integers(0, 4, u).astype(np.int32),
        rng.integers(0, 4, u).astype(np.int32),
        np.where(rng.random(u) < 0.5, IDLE, rng.integers(0, 9, u)).astype(np.int32),
        np.where(rng.random(u) < 0.5, NEVER, rng.integers(0, 10**6, u)).astype(np.int32),
        rng.random(u) < 0.8,
        rng.random(u) < 0.5,
        np.where(rng.random(u) < 0.3, 123_000, SENTINEL).astype(np.int32),
    ]
    return [uniq[pick]] + [np.ascontiguousarray(v[pick]) for v in vals]


def on_card(batch, device):
    return [torch.from_numpy(a).to(device) for a in batch]


def scatter_state(n: int, C: int, seed: int, device):
    """A seeded SoA of n rows and C feature columns, for the scatter."""
    from kwok_tpu_torch.ops.tick import soa_from_numpy

    rng = np.random.default_rng(seed)
    i32 = lambda *shape: rng.integers(-(2**31), 2**31, shape).astype(np.int32)  # noqa: E731
    return soa_from_numpy(dict(
        features=i32(n, C), sig=i32(n), ovc=i32(n), stage=i32(n), fire_at=i32(n),
        active=rng.random(n) < 0.5, rematch=rng.random(n) < 0.5, del_ts=i32(n),
        now=np.array(0, np.int32), key=np.array([0, seed], np.uint32)), device)


def scatter_parity(device) -> None:
    """scatter_rows from host batches (pack, one copy, csrc/scatter.cu)
    against the plain version on the same batch on the card, at the
    feature widths of the node, pod and wide stage sets, at SCATTER_BS
    rows; then two batches back to back with no sync between them,
    writing different values into rows they share, while a kernel holds
    the stream: a pinned buffer reused before its copy ran would leave
    the second batch's values in the first batch's rows."""
    from kwok_tpu_torch.engine.compiler import CompiledStageSet
    from kwok_tpu_torch.ops import tick as T

    t0 = time.perf_counter()
    widths = {name: compiled_set(name).C for name in ("node-default-lease", "pod-general+pod-chaos")}
    widths["wide"] = CompiledStageSet(wide_stages()).C
    for i, (name, C) in enumerate(widths.items()):
        start = scatter_state(SCATTER_N, C, 20 + i, device)
        for B in SCATTER_BS:
            batch = scatter_batch(SCATTER_N, C, B, 30 + i, repeats=B < SCATTER_N)
            ks, ps = clone_soa(start), clone_soa(start)
            T.scatter_rows(ks, *batch)
            T._scatter_rows_impl(ps, *on_card(batch, device))
            assert_soa_equal(f"scatter_rows {name} C={C} B={B}", ks, ps)
        # the same rows and values as int64 arrays (bool columns stay
        # bool): cast to the SoA's dtypes before the pack, as the
        # reference's scatter casts them
        batch = scatter_batch(SCATTER_N, C, 1_024, 35 + i)
        ks, ps = clone_soa(start), clone_soa(start)
        T.scatter_rows(ks, *[a.astype(np.int64) if a.dtype == np.int32 else a for a in batch])
        T._scatter_rows_impl(ps, *on_card(batch, device))
        assert_soa_equal(f"scatter_rows {name} C={C} int64 batch", ks, ps)
        # rows out of range among valid ones: wrapped or dropped on the host
        batch = rows_out_of_range(scatter_batch(SCATTER_N, C, 1_024, 37 + i, repeats=False),
                                  SCATTER_N)
        ks, ps = clone_soa(start), clone_soa(start)
        T.scatter_rows(ks, *batch)
        T._scatter_rows_impl(ps, *on_card(batch, device))
        assert_soa_equal(f"scatter_rows {name} C={C} rows out of range", ks, ps)
        B = min(30_000, SCATTER_N // 4)
        first = scatter_batch(SCATTER_N, C, B, 40 + i, repeats=False)
        second = scatter_batch(SCATTER_N, C, B, 50 + i, repeats=False)
        # every other row of the first batch, and as many of its own
        fresh = np.setdiff1d(second[0], first[0])[:B - (B + 1) // 2]
        second[0] = np.random.default_rng(i).permutation(np.concatenate([first[0][::2], fresh]))
        ks, ps = clone_soa(start), clone_soa(start)
        torch.cuda.synchronize()
        torch.cuda._sleep(HOLD_CYCLES)
        T.scatter_rows(ks, *first)
        T.scatter_rows(ks, *second)
        for batch in (first, second):
            T._scatter_rows_impl(ps, *on_card(batch, device))
        assert_soa_equal(f"scatter_rows {name} C={C} back to back", ks, ps)
        log(f"parity scatter_rows {name} C={C}: host batches of {list(SCATTER_BS)} rows into "
            f"{SCATTER_N}, an int64 batch of 1,024 rows, one with rows out of range and two "
            "back to back without a sync: equal")
    log(f"parity scatter_rows: {time.perf_counter() - t0:.1f} s")


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
        return sim.start_fetch(st).wait(), t0

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
        fetches = pod_sim.start_fetch(pod_dev), node_sim.start_fetch(node_dev)
        t_d = time.perf_counter()
        for f in fetches:
            f.wait()
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
    missing = [k for k in ("tick", "run_ticks_collect", "run_ticks", "scatter_rows")
               if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    # the collect kernel's pinned host block, as the simulator has it
    # written, against its device output and the plain version, on
    # copies of the live state (after the count: a check, not the path)
    ks, ps = clone_soa(live), clone_soa(live)
    ks, kst, block = run_collect(params, ks, MACRO_K)
    ps, pst = T._run_ticks_collect_impl(params, ps, DT_MS, MACRO_K)
    assert_equal("main-path run_ticks_collect host block", block, kst.cpu())
    assert_equal("main-path run_ticks_collect stages", kst, pst)
    assert_soa_equal("main-path run_ticks_collect", ks, ps)
    log(f"host block of run_ticks_collect K={MACRO_K} on the live state: equal to its device "
        f"output and the plain version ({int((pst >= 0).sum())} fired)")
    return counts, pod_sim, wide_sim


# ------------------------------------------------------------------ phase 3b


def sharded_columns(sim):
    """The simulator's device SoA, every row column in row order on the
    host, and the clock and key of each shard (the one of an unsharded
    SoA)."""
    from kwok_tpu_torch.parallel.mesh import ROW_FIELDS

    _, soa = sim.to_device()
    if sim.mesh is None:
        cols = {f: getattr(soa, f).cpu() for f in ROW_FIELDS}
        clocks = [(int(soa.now), tuple(soa.key.view(torch.int32).tolist()))]
    else:
        cols = {f: soa.column(f).to_host() for f in ROW_FIELDS}
        clocks = [(int(s.now), tuple(s.key.view(torch.int32).tolist())) for s in soa.shards]
    return cols, clocks


def phase_mesh(smi, device):
    """Phase 3b: the main path's simulators over a row mesh, in lockstep
    with the unsharded ones; returns the phase's launches and the
    4-shard pod simulator."""
    from kwok_tpu_torch import graft_entry
    from kwok_tpu_torch.engine.simulator import DeviceSimulator
    from kwok_tpu_torch.ops import tick as T
    from kwok_tpu_torch.parallel import mesh as M
    from kwok_tpu_torch.stages import default_node_stages, load_builtin

    t_phase = time.perf_counter()
    meshes = {
        "unsharded": None,
        f"{torch.cuda.device_count()} card(s)": M.make_mesh(torch.cuda.device_count()),
        f"{MESH_SHARDS} shards of one card": M.make_mesh(devices=[device] * MESH_SHARDS),
    }
    sims = {}
    for name, mesh in meshes.items():
        pods = DeviceSimulator(load_builtin("pod-general") + load_builtin("pod-chaos"),
                               capacity=N_PODS, seed=0, mesh=mesh, device=device)
        pods.admit_bulk(new_pod(), N_PODS)
        nodes = DeviceSimulator(default_node_stages(lease=True), capacity=N_NODES, seed=1,
                                mesh=mesh, device=device)
        nodes.admit_bulk(new_node(), N_NODES)
        pods.to_device()
        nodes.to_device()
        sims[name] = (pods, nodes)
    caps = {name: (p.capacity, n.capacity) for name, (p, n) in sims.items()}
    if len(set(caps.values())) != 1:
        raise AssertionError(f"mesh: capacities differ: {caps}")
    torch.cuda.synchronize()
    log(f"mesh: setup {time.perf_counter() - t_phase:.1f} s, meshes "
        f"{ {name: (str(m) if m else None) for name, m in meshes.items()} }")

    rng = np.random.default_rng(3)
    perm = rng.permutation(N_PODS)
    per_macro = {name: [] for name in sims}
    flush_s = {name: [] for name in sims}
    churn_s = dict.fromkeys(sims, 0.0)
    fired = dict.fromkeys(sims, 0)
    churns = deleted = 0
    T.reset_launches()
    for m in range(MESH_MACROS):
        outs = []
        for name, (pods, nodes) in sims.items():
            t0 = time.perf_counter()
            # the host writes' flush, which tick_many would make first:
            # after a churn the unsharded pods' scatter (asynchronous, so
            # its copy and kernel fall in the rest); nothing on a mesh,
            # which re-uploads in full
            pods._flush_pending()
            flush_s[name].append(time.perf_counter() - t0)
            st, t0_ms = pods.tick_many(DT_MS, MACRO_K)
            nst, _ = nodes.tick_many(DT_MS, MACRO_K)
            per_macro[name].append(time.perf_counter() - t0)
            fired[name] += int(np.count_nonzero(st >= 0)) + int(np.count_nonzero(nst >= 0))
            outs.append((name, st.astype(np.int32), nst.astype(np.int32), t0_ms))
        base = outs[0]
        for name, st, nst, t0_ms in outs[1:]:
            if st.shape != base[1].shape or not np.array_equal(st, base[1]):
                diff = np.argwhere(st != base[1])[:3].tolist() if st.shape == base[1].shape else []
                raise AssertionError(f"mesh: macro-tick {m}: pod fired stages of {name} differ "
                                     f"from {base[0]}, first at [tick, row] {diff}")
            if not np.array_equal(nst, base[2]) or t0_ms != base[3]:
                raise AssertionError(f"mesh: macro-tick {m}: node fired stages or clock of "
                                     f"{name} differ from {base[0]}")
        deleted += int(np.count_nonzero(np.isin(base[1], np.nonzero(
            sims["unsharded"][0].cset.stage_delete)[0])))
        if m % MESH_CHURN_EVERY == MESH_CHURN_EVERY - 1 and m < MESH_MACROS - 1:
            # phase 3's churn on rows never touched before: released rows
            # are admitted again, deleted rows are left to their FSM
            lo = churns * 2 * CHURN
            released, deleting = perm[lo:lo + CHURN], perm[lo + CHURN:lo + 2 * CHURN]
            for name, (pods, _) in sims.items():
                t0 = time.perf_counter()
                for row in released.tolist():
                    pods.release(row)
                at = pods.now_ms + 2_000
                for row in deleting.tolist():
                    pods.request_delete(row, at)
                new_rows = [pods.admit(new_pod(N_PODS + churns * CHURN + i))
                            for i in range(CHURN)]
                churn_s[name] += time.perf_counter() - t0
                if sorted(new_rows) != sorted(released.tolist()):
                    raise AssertionError(f"mesh: {name}: admits did not reuse the released rows")
            churns += 1
    if deleted == 0:
        raise AssertionError("mesh: no requested delete reached its delete stage")
    final = {name: (sharded_columns(p), sharded_columns(n)) for name, (p, n) in sims.items()}
    ref = final["unsharded"]
    for name, cols in final.items():
        for kind, (got, want) in zip(("pods", "nodes"), zip(cols, ref)):
            for f in want[0]:
                assert_equal(f"mesh: final {kind} soa.{f} of {name}", got[0][f], want[0][f])
            if set(got[1]) != {want[1][0]}:
                raise AssertionError(f"mesh: final {kind} clocks of {name}: {got[1]} != {want[1]}")
    # the macro-ticks right after a churn carry its upload: a scatter of
    # the touched rows unsharded, a full re-upload on a mesh
    after = [m for m in range(1, MESH_MACROS) if m % MESH_CHURN_EVERY == 0]
    line = {name: {
        "ms_per_macro_tick": sum(t) / MESH_MACROS * 1e3,
        "median_ms": float(np.median(t)) * 1e3,
        "after_churn_mean_ms": float(np.mean([t[m] for m in after])) * 1e3,
        "after_churn_flush_ms": float(np.mean([flush_s[name][m] for m in after])) * 1e3,
        "after_churn_rest_ms": float(np.mean([t[m] - flush_s[name][m] for m in after])) * 1e3,
        "transitions_per_s": fired[name] / sum(t),
        "transitions": fired[name],
        "churn_s": churn_s[name],
    } for name, t in per_macro.items()}
    log(f"mesh: {MESH_MACROS} pod+node macro-ticks of K={MACRO_K} in lockstep, {churns} churns "
        f"of {CHURN} rows, {deleted} delete stages fired; fired stages equal on every tick and "
        f"final SoA equal across {list(sims)}  [{smi}]")
    log("mesh: " + json.dumps(line))

    # the bench loop over the 4 shards against run_ticks on the same state
    pods4 = sims[f"{MESH_SHARDS} shards of one card"][0]
    mesh4 = pods4.mesh
    params4, live4 = pods4.to_device()
    params1, live1 = sims["unsharded"][0].to_device()
    ks, ps = clone_sharded(live4), clone_soa(live1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ks, kc = M.sharded_run_ticks(mesh4, DT_MS, BENCH_TICKS)(params4, ks)
    n_fired = int(kc)
    w = time.perf_counter() - t0
    ps, pc = T.run_ticks(params1, ps, DT_MS, BENCH_TICKS)
    assert_equal("mesh: sharded_run_ticks count against run_ticks", kc, pc)
    assert_sharded_equal("mesh: sharded_run_ticks against run_ticks", ks, ps)
    log(f"mesh: sharded_run_ticks window: {BENCH_TICKS} ticks x {N_PODS} pods over "
        f"{MESH_SHARDS} shards in {w * 1e3:.2f} ms: {n_fired / w:.0f} transitions/s "
        f"({n_fired} fired, equal to run_ticks)  [{smi}]")
    del ks, ps

    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(MESH_SHARDS, devices=[device] * MESH_SHARDS, n_rows=DRYRUN_ROWS)
    log(f"mesh: dryrun_multichip over {MESH_SHARDS} shards of the card: "
        f"{time.perf_counter() - t0:.1f} s")
    counts = T.launches()
    log(f"mesh: launches {counts}; phase 3b took {time.perf_counter() - t_phase:.1f} s")
    missing = [k for k in ("sharded_tick", "sharded_run_ticks") if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the mesh path: {missing}")
    return counts, pods4


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


def device_kernels_ms(fn, reps: int) -> dict:
    """Mean device time in ms per call of ``fn``, over ``reps`` calls, of
    each name torch.profiler's CUDA activity records (empty when it
    records none).  Host-side operators, whose device time is that of
    the kernels they launch, are left out, so that nothing counts twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3 for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0
            and getattr(e, "device_type", None) != DeviceType.CPU}


def device_ms(fn, reps: int):
    """Mean device time in ms of the kernels ``fn`` launches, over
    ``reps`` calls, from torch.profiler's CUDA activity (None when the
    profiler records none).  Unlike cuda_ms it leaves out the host's
    dispatch, which bounds cuda_ms for kernels shorter than it."""
    return sum(device_kernels_ms(fn, reps).values()) or None


def tick_split(fn, live_soa, reps: int, smi: str, name: str) -> dict:
    """Where the device time of ``soa = fn(soa)`` chained on a copy of
    ``live_soa`` goes: its time by kernel name, the key schedule's share
    of it, and the time on an idle copy of the state (every fire_at
    NEVER, no rematch: rows are read, tested and written back, and
    nothing fires or rematches), the streaming floor; the gap to it is
    the fire, effect and rematch work."""
    from kwok_tpu_torch.engine.compiler import NEVER

    by_kernel = device_kernels_ms(chained(fn, clone_soa(live_soa)), reps)
    live = sum(by_kernel.values())
    key = sum(v for k, v in by_kernel.items() if "key_schedule" in k)
    idle_soa = clone_soa(live_soa)
    idle_soa.fire_at.fill_(NEVER)
    idle_soa.rematch.zero_()
    idle = device_ms(chained(fn, idle_soa), reps)
    split = {"live_device_ms": live, "idle_device_ms": idle,
             "rematch_work_ms": None if idle is None else live - idle,
             "key_schedule_device_ms": key,
             "key_schedule_share": key / live if live else None}
    log(f"{name} split: {json.dumps(split)}; by kernel {json.dumps(by_kernel)}  [{smi}]")
    return split


def wall_ms(fn, reps: int) -> float:
    """Mean host ms of ``fn`` up to the end of its work on the card, over
    ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / reps * 1e3


def flush_ms(sim, k: int, reps: int) -> dict:
    """``sim._flush_pending`` at k pending rows, on the host clock to the
    end of its work on the card: median and mean ms over ``reps`` flushes
    after one warm-up.  The host mirror is synced first, so each flush
    writes back what the SoA holds.  One more flush runs under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on a
    host-device sync."""
    sim._ensure_synced()
    rows = np.random.default_rng(13).choice(sim.num_rows, k, replace=False).tolist()
    times = []
    for i in range(reps + 2):
        for r in rows:
            sim._mark_pending(r)
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.set_sync_debug_mode("error")
            try:
                sim._flush_pending()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            continue
        t0 = time.perf_counter()
        sim._flush_pending()
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
    return {"rows": k, "median_ms": float(np.median(times)) * 1e3,
            "mean_ms": float(np.mean(times)) * 1e3, "sync_free": True}


def chained(fn, soa):
    """A call of ``soa = fn(soa)``: each call continues from the state,
    clock and key the last one left, as the simulator's calls do (a
    repeat from the same clock would find the rows already re-armed)."""
    state = [soa]

    def call():
        state[0] = fn(state[0])

    return call


def chained_ms(fn, soa, reps: int) -> float:
    return cuda_ms(chained(fn, soa), reps)


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


def phase_measure(counts, pod_sim, wide_sim, mesh_sim, smi):
    from kwok_tpu_torch.ops import kernels, prng
    from kwok_tpu_torch.ops import tick as T
    from kwok_tpu_torch.parallel import mesh as M

    entries = []
    src_tick = "kwok_tpu_torch/csrc/tick.cu"

    def entry(name, shape, source, replaces, ms, dev_ms, plain_ms, bound, err, library_ms=None,
              **extra):
        entries.append(dict(
            name=name, shape=shape, route="cuda", source=source, replaces=replaces,
            launches=counts.get(name), max_abs_err=err, ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms,
            **extra))
        dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        log(f"{name}: {ms:.4f} ms (device time {dev}), plain {plain_ms:.4f} ms, "
            f"bound {bound[0]:.4f} ms ({bound[1]}), max_abs_err {err}  [{smi}]")

    # run_ticks_collect at the production shape: 1M pods, K=8
    params, live = pod_sim.to_device()
    rematch0 = int(live.rematch.sum())
    ks, ps = clone_soa(live), clone_soa(live)
    ks, kst, block = run_collect(params, ks, MACRO_K)
    ps, pst = T._run_ticks_collect_impl(params, ps, DT_MS, MACRO_K)
    assert_equal("main-shape run_ticks_collect", kst, pst)
    assert_equal("main-shape run_ticks_collect host block", block, pst.cpu())
    assert_soa_equal("main-shape run_ticks_collect", ks, ps)
    err = max_abs_err([(kst, pst)] + list(zip(ks, ps)))
    fired = int((kst >= 0).sum())
    # the launches are in stream order, so one block serves them all
    collect = lambda s: T.run_ticks_collect(params, s, DT_MS, MACRO_K, host=block)[0]  # noqa: E731
    ms = chained_ms(collect, clone_soa(live), 20)
    split = tick_split(collect, live, 20, smi, "run_ticks_collect")
    dev_ms = split["live_device_ms"] or None
    plain_ms = chained_ms(lambda s: T._run_ticks_collect_impl(params, s, DT_MS, MACRO_K)[0],
                          clone_soa(live), 2)
    S, KC = params.cond_col.shape
    smem = kernels.tick_smem_bytes(S, KC, live.features.shape[1])
    log(f"row kernel at the pod set's widths (S={S}, KC={KC}, C={live.features.shape[1]}): "
        f"{smem} bytes of dynamic shared memory per block")
    entry("run_ticks_collect", f"{N_PODS:,} pod rows, K=8 (the main path's macro-tick)",
          src_tick, "kwok_tpu/ops/tick.py:241", ms, dev_ms, plain_ms,
          tick_bound(params, N_PODS, MACRO_K, fired + rematch0, MACRO_K * N_PODS), err,
          split=split, smem_bytes=smem)

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
    window = lambda s: T.run_ticks(params, s, DT_MS, BENCH_TICKS)[0]  # noqa: E731
    ms = chained_ms(window, clone_soa(live), 3)
    split = tick_split(window, live, 3, smi, "run_ticks")
    dev_ms = split["live_device_ms"] or None
    entry("run_ticks", f"{N_PODS:,} pod rows, K=600 (the bench-style window)",
          src_tick, "kwok_tpu/ops/tick.py:323", ms, dev_ms, plain_ms,
          tick_bound(params, N_PODS, BENCH_TICKS, int(kc) + rematch0, 4), err, split=split)

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
    one = lambda s: T.tick(wparams, s, DT_MS)[0]  # noqa: E731
    ms = chained_ms(one, clone_soa(wlive), 20)
    dev_ms = device_ms(chained(one, clone_soa(wlive)), 20)
    plain_ms = chained_ms(lambda s: T._tick_impl(wparams, s, DT_MS)[0], clone_soa(wlive), 3)
    entry("tick", f"{N_PODS:,} pod rows, S={WIDE_STAGES}: a synthetic set that covers "
          "the >126-stage branch, not a user workload",
          src_tick, "kwok_tpu/ops/tick.py:217", ms, dev_ms, plain_ms,
          tick_bound(wparams, N_PODS, 1, int(ko.fired_count) + rematch0, 6 * N_PODS + 4), err)

    # scatter_rows at the churn's shape: 30,000 rows, unpadded
    k = 3 * CHURN
    dev = live.features.device
    C = live.features.shape[1]
    batch = scatter_batch(N_PODS, C, k, 11, repeats=False)  # a flush's rows are distinct
    ks, ps = clone_soa(live), clone_soa(live)
    T.scatter_rows(ks, *batch)
    card_batch = on_card(batch, dev)
    T._scatter_rows_impl(ps, *card_batch)
    assert_soa_equal("main-shape scatter_rows", ks, ps)
    err = max_abs_err(list(zip(ks, ps)))
    # the kernel alone, on the packed batch already on the card, against
    # the plain version; then the wrapper from the host batch (pack,
    # range check, copy, kernel) and the simulator's flush, on the host
    # clock to the end of their work on the card
    packed = T.pack_batch(batch[0], batch[1:], N_PODS, dev)
    staged = packed.host.to(dev)
    ms = cuda_ms(lambda: kernels.scatter_rows(ks, staged, packed.layout), 50)
    dev_ms = device_ms(lambda: kernels.scatter_rows(ks, staged, packed.layout), 50)
    plain_ms = cuda_ms(lambda: T._scatter_rows_impl(ps, *card_batch), 20)
    wrapper_ms = wall_ms(lambda: T.scatter_rows(ks, *batch), 20)
    flush = flush_ms(pod_sim, k, 20)
    log(f"scatter_rows from a host batch (pack, check, copy, kernel): {wrapper_ms:.4f} ms; "
        f"DeviceSimulator._flush_pending at {k:,} rows: {json.dumps(flush)}  [{smi}]")
    nbytes = k * 4 + 2 * k * (C * 4 + 5 * 4 + 2)  # indices; batch read; rows written
    entry("scatter_rows", f"{k:,} rows, C={C} (the churn's flush, unpadded)",
          "kwok_tpu_torch/csrc/scatter.cu", "kwok_tpu/ops/tick.py:275",
          ms, dev_ms, plain_ms, (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"), err,
          wrapper_ms=wrapper_ms, flush_ms=flush)
    # lease_tick at the facade's lane: LANE_CAPACITY slots, N_NODES live
    # with fire times spread over one renew interval plus its jitter,
    # ticked every DT_MS as the node player ticks it
    from kwok_tpu_torch.engine.compiler import NEVER
    from kwok_tpu_torch.ops import prng

    renew, jitter = 10_000, 400
    fire = np.full(LANE_CAPACITY, NEVER, np.int32)
    fire[:N_NODES] = np.random.default_rng(5).integers(0, renew + jitter, N_NODES)
    lane0 = T.LeaseLane(fire_at=torch.from_numpy(fire).to(live.features.device),
                        key=prng.prng_key(5, live.features.device))
    reps = 200
    # the due slots of the timed calls, counted on the plain version
    # (the operation term of the bound: two threefry draws per renewal)
    due_total, lane, now = 0, lane0, 0
    for _ in range(reps):
        now += DT_MS
        lane, due, _ = T._lease_tick_impl(lane, now, renew, jitter)
        due_total += int(due.sum())
    k, kd, kl = T.lease_tick(lane0, DT_MS, renew, jitter)
    p, pd, pl = T._lease_tick_impl(lane0, DT_MS, renew, jitter)
    pairs = [(k.fire_at, p.fire_at), (kd, pd), (kl, pl), (k.key, p.key)]
    for (got, want), f in zip(pairs, ("fire_at", "due", "lag", "key")):
        assert_equal(f"main-shape lease_tick {f}", got, want)
    err = max_abs_err(pairs)

    def lease_chain(fn):
        """A call of ``fn`` on the lane the last one left, at a later now."""
        state = [lane0, 0]

        def call():
            state[1] += DT_MS
            state[0] = fn(state[0], state[1], renew, jitter)[0]

        return call

    ms = cuda_ms(lease_chain(T.lease_tick), reps)
    dev_ms = device_ms(lease_chain(T.lease_tick), reps)
    plain_ms = cuda_ms(lease_chain(T._lease_tick_impl), reps)
    nbytes = LANE_CAPACITY * (4 + 4 + 1 + 4) + 2 * 8  # fire_at in; fire_at, due, lag out; keys
    ops = LANE_CAPACITY * ROW_TICK_OPS + due_total / reps * 2 * DRAW_OPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    entry("lease_tick", f"{LANE_CAPACITY:,} slots, {N_NODES:,} live "
          f"({due_total / reps:.1f} due per {DT_MS} ms tick; the facade's lane)",
          "kwok_tpu_torch/csrc/lease.cu", "kwok_tpu/ops/tick.py:305", ms, dev_ms, plain_ms,
          (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"), err)

    # sharded_tick at the mesh path's shape: 1M pods over 4 shards of the card
    mparams, mlive = mesh_sim.to_device()
    mesh = mesh_sim.mesh
    rematch0 = sum(int(s.rematch.sum()) for s in mlive.shards)
    step = M.sharded_tick(mesh, DT_MS)
    ks, ps = clone_sharded(mlive), clone_sharded(mlive)
    ks, ko = step(mparams, ks)
    ps, po = M._sharded_tick_impl(mesh, mparams, ps, DT_MS)
    pairs = [(ko.fired_count, po.fired_count)]
    for f in ("fired", "fired_stage", "deleted"):
        pairs.append((getattr(ko, f).to_host(), getattr(po, f).to_host()))
    pairs += [(ks.column(f).to_host(), ps.column(f).to_host()) for f in M.ROW_FIELDS]
    for i, (got, want) in enumerate(pairs):
        assert_equal(f"main-shape sharded_tick output {i}", got, want)
    err = max_abs_err(pairs)
    sharded_one = lambda s: step(mparams, s)[0]  # noqa: E731
    ms = chained_ms(sharded_one, clone_sharded(mlive), 20)
    dev_ms = device_ms(chained(sharded_one, clone_sharded(mlive)), 20)
    plain_ms = chained_ms(lambda s: M._sharded_tick_impl(mesh, mparams, s, DT_MS)[0],
                          clone_sharded(mlive), 3)
    entry("sharded_tick", f"{N_PODS:,} pod rows over {MESH_SHARDS} shards of one card, one "
          "tick (the mesh path's per-tick call)",
          src_tick, "kwok_tpu/parallel/mesh.py:94", ms, dev_ms, plain_ms,
          tick_bound(mparams[0], N_PODS, 1, int(ko.fired_count) + rematch0, 6 * N_PODS + 4), err)

    # sharded_run_ticks at the bench window's shape over the same shards
    run = M.sharded_run_ticks(mesh, DT_MS, BENCH_TICKS)
    ks, ps = clone_sharded(mlive), clone_sharded(mlive)
    ks, kc = run(mparams, ks)
    t0 = time.perf_counter()
    ps, pc = M._sharded_run_ticks_impl(mesh, mparams, ps, DT_MS, BENCH_TICKS)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert_equal("main-shape sharded_run_ticks count", kc, pc)
    pairs = [(kc, pc)] + [(ks.column(f).to_host(), ps.column(f).to_host()) for f in M.ROW_FIELDS]
    for i, (got, want) in enumerate(pairs):
        assert_equal(f"main-shape sharded_run_ticks output {i}", got, want)
    err = max_abs_err(pairs)
    window = lambda s: run(mparams, s)[0]  # noqa: E731
    ms = chained_ms(window, clone_sharded(mlive), 3)
    dev_ms = device_ms(chained(window, clone_sharded(mlive)), 3)
    entry("sharded_run_ticks", f"{N_PODS:,} pod rows over {MESH_SHARDS} shards of one card, "
          f"K={BENCH_TICKS} (the bench-style window)",
          src_tick, "kwok_tpu/parallel/mesh.py:116", ms, dev_ms, plain_ms,
          tick_bound(mparams[0], N_PODS, BENCH_TICKS, int(kc) + rematch0, 4), err)

    # threefry, the device functions every tick and lease kernel inlines,
    # checked alone at one draw per pod row: split(key, n) and uniform(key, n)
    key = prng.prng_key(0, live.features.device)
    kpairs, ku = kernels.threefry_draws(key, N_PODS)
    pairs = [(kpairs, prng.split(key, N_PODS)),
             (ku.view(torch.int32), prng.uniform(key, N_PODS).view(torch.int32))]
    for (got, want), f in zip(pairs, ("split", "uniform")):
        assert_equal(f"main-shape threefry {f}", got, want)
    err = max_abs_err(pairs)
    ms = cuda_ms(lambda: kernels.threefry_draws(key, N_PODS), 50)
    dev_ms = device_ms(lambda: kernels.threefry_draws(key, N_PODS), 50)
    plain_ms = cuda_ms(lambda: (prng.split(key, N_PODS), prng.uniform(key, N_PODS)), 5)
    nbytes = N_PODS * (8 + 4) + 8  # the [n, 2] keys and the [n] floats out; the key in
    ops = N_PODS * (2 * DRAW_OPS - 3)  # a split is one threefry, a uniform one more and 3
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    entry("threefry", f"{N_PODS:,} split keys and uniforms, checked alone; inside the tick "
          "and lease kernels it runs inline, so its launches are theirs",
          "kwok_tpu_torch/csrc/threefry.cuh", "kwok_tpu/ops/tick.py:144", ms, dev_ms, plain_ms,
          (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"), err)
    order = ["threefry", "tick", "run_ticks_collect", "run_ticks", "scatter_rows", "lease_tick",
             "sharded_tick", "sharded_run_ticks"]
    return sorted(entries, key=lambda e: order.index(e["name"]))


# ------------------------------------------------------------------ phase 5


class TracebackCounter:
    """``sys.stderr``, passed through, counting the tracebacks printed on
    it: the players' tick loops print and survive what they catch."""

    def __init__(self, inner):
        self.inner = inner
        self.count = 0

    def write(self, text):
        self.count += text.count("Traceback (most recent call last)")
        return self.inner.write(text)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class StackSampler(threading.Thread):
    """A sampling profiler of the players' tick threads: every
    ``interval`` s it reads each thread's Python stack and counts every
    function of this repository on it ("on_stack": the share of samples
    a function, with what it calls, was running) and the innermost such
    function ("innermost": its own code, or a call outside the
    repository)."""

    def __init__(self, threads, interval: float = 0.01):
        super().__init__(daemon=True)
        self.threads = threads  # name -> threading.Thread
        self.interval = interval
        self.done = threading.Event()
        self.reset()

    def run(self):
        idents = {t.ident: name for name, t in self.threads.items()}
        while not self.done.wait(self.interval):
            frames = sys._current_frames()
            for ident, name in idents.items():
                f = frames.get(ident)
                if f is None:
                    continue
                self.samples[name] += 1
                seen = []
                while f is not None:
                    path = f.f_code.co_filename
                    if path.startswith(HERE):
                        seen.append(f"{os.path.relpath(path, HERE)}:{f.f_code.co_name}")
                    f = f.f_back
                self.on_stack[name].update(set(seen))
                if seen:
                    self.innermost[name][seen[0]] += 1

    def reset(self):
        self.samples = Counter()
        self.on_stack = {name: Counter() for name in self.threads}
        self.innermost = {name: Counter() for name in self.threads}

    def top(self, k: int = 12) -> dict:
        def shares(counter, n):
            return {fn: round(c / max(n, 1), 4) for fn, c in counter.most_common(k)}

        return {name: {"samples": self.samples[name],
                       "on_stack": shares(self.on_stack[name], self.samples[name]),
                       "innermost": shares(self.innermost[name], self.samples[name])}
                for name in self.threads}


def facade_pod(i: int, n_nodes: int) -> dict:
    """The reference bench's chaos-labelled pod (``bench.py:681-697``),
    bound to node ``i % n_nodes``."""
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"pod-{i}",
            "namespace": "default",
            "uid": "uid",
            "labels": {"pod-container-running-failed.stage.kwok.x-k8s.io": "true"},
        },
        "spec": {
            "nodeName": f"node-{i % n_nodes}",
            "containers": [{"name": "app", "image": "fake"}],
        },
        "status": {},
    }


def facade_node(i: int) -> dict:
    return {"apiVersion": "v1", "kind": "Node", "metadata": {"name": f"node-{i}"},
            "spec": {}, "status": {}}


def rows_started(player) -> int:
    """Rows whose object carries a status phase: the first stage of every
    pod and node stage set writes one."""
    return sum(1 for o in list(player.sim.objects)
               if o is not None and (o.get("status") or {}).get("phase"))


def p99(values) -> float:
    v = sorted(values)
    return v[int(0.99 * (len(v) - 1))] if v else float("nan")


def leases_unheld_or_expired(leases, holder: str, n: int, now: float) -> int:
    """How many of the n node Leases are missing, not held by ``holder``,
    or expired at ``now`` (seconds since the epoch): renewTime +
    leaseDurationSeconds <= now."""
    bad = max(0, n - len(leases))
    for lease in leases:
        spec = lease.get("spec") or {}
        renewed = spec.get("renewTime")
        if spec.get("holderIdentity") != holder or not renewed:
            bad += 1
        elif (datetime.datetime.fromisoformat(renewed).timestamp()
              + float(spec.get("leaseDurationSeconds") or 0)) <= now:
            bad += 1
    return bad


def lease_samples(list_leases, holder: str, n: int, t0: float, renew_s: float) -> list:
    """The window: RENEW_PERIODS renewal periods from ``t0`` (perf
    counter), with the node Leases read at its start and at the end of
    each period; for each sample, the count of leases missing, unheld or
    expired when it was read."""
    out = []
    for k in range(RENEW_PERIODS + 1):
        time.sleep(max(0.0, t0 + k * renew_s - time.perf_counter()))
        now = time.time()
        out.append(leases_unheld_or_expired(list_leases(), holder, n, now))
    return out


def check_leases(what: str, renewals: int, n_nodes: int, wall: float, renew_s: float,
                 unheld) -> None:
    """The lease contract over a window of whole renewal periods: at
    least 90% of one renewal a lease a period, and no lease unheld or
    expired at any sample."""
    want = 0.9 * n_nodes * wall / renew_s
    if renewals < want:
        raise AssertionError(f"{what}: {renewals} lease renewals in {wall:.1f} s, "
                             f"want at least {want:.0f}")
    if any(unheld):
        raise AssertionError(f"{what}: leases missing, unheld or expired at the window's "
                             f"samples: {unheld}")


def phase_facade(smi, device, t_script):
    """Phase 5: ``Controller(backend="device")`` on a full store, started
    as the daemon starts it; returns the launches of the phase.  Warming
    must end by ``t_script + SCRIPT_BUDGET_S`` less the window and
    ``FACADE_STOP_S``."""
    import gc

    from kwok_tpu_torch.api.config import KwokConfiguration
    from kwok_tpu_torch.cluster.store import ResourceStore
    from kwok_tpu_torch.controllers import Controller
    from kwok_tpu_torch.controllers import device_player as DP
    from kwok_tpu_torch.controllers.device_lease import DeviceLeaseLane
    from kwok_tpu_torch.ops import tick as T
    from kwok_tpu_torch.stages import default_node_stages, load_builtin

    n_pods, n_nodes = FACADE_PODS, N_NODES
    t_phase = time.perf_counter()
    store = ResourceStore()
    for lo in range(0, n_nodes, 10_000):
        store.bulk([{"verb": "create", "data": facade_node(i)}
                    for i in range(lo, min(lo + 10_000, n_nodes))])
    for lo in range(0, n_pods, 10_000):
        store.bulk([{"verb": "create", "data": facade_pod(i, n_nodes)}
                    for i in range(lo, min(lo + 10_000, n_pods))])
    t_store = time.perf_counter() - t_phase
    log(f"facade: store holds {store.count('Node')} nodes and {store.count('Pod')} pods "
        f"({t_store:.1f} s); fast drain loaded: {DP._FAST is not None}")
    conf = KwokConfiguration(manage_all_nodes=True, backend="device",
                             device_capacity=LANE_CAPACITY)
    ctr = Controller(
        store, conf, seed=0, device=device,
        local_stages={"Pod": load_builtin("pod-general") + load_builtin("pod-chaos"),
                      "Node": default_node_stages(lease=True)})
    # the daemon's GC tuning (kwok_tpu/cmd/kwok.py:368, :462-463)
    gc.set_threshold(200_000, 100, 100)
    tracebacks = TracebackCounter(sys.stderr)
    sys.stderr = tracebacks
    T.reset_launches()
    try:
        t_start = time.perf_counter()
        ctr.start()
        gc.collect()
        gc.freeze()
        missing = [k for k in ("Pod", "Node") if k not in ctr.device_players]
        if missing:
            raise AssertionError(f"facade: no device player for {missing}: "
                                 f"{sorted(ctr.device_players)}")
        pods, nodes = ctr.device_players["Pod"], ctr.device_players["Node"]
        lane = ctr.node_leases._lane if ctr.node_leases is not None else None
        if not isinstance(lane, DeviceLeaseLane) or nodes.post_tick != lane.tick:
            raise AssertionError(f"facade: no device lease lane on the node player: {lane!r}")
        sampler = StackSampler({"pod": pods._threads[0], "node": nodes._threads[0]})
        sampler.start()

        # admission of every row, every held lease on the lane, and the
        # first transition of every row
        renew_s = ctr.node_leases.renew_interval * (1 + ctr.node_leases.renew_jitter)
        window_s = RENEW_PERIODS * renew_s
        deadline = (t_script + SCRIPT_BUDGET_S - DAEMON_RESERVE_S - KWOKCTL_RESERVE_S
                    - window_s - FACADE_STOP_S)
        deadline_s = deadline - t_start
        log(f"facade: warming may take {deadline_s:.0f} s")
        admitted_at = started = None
        last_log = time.perf_counter()
        while True:
            now = time.perf_counter()
            if tracebacks.count:
                raise AssertionError(f"facade: {tracebacks.count} tracebacks while warming")
            if now > deadline:
                raise AssertionError(
                    f"facade: not warm after {deadline_s:.0f} s: {len(pods._rows)}/{n_pods} pods "
                    f"and {len(nodes._rows)}/{n_nodes} nodes admitted, {len(lane)} leases on "
                    f"the lane, {pods.transitions} pod and {nodes.transitions} node "
                    f"transitions, rows started {(rows_started(pods), rows_started(nodes))}")
            if admitted_at is None and len(pods._rows) == n_pods and len(nodes._rows) == n_nodes:
                admitted_at = now
                log(f"facade: admitted {n_pods} pods and {n_nodes} nodes in "
                    f"{now - t_start:.1f} s ({n_pods / (now - t_start):.0f} pods/s)")
            if (admitted_at is not None and len(lane) == n_nodes
                    and pods.transitions >= n_pods and nodes.transitions >= n_nodes):
                started = (rows_started(pods), rows_started(nodes))
                if started == (n_pods, n_nodes):
                    break
            if now - last_log > 30:
                last_log = now
                log(f"facade: warming, {now - t_start:.0f} s: {len(pods._rows)} pods and "
                    f"{len(nodes._rows)} nodes admitted, {len(lane)} leases on the lane, "
                    f"{pods.transitions} pod transitions, rows started {started}")
            time.sleep(2.0)
        t_warm = time.perf_counter() - t_start
        log(f"facade: every row admitted and past its first transition, {len(lane)} leases "
            f"on the lane, after {t_warm:.1f} s ({pods.transitions} pod transitions)")
        log("facade: tick threads while warming, share of samples: " + json.dumps(sampler.top()))
        sampler.reset()

        # the timed window
        before = dict(T.launches())
        tr0 = (pods.transitions, nodes.transitions)
        d0, s0, h0, b0 = pods.t_device, pods.t_store, pods.t_host, pods.t_build
        r0, tb0 = lane.renew_count, tracebacks.count
        t0 = time.perf_counter()
        unheld = lease_samples(lambda: store.list("Lease", namespace=NODE_LEASE_NS)[0],
                               conf.id, n_nodes, t0, renew_s)
        wall = time.perf_counter() - t0
        after = dict(T.launches())
        sampler.done.set()
        log("facade: tick threads in the window, share of samples: " + json.dumps(sampler.top()))
        renewals = lane.renew_count - r0
        build = pods.t_build - b0
        line = {
            "pods": n_pods, "pods_cut_from": N_PODS, "nodes": n_nodes, "lane_slots": len(lane._fire_np),
            "window_s": wall,
            "transitions_per_s": (pods.transitions - tr0[0] + nodes.transitions - tr0[1]) / wall,
            "pod_transitions_per_s": (pods.transitions - tr0[0]) / wall,
            "node_transitions_per_s": (nodes.transitions - tr0[1]) / wall,
            "breakdown_s": {
                "device_tick_s": pods.t_device - d0,
                "store_bulk_s": pods.t_store - s0,
                "host_build_s": build,
                "host_drain_s": pods.t_host - h0 - build,
            },
            "tick_lag_p99_s": p99(pods.tick_lags),
            "node_tick_lag_p99_s": p99(nodes.tick_lags),
            "renewals": renewals,
            "renew_period_s": renew_s,
            "leases_unheld_or_expired_at_samples": unheld,
            "renew_lag_p99_s": p99(lane.renew_lags),
            "launches_in_window": {k: after[k] - before[k] for k in after},
            "fast_drain_loaded": DP._FAST is not None,
            "store_fill_s": t_store,
            "admit_s": admitted_at - t_start,
            "admitted_pods_per_s": n_pods / (admitted_at - t_start),
            "warm_s": t_warm,
            "device": smi,
        }
        log("facade: " + json.dumps(line))
        grew = [k for k in ("run_ticks_collect", "lease_tick")
                if line["launches_in_window"][k] <= 0]
        if grew:
            raise AssertionError(f"facade: kernels not launched in the window: {grew}")
        check_leases("facade", renewals, n_nodes, wall, renew_s, unheld)
        if tracebacks.count:
            raise AssertionError(f"facade: the tick loops printed {tracebacks.count} tracebacks")
        return dict(after)
    finally:
        sys.stderr = tracebacks.inner
        ctr.stop()
        gc.unfreeze()


# ------------------------------------------------------------------ phase 6

DAEMON_ID = "kwok-chip-smoke"
NODE_LEASE_S = 40  # the KwokConfiguration default, stated in the daemon's config
# what the device-backend daemon prints on SIGTERM: its kernel launches
LAUNCH_LINE = "kwok kernel launches "


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_process(args, out):
    """A Python subprocess of this checkout in its own process group,
    its output in the file ``out``."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    return subprocess.Popen([sys.executable, *args], cwd=HERE, env=env, stdout=out,
                            stderr=subprocess.STDOUT, start_new_session=True)


def stop_process(proc, timeout: float):
    """SIGTERM, then the exit code; the group is killed if the process
    outlives ``timeout`` (then None), and in any case once it has exited,
    so that nothing it started lives on."""
    import signal

    rc = proc.poll()
    if rc is None:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait(timeout=30)
    return rc


def read_output(out) -> str:
    out.flush()
    out.seek(0)
    return out.read().decode(errors="replace")


def daemon_launches(what: str, out: str) -> dict:
    """The kernel launches one device-backend daemon printed on its way
    out: ``out`` holds that daemon's output alone and exactly one launch
    line; fails unless the daemon's kernels were all launched."""
    lines = [ln for ln in out.splitlines() if ln.startswith(LAUNCH_LINE)]
    if len(lines) != 1:
        raise AssertionError(f"{what}: {len(lines)} launch lines, not one:\n{out[-4000:]}")
    launches = json.loads(lines[0][len(LAUNCH_LINE):])
    never = [k for k in ("run_ticks_collect", "lease_tick", "scatter_rows")
             if launches.get(k, 0) <= 0]
    if never:
        raise AssertionError(f"{what}: kernels not launched: {never}")
    return launches


class WatchCount(threading.Thread):
    """A watch of ``kind`` on the apiserver from ``since_rv``, each event
    handed to ``on_event(type, obj)`` on this thread; ``ended`` is set when
    the stream ends before ``stop``."""

    def __init__(self, client, kind: str, since_rv: int, on_event, namespace=None):
        super().__init__(daemon=True, name=f"watch-{kind}")
        self.stream = client.watch(kind, namespace=namespace, since_rv=since_rv)
        self.on_event = on_event
        self.stopping = False
        self.ended = False

    def run(self):
        for ev in self.stream:
            self.on_event(ev.type, ev.object)
        self.ended = not self.stopping

    def stop(self):
        self.stopping = True
        self.stream.stop()


class ClusterView:
    """What phases 6 and 7 read from the apiserver's watches: Nodes Ready,
    the node Leases' holders, renewals (MODIFIED events that keep the
    holder and move renewTime), the pods that have had a first
    transition (they carry a status phase) and those Running."""

    def __init__(self, holder: str):
        self.holder = holder
        self.node_ready = {}
        self.lease = {}  # name -> (holder, renewTime)
        self.renewals = 0
        self.started = set()
        self.running = set()

    def on_node(self, etype, obj):
        conds = (obj.get("status") or {}).get("conditions") or []
        self.node_ready[obj["metadata"]["name"]] = any(
            c.get("type") == "Ready" and c.get("status") == "True" for c in conds)

    def on_lease(self, etype, obj):
        spec = obj.get("spec") or {}
        now = (spec.get("holderIdentity"), spec.get("renewTime"))
        before = self.lease.get(obj["metadata"]["name"])
        self.lease[obj["metadata"]["name"]] = now
        if (etype == "MODIFIED" and before is not None and before[0] == now[0] == self.holder
                and before[1] != now[1]):
            self.renewals += 1

    def on_pod(self, etype, obj):
        name, phase = obj["metadata"]["name"], (obj.get("status") or {}).get("phase")
        if phase:
            self.started.add(name)
        if phase == "Running" and etype != "DELETED":
            self.running.add(name)
        else:
            self.running.discard(name)

    def counts(self):
        """Nodes Ready, leases held by the holder, pods started (the
        copies are taken whole, under the interpreter lock)."""
        return (sum(list(self.node_ready.values())),
                sum(1 for h, _ in list(self.lease.values()) if h == self.holder),
                len(self.started))


def scrape(url: str) -> dict:
    """The daemon's self metrics: {(name, sorted labels): value}."""
    import urllib.request

    from kwok_tpu_torch.utils.promtext import iter_samples

    with urllib.request.urlopen(url, timeout=30) as resp:
        text = resp.read().decode()
    return {(name, tuple(sorted(labels.items()))): v for name, labels, v in iter_samples(text)}


def metric(samples: dict, name: str, **labels):
    """A sample's value, None when the daemon does not publish it."""
    return samples.get((name, tuple(sorted(labels.items()))))


def daemon_config(path: str) -> None:
    """The daemon's --config: phase 5's stages (pod-general + pod-chaos,
    the default lease node stages) and its device capacity."""
    import yaml

    from kwok_tpu_torch.stages import load_builtin_docs

    docs = (load_builtin_docs("pod-general") + load_builtin_docs("pod-chaos")
            + load_builtin_docs("node-fast")
            + [d for d in load_builtin_docs("node-heartbeat")
               if d["metadata"]["name"] == "node-heartbeat-with-lease"])
    docs.append({"apiVersion": "config.kwok.x-k8s.io/v1alpha1", "kind": "KwokConfiguration",
                 "options": {"deviceCapacity": LANE_CAPACITY,
                             "nodeLeaseDurationSeconds": NODE_LEASE_S}})
    with open(path, "w") as f:
        yaml.safe_dump_all(docs, f)


def phase_daemon(smi, t_script):
    """Phase 6: the port's apiserver and kwok daemon as subprocesses, the
    daemon on the card with ``--backend device``; returns the daemon's
    launches.  Warming must end by ``t_script + SCRIPT_BUDGET_S`` less
    the window and DAEMON_STOP_S."""
    import tempfile

    from kwok_tpu_torch.cluster.client import ClusterClient

    n_pods, n_nodes = DAEMON_PODS, N_NODES
    t_phase = time.perf_counter()
    api_port, kubelet_port = free_port(), free_port()
    url = f"http://127.0.0.1:{api_port}"
    procs, watches = [], []
    with tempfile.TemporaryDirectory() as tmp, \
            open(os.path.join(tmp, "apiserver.log"), "w+b") as api_out, \
            open(os.path.join(tmp, "kwok.log"), "w+b") as kwok_out:
        try:
            procs.append(start_process(
                ["-m", "kwok_tpu_torch.cmd.apiserver", "--port", str(api_port)], api_out))
            client = ClusterClient(url)
            if not client.wait_ready(timeout=60):
                raise AssertionError("daemon: the apiserver did not come up:\n"
                                     + read_output(api_out)[-4000:])
            # a scale-up in chunks of 10,000, as `kwokctl scale` makes one
            for lo in range(0, n_nodes, 10_000):
                client.bulk([{"verb": "create", "data": facade_node(i)}
                             for i in range(lo, min(lo + 10_000, n_nodes))])
            for lo in range(0, n_pods, 10_000):
                client.bulk([{"verb": "create", "data": facade_pod(i, n_nodes)}
                             for i in range(lo, min(lo + 10_000, n_pods))])
            t_fill = time.perf_counter() - t_phase
            counts = (client.count("Node"), client.count("Pod"))
            if counts != (n_nodes, n_pods):
                raise AssertionError(f"daemon: the apiserver holds {counts} nodes and pods")
            log(f"daemon: the apiserver holds {n_nodes} nodes and {n_pods} pods ({t_fill:.1f} s)")

            view = ClusterView(DAEMON_ID)
            rv = client.resource_version
            for kind, on_event, ns in (("Node", view.on_node, None),
                                       ("Lease", view.on_lease, NODE_LEASE_NS),
                                       ("Pod", view.on_pod, None)):
                watches.append(WatchCount(client, kind, rv, on_event, namespace=ns))
                watches[-1].start()
            config = os.path.join(tmp, "kwok.yaml")
            daemon_config(config)
            t_start = time.perf_counter()
            daemon = start_process(
                ["-m", "kwok_tpu_torch.cmd.kwok", "--backend", "device", "--server", url,
                 "--server-address", f"127.0.0.1:{kubelet_port}", "--seed", "0",
                 "--id", DAEMON_ID, "--config", config], kwok_out)
            procs.append(daemon)

            # every Node Ready, every node Lease held by the daemon, and the
            # first transition of every pod, read from the apiserver
            renew_s = NODE_LEASE_S / 4 * (1 + 0.04)
            window_s = RENEW_PERIODS * renew_s
            deadline = t_script + SCRIPT_BUDGET_S - KWOKCTL_RESERVE_S - window_s - DAEMON_STOP_S
            log(f"daemon: warming may take {deadline - t_start:.0f} s")
            last_log = t_start
            while True:
                now = time.perf_counter()
                ready, held, started = view.counts()
                if daemon.poll() is not None:
                    raise AssertionError(f"daemon: exited with {daemon.returncode} while warming:\n"
                                         + read_output(kwok_out)[-4000:])
                if any(w.ended for w in watches):
                    raise AssertionError("daemon: a watch on the apiserver ended")
                if (ready, held, started) == (n_nodes, n_nodes, n_pods):
                    break
                if now > deadline:
                    raise AssertionError(
                        f"daemon: not warm after {now - t_start:.0f} s: {ready}/{n_nodes} nodes "
                        f"Ready, {held} leases held, {started}/{n_pods} pods started")
                if now - last_log > 30:
                    last_log = now
                    log(f"daemon: warming, {now - t_start:.0f} s: {ready} nodes Ready, {held} "
                        f"leases held, {started} pods started")
                time.sleep(2.0)
            t_warm = time.perf_counter() - t_start
            log(f"daemon: every node Ready and its lease held, every pod started, after "
                f"{t_warm:.1f} s")

            # the timed window
            metrics_url = f"http://127.0.0.1:{kubelet_port}/metrics"
            m0, r0 = scrape(metrics_url), view.renewals
            t0 = time.perf_counter()
            unheld = lease_samples(lambda: client.list("Lease", namespace=NODE_LEASE_NS)[0],
                                   DAEMON_ID, n_nodes, t0, renew_s)
            wall = time.perf_counter() - t0
            m1, renewals = scrape(metrics_url), view.renewals - r0
            if any(w.ended for w in watches):
                raise AssertionError("daemon: a watch on the apiserver ended")

            def rate(kind):
                played = [metric(m, "kwok_stage_transitions_total", kind=kind, backend="device")
                          for m in (m0, m1)]
                return None if None in played else (played[1] - played[0]) / wall

            line = {
                "pods": n_pods, "pods_cut_from": N_PODS, "nodes": n_nodes, "window_s": wall,
                "pod_transitions_per_s": rate("Pod"),
                "node_transitions_per_s": rate("Node"),
                "tick_lag_p99_s": metric(m1, "kwok_tick_lag_seconds", kind="Pod", quantile="0.99"),
                "node_tick_lag_p99_s": metric(m1, "kwok_tick_lag_seconds", kind="Node",
                                              quantile="0.99"),
                "renewals": renewals,
                "renew_period_s": renew_s,
                "leases_unheld_or_expired_at_samples": unheld,
                "renew_lag_p99_s": metric(m1, "kwok_lease_renew_lag_seconds", quantile="0.99"),
                "fill_s": t_fill,
                "warm_s": t_warm,
                "device": smi,
            }
            log("daemon: " + json.dumps(line))
            for kind in ("Pod", "Node"):
                played = metric(m1, "kwok_stage_transitions_total", kind=kind, backend="device")
                host = metric(m1, "kwok_stage_transitions_total", kind=kind, backend="host")
                if not played or host is not None:
                    raise AssertionError(f"daemon: {kind} is not played on the device backend: "
                                         f"{played} device transitions, host {host}")
            check_leases("daemon", renewals, n_nodes, wall, renew_s, unheld)

            t_stop = time.perf_counter()
            rc = stop_process(daemon, DAEMON_STOP_S)
            out = read_output(kwok_out)
            log(f"daemon: stopped in {time.perf_counter() - t_stop:.1f} s, exit code {rc}")
            if rc != 0:
                raise AssertionError(f"daemon: exit code {rc} on SIGTERM:\n{out[-4000:]}")
            if "Traceback (most recent call last)" in out:
                raise AssertionError(f"daemon: printed a traceback:\n{out[-8000:]}")
            started_line = [ln for ln in out.splitlines() if "kwok controller started" in ln]
            log(f"daemon: {started_line}")
            launches = daemon_launches("daemon", out)
            log(f"daemon: launches {launches}")
            return launches
        finally:
            for w in watches:
                w.stop()
            for proc in reversed(procs):
                stop_process(proc, 30)


# ------------------------------------------------------------------ phase 7

# The upstream kwokctl CI benchmark (reference
# test/kwokctl/kwokctl_benchmark_test.sh:110-112): 2,000 nodes Ready
# within 120 s, then 5,000 pods Running within 240 s, created in shards
# with nodeName as its generator places them; then pods the scheduler
# must bind.  Nothing is cut.
KWOKCTL_NODES = 2_000
KWOKCTL_PODS = 5_000
KWOKCTL_POD_SHARDS = 10
KWOKCTL_UNBOUND = 500
KWOKCTL_NODES_S = 120.0
KWOKCTL_PODS_S = 240.0
KWOKCTL_UNBOUND_S = 120.0
KWOKCTL_ID = "kwok-controller"  # the daemon's --id, its component name


def kwokctl(env, *args, timeout: float = 300.0) -> subprocess.CompletedProcess:
    """``python -m kwok_tpu_torch.cmd.kwokctl --name smoke ...`` as users
    run it; fails on a non-zero exit."""
    out = subprocess.run([sys.executable, "-m", "kwok_tpu_torch.cmd.kwokctl", "--name", "smoke",
                          *args], cwd=HERE, env=env, capture_output=True, text=True,
                         timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"kwokctl {' '.join(args)}: exit code {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return out


def wait_until(what: str, cond, timeout: float, poll: float = 0.5) -> float:
    """Seconds until ``cond()`` holds; fails after ``timeout``."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"kwokctl: {what} not within {timeout:.0f} s")
        time.sleep(poll)
    return time.perf_counter() - t0


def phase_kwokctl(smi, device):
    """Phase 7: ``kwokctl create cluster --backend device`` starts the
    port's five components, the daemon on ``device``; the reference CI
    benchmark's nodes and pods through ``kwokctl scale``, pods the
    scheduler binds, one window of three renewal periods, phase 8's
    chaos run, ``get components``, ``snapshot save`` and ``delete
    cluster``; returns the launches of phase 7's daemon and of the one
    the supervisor restarted in phase 8."""
    import shutil
    import tempfile

    import yaml

    from kwok_tpu_torch.cluster.client import ClusterClient
    from kwok_tpu_torch.cluster.store import ResourceStore
    from kwok_tpu_torch.cluster.wal import read_state_file
    from kwok_tpu_torch.ctl.runtime import BinaryRuntime
    from kwok_tpu_torch.snapshot import load

    t_phase = time.perf_counter()
    home = tempfile.mkdtemp(prefix="kwokctl-smoke-")
    env = {k: v for k, v in os.environ.items() if k != "KWOK_TORCH_DEVICE"}
    env.update(KWOK_TPU_HOME=home, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    if device.type == "cpu":
        env["KWOK_TORCH_DEVICE"] = "cpu"  # a rehearsal on a machine without a card
    workdir = os.path.join(home, "clusters", "smoke")
    watches, created = [], False
    try:
        kwokctl(env, "create", "cluster", "--backend", "device", "--enable-tracing",
                "--wait", "90")
        created = True
        t_created = time.perf_counter() - t_phase
        with open(os.path.join(workdir, "components.json")) as f:
            modules = {c["name"]: c["args"][c["args"].index("-m") + 1] for c in json.load(f)}
        if len(modules) != 5 or any(not m.startswith("kwok_tpu_torch.cmd.")
                                    for m in modules.values()):
            raise AssertionError(f"kwokctl: components {modules}")
        daemon_log = os.path.join(workdir, "logs", f"{KWOKCTL_ID}.log")

        def log_text():
            with open(daemon_log, encoding="utf-8", errors="replace") as f:
                return f.read()

        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", 0)
        want = f"kwok controller started (backend=device, device={device})"
        wait_until("the daemon's start line", lambda: "kwok controller started" in log_text(), 120)
        if want not in log_text():
            raise AssertionError(f"kwokctl: the daemon's log lacks {want!r}:\n{log_text()[-4000:]}")
        log(f"kwokctl: cluster up in {t_created:.1f} s, components {modules}; {want}")

        with open(os.path.join(workdir, "kwok.yaml")) as f:
            conf = yaml.safe_load(f)
        client = ClusterClient(conf["serverURL"])
        view = ClusterView(KWOKCTL_ID)
        rv = client.resource_version
        for kind, on_event, ns in (("Node", view.on_node, None),
                                   ("Lease", view.on_lease, NODE_LEASE_NS),
                                   ("Pod", view.on_pod, None)):
            watches.append(WatchCount(client, kind, rv, on_event, namespace=ns))
            watches[-1].start()

        n_nodes, n_pods = KWOKCTL_NODES, KWOKCTL_PODS
        t0 = time.perf_counter()
        kwokctl(env, "scale", "node", "--replicas", str(n_nodes))
        wait_until(f"{n_nodes} nodes Ready", lambda: view.counts()[0] == n_nodes,
                   KWOKCTL_NODES_S - (time.perf_counter() - t0))
        t_nodes = time.perf_counter() - t0
        log(f"kwokctl: {n_nodes} nodes Ready in {t_nodes:.1f} s")

        t0 = time.perf_counter()
        per = n_pods // KWOKCTL_POD_SHARDS
        for shard in range(KWOKCTL_POD_SHARDS):
            kwokctl(env, "scale", "pod", "--replicas", str(per), "--name-prefix", f"pod-{shard}",
                    "--param", f"nodeName=node-{shard}")
        wait_until(f"{n_pods} pods Running", lambda: len(view.running) == n_pods,
                   KWOKCTL_PODS_S - (time.perf_counter() - t0))
        t_pods = time.perf_counter() - t0
        log(f"kwokctl: {n_pods} pods Running in {t_pods:.1f} s ({n_pods / t_pods:.1f} pods/s)")

        t0 = time.perf_counter()
        kwokctl(env, "scale", "pod", "--replicas", str(KWOKCTL_UNBOUND), "--name-prefix", "unbound")
        wait_until(f"{KWOKCTL_UNBOUND} pods bound and Running",
                   lambda: len(view.running) == n_pods + KWOKCTL_UNBOUND, KWOKCTL_UNBOUND_S)
        t_unbound = time.perf_counter() - t0
        unbound, _ = client.list("Pod", field_selector="spec.nodeName=")
        if unbound:
            raise AssertionError(f"kwokctl: {len(unbound)} pods without a node")
        log(f"kwokctl: {KWOKCTL_UNBOUND} pods bound by the scheduler and Running in "
            f"{t_unbound:.1f} s")

        # the timed window
        renew_s = NODE_LEASE_S / 4 * (1 + 0.04)
        metrics_url = f"http://127.0.0.1:{conf['ports']['kubelet']}/metrics"
        m0, r0 = scrape(metrics_url), view.renewals
        t0 = time.perf_counter()
        unheld = lease_samples(lambda: client.list("Lease", namespace=NODE_LEASE_NS)[0],
                               KWOKCTL_ID, n_nodes, t0, renew_s)
        wall = time.perf_counter() - t0
        m1, renewals = scrape(metrics_url), view.renewals - r0
        if any(w.ended for w in watches):
            raise AssertionError("kwokctl: a watch on the apiserver ended")

        def rate(kind):
            played = [metric(m, "kwok_stage_transitions_total", kind=kind, backend="device")
                      for m in (m0, m1)]
            return None if None in played else (played[1] - played[0]) / wall

        line = {
            "nodes": n_nodes, "pods": n_pods, "scheduled_pods": KWOKCTL_UNBOUND,
            "cluster_up_s": t_created, "nodes_ready_s": t_nodes, "pods_running_s": t_pods,
            "pods_per_s": n_pods / t_pods, "scheduled_running_s": t_unbound,
            "window_s": wall,
            "pod_transitions_per_s": rate("Pod"), "node_transitions_per_s": rate("Node"),
            "tick_lag_p99_s": metric(m1, "kwok_tick_lag_seconds", kind="Pod", quantile="0.99"),
            "node_tick_lag_p99_s": metric(m1, "kwok_tick_lag_seconds", kind="Node",
                                          quantile="0.99"),
            "renewals": renewals, "renew_period_s": renew_s,
            "leases_unheld_or_expired_at_samples": unheld,
            "renew_lag_p99_s": metric(m1, "kwok_lease_renew_lag_seconds", quantile="0.99"),
            "device": smi,
        }
        check_leases("kwokctl", renewals, n_nodes, wall, renew_s, unheld)
        for w in watches:
            w.stop()
        watches = []

        chaos_from = os.path.getsize(daemon_log)  # the log's part before phase 8
        chaos_line, launches, restarted_from = phase_chaos(env, home, workdir, conf, n_nodes,
                                                           device, smi, chaos_from)
        log("chaos: " + json.dumps(chaos_line))
        line["launches"] = launches

        listed = kwokctl(env, "get", "components").stdout.splitlines()
        up = [ln.split()[0] for ln in listed if ln.split()[1:2] == ["Running"]]
        if sorted(up) != sorted(modules):
            raise AssertionError(f"kwokctl get components: {listed}")
        snap = os.path.join(home, "snapshot.json")
        kwokctl(env, "snapshot", "save", "--path", snap)
        store = ResourceStore()
        load(store, objects=read_state_file(snap)["objects"])
        held = (store.count("Node"), store.count("Pod"))
        if held != (n_nodes, n_pods + KWOKCTL_UNBOUND + CHAOS_PODS):
            raise AssertionError(f"kwokctl snapshot: {held} Nodes and Pods")
        line["snapshot_nodes_pods"] = held

        # the daemon's log stays readable through this handle after the
        # delete removes the cluster's directory
        pids = {}
        for name in modules:
            with open(os.path.join(workdir, "pids", f"{name}.pid")) as f:
                pids[name] = int(f.read())
        with open(daemon_log, "rb") as f:
            t0 = time.perf_counter()
            kwokctl(env, "delete", "cluster")
            created = False
            line["delete_s"] = time.perf_counter() - t0
            raw = f.read()
        out = raw.decode(errors="replace")
        alive = [name for name, pid in pids.items() if BinaryRuntime._alive(pid)]
        if alive:
            raise AssertionError(f"kwokctl delete cluster: still alive {alive}")
        before = raw[:chaos_from].decode(errors="replace")
        if "Traceback (most recent call last)" in before:
            raise AssertionError(f"kwokctl: the daemon printed a traceback:\n{before[-8000:]}")
        outage = chaos_outage_errors(raw[chaos_from:].decode(errors="replace"))
        line["chaos_outage_tracebacks"] = outage
        # the daemon that exits here is the one the supervisor restarted:
        # its part of the log starts at its start line after the kill
        chaos_launches = daemon_launches(
            "chaos", raw[restarted_from:].decode(errors="replace"))
        line["chaos_launches"] = chaos_launches
        line["phase_s"] = time.perf_counter() - t_phase
        log("kwokctl: " + json.dumps(line))
        return launches, chaos_launches
    finally:
        for w in watches:
            w.stop()
        if created:
            subprocess.run([sys.executable, "-m", "kwok_tpu_torch.cmd.kwokctl", "--name", "smoke",
                            "delete", "cluster"], cwd=HERE, env=env, capture_output=True,
                           timeout=120)
        shutil.rmtree(home, ignore_errors=True)


# ------------------------------------------------------------------ phase 8

# A chaos run against phase 7's cluster as the README's "Chaos testing"
# drives one: a seeded ChaosProfile whose process faults
# ``python -m kwok_tpu_torch.chaos --cluster smoke --supervise`` applies
# at wall-clock offsets from its start while the component supervisor
# restarts what dies.  The daemon, which holds the SoA on the card, is
# SIGKILLed at 1 s; the apiserver at 30 s, after the daemon's expected
# recovery (start-up, a fresh SoA, every lease renewed); the daemon is
# SIGSTOPped for 5 s at 45 s.  Phase 7's daemon is first restarted
# gracefully by a one-fault profile (``restart``), so that it prints its
# launches on the way out as before; its successor is the one killed.
CHAOS_SEED = 8
CHAOS_FAULTS = (
    {"component": KWOKCTL_ID, "at": 1.0, "action": "kill"},
    {"component": "apiserver", "at": 30.0, "action": "kill"},
    {"component": KWOKCTL_ID, "at": 45.0, "action": "stop", "resumeAfter": 5.0},
)
CHAOS_PODS = 500
CHAOS_PODS_S = 60.0
CHAOS_SETTLE_S = 90.0  # a restarted daemon to hold every lease again
CHAOS_RUN_S = 240.0  # the chaos command's time limit
START_LINE = "kwok controller started"


class DaemonLog(threading.Thread):
    """Every 0.1 s: the start lines the daemon's log has gained (each with
    the perf-counter time it was seen) and, for the pid given to
    ``track``, when it was first seen dead."""

    def __init__(self, path: str, pidfile: str):
        super().__init__(daemon=True, name="daemon-log")
        self.path, self.pidfile = path, pidfile
        self.done = threading.Event()
        self.starts = []  # (perf counter, line, its byte offset in the log)
        self.dead_at = None
        self._pid = None
        self._offset = 0
        self._tail = b""

    def track(self) -> int:
        """Watch the daemon's current process; returns its pid."""
        with open(self.pidfile) as f:
            self._pid, self.dead_at = int(f.read()), None
        return self._pid

    def poll(self) -> None:
        from kwok_tpu_torch.ctl.runtime import BinaryRuntime

        with open(self.path, "rb") as f:
            f.seek(self._offset)
            at = self._offset - len(self._tail)  # the log's offset of data[0]
            data = self._tail + f.read()
            self._offset = f.tell()
        lines = data.split(b"\n")
        self._tail = lines.pop()
        now = time.perf_counter()
        for ln in lines:
            text = ln.decode(errors="replace")
            if text.startswith(START_LINE):
                self.starts.append((now, text, at))
            at += len(ln) + 1
        if self._pid is not None and self.dead_at is None and not BinaryRuntime._alive(self._pid):
            self.dead_at = now

    def run(self):
        while not self.done.wait(0.1):
            self.poll()

    def stop(self):
        self.done.set()
        self.join(timeout=5)


#: what a daemon's workers may print, caught and retried, while the
#: chaos plan's apiserver is down: a request that found no server
#: (ApiUnavailable, raised from the refused or reset connection)
OUTAGE_ERRORS = ("kwok_tpu_torch.cluster.client.ApiUnavailable: ", "ConnectionRefusedError: ",
                 "ConnectionResetError: ", "BrokenPipeError: ",
                 "http.client.RemoteDisconnected: ")


def chaos_outage_errors(text: str) -> int:
    """The tracebacks in the daemon's log from phase 8 on: fails on any
    exception but those of the apiserver's outage; returns their count."""
    errors = [ln for ln in text.splitlines() if re.match(r"[A-Za-z_][\w.]*: ", ln)]
    other = [ln for ln in errors if not ln.startswith(OUTAGE_ERRORS)]
    if other:
        raise AssertionError(f"chaos: the daemon printed errors besides the apiserver's "
                             f"outage: {other[:10]}\n{text[-8000:]}")
    return text.count("Traceback (most recent call last)")


def chaos_command(env, home: str, name: str, faults, supervise: bool):
    """Write a ChaosProfile of ``faults`` and start ``python -m
    kwok_tpu_torch.chaos`` on it against the cluster."""
    import yaml

    profile = os.path.join(home, f"{name}.yaml")
    with open(profile, "w") as f:
        yaml.safe_dump({"kind": "ChaosProfile", "seed": CHAOS_SEED,
                        "process": [dict(x) for x in faults]}, f)
    args = [sys.executable, "-m", "kwok_tpu_torch.chaos", "--profile", profile,
            "--cluster", "smoke"] + (["--supervise"] if supervise else [])
    return subprocess.Popen(args, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def chaos_report(what: str, proc, timeout: float) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"{what}: the chaos command ran past {timeout:.0f} s:\n{err[-4000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"{what}: the chaos command exited {proc.returncode}:\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
    return json.loads(out)


class LeaseSamples:
    """The node Leases read once a second: at each read, how many are
    missing, unheld or expired; each lease's renewTimes, for the longest
    gap between renewals; and the reads that failed (apiserver down)."""

    def __init__(self, url: str, n: int):
        from kwok_tpu_torch.cluster.client import NO_RETRY, ClusterClient

        self.client = ClusterClient(url, timeout=5.0, retry=NO_RETRY)
        self.n = n
        self.bad = []  # (seconds since the first read, count)
        self.failed = 0
        self.renewed = {}  # name -> last renewTime (epoch seconds)
        self.gap_s = 0.0
        self.t0 = None

    def sample(self) -> None:
        now = time.time()
        self.t0 = self.t0 if self.t0 is not None else now
        try:
            leases = self.client.list("Lease", namespace=NODE_LEASE_NS)[0]
        except Exception:  # noqa: BLE001 — the apiserver is down; counted
            self.failed += 1
            return
        self.bad.append((round(now - self.t0, 1),
                         leases_unheld_or_expired(leases, KWOKCTL_ID, self.n, now)))
        for lease in leases:
            renewed = (lease.get("spec") or {}).get("renewTime")
            if not renewed:
                continue
            t = datetime.datetime.fromisoformat(renewed).timestamp()
            name = lease["metadata"]["name"]
            before = self.renewed.get(name)
            if before is not None and t > before:
                self.gap_s = max(self.gap_s, t - before)
            self.renewed[name] = t

    def longest_gap_s(self) -> float:
        """The longest gap between two renewals of any lease, the time
        since each lease's last renewal included."""
        now = time.time()
        return max([self.gap_s] + [now - t for t in self.renewed.values()])


def wait_leases_renewed(client, n: int, since: float, timeout: float) -> float:
    """Seconds until every node Lease is held by the daemon and renewed
    after ``since`` (epoch seconds)."""

    def renewed():
        leases = client.list("Lease", namespace=NODE_LEASE_NS)[0]
        fresh = [ls for ls in leases if (ls.get("spec") or {}).get("holderIdentity") == KWOKCTL_ID
                 and (ls["spec"].get("renewTime") or "") and datetime.datetime.fromisoformat(
                     ls["spec"]["renewTime"]).timestamp() > since]
        return len(fresh) == n

    return wait_until(f"{n} leases renewed by the restarted daemon", renewed, timeout)


def nodes_ready(client) -> int:
    nodes = client.list("Node")[0]
    return sum(1 for o in nodes if any(
        c.get("type") == "Ready" and c.get("status") == "True"
        for c in (o.get("status") or {}).get("conditions") or []))


def phase_chaos(env, home: str, workdir: str, conf: dict, n_nodes: int, device, smi: str,
                log_from: int):
    """Phase 8: phase 7's daemon restarted gracefully (its launches read
    from its exit line, the one launch line in the log from ``log_from``
    to its successor's start line), then the chaos plan against the
    cluster under the supervisor: the daemon's restart must come back on
    ``device`` with every lease renewed in time, every Node Ready, and
    500 new placed pods Running through it.  Returns the chaos line, the
    launches phase 7's daemon printed, and the log's offset of the start
    line of the daemon the supervisor restarted after the kill."""
    from kwok_tpu_torch.cluster.client import ClusterClient

    t_phase = time.perf_counter()
    renew_s = NODE_LEASE_S / 4 * (1 + 0.04)
    want = f"{START_LINE} (backend=device, device={device})"
    client = ClusterClient(conf["serverURL"])
    daemon_log = os.path.join(workdir, "logs", f"{KWOKCTL_ID}.log")
    watch = DaemonLog(daemon_log, os.path.join(workdir, "pids", f"{KWOKCTL_ID}.pid"))
    watch.poll()
    watch.start()
    try:
        # phase 7's daemon: a graceful restart prints its launches
        n_starts, since = len(watch.starts), time.time()
        t0 = time.perf_counter()
        chaos_report("chaos restart", chaos_command(
            env, home, "restart", [{"component": KWOKCTL_ID, "at": 0.0, "action": "restart"}],
            False), 120.0)
        wait_until("the daemon's start line after the restart",
                   lambda: len(watch.starts) > n_starts, 60)
        with open(daemon_log, "rb") as f:
            f.seek(log_from)
            first = daemon_launches("kwokctl", f.read(watch.starts[n_starts][2] - log_from)
                                    .decode(errors="replace"))
        settled = wait_leases_renewed(client, n_nodes, since, CHAOS_SETTLE_S)
        line = {"restart_to_leases_renewed_s": time.perf_counter() - t0,
                "restart_start_line_s": watch.starts[n_starts][0] - t0}
        log(f"chaos restart: phase 7's daemon restarted, every lease renewed {settled:.1f} s "
            "later")

        # the fault plan, the leases read once a second from its start
        n_starts = len(watch.starts)
        pid = watch.track()
        samples = LeaseSamples(conf["serverURL"], n_nodes)
        t0 = time.perf_counter()
        proc = chaos_command(env, home, "chaos", CHAOS_FAULTS, True)
        while proc.poll() is None and time.perf_counter() - t0 < CHAOS_RUN_S:
            samples.sample()
            time.sleep(max(0.0, 1.0 - (time.perf_counter() - t0) % 1.0))
        report = chaos_report("chaos", proc, 10.0)
        t_end = time.perf_counter()
        while time.perf_counter() - t_end < renew_s:  # one renewal period after
            samples.sample()
            time.sleep(1.0)
        events = [(e["component"], e["action"]) for e in report["process_events"]]
        if events != [(KWOKCTL_ID, "kill"), ("apiserver", "kill"), (KWOKCTL_ID, "stop"),
                      (KWOKCTL_ID, "resume")]:
            raise AssertionError(f"chaos: process events {report['process_events']}")
        restarted = sorted({e["component"] for e in report["supervisor_events"]
                            if e.get("action") == "restarted"})
        if restarted != sorted([KWOKCTL_ID, "apiserver"]):
            raise AssertionError(f"chaos: supervisor events {report['supervisor_events']}")
        recovery = report["recovery_times_s"]
        if len(recovery) < 2 or max(recovery) >= NODE_LEASE_S:
            raise AssertionError(f"chaos: recovery times {recovery} s, each must be under "
                                 f"the {NODE_LEASE_S} s lease")
        if watch.dead_at is None:
            raise AssertionError(f"chaos: the daemon (pid {pid}) was never seen dead")
        after = [(t, text, at) for t, text, at in watch.starts[n_starts:] if t >= watch.dead_at]
        if not after or after[0][1] != want:
            raise AssertionError(f"chaos: no {want!r} after the kill: {watch.starts[n_starts:]}")
        bad = [b for b in samples.bad if b[1]]
        if samples.failed >= NODE_LEASE_S:
            raise AssertionError(f"chaos: {samples.failed} reads of the leases failed, a lease's "
                                 "worth of seconds without the apiserver")
        if bad or not samples.bad:
            raise AssertionError(f"chaos: leases missing, unheld or expired at samples "
                                 f"(seconds, count): {bad or 'no sample read'}")
        ready = nodes_ready(client)
        if ready != n_nodes:
            raise AssertionError(f"chaos: {ready} of {n_nodes} nodes Ready after the faults")

        t0 = time.perf_counter()
        kwokctl(env, "scale", "pod", "--replicas", str(CHAOS_PODS), "--name-prefix", "chaos",
                "--param", "nodeName=node-0")

        def chaos_running():
            pods = client.list("Pod")[0]
            return sum(1 for o in pods if o["metadata"]["name"].startswith("chaos")
                       and (o.get("status") or {}).get("phase") == "Running")

        wait_until(f"{CHAOS_PODS} pods Running after the faults",
                   lambda: chaos_running() == CHAOS_PODS, CHAOS_PODS_S)
        t_pods = time.perf_counter() - t0
        line.update({
            "faults": [dict(x) for x in CHAOS_FAULTS], "seed": CHAOS_SEED,
            "process_events": report["process_events"],
            "supervisor_events": report["supervisor_events"],
            "recovery_times_s": recovery,
            "kill_to_start_line_s": after[0][0] - watch.dead_at,
            "lease_samples": len(samples.bad), "lease_reads_failed": samples.failed,
            "leases_unheld_or_expired_at_samples": sum(b[1] for b in samples.bad),
            "longest_renewal_gap_s": samples.longest_gap_s(), "lease_s": NODE_LEASE_S,
            "nodes_ready": ready, "pods_running_s": t_pods, "pods": CHAOS_PODS,
            "phase_s": time.perf_counter() - t_phase, "device": smi,
        })
        return line, first, after[0][2]
    finally:
        watch.stop()


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
    mesh_counts, mesh_sim = phase_mesh(smi, device)
    counts.update({k: mesh_counts[k] for k in ("sharded_tick", "sharded_run_ticks")})
    kernels_line = phase_measure(counts, pod_sim, wide_sim, mesh_sim, smi)
    del pod_sim, wide_sim, mesh_sim
    torch.cuda.empty_cache()
    facade_counts = phase_facade(smi, device, t0)
    daemon_counts = phase_daemon(smi, t0)
    kwokctl_counts, chaos_counts = phase_kwokctl(smi, device)
    for e in kernels_line:
        if e["name"] == "lease_tick":
            e["launches"] = facade_counts["lease_tick"]
        # beside each path's count, the daemon's (phase 6), that of the
        # daemon kwokctl started (phase 7) and that of its successor the
        # supervisor restarted after the chaos plan killed it (phase 8)
        e["daemon_launches"] = daemon_counts.get(e["name"], 0)
        e["kwokctl_launches"] = kwokctl_counts.get(e["name"], 0)
        e["chaos_launches"] = chaos_counts.get(e["name"], 0)
    # threefry runs inline in every kernel but scatter_rows
    for key in ("launches", "daemon_launches", "kwokctl_launches", "chaos_launches"):
        inlined = [e[key] for e in kernels_line if e["name"] not in ("threefry", "scatter_rows")]
        for e in kernels_line:
            if e["name"] == "threefry":
                e[key] = sum(inlined)
    never = [e["name"] for e in kernels_line if not e["launches"]]
    if never:
        raise AssertionError(f"kernels never launched on their path: {never}")
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
