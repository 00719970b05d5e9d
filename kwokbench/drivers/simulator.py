"""Unpaced macro-ticks of a pod and a node ``DeviceSimulator``.

The traffic file gives the warm-up and the sample that the check keeps;
the configuration gives the stage sets, the objects, their counts, the
tick and the ticks a macro-tick.  Set-up (copied from ``chip_smoke.py``
phase 3): both simulators are built, every object admitted with
``admit_bulk`` and uploaded with ``to_device``, then warmed by
macro-ticks.  The window calls the program's blocking
``DeviceSimulator.tick_many`` on the pod simulator, then on the node
simulator, back to back, and keeps only the sampled rows' columns of the
fired-stage arrays it returns.  The traced run also counts the fired
stages on the card (``chip_smoke.py`` phase 3's count) by wrapping each
simulator's ``tick_many_async``, which ``tick_many`` calls.

``correct``: the plain reference (``reference/fsm.py``) replays each
sampled row from its admission through every tick of the run, from the
seed and the configuration's reference stage sets, and every fired
stage of those rows must equal the program's.
"""

from __future__ import annotations

import time

import numpy as np

from kwokbench import devtrace
from kwokbench.outcome import Ctx, Result
from kwokbench.reference import control as ref_control
from kwokbench.reference import fsm


def stage_list(spec: dict):
    """The program's stages named by ``{"files": [...], "names": [...]}``:
    every stage of the files, or those named, in file order."""
    from kwok_tpu_torch.stages import load_builtin

    stages = [s for f in spec["files"] for s in load_builtin(f)]
    names = spec.get("names")
    return [s for s in stages if names is None or s.name in names]


def _counted(sim, fired):
    """Counts the fired stages of each macro-tick on the card, ahead of
    the program's own fetch in ``tick_many``; the trace's reduction
    leaves the count's device work out of the program's."""
    from torch.profiler import record_function

    inner = sim.tick_many_async

    def tick_many_async(dt_ms, n_ticks):
        stages, t0 = inner(dt_ms, n_ticks)
        with record_function(devtrace.HARNESS + ".count"):
            fired.append((stages >= 0).sum())
        return stages, t0

    sim.tick_many_async = tick_many_async


def run(ctx: Ctx) -> Result:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from kwok_tpu_torch.engine.simulator import DeviceSimulator

    cfg, mix = ctx.cell.config, ctx.cell.traffic
    dt, K = int(cfg["tick_ms"]), int(cfg["ticks_per_macro"])
    n_pods, n_nodes = ctx.size("pods"), ctx.size("nodes")
    device = torch.device(ctx.device)
    cuda = device.type == "cuda"
    seeds = {"Pod": ctx.seed, "Node": ctx.seed + 1}
    rng = np.random.default_rng(ctx.seed)
    sample = {
        "Pod": np.sort(rng.choice(n_pods, min(n_pods, int(mix["sample_pod_rows"])), replace=False)),
        "Node": np.sort(rng.choice(n_nodes, min(n_nodes, int(mix["sample_node_rows"])),
                                   replace=False)),
    }

    sims = {}
    for kind, n, stages, tmpl in (("Pod", n_pods, cfg["pod_stages"], cfg["pod_template"]),
                                  ("Node", n_nodes, cfg["node_stages"], cfg["node_template"])):
        sim = DeviceSimulator(stage_list(stages), capacity=n, seed=seeds[kind], device=device)
        sim.admit_bulk(tmpl, n)
        sim.to_device()
        sims[kind] = sim
    names = {k: [c.name for c in s.cset.compiled] for k, s in sims.items()}
    kept = {"Pod": [], "Node": []}

    def macro():
        for kind in ("Pod", "Node"):
            st, _ = sims[kind].tick_many(dt, K)
            kept[kind].append(st[:, sample[kind]])

    def traced_macro():
        for kind in ("Pod", "Node"):
            with record_function(f"{kind}.tick_many"):
                st, _ = sims[kind].tick_many(dt, K)
            with record_function(devtrace.HARNESS + ".keep"):
                kept[kind].append(st[:, sample[kind]])

    for _ in range(int(mix["warm_macro_ticks"])):
        macro()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t0
    ctx.log(f"set-up {setup_s:.4f} s: {n_pods} pods (S={len(names['Pod'])}, "
            f"C={sims['Pod'].cset.C}) and {n_nodes} nodes (S={len(names['Node'])}), "
            f"{mix['warm_macro_ticks']} warm macro-ticks of K={K}")

    fired = {"Pod": [], "Node": []}
    warm = len(kept["Pod"])
    red = None
    if ctx.trace:
        # the first trace_s seconds of the window are profiled
        for kind in ("Pod", "Node"):
            _counted(sims[kind], fired[kind])
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()
        t_start = time.perf_counter()
        with record_function(devtrace.WINDOW):
            while True:
                traced_macro()
                if time.perf_counter() - t_start >= min(ctx.seconds, float(mix["trace_s"])):
                    break
        prof.__exit__(None, None, None)
        for kind in ("Pod", "Node"):
            del sims[kind].tick_many_async
    else:
        t_start = time.perf_counter()
    traced = len(kept["Pod"]) - warm
    while time.perf_counter() - t_start < ctx.seconds or not len(kept["Pod"]) - warm:
        macro()
    window = time.perf_counter() - t_start
    macros = len(kept["Pod"]) - warm
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    ctx.log(f"window {window:.6f} s: {macros} pod+node macro-ticks, "
            f"{window / macros * 1e3:.6f} ms each")

    layer = {"macro_ticks": traced}
    busy = breakdown = None
    if ctx.trace:
        counts = {k: int(torch.stack(v).sum()) for k, v in fired.items()}
        params = {k: s.to_device()[0] for k, s in sims.items()}
        layer["tick_collect"] = [{
            "n": sims[k].capacity, "ticks": K, "launches": traced,
            "rematches": counts[k] / traced,
            "S": int(params[k].cond_col.shape[0]), "KC": int(params[k].cond_col.shape[1]),
            "C": int(params[k].eff_mode.shape[2]),
            "param_bytes": int(sum(t.numel() * t.element_size() for t in params[k])),
            "out_bytes": K * sims[k].capacity,
        } for k in ("Pod", "Node")]
        red = devtrace.reduce_profile(prof)
        del prof
        layer["trace"] = red
        if red is not None and red["busy_s"] > 0:
            busy, breakdown = red["busy_s"], devtrace.breakdown(red)
            ctx.log(f"trace of the window's first {traced} macro-ticks: {red['window_s']:.6f} s, "
                    f"device busy {red['busy_s']:.6f} s; transitions counted on the card "
                    f"{counts}, {sum(counts.values()) / red['window_s']:.1f} transitions/s "
                    f"(pods+nodes)")

    # the program's state is freed before the reference runs
    n_ticks = len(kept["Pod"]) * K
    got = {k: np.concatenate(v, 0).astype(np.int16) for k, v in kept.items()}
    del sims, kept
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = fsm.load_reference(cfg, ctx.cell.here + "/configs")
    checks, control, bad_macros = [], [], np.zeros(n_ticks // K, bool)
    for kind in ("Pod", "Node"):
        stage_set = fsm.StageSet(ref["kinds"][kind])
        if stage_set.names != names[kind]:
            ctx.warn(f"{kind}: the program's stages {names[kind]} are not the reference's "
                     f"{stage_set.names}")
            checks.append((f"{kind.lower()}_stage_sets_differ", 1, 0))
            continue
        draws = ref_control.draws(seeds[kind], sample[kind], n_ticks)
        want = fsm.replay(stage_set, seeds[kind], sample[kind], n_ticks, dt, *draws)
        wrong = got[kind] != want
        bad_macros |= wrong.reshape(-1, K, wrong.shape[1]).any(axis=(1, 2))
        ctx.log(f"{kind}: {len(sample[kind])} sampled rows over {n_ticks} ticks, "
                f"{int((want >= 0).sum())} reference transitions, "
                f"{int((got[kind] >= 0).sum())} of the program's")
        checks.append((f"{kind.lower()}_stage_mismatches", int(wrong.sum()), 0))
        if ctx.control:
            low = fsm.replay(stage_set, seeds[kind], sample[kind], n_ticks, dt,
                             *ref_control.bf16_draws(draws))
            control.append((f"{kind.lower()}_stage_mismatches", int((low != want).sum())))
    ctx.log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    return Result(
        e2e={"sim_macro_tick_ms": window / macros * 1e3, "setup_s": setup_s},
        layer=layer, attempted=macros, failed=int(bad_macros[warm:].sum()),
        checks=checks, memory_peak_bytes=peak, busy_s=busy,
        window_s=red["window_s"] if busy is not None else None, breakdown=breakdown,
        control=control)
