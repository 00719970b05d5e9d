"""An open loop of pods into a kwokctl cluster.

Set-up (copied from ``chip_smoke.py`` phase 7): ``python -m
kwok_tpu_torch.cmd.kwokctl create cluster`` with the configuration's
arguments, the client's watches of Nodes, node Leases and Pods, then
``kwokctl scale node`` and the placed pods in ``kwokctl scale pod``
shards, each by ``nodeName``, until every node is Ready and every
placed pod Running; then a short run of the loop, whose pods are
deleted before the window.  The window is the traffic file's open
loop: a fixed number of pods, ``rate_per_s`` times the window, created
unbound at times drawn from the seed (uniform over the window, sorted:
arrivals of a Poisson process of that rate, given their count), each
deleted ``delete_after_s`` after its create was due.  Each is timed from
when its create was due.  After the window the loop's last deletes are
sent on time, and the client waits for each pod to be Running and for
each delete to take effect, at most ``settle_s`` past the close.

``correct``: the plain reference (``reference/cluster.py``) judges what
the client saw against the configuration's guarantees: every
acknowledged create bound once to a node of the cluster and Running with
its containers running and ready; every acknowledged delete gone; every
node lease held by the daemon and renewed inside its duration.
"""

from __future__ import annotations

import heapq
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from kwokbench import devtrace, spec, stats
from kwokbench.client import Api, ApiError, Watch, family_sum, scrape
from kwokbench.outcome import Ctx, Result
from kwokbench.reference import cluster as ref

STREAM = "stream-"
WARM = "warm-"
PROFILE_ENV = "KWOKBENCH_PROFILE_DIR"
SITE = os.path.join(spec.HERE, "site")


class Kwokctl:
    """``python -m kwok_tpu_torch.cmd.kwokctl --name <name> ...`` as users run it."""

    def __init__(self, env: dict, name: str):
        self.env, self.name = env, name

    def __call__(self, *args, timeout: float = 300.0) -> str:
        out = subprocess.run([sys.executable, "-m", "kwok_tpu_torch.cmd.kwokctl", "--name",
                              self.name, *args], cwd=spec.ROOT, env=self.env,
                             capture_output=True, text=True, timeout=timeout)
        if out.returncode != 0:
            raise RuntimeError(f"kwokctl {' '.join(args)}: exit code {out.returncode}:\n"
                               f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
        return out.stdout


class View:
    """What the client's watches saw, each event stamped on arrival."""

    def __init__(self):
        self.node_ready = {}
        self.node_names = set()
        self.leases = {}  # name -> {"holder", "renew", "last_t"}
        self.renewals = []  # (t, gap since the lease's previous renewal)
        self.placed_running = set()
        self.pods = {}  # the loop's pods: name -> record

    def on_node(self, etype, obj, t):
        conds = (obj.get("status") or {}).get("conditions") or []
        name = obj["metadata"]["name"]
        self.node_ready[name] = etype != "DELETED" and any(
            c.get("type") == "Ready" and c.get("status") == "True" for c in conds)
        if etype == "DELETED":
            self.node_names.discard(name)
        else:
            self.node_names.add(name)

    def on_lease(self, etype, obj, t):
        spec_ = obj.get("spec") or {}
        holder, renew = spec_.get("holderIdentity"), spec_.get("renewTime")
        name = obj["metadata"]["name"]
        rec = self.leases.get(name)
        if rec is None or etype == "ADDED":
            self.leases[name] = {"holder": holder, "renew": renew, "last_t": t}
            return
        if etype == "MODIFIED" and renew != rec["renew"]:
            self.renewals.append((t, t - rec["last_t"]))
            rec.update(holder=holder, renew=renew, last_t=t)

    def on_pod(self, etype, obj, t):
        name = obj["metadata"]["name"]
        phase = (obj.get("status") or {}).get("phase")
        rec = self.pods.get(name)
        if rec is None:
            if phase == "Running" and etype != "DELETED":
                self.placed_running.add(name)
            else:
                self.placed_running.discard(name)
            return
        node = (obj.get("spec") or {}).get("nodeName")
        if node and (not rec["nodes"] or rec["nodes"][-1] != node):
            rec["nodes"].append(node)
            if rec["bind_t"] is None:
                rec["bind_t"] = t
        if etype == "DELETED":
            rec["gone"], rec["gone_t"] = True, t
        elif phase == "Running" and rec["running_t"] is None:
            rec["running_t"], rec["running_obj"] = t, obj

    def add_pods(self, names):
        for name in names:
            self.pods[name] = {"nodes": [], "bind_t": None, "running_t": None,
                               "running_obj": None, "gone": False, "created": False,
                               "deleted": False, "due": None, "delete_due": None}


def wait_until(what: str, cond, timeout: float, poll: float = 0.2) -> float:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise RuntimeError(f"{what} not within {timeout:.0f} s")
        time.sleep(poll)
    return time.perf_counter() - t0


def arrivals(seed: int, n: int, seconds: float) -> np.ndarray:
    """``n`` arrival offsets in [0, seconds), sorted, from the seed."""
    return np.sort(np.random.default_rng(seed).uniform(0.0, seconds, n))


def open_loop(api: Api, view: View, template: dict, names, offsets, delete_after: float,
              workers: int, t_start: float, place: int = 0):
    """Creates pod ``names[i]`` at ``t_start + offsets[i]`` and deletes it
    ``delete_after`` later, each on time whatever the apiserver does;
    with ``place`` nodes, pod i is created on node ``i % place`` by
    ``nodeName``, else unbound.  Returns the generator's lateness
    (seconds) of each operation once every operation has returned."""
    ns = template["metadata"]["namespace"]
    ops = []
    for name, off in zip(names, offsets):
        rec = view.pods[name]
        rec["due"], rec["delete_due"] = t_start + off, t_start + off + delete_after
        ops.append((rec["due"], 0, name))
        ops.append((rec["delete_due"], 1, name))
    heapq.heapify(ops)
    late = []
    node_of = {name: f"node-{i % place}" for i, name in enumerate(names)} if place else {}

    def create(name):
        obj = json.loads(json.dumps(template))
        obj["metadata"]["name"] = name
        if name in node_of:
            obj["spec"]["nodeName"] = node_of[name]
        try:
            api.create("pods", obj, namespace=ns)
            view.pods[name]["created"] = True
        except (ApiError, OSError) as exc:
            view.pods[name]["create_error"] = str(exc)

    def delete(name):
        try:
            api.delete("pods", name, namespace=ns)
            view.pods[name]["deleted"] = True
        except (ApiError, OSError) as exc:
            view.pods[name]["delete_error"] = str(exc)

    with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="kwokbench-loop") as pool:
        futures = []
        while ops:
            due, kind, name = heapq.heappop(ops)
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(time.perf_counter() - due)
            futures.append(pool.submit(delete if kind else create, name))
        for f in futures:
            f.result()
    return late


def settle(view: View, names, timeout_at: float) -> None:
    """Waits until each pod of ``names`` is Running (or failed to be
    created) and, where deleted, gone; at most until ``timeout_at``."""
    def done():
        return all((r["running_t"] is not None or not r["created"])
                   and (r["gone"] or not r["deleted"]) for r in map(view.pods.get, names))
    while not done() and time.perf_counter() < timeout_at:
        time.sleep(0.1)


def lease_gaps(view: View, t_start: float, t_end: float):
    """The window's lease renewal gaps: (the time since the lease's
    previous renewal, for each renewal seen in the window; each lease's
    open gap, the time since its last renewal, at the window's end)."""
    gaps = [g for t, g in list(view.renewals) if t_start <= t <= t_end]
    open_gaps = [t_end - rec["last_t"] for rec in list(view.leases.values())]
    return gaps, open_gaps


def running_latencies(recs: dict, t_judged: float):
    """For each pod of the loop, the seconds from its create being due to
    the watch seeing it Running; a pod never seen Running counts the
    whole wait, up to ``t_judged``, when the client stopped waiting (the
    run is then not correct)."""
    return [(r["running_t"] if r["running_t"] is not None else t_judged) - r["due"]
            for r in recs.values()]


def smi_memory_bytes() -> int:
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout.split()
    return max((int(x) for x in out if x.isdigit()), default=0) * 2**20


class Cluster:
    """A kwokctl cluster set up as the configuration says, with the
    client's watches on it; closed with ``kwokctl delete cluster``."""

    def __init__(self, ctx: Ctx):
        self.ctx, self.cfg = ctx, ctx.cell.config
        self.cuda = ctx.device != "cpu"
        self.home = tempfile.mkdtemp(prefix="kwokbench-kwokctl-")
        env = {k: v for k, v in os.environ.items() if k != "KWOK_TORCH_DEVICE"}
        paths = [spec.ROOT] + ([SITE] if ctx.trace else [])
        env.update(KWOK_TPU_HOME=self.home, PYTHONPATH=os.pathsep.join(
            paths + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        if not self.cuda:
            env["KWOK_TORCH_DEVICE"] = "cpu"
        self.profile_dir = os.path.join(self.home, "profile")
        if ctx.trace:
            os.makedirs(self.profile_dir)
            env[PROFILE_ENV] = self.profile_dir
        self.kwokctl = Kwokctl(env, self.cfg["cluster_name"])
        self.workdir = os.path.join(self.home, "clusters", self.cfg["cluster_name"])
        self.watches, self.created = [], False
        self.view = View()
        self.n_nodes = ctx.size("nodes")
        self.peak = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for w in self.watches:
            w.stop()
        if self.created:
            _delete_cluster(self.kwokctl, self.workdir)
        shutil.rmtree(self.home, ignore_errors=True)

    def up(self) -> str:
        """Creates the cluster, its nodes and its placed pods."""
        cfg, view = self.cfg, self.view
        n_placed, shards = self.ctx.size("placed_pods"), int(cfg["placed_pod_shards"])
        t0 = time.perf_counter()
        self.kwokctl("create", "cluster", *cfg["create_args"])
        self.created = True
        self.up_s = time.perf_counter() - t0
        with open(os.path.join(self.workdir, "kwok.yaml")) as f:
            self.conf = _yaml(f.read())
        self.api = Api(self.conf["serverURL"])
        self.metrics_url = self.conf["serverURL"].rstrip("/") + "/metrics"
        rv = self.api.resource_version()
        for plural, on_event, ns in (("nodes", view.on_node, None),
                                     ("leases", view.on_lease, cfg["node_lease_namespace"]),
                                     ("pods", view.on_pod, None)):
            self.watches.append(Watch(self.api, plural, rv, on_event, namespace=ns))
            self.watches[-1].start()
        self.kwokctl("scale", "node", "--replicas", str(self.n_nodes))
        nodes_s = wait_until(f"{self.n_nodes} nodes Ready",
                             lambda: sum(list(view.node_ready.values())) == self.n_nodes, 240)
        t1 = time.perf_counter()
        for shard in range(shards):
            self.kwokctl("scale", "pod", "--replicas", str(n_placed // shards), "--name-prefix",
                         f"pod-{shard}", "--param", f"nodeName=node-{shard}")
        wait_until(f"{n_placed} placed pods Running",
                   lambda: len(view.placed_running) == n_placed, 300)
        placed_s = time.perf_counter() - t1
        self.sample_memory()
        return (f"cluster up {self.up_s:.4f} s, {self.n_nodes} nodes Ready in {nodes_s:.4f} s, "
                f"{n_placed} placed pods Running in {placed_s:.4f} s")

    def sample_memory(self) -> None:
        if self.cuda:
            self.peak = max(self.peak, smi_memory_bytes())

    def loop(self, prefix: str, rate: float, seconds: float, delete_after: float, seed: int,
             settle_s: float, trace: bool = False) -> dict:
        """One window of the open loop; what the client saw of it."""
        mix, view = self.ctx.cell.traffic, self.view
        n = max(1, int(round(rate * seconds)))
        names = [f"{prefix}{i:06d}" for i in range(n)]
        view.pods = {}
        view.add_pods(names)
        m0 = scrape(self.metrics_url)
        offsets = arrivals(seed, n, seconds)
        t_start = time.perf_counter() + 0.05
        if trace:
            open(os.path.join(self.profile_dir, "start"), "w").close()
        box = {}
        place = self.n_nodes if mix["placement"] == "nodeName" else 0
        loop = threading.Thread(target=lambda: box.update(late=open_loop(
            self.api, view, self.cfg["pod_template"], names, offsets, delete_after,
            int(mix["workers"]), t_start, place)), name="kwokbench-open-loop")
        loop.start()
        time.sleep(max(0.0, t_start + seconds - time.perf_counter()))
        t_end = time.perf_counter()
        if trace:
            open(os.path.join(self.profile_dir, "stop"), "w").close()
        m1 = scrape(self.metrics_url)
        self.sample_memory()
        gaps, open_gaps = lease_gaps(view, t_start, t_end)
        leases_end = {k: dict(v) for k, v in view.leases.items()}
        loop.join()
        settle(view, names, max(t_end, max(r["delete_due"] for r in view.pods.values()))
               + settle_s)
        t_judged = time.perf_counter()
        remaining = {p["metadata"]["name"] for p in self.api.list("pods")[0]
                     if p["metadata"]["name"].startswith(prefix)}
        recs = view.pods
        lat = running_latencies(recs, t_judged)
        return {
            "n": n, "window_s": t_end - t_start, "recs": recs, "remaining": remaining,
            "late": box.get("late", []), "running_s": lat,
            "bind_s": [r["bind_t"] - r["due"] for r in recs.values() if r["bind_t"] is not None],
            "running_after_bind_s": [r["running_t"] - r["bind_t"] for r in recs.values()
                                     if r["running_t"] is not None and r["bind_t"] is not None],
            "lease_gaps": gaps, "lease_open_gaps": open_gaps, "leases_end": leases_end,
            "api_requests": family_sum(m1, "kwok_apiserver_request_duration_seconds_count")
            - family_sum(m0, "kwok_apiserver_request_duration_seconds_count"),
            "api_seconds": family_sum(m1, "kwok_apiserver_request_duration_seconds_sum")
            - family_sum(m0, "kwok_apiserver_request_duration_seconds_sum"),
            "watches_ended": [w.name for w in self.watches if w.ended],
        }


def stalls(recs: dict, over: float = 1.0) -> list:
    """Episodes in which pods took over ``over`` seconds from due to
    Running: [first due, last due, worst latency], seconds into the loop,
    episodes parted by a second with none."""
    t0 = min((r["due"] for r in recs.values()), default=0.0)
    slow = sorted((r["due"] - t0, (r["running_t"] or math.inf) - r["due"])
                  for r in recs.values() if (r["running_t"] or math.inf) - r["due"] > over)
    out = []
    for due, lat in slow:
        if out and due - out[-1][1] <= 1.0:
            out[-1][1], out[-1][2] = due, max(out[-1][2], lat)
        else:
            out.append([due, due, lat])
    return [[round(a, 3), round(b, 3), round(c, 3)] for a, b, c in out]


def describe(w: dict, rate: float) -> str:
    recs, late, lat = w["recs"], w["late"], w["running_s"]
    lease = w["lease_gaps"] + w["lease_open_gaps"]
    return (f"window {w['window_s']:.6f} s: {w['n']} pods at {rate} pods/s, "
            f"{sum(r['created'] for r in recs.values())} created, "
            f"{sum(r['deleted'] for r in recs.values())} deleted; generator late "
            f"p50 {stats.percentile(late, 0.5):.6f} s, max {max(late, default=0):.6f} s; "
            f"running p50 {stats.percentile(lat, 0.5):.6f} s over {len(lat)} samples, "
            f"{stats.beyond(lat, 0.95)} beyond p95; lease gap samples {len(w['lease_gaps'])} "
            f"closed + {len(w['lease_open_gaps'])} open, {stats.beyond(lease, 0.99)} beyond p99; "
            f"apiserver {w['api_requests']:.0f} requests; watches ended {w['watches_ended']}; "
            f"episodes of pods over 1 s to Running [from, to, worst] {stalls(recs)}")


def run(ctx: Ctx) -> Result:
    cfg, mix = ctx.cell.config, ctx.cell.traffic
    rate = float(mix["rate_per_s"])
    with Cluster(ctx) as c:
        said = c.up()
        # the loop's path, warmed by a short run of it before the window
        warm = c.loop(WARM, rate, float(mix["warm_s"]), float(mix["warm_delete_after_s"]),
                      ctx.seed + 1, 120.0)
        setup_s = time.perf_counter() - ctx.t0
        ctx.log(f"set-up {setup_s:.4f} s: {said}, {warm['n']} warm-up pods")
        w = c.loop(STREAM, rate, ctx.seconds, float(mix["delete_after_s"]), ctx.seed,
                   float(mix["settle_s"]), trace=ctx.trace)
        daemon = _daemon_profile(c.profile_dir) if ctx.trace else None
        nodes = set(c.view.node_names)
        up_s, peak = c.up_s, c.peak
    ctx.log(describe(w, rate))
    recs = w["recs"]
    lease_samples = w["lease_gaps"] + w["lease_open_gaps"]
    checks, control = judge(ctx, w, nodes, c.n_nodes)
    layer = {k: w[k] for k in ("bind_s", "running_after_bind_s", "api_requests", "api_seconds")}
    layer.update(up_s=up_s, daemon=daemon)
    failed = sum(1 for r in recs.values()
                 if not r["created"] or r["running_t"] is None or (r["deleted"] and not r["gone"]))
    busy = window = breakdown = None
    if daemon is not None and "error" in daemon:
        ctx.warn(f"the daemon's profiler window failed: {daemon['error']}")
    if daemon is not None and daemon.get("busy_s"):
        busy, window = daemon["busy_s"], daemon["window_s"]
        breakdown = {"device_ops": devtrace.top({k: v["seconds"] for k, v in daemon["ops"].items()}),
                     "idle_gaps": [["the daemon's host work (not traced)", window - busy]]}
        peak = max(peak, int(daemon.get("memory_peak_bytes", 0)))
    return Result(
        e2e={"pod_running_p50_s": stats.percentile(w["running_s"], 0.5),
             "pod_running_p95_s": stats.percentile(w["running_s"], 0.95),
             "lease_renew_gap_p99_s": stats.percentile(lease_samples, 0.99),
             "setup_s": setup_s},
        layer=layer, attempted=w["n"], failed=failed, checks=checks, memory_peak_bytes=peak,
        busy_s=busy, window_s=window, breakdown=breakdown, control=control)


def judge(ctx: Ctx, w: dict, nodes, n_nodes: int):
    """The checks of one window, (name, value, limit), and with
    ``ctx.control`` the control's readings, (name, value)."""
    cfg, recs = ctx.cell.config, w["recs"]
    faults = ref.judge_pods(recs, cfg["pod_template"]["spec"], nodes, w["remaining"])
    for line in ref.first_faults(recs, cfg["pod_template"]["spec"], nodes):
        ctx.warn(f"fault: {line}")
    checks = [(f"pods_{k}", v, 0) for k, v in faults.items()]
    checks += [("leases_unheld", ref.lease_faults(w["leases_end"], cfg["daemon_id"], n_nodes), 0),
               ("lease_gap_max_s", max(w["lease_gaps"] + w["lease_open_gaps"], default=math.inf),
                float(cfg["node_lease_duration_s"])),
               ("watches_ended", len(w["watches_ended"]), 0)]
    control = _control(recs, cfg, nodes, w["remaining"]) if ctx.control else []
    return checks, control


def many(ctx: Ctx, seeds):
    """One cluster, one window per seed at the cell's rate and length:
    for each, (seed, checks, control readings).  For reading the
    control and many seeds in one process (``kwokbench.control``)."""
    mix = ctx.cell.traffic
    rate = float(mix["rate_per_s"])
    out = []
    with Cluster(ctx) as c:
        ctx.log(c.up())
        c.loop(WARM, rate, float(mix["warm_s"]), float(mix["warm_delete_after_s"]),
               ctx.seed + 1, 120.0)
        for i, seed in enumerate(seeds):
            w = c.loop(f"{STREAM}{i}-", rate, ctx.seconds, float(mix["delete_after_s"]), seed,
                       float(mix["settle_s"]))
            ctx.log(describe(w, rate))
            checks, control = judge(ctx, w, set(c.view.node_names), c.n_nodes)
            out.append((seed, checks, control))
    return out


def _control(recs: dict, cfg: dict, nodes, remaining: set):
    """The control: the client's own observations with one guarantee
    broken, as a cluster that lost one acknowledged delete would show
    them; the reference must judge it not correct."""
    broken = {k: dict(v) for k, v in recs.items()}
    victim = next((k for k, v in sorted(broken.items()) if v["deleted"]), None)
    if victim is not None:
        broken[victim]["gone"] = False
    faults = ref.judge_pods(broken, cfg["pod_template"]["spec"], nodes, remaining)
    return [(f"pods_{k}", v) for k, v in faults.items()]


def _yaml(text: str) -> dict:
    import yaml

    return yaml.safe_load(text)


def _daemon_profile(profile_dir: str, timeout: float = 60.0):
    path = os.path.join(profile_dir, "daemon.json")
    t0 = time.perf_counter()
    while not os.path.exists(path) and time.perf_counter() - t0 < timeout:
        time.sleep(0.1)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _delete_cluster(kwokctl: Kwokctl, workdir: str) -> None:
    """``kwokctl delete cluster``; then no component may be left alive."""
    pids = []
    piddir = os.path.join(workdir, "pids")
    for name in os.listdir(piddir) if os.path.isdir(piddir) else ():
        try:
            with open(os.path.join(piddir, name)) as f:
                pids.append(int(f.read()))
        except (OSError, ValueError):
            pass
    try:
        kwokctl("delete", "cluster", timeout=180)
    finally:
        for pid in pids:
            try:
                os.killpg(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
