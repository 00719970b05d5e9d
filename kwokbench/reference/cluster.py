"""The plain reference of a kwokctl cluster's guarantees.

What a client that created and deleted pods may expect of the cluster,
written from the configuration's stated guarantees and Kubernetes'
pod semantics, and judged from the client's own observations (its
watches' events and its final listing):

- a pod whose create was acknowledged is bound once, to a node of the
  cluster, and reaches Running with every container of its spec running
  and ready, the Ready condition True and an IP;
- a pod whose delete was acknowledged leaves the store;
- every node lease stays held by the daemon and is never left unrenewed
  for its duration.

It imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional


def running_faults(spec: dict, obj: dict) -> List[str]:
    """How the first Running object the client saw of a pod created from
    ``spec`` departs from what a Running pod must carry."""
    faults = []
    status = obj.get("status") or {}
    if status.get("phase") != "Running":
        faults.append(f"phase {status.get('phase')!r}")
    want = [c["name"] for c in spec.get("containers") or []]
    got = {c.get("name"): c for c in status.get("containerStatuses") or []}
    for name in want:
        c = got.get(name)
        if c is None:
            faults.append(f"container {name} has no status")
        elif not c.get("ready") or "running" not in (c.get("state") or {}):
            faults.append(f"container {name} not running and ready")
    if sorted(got) != sorted(want):
        faults.append(f"container statuses {sorted(got)} for containers {want}")
    ready = [c for c in status.get("conditions") or [] if c.get("type") == "Ready"]
    if not ready or ready[0].get("status") != "True":
        faults.append("Ready condition not True")
    if not status.get("podIP"):
        faults.append("no podIP")
    return faults


def judge_pods(pods: Dict[str, dict], spec: dict, nodes: Iterable[str],
               remaining: Iterable[str]) -> Dict[str, int]:
    """Counts of broken guarantees over the client's pod records: each
    record has ``created`` and ``deleted`` (acknowledged), ``nodes`` (every
    nodeName the watch saw), ``running_obj`` (the first Running object)
    and ``gone`` (a DELETED event seen).  ``remaining`` names the pods
    the final listing still holds."""
    nodes, remaining = set(nodes), set(remaining)
    out = {"never_running": 0, "bad_running_status": 0, "bound_twice": 0,
           "bound_off_cluster": 0, "deletes_not_applied": 0}
    for name, rec in pods.items():
        if not rec.get("created"):
            continue
        bound = rec.get("nodes") or []
        if len(set(bound)) > 1:
            out["bound_twice"] += 1
        if not set(bound) <= nodes:
            out["bound_off_cluster"] += 1
        if rec.get("running_obj") is None:
            out["never_running"] += 1
        elif running_faults(spec, rec["running_obj"]):
            out["bad_running_status"] += 1
        if rec.get("deleted") and (not rec.get("gone") or name in remaining):
            out["deletes_not_applied"] += 1
    return out


def lease_faults(leases: Dict[str, dict], holder: str, n_nodes: int) -> int:
    """Node leases missing at the end, or held by another than ``holder``."""
    held = sum(1 for rec in leases.values() if rec.get("holder") == holder)
    return max(0, n_nodes - held)


def first_faults(pods: Dict[str, dict], spec: dict, nodes: Iterable[str], n: int = 3) -> List[str]:
    """The first few pods whose records break a guarantee, with what was
    seen of them, for the log."""
    nodes, out = set(nodes), []
    for name, rec in sorted(pods.items()):
        if not rec.get("created"):
            continue
        why = list(running_faults(spec, rec["running_obj"])) if rec.get("running_obj") else []
        bound = rec.get("nodes") or []
        if len(set(bound)) > 1 or not set(bound) <= nodes:
            why.append(f"bound to {bound}, off the cluster: {sorted(set(bound) - nodes)}")
        if rec.get("running_obj") is None:
            why.append("never Running")
        if rec.get("deleted") and not rec.get("gone"):
            why.append("deleted, never gone")
        if why:
            out.append(f"{name}: {why}")
        if len(out) >= n:
            break
    return out
