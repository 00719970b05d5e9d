"""Server-side apply: field sets, fieldsV1 codec, conflict detection.

The reference gets SSA for free from the real kube-apiserver its
clusters compose (reference runtime/binary/cluster.go:316-728); this
repo IS the apiserver, so the behavior lives here (VERDICT r03 #3).
A managedFields-lite model:

- a manager's ownership is the set of LEAF paths its applied
  configuration mentions (dicts recurse; scalars and lists are leaves —
  lists are atomic at this granularity, the same simplification the
  in-tree strategic-merge metadata makes for untyped CRs);
- ownership is encoded to/from the wire ``fieldsV1`` shape
  (``{"f:spec": {"f:replicas": {}}}``) so kubectl can read it back;
- applying removes the fields the manager owned before but no longer
  mentions (the "abandon" half of apply semantics);
- a second manager applying an owned field conflicts (HTTP 409 with
  FieldManagerConflict causes) unless ``force=true``, which transfers
  ownership — the exact kubectl retry contract.

Object identity and bookkeeping fields are exempt from ownership
(they are shared): apiVersion, kind, metadata.name/namespace/uid/
creationTimestamp/resourceVersion/generation/managedFields.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Set, Tuple

Path = Tuple[str, ...]
FieldSet = Set[Path]

#: identity/bookkeeping paths never owned by a manager
EXEMPT: FieldSet = {
    ("apiVersion",),
    ("kind",),
    ("metadata", "name"),
    ("metadata", "namespace"),
    ("metadata", "uid"),
    ("metadata", "creationTimestamp"),
    ("metadata", "resourceVersion"),
    ("metadata", "generation"),
    ("metadata", "managedFields"),
}


def field_set(obj: dict) -> FieldSet:
    """Leaf paths an applied configuration claims."""
    out: FieldSet = set()

    def walk(node, prefix: Path) -> None:
        if isinstance(node, dict) and node:
            for k, v in node.items():
                walk(v, prefix + (str(k),))
        else:
            # scalars, lists, None, and empty dicts are leaves
            if prefix and prefix not in EXEMPT:
                out.add(prefix)

    walk(obj, ())
    return out


def to_fields_v1(fs: FieldSet) -> dict:
    """Encode a field set in the wire ``fieldsV1`` shape."""
    root: dict = {}
    for path in sorted(fs):
        cur = root
        for seg in path:
            cur = cur.setdefault(f"f:{seg}", {})
    return root


def from_fields_v1(node: dict, prefix: Path = ()) -> FieldSet:
    out: FieldSet = set()
    for k, v in (node or {}).items():
        if not k.startswith("f:"):
            continue  # "." / "k:{...}" entries from richer encoders
        path = prefix + (k[2:],)
        if isinstance(v, dict) and any(x.startswith("f:") for x in v):
            out |= from_fields_v1(v, path)
        else:
            out.add(path)
    return out


_MISSING = object()


def path_get(obj, path: Path):
    """Value at a leaf path; ``_MISSING`` when absent."""
    cur = obj
    for seg in path:
        if not isinstance(cur, dict):
            return _MISSING
        if seg not in cur:
            return _MISSING
        cur = cur[seg]
    return cur


def find_conflicts(
    desired: FieldSet,
    others: Iterable[Tuple[str, FieldSet]],
    applied: dict,
    current: dict,
) -> List[Tuple[str, Path, Path]]:
    """(manager, their_path, our_path) triples where another manager
    owns a desired leaf AND the applied value differs from the current
    one — equal values become co-ownership, not a conflict (upstream
    SSA semantics).  Ancestor/descendant overlap (owning ``spec.foo``
    vs claiming ``spec.foo.bar``) is structural and always conflicts.

    Both paths are reported because they serve different consumers: a
    forced apply dispossesses the OTHER manager's entry (their_path —
    the one actually present in their field set), while the Status
    cause names what the APPLIER claimed (our_path).  Collapsing to
    the longer of the two left forced applies unable to strip an
    ancestor claim (ADVICE r04 #2)."""
    out: List[Tuple[str, Path, Path]] = []
    for manager, fs in others:
        hits = set()
        for p in fs & desired:
            if path_get(applied, p) != path_get(current, p):
                hits.add((p, p))
        for theirs in fs:
            for ours in desired:
                if theirs == ours:
                    continue
                shorter, longer = sorted((theirs, ours), key=len)
                if longer[: len(shorter)] == shorter:
                    hits.add((theirs, ours))
        for theirs, ours in sorted(hits):
            out.append((manager, theirs, ours))
    return out


def remove_path(obj: dict, path: Path) -> None:
    """Delete a leaf path in place, pruning emptied parent dicts."""
    parents: List[Tuple[dict, str]] = []
    cur = obj
    for seg in path[:-1]:
        nxt = cur.get(seg)
        if not isinstance(nxt, dict):
            return
        parents.append((cur, seg))
        cur = nxt
    cur.pop(path[-1], None)
    for parent, seg in reversed(parents):
        child = parent.get(seg)
        if isinstance(child, dict) and not child:
            del parent[seg]
        else:
            break


def dotted(path: Path) -> str:
    """k8s Status cause field syntax: ``.spec.replicas``."""
    return "." + ".".join(path)
