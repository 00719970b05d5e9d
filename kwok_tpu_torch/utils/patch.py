"""Patch application: JSON Patch, JSON Merge Patch, strategic merge.

The reference applies stage effects as one of three patch types against
the apiserver (reference: pkg/utils/lifecycle/next.go:96-121,
pkg/kwok/controllers/utils.go:162-304 for no-op detection). Here the
store is in-process, so we implement the appliers directly:

- JSON Patch (RFC 6902) subset: add/remove/replace — what the finalizer
  ops emit (reference finalizers.go:32-116).
- JSON Merge Patch (RFC 7386): recursive merge, null deletes.
- Strategic merge: like merge patch, but lists of objects merge by a
  patch-merge key (k8s semantics). We carry a small key table for the
  types the simulator touches (containers/conditions by name/type);
  unknown lists replace wholesale, which matches the RFC 7386 fallback
  the reference gets for unregistered types.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

PATCH_JSON = "json"
PATCH_MERGE = "merge"
PATCH_STRATEGIC = "strategic"

# ---------------------------------------------------------------------------
# Strategic-merge metadata
#
# The reference discovers patchMergeKey/patchStrategy per type from the
# apiserver's OpenAPI v3 (pkg/utils/patch/openapi.go:43-248).  This repo IS
# the apiserver, so the authoritative metadata lives here: a per-kind table
# mirroring the upstream k8s struct tags (x-kubernetes-patch-merge-key /
# x-kubernetes-patch-strategy), served back out via /openapi/v3
# (cluster/k8s_api.py) so ecosystem tools discover the same truth.
# ---------------------------------------------------------------------------

#: ("merge", key) = merge by key; ("merge", None) = primitive set-merge;
#: absent = atomic (replace wholesale)
_POD_META = {
    ("spec", "containers"): ("merge", "name"),
    ("spec", "initContainers"): ("merge", "name"),
    ("spec", "ephemeralContainers"): ("merge", "name"),
    ("spec", "volumes"): ("merge", "name"),
    ("spec", "containers", "env"): ("merge", "name"),
    ("spec", "containers", "ports"): ("merge", "containerPort"),
    ("spec", "containers", "volumeMounts"): ("merge", "mountPath"),
    ("spec", "containers", "volumeDevices"): ("merge", "devicePath"),
    ("spec", "initContainers", "env"): ("merge", "name"),
    ("spec", "initContainers", "ports"): ("merge", "containerPort"),
    ("spec", "initContainers", "volumeMounts"): ("merge", "mountPath"),
    ("spec", "imagePullSecrets"): ("merge", "name"),
    ("spec", "hostAliases"): ("merge", "ip"),
    ("spec", "readinessGates"): ("merge", "conditionType"),
    ("status", "conditions"): ("merge", "type"),
    # NOTE upstream PodStatus.ContainerStatuses carries NO patch tags:
    # atomic replace (the old name-keyed table diverged here)
}
_NODE_META = {
    ("status", "conditions"): ("merge", "type"),
    ("status", "addresses"): ("merge", "type"),
    # taints, images, volumesAttached: atomic upstream
}
_SERVICE_META = {
    ("spec", "ports"): ("merge", "port"),
}
_COMMON_META = {
    ("metadata", "finalizers"): ("merge", None),  # primitive set-merge
    ("metadata", "ownerReferences"): ("merge", "uid"),
}

#: kind -> {path tuple (list indices elided) -> ("merge", key|None)}
STRATEGIC_META: Dict[str, Dict[tuple, tuple]] = {
    "Pod": {**_COMMON_META, **_POD_META},
    "Node": {**_COMMON_META, **_NODE_META},
    "Service": {**_COMMON_META, **_SERVICE_META},
}

#: legacy field-NAME-keyed fallback for kinds without typed metadata
#: (CRDs and untyped objects): matches the pre-OpenAPI behavior so
#: unknown kinds keep merging the well-known k8s list shapes
_MERGE_KEYS = {
    "conditions": "type",
    "containers": "name",
    "initContainers": "name",
    "ephemeralContainers": "name",
    "containerStatuses": "name",
    "initContainerStatuses": "name",
    "ephemeralContainerStatuses": "name",
    "volumes": "name",
    "env": "name",
    "ports": "containerPort",
    "addresses": "type",
    "finalizers": None,  # set-merge
}


def register_strategic_meta(kind: str, path: tuple, merge_key: Optional[str]) -> None:
    """Register list metadata for a CRD kind (the CRD's
    x-kubernetes-patch-merge-key analog)."""
    STRATEGIC_META.setdefault(kind, dict(_COMMON_META))[tuple(path)] = (
        "merge",
        merge_key,
    )


def list_meta(kind: Optional[str], path: tuple, field_name: str):
    """(strategy, merge_key) for a list field: typed table first, then
    the name-keyed fallback for unknown kinds; None = atomic."""
    if kind:
        table = STRATEGIC_META.get(kind)
        if table is not None:
            return table.get(path)
    if field_name in _MERGE_KEYS:
        return ("merge", _MERGE_KEYS[field_name])
    return None


def apply_json_patch(obj: Any, ops: List[Dict[str, Any]]) -> Any:
    """Apply an RFC 6902 patch (add/remove/replace subset).

    Copy-on-write along each op's path only: untouched subtrees are
    SHARED with the input (the store's handed-out-by-reference contract
    makes inputs immutable; deep-copying a whole 60-node pod to flip
    one finalizer list was a top cost of the 1M-row create wave)."""
    out = _shallow(obj)
    for op in ops:
        path = op["path"]
        parts = [p.replace("~1", "/").replace("~0", "~") for p in path.split("/")[1:]]
        action = op["op"]
        parent, last = _traverse_cow(out, parts)
        if action == "add":
            value = _copy_json(op["value"])
            if isinstance(parent, list):
                if last == "-":
                    parent.append(value)
                else:
                    parent.insert(int(last), value)
            else:
                parent[last] = value
        elif action == "remove":
            if isinstance(parent, list):
                del parent[int(last)]
            else:
                if last not in parent:
                    raise KeyError(f"path not found: {path}")
                del parent[last]
        elif action == "replace":
            value = _copy_json(op["value"])
            if isinstance(parent, list):
                parent[int(last)] = value
            else:
                parent[last] = value
        else:
            raise ValueError(f"unsupported json patch op {action!r}")
    return out


def _traverse(obj: Any, parts: List[str]):
    cur = obj
    for p in parts[:-1]:
        if isinstance(cur, list):
            cur = cur[int(p)]
        else:
            cur = cur[p]
    return cur, parts[-1]


def _shallow(x: Any) -> Any:
    if isinstance(x, dict):
        return dict(x)
    if isinstance(x, list):
        return list(x)
    return x


def _traverse_cow(obj: Any, parts: List[str]):
    """Like _traverse, but shallow-copies each container on the walk
    and re-links it into the (already copied) parent, so mutating the
    returned parent never touches the original's subtrees."""
    cur = obj
    for p in parts[:-1]:
        if isinstance(cur, list):
            i = int(p)
            child = _shallow(cur[i])
            cur[i] = child
        else:
            child = _shallow(cur[p])
            cur[p] = child
        cur = child
    return cur, parts[-1]


def copy_json(x: Any) -> Any:
    """Deep copy for JSON-shaped data (dict/list/scalars) — the ONE
    canonical implementation (cluster.store re-exports it).  Inputs are
    JSON by contract, so the general deepcopy machinery (memo dict,
    reductor dispatch) is pure overhead on the hot copy paths; this is
    ~3x faster and shares immutable leaves."""
    t = type(x)
    if t is dict:
        return {k: copy_json(v) for k, v in x.items()}
    if t is list:
        return [copy_json(v) for v in x]
    return x


_copy_json = copy_json


def apply_merge_patch(obj: Any, patch: Any) -> Any:
    """RFC 7386 JSON Merge Patch."""
    if not isinstance(patch, dict):
        return _copy_json(patch)
    if not isinstance(obj, dict):
        obj = {}
    out = dict(obj)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = apply_merge_patch(out.get(k), v)
    return out


def merge_patch_is_noop(obj: Any, patch: Any) -> bool:
    """Would this RFC 7386 merge patch leave ``obj`` unchanged?
    Allocation-free equivalent of ``apply_merge_patch(obj, patch) ==
    obj`` (the drain runs this once per dirty row)."""
    if not isinstance(patch, dict):
        return obj == patch
    if not isinstance(obj, dict):
        # merging a dict patch onto a non-dict replaces it with the
        # patch applied to {} — a no-op only in degenerate cases the
        # full apply handles; report "changes" conservatively
        return False
    for k, v in patch.items():
        if v is None:
            if k in obj:
                return False
        elif isinstance(v, dict):
            cur = obj.get(k)
            if not isinstance(cur, dict) or not merge_patch_is_noop(cur, v):
                return False
        else:
            if k not in obj or obj[k] != v:
                return False
    return True


_DIRECTIVE = "$patch"
_DEL_PRIMITIVE = "$deleteFromPrimitiveList/"
_SET_ORDER = "$setElementOrder/"


def apply_strategic_merge_patch(
    obj: Any,
    patch: Any,
    field_name: str = "",
    kind: Optional[str] = None,
    path: tuple = (),
) -> Any:
    """Strategic merge with k8s semantics: dicts merge recursively,
    lists of objects merge by the field's patch-merge key (typed
    metadata via ``list_meta``; see STRATEGIC_META), other lists
    replace; ``$patch: replace|delete`` and ``$deleteFromPrimitiveList``
    directives honored (``$setElementOrder`` is accepted and ignored —
    element order follows merge order, a documented divergence).

    (reference consumes the same metadata through OpenAPI discovery,
    pkg/utils/patch/openapi.go:43-248)"""
    if isinstance(patch, dict) and isinstance(obj, dict):
        directive = patch.get(_DIRECTIVE)
        if directive == "replace":
            return {
                k: _copy_json(v) for k, v in patch.items() if k != _DIRECTIVE
            }
        if directive == "delete":
            return None  # caller (dict/list merge) removes the entry
        out = dict(obj)
        for k, v in patch.items():
            if k.startswith(_DEL_PRIMITIVE):
                target = k[len(_DEL_PRIMITIVE):]
                cur = out.get(target)
                if isinstance(cur, list) and isinstance(v, list):
                    out[target] = [x for x in cur if x not in v]
                continue
            if k.startswith(_SET_ORDER) or k == _DIRECTIVE:
                continue
            if v is None:
                out.pop(k, None)
                continue
            merged = (
                apply_strategic_merge_patch(out[k], v, k, kind, path + (k,))
                if k in out
                else _strip_directives(v)
            )
            if merged is None:
                out.pop(k, None)  # nested {"$patch": "delete"}
            else:
                out[k] = merged
        return out
    if isinstance(patch, list) and isinstance(obj, list):
        meta = list_meta(kind, path, field_name)
        if meta is None:
            return _strip_directives(patch)
        key = meta[1]
        if key is None:  # primitive set-merge (e.g. finalizers)
            merged = list(obj)
            for item in patch:
                if item not in merged:
                    merged.append(_copy_json(item))
            return merged
        merged = [_copy_json(i) for i in obj]
        index = {i.get(key): n for n, i in enumerate(merged) if isinstance(i, dict)}
        for item in patch:
            if isinstance(item, dict) and item.get(key) in index:
                n = index[item[key]]
                if item.get(_DIRECTIVE) == "delete":
                    # mark for removal, fix indexes after
                    merged[n] = None
                    continue
                merged[n] = apply_strategic_merge_patch(
                    merged[n], item, "", kind, path
                )
            elif isinstance(item, dict) and item.get(_DIRECTIVE) == "delete":
                continue  # delete of an absent element: no-op
            else:
                merged.append(_strip_directives(item))
                if isinstance(item, dict):
                    index[item.get(key)] = len(merged) - 1
        return [m for m in merged if m is not None]
    return _strip_directives(patch)


def _strip_directives(v: Any) -> Any:
    """Deep copy minus $patch/$setElementOrder bookkeeping keys (a new
    element carrying a directive must not store it)."""
    t = type(v)
    if t is dict:
        return {
            k: _strip_directives(x)
            for k, x in v.items()
            if k != _DIRECTIVE and not k.startswith(_SET_ORDER)
        }
    if t is list:
        return [_strip_directives(x) for x in v]
    return v


def apply_patch(obj: Any, data: Any, patch_type: str, kind: Optional[str] = None) -> Any:
    if patch_type == PATCH_JSON:
        if isinstance(data, (str, bytes)):
            data = json.loads(data)
        return apply_json_patch(obj, data)
    if isinstance(data, (str, bytes)):
        data = json.loads(data)
    if patch_type == PATCH_STRATEGIC:
        return apply_strategic_merge_patch(obj, data, kind=kind)
    return apply_merge_patch(obj, data)


def wrap_with_root(root: str, patch: Any) -> Any:
    """Wrap rendered patch data under a root field (merge-patch flavor),
    mirroring reference next.go:147-155 wrapMergePatchData."""
    if not root:
        return patch
    return {root: patch}


def wrap_json_patch_with_root(root: str, ops: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Prefix JSON-patch op paths with /root (reference next.go:157-170)."""
    if not root:
        return ops
    out = []
    for op in ops:
        op = dict(op)
        if "path" in op:
            op["path"] = f"/{root}{op['path']}"
        out.append(op)
    return out


def is_noop_patch(
    obj: Any, data: Any, patch_type: str, kind: Optional[str] = None
) -> bool:
    """Would applying this patch change the object?
    (reference controllers/utils.go:162-304 checkNeedPatch*)"""
    try:
        if patch_type == PATCH_MERGE:
            if isinstance(data, (str, bytes)):
                data = json.loads(data)
            return merge_patch_is_noop(obj, data)
        return apply_patch(obj, data, patch_type, kind=kind) == obj
    except (KeyError, IndexError, ValueError, TypeError):
        return False
