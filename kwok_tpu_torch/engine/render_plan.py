"""Cross-row render plans: batched stage-patch materialization.

The host drain's per-row cost used to be one full gotpl render + YAML
parse per fired row (~1ms).  For a device-compilable stage set, a
stage's rendered patch depends only on:

- the row's *signature* (spec/labels/annotations equality class — the
  same key the compiler's effect tables use),
- the row's identity (metadata name/namespace/uid),
- env-func outputs (PodIP/NodeIP..., row-stable),
- ``Now`` (per tick), and
- the template-read projection (``CompiledStageSet._read_paths``).

So one render per (stage, sig) with *sentinel* values substituted for
identity/funcs/Now yields a reusable plan: per row, the patch is rebuilt
by replacing sentinel leaves — tens of dict nodes, not a render.  This
is the drain half of SURVEY §7's "render/merge JSON on host without
becoming the bottleneck"; the reference's per-object equivalent is the
template render in pkg/utils/lifecycle/next.go:73-88.

Soundness notes:

- Env funcs are treated as opaque row constants: a template that
  *branches* on a func's output (``{{ if eq PodIP ... }}``) would
  mis-plan.  The device compiler already makes the same assumption (its
  abstract exploration renders with fixed COMPILE_ENV_FUNCS), so the
  fast path inherits, not adds, the constraint.
- Plans are only used when the stage set has no template read paths
  (``cset._read_paths`` empty); otherwise rows fall back to the
  per-row path.  Identity reads (.metadata.name/namespace/uid) are
  handled via sentinels, and spec/labels/annotations reads are covered
  by the signature key.
- Sequential merge patches compose into one template by RFC 7386 patch
  composition; shapes where composition does not hold (scalar patched
  then dict-merged) are rejected to the slow path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from kwok_tpu_torch.utils.patch import apply_merge_patch

#: sentinel token namespace — alphanumeric + dots so YAML keeps plain
#: scalars as strings and quoting never mangles them
_S = "zq9kws"
NOW_S = f"{_S}.now.z"
NAME_S = f"{_S}.nm.z"
NS_S = f"{_S}.ns.z"
UID_S = f"{_S}.uid.z"


def _func_token(i: int) -> str:
    return f"{_S}.f{i}.z"


class PatchPlan:
    """One patch of a stage, as a sentinel template (general form:
    any patch type/subresource — powers the slow path's render)."""

    __slots__ = ("compiled", "template", "type", "subresource", "impersonation")

    def __init__(self, template, ptype, subresource, impersonation):
        self.template = template
        self.type = ptype
        self.subresource = subresource
        self.impersonation = impersonation
        self.compiled = _compile_node(template)

    def build(self, vals: Dict[str, Any]) -> Any:
        if self.compiled is None:
            return self.template
        return build(self.compiled, vals)


class RenderPlan:
    """Compiled per-(stage, sig) patch builder.

    ``patch_plans`` is the general form (one sentinel template per
    stage patch — replaces the per-row gotpl render everywhere).  When
    the stage is *fast-eligible* (merge patches on status only, no
    delete/finalizers, composable), ``fast`` is True and ``template``
    holds the single merged status template for the columnar drain."""

    __slots__ = (
        "compiled",
        "template",
        "calls",
        "has_event",
        "has_null",
        "top_plain",
        "all_top_plain",
        "immediate",
        "fast",
        "patch_plans",
        "_tick_bound",
        "has_now",
    )

    def __init__(self, template, calls, has_event, immediate, fast, patch_plans):
        self._tick_bound = None
        #: template stamps Now somewhere -> a rebuilt patch can never be
        #: a no-op against a status written at an earlier tick (virtual
        #: timestamps strictly increase), so the drain skips the deep
        #: equality check for these plans
        self.has_now = _contains_token(template, NOW_S) if template is not None else False
        self.template = template  # merged status-patch template (sentinels)
        self.calls: List[Tuple[str, Tuple]] = calls  # (func name, args)
        self.has_event = has_event
        self.has_null = _has_null(template) if template is not None else False
        #: top-level keys whose template values are non-dict (replace
        #: wholesale under merge-patch) — lets build() skip the merge
        #: when the current status has no other keys
        self.top_plain = (
            {
                k
                for k, v in template.items()
                if not isinstance(v, dict) and v is not None
            }
            if template is not None
            else set()
        )
        #: every template key replaces wholesale -> the merge collapses
        #: to a top-level dict update
        self.all_top_plain = (
            template is not None and len(self.top_plain) == len(template)
        )
        self.compiled = _compile_node(template) if template is not None else None
        self.immediate = immediate
        self.fast = fast
        self.patch_plans: List[PatchPlan] = patch_plans

    def _vals(self, obj: dict, now_s: str, funcs: Dict[str, Callable]) -> Dict[str, Any]:
        meta = obj.get("metadata") or {}
        vals: Dict[str, Any] = {
            NOW_S: now_s,
            NAME_S: meta.get("name") or "",
            NS_S: meta.get("namespace") or "",
            UID_S: meta.get("uid") or "",
        }
        for i, (fname, args) in enumerate(self.calls):
            f = funcs.get(fname)
            if f is None:
                raise KeyError(f"env func {fname} missing")
            rargs = [_resolve_arg(a, vals) for a in args]
            vals[_func_token(i)] = f(*rargs)
        return vals

    def bind_tick(self, now_s: str):
        """Substitute the tick-constant Now once; returns (bound
        template, row_compiled) where only row-dependent tokens remain.
        row_compiled None means the bound template is fully static —
        shared by every row this tick (heartbeat-style patches).  Cached
        per now_s (one bind per plan per tick)."""
        tb = self._tick_bound
        if tb is None or tb[0] != now_s:
            if self.compiled is None:
                bound, comp = self.template, None
            else:
                bound = _bind(self.compiled, {NOW_S: now_s})
                comp = _compile_node(bound)
            tb = self._tick_bound = (now_s, bound, comp)
        return tb[1], tb[2]

    def row_vals(self, obj: dict, funcs: Dict[str, Callable]) -> Dict[str, Any]:
        """Per-row substitution values (identity + env-func results —
        no Now; bind_tick already resolved it)."""
        meta = obj.get("metadata") or {}
        vals: Dict[str, Any] = {
            NAME_S: meta.get("name") or "",
            NS_S: meta.get("namespace") or "",
            UID_S: meta.get("uid") or "",
        }
        for i, (fname, args) in enumerate(self.calls):
            f = funcs.get(fname)
            if f is None:
                raise KeyError(f"env func {fname} missing")
            rargs = [_resolve_arg(a, vals) for a in args]
            vals[_func_token(i)] = f(*rargs)
        return vals

    def build_patch(self, obj: dict, now_s: str, funcs: Dict[str, Callable]) -> Any:
        """Materialize this row's merged status patch (fast form)."""
        bound, comp = self.bind_tick(now_s)
        if comp is None:
            return bound
        return build(comp, self.row_vals(obj, funcs))

    def build_patches(self, obj: dict, now_s: str, funcs: Dict[str, Callable]):
        """Materialize the stage's patches as lifecycle.Patch objects
        (general form, used by the per-row slow path in place of a
        full gotpl render)."""
        from kwok_tpu_torch.engine.lifecycle import Patch

        vals = self._vals(obj, now_s, funcs)
        return [
            Patch(
                data=pp.build(vals),
                type=pp.type,
                subresource=pp.subresource,
                impersonation=pp.impersonation,
            )
            for pp in self.patch_plans
        ]

    def new_status(self, cur_status: dict, patch: Any) -> dict:
        """Merge the built patch onto the row's current status, skipping
        the recursive merge when every patch key replaces wholesale
        (the steady-churn common case)."""
        if not self.has_null and self.all_top_plain:
            if all(k in self.top_plain for k in cur_status):
                return patch
            out = dict(cur_status)
            out.update(patch)
            return out
        return apply_merge_patch(cur_status, patch)


def _resolve_arg(a: Any, vals: Dict[str, Any]) -> Any:
    if isinstance(a, str) and _S in a:
        return _sub_str(a, vals)
    return a


_TOK_RE = __import__("re").compile(r"zq9kws\.[a-z0-9]+\.z")


def _sub_str(leaf: str, vals: Dict[str, Any]) -> Any:
    """Substitute sentinel tokens in an arbitrary string (func args)."""
    if leaf in vals:
        return vals[leaf]
    for tok in _TOK_RE.findall(leaf):
        leaf = leaf.replace(tok, str(vals.get(tok, tok)))
    return leaf


def _compile_node(node: Any):
    """Pre-walk the template: returns None for sentinel-free (static,
    shareable) subtrees, else a builder spec.  String leaves precompute
    their token list; a leaf that is exactly one token keeps the
    substituted value's type (NodePort stays an int)."""
    if isinstance(node, dict):
        items = []
        for k, v in node.items():
            c = _compile_node(v)
            if c is not None:
                items.append((k, c))
        return ("d", node, items) if items else None
    if isinstance(node, list):
        items = []
        for i, v in enumerate(node):
            c = _compile_node(v)
            if c is not None:
                items.append((i, c))
        return ("l", node, items) if items else None
    if isinstance(node, str) and _S in node:
        toks = _TOK_RE.findall(node)
        if len(toks) == 1 and toks[0] == node:
            return ("x", node, None)  # exact: typed substitution
        return ("s", node, toks)
    return None


def _bind(comp, vals: Dict[str, Any]) -> Any:
    """Like _build, but unknown tokens survive — produces a narrower
    template with only the still-unresolved (row-dependent) leaves."""
    kind, orig, items = comp
    if kind == "x":
        return vals.get(orig, orig)
    if kind == "s":
        for tok in items:
            v = vals.get(tok)
            if v is not None:
                orig = orig.replace(tok, str(v))
        return orig
    if kind == "d":
        out = dict(orig)
        for k, c in items:
            out[k] = _bind(c, vals)
        return out
    out = list(orig)
    for i, c in items:
        out[i] = _bind(c, vals)
    return out


def _build(comp, vals: Dict[str, Any]) -> Any:
    kind, orig, items = comp
    if kind == "x":
        return vals[orig]
    if kind == "s":
        for tok in items:
            orig = orig.replace(tok, str(vals[tok]))
        return orig
    if kind == "d":
        out = dict(orig)
        for k, c in items:
            out[k] = _build(c, vals)
        return out
    out = list(orig)
    for i, c in items:
        out[i] = _build(c, vals)
    return out


def _native_build():
    try:
        from kwok_tpu_torch.native.fastdrain import load

        mod = load()
    except Exception:  # noqa: BLE001 — accelerator only
        return None
    return getattr(mod, "build", None) if mod is not None else None


#: preferred builder: the C extension when available — semantics pinned
#: equal to _build by tests/test_render_plan.py::test_c_python_builder_parity
build = _native_build() or _build


def _contains_token(node: Any, tok: str) -> bool:
    if isinstance(node, str):
        return tok in node
    if isinstance(node, dict):
        return any(_contains_token(v, tok) for v in node.values())
    if isinstance(node, list):
        return any(_contains_token(v, tok) for v in node)
    return False


def _has_null(node: Any) -> bool:
    """Does the template carry RFC 7386 delete markers?  Only nulls
    reachable through pure-dict paths count: a merge patch replaces
    list subtrees atomically, so a ``null`` inside a list (e.g. the
    conditions' ``lastProbeTime: null``) is a literal value."""
    if isinstance(node, dict):
        return any(v is None or _has_null(v) for v in node.values())
    return False


class _Incomposable(Exception):
    pass


def _merge_templates(a: Any, b: Any) -> Any:
    """RFC 7386 composition of two merge-patch *templates* such that
    apply(apply(x, a), b) == apply(x, merge(a, b)).  Raises when the
    law does not hold for the shapes involved."""
    if not isinstance(b, dict):
        return b
    if not isinstance(a, dict):
        # x.k was replaced by scalar a, then dict-merged by b: the
        # composed patch cannot express "clear then merge"
        raise _Incomposable()
    out = dict(a)
    for k, v in b.items():
        if v is None:
            out[k] = None
        elif k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge_templates(out[k], v)
        elif k in out and not isinstance(out[k], dict) and isinstance(v, dict):
            raise _Incomposable()
        else:
            out[k] = v
    return out


def compile_plan(lifecycle, cs, obj: dict, func_names) -> Optional[RenderPlan]:
    """Build a RenderPlan for (stage, representative object), or None
    when even the general (per-patch) form cannot be planned — i.e. a
    render that errors on sentinels.  ``plan.fast`` says whether the
    columnar status path applies; otherwise ``plan.build_patches``
    still replaces the slow path's per-row gotpl render."""
    effects = lifecycle.effects(cs)
    if effects is None:
        return RenderPlan({}, [], False, cs.immediate_next_stage, True, [])
    nxt = effects.next

    meta = obj.get("metadata") or {}
    rep = dict(obj)
    rmeta = dict(meta)
    if rmeta.get("name"):
        rmeta["name"] = NAME_S
    if rmeta.get("namespace"):
        rmeta["namespace"] = NS_S
    if rmeta.get("uid"):
        rmeta["uid"] = UID_S
    rep["metadata"] = rmeta

    calls: List[Tuple[str, Tuple]] = []

    def mk(fname: str):
        def f(*args):
            key = (fname, tuple(args))
            try:
                i = calls.index(key)
            except ValueError:
                i = len(calls)
                calls.append(key)
            return _func_token(i)

        return f

    sfuncs: Dict[str, Callable] = {name: mk(name) for name in func_names}
    sfuncs["Now"] = lambda: NOW_S

    try:
        patches = effects.patches(rep, sfuncs)
    except Exception:  # noqa: BLE001 — template not plan-renderable
        return None

    patch_plans = [
        PatchPlan(p.data, p.type or "merge", p.subresource, p.impersonation)
        for p in patches
    ]

    fast = not nxt.delete and nxt.finalizers is None
    merged: Any = {}
    if fast:
        for p in patches:
            if (
                (p.type or "merge") != "merge"
                or p.subresource != "status"
                or p.impersonation
            ):
                fast = False
                break
            data = p.data
            if (
                not isinstance(data, dict)
                or set(data) != {"status"}
                or not isinstance(data["status"], dict)
            ):
                fast = False
                break
            try:
                merged = _merge_templates(merged, data["status"])
            except _Incomposable:
                fast = False
                break
    return RenderPlan(
        merged if fast else None,
        calls,
        nxt.event is not None,
        cs.immediate_next_stage,
        fast,
        patch_plans,
    )
