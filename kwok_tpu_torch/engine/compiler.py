"""Stage-set compiler: Stage CRDs -> dense tensors for the device kernel.

This is the ahead-of-time counterpart of the reference's per-object
interpretation (reference: pkg/utils/lifecycle/lifecycle.go:194-267
NewStage, Match at lifecycle.go:125-191, Delay at lifecycle.go:313-341,
plus next.go:43-96 Patches). Three artifacts are produced:

1. **Predicates** — every selector becomes rows of (column, mask,
   negate) tests over the bitmask feature columns (features.py).
2. **Scalars** — static weights, delay/jitter milliseconds, delete
   flags, event ids, plus flags for the dynamic delay sources the zoo
   uses (deletionTimestamp deadlines). Per-object annotation overrides
   (weightFrom/durationFrom on `.metadata.annotations[...]`) become
   *override classes*: rows with identical annotation sets share a row
   in the override tables.
3. **Effects** — by *abstract FSM exploration*: for each distinct spec
   signature, a representative object is driven through the host
   lifecycle engine (the parity oracle); each (signature, stage)
   transition's rendered merge-patches are converted to feature-column
   SET/KEEP vectors via the merge-patch path-touch rule. Device
   transitions are therefore derived from the real host renderer, by
   construction.

Anything outside the compilable subset (jq expressions beyond kq,
non-merge patch types, weightFrom/durationFrom on non-annotation
non-deletionTimestamp sources, inconsistent effects across pre-states)
raises ``StageCompileError`` — the controller then routes that resource
class to the host slow path, mirroring how the reference keeps full
generality.

The fallback granularity is deliberately **per kind, not per stage**:
one exotic stage in a set demotes the whole kind to the host backend
(Controller._start_device_controller catches the error and returns
False).  Splitting a kind across backends would need two engines to
agree on weighted-choice PRNG streams and informer dedup for the same
rows — the parity cost outweighs the win, since stage sets are
per-kind artifacts anyway.  ``tests/test_device_backend.py::
test_exotic_stage_demotes_kind_to_host`` pins the behavior.
"""

from __future__ import annotations

import copy
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from kwok_tpu_torch.api.types import Stage
from kwok_tpu_torch.engine.features import (
    ALL_MASK,
    CompiledCondition,
    FeatureSchema,
    compile_selector,
)
from kwok_tpu_torch.engine.lifecycle import CompiledStage, Lifecycle, to_json_standard
from kwok_tpu_torch.utils.expression import parse_go_duration, parse_rfc3339
from kwok_tpu_torch.utils.kq import Query
from kwok_tpu_torch.utils.patch import apply_patch

SENTINEL = -(2**31)  # "no value" in override tables
IDLE = -1  # no current stage
NEVER = 2**31 - 1  # fire_at for idle rows

MODE_KEEP = 0
MODE_SET = 1

DELETION_TS_EXPR = ".metadata.deletionTimestamp"

# Deterministic env funcs for compile-time template rendering: only the
# *existence* and vocabulary-membership of rendered values reach the
# feature columns, so fixed strings are exact. Now/StartTime are pinned
# so exploration states are render-deterministic (the BFS would never
# terminate on self-loop stages otherwise).
COMPILE_ENV_FUNCS = {
    "NodeIP": lambda: "10.0.0.1",
    "NodeName": lambda: "node",
    "NodePort": lambda: 10250,
    "PodIP": lambda: "10.64.0.1",
    "NodeIPWith": lambda name: "10.0.0.1",
    "PodIPWith": lambda *a: "10.64.0.1",
    "Now": lambda: "2026-01-01T00:00:00.000000Z",
    "StartTime": lambda: "2026-01-01T00:00:00.000000Z",
}

# Safety bound on per-signature exploration (pathological template-
# driven state growth raises StageCompileError instead of spinning).
MAX_EXPLORED_STATES = 4096


class StageCompileError(ValueError):
    """Stage set is outside the device-compilable subset."""


@dataclass
class StageScalars:
    weight: int
    weight_from_annotation: Optional[str]
    duration_ms: int
    duration_from_annotation: Optional[str]
    duration_from_deletion_ts: bool
    has_jitter: bool
    jitter_ms: int
    jitter_from_annotation: Optional[str]
    jitter_from_deletion_ts: bool
    delete: bool
    event_id: int
    immediate: bool


def _annotation_key_of(expr: Optional[str]) -> Tuple[Optional[str], bool, bool]:
    """Classify an expressionFrom source: returns (annotation_key,
    is_deletion_ts, ok)."""
    if expr is None:
        return None, False, True
    if expr == DELETION_TS_EXPR:
        return None, True, True
    # the zoo's override convention: .metadata.annotations["..."]
    prefix = '.metadata.annotations["'
    if expr.startswith(prefix) and expr.endswith('"]'):
        return expr[len(prefix) : -2], False, True
    return None, False, False


class CompiledStageSet:
    """Dense-tensor form of one stage set (one resourceRef)."""

    def __init__(self, stages: List[Stage], max_conditions: int = 8):
        try:
            self.lifecycle = Lifecycle(stages)
        except Exception as e:  # kq compile errors etc. -> host fallback
            raise StageCompileError(f"lifecycle compile failed: {e}") from e
        self.compiled: List[CompiledStage] = self.lifecycle.stages
        self.schema = FeatureSchema()
        self.num_stages = len(self.compiled)
        if self.num_stages == 0:
            raise StageCompileError("no compilable stages (all selector-less?)")

        # --- predicates -----------------------------------------------------
        raw_stages = [s.raw for s in self.compiled]
        conds_per_stage: List[List[CompiledCondition]] = []
        for st in raw_stages:
            try:
                conds_per_stage.append(compile_selector(self.schema, st))
            except Exception as e:
                raise StageCompileError(f"selector of {st.name!r}: {e}") from e
        K = max(max((len(c) for c in conds_per_stage), default=1), 1)
        if K > max_conditions:
            raise StageCompileError(f"too many conditions per stage: {K}")
        S = self.num_stages
        self.cond_col = np.zeros((S, K), np.int32)
        self.cond_mask = np.zeros((S, K), np.int32)
        self.cond_neg = np.zeros((S, K), np.bool_)
        self.cond_valid = np.zeros((S, K), np.bool_)
        for i, conds in enumerate(conds_per_stage):
            for j, c in enumerate(conds):
                self.cond_col[i, j] = c.col
                self.cond_mask[i, j] = np.int32(c.mask & 0xFFFFFFFF) if c.mask < 2**31 else np.int32(c.mask - 2**32)
                self.cond_neg[i, j] = c.negate
                self.cond_valid[i, j] = True

        # --- scalars ---------------------------------------------------------
        self.events: List[Any] = []  # StageEvent objects (see below)
        self.scalars: List[StageScalars] = []
        for cs in self.compiled:
            st = cs.raw
            w_ann, w_dts, ok = _annotation_key_of(
                st.weight_from.expression_from if st.weight_from else None
            )
            if not ok or w_dts:
                raise StageCompileError(f"{st.name}: weightFrom source not compilable")
            d_ann = j_ann = None
            d_dts = j_dts = False
            duration_ms = 0
            jitter_ms = 0
            has_jitter = False
            if st.delay is not None:
                d = st.delay
                duration_ms = d.duration_milliseconds or 0
                d_ann, d_dts, ok = _annotation_key_of(
                    d.duration_from.expression_from if d.duration_from else None
                )
                if not ok:
                    raise StageCompileError(
                        f"{st.name}: durationFrom source not compilable"
                    )
                if d.jitter_duration_milliseconds is not None or d.jitter_duration_from is not None:
                    has_jitter = True
                    jitter_ms = (
                        d.jitter_duration_milliseconds
                        if d.jitter_duration_milliseconds is not None
                        else SENTINEL
                    )
                    j_ann, j_dts, ok = _annotation_key_of(
                        d.jitter_duration_from.expression_from
                        if d.jitter_duration_from
                        else None
                    )
                    if not ok:
                        raise StageCompileError(
                            f"{st.name}: jitterDurationFrom source not compilable"
                        )
            nxt = st.next
            event_id = -1
            if nxt is not None and nxt.event is not None:
                event_id = len(self.events)
                # the StageEvent object itself (attribute access —
                # Transition.event consumers read .type/.reason/.message)
                self.events.append(nxt.event)
            if nxt is not None:
                for p in nxt.patches:
                    if (p.type or "merge") != "merge":
                        raise StageCompileError(
                            f"{st.name}: patch type {p.type!r} not device-compilable"
                        )
            self.scalars.append(
                StageScalars(
                    weight=st.weight,
                    weight_from_annotation=w_ann,
                    duration_ms=duration_ms,
                    duration_from_annotation=d_ann,
                    duration_from_deletion_ts=d_dts,
                    has_jitter=has_jitter,
                    jitter_ms=jitter_ms,
                    jitter_from_annotation=j_ann,
                    jitter_from_deletion_ts=j_dts,
                    delete=bool(nxt.delete) if nxt else False,
                    event_id=event_id,
                    immediate=st.immediate_next_stage,
                )
            )

        self.w_static = np.array([s.weight for s in self.scalars], np.int32)
        self.d_static = np.array([s.duration_ms for s in self.scalars], np.int32)
        self.j_static = np.array(
            [s.jitter_ms if s.has_jitter else SENTINEL for s in self.scalars], np.int32
        )
        self.has_jitter = np.array([s.has_jitter for s in self.scalars], np.bool_)
        self.d_from_del_ts = np.array(
            [s.duration_from_deletion_ts for s in self.scalars], np.bool_
        )
        self.j_from_del_ts = np.array(
            [s.jitter_from_deletion_ts for s in self.scalars], np.bool_
        )
        self.stage_delete = np.array([s.delete for s in self.scalars], np.bool_)
        self.stage_event = np.array([s.event_id for s in self.scalars], np.int32)
        # consumed by the cluster/controller layer, not the tick kernel:
        # on-device rematch is always immediate; non-immediate stages wait
        # for the store round-trip before external visibility.
        self.stage_immediate = np.array([s.immediate for s in self.scalars], np.bool_)

        # --- signatures / effects / override classes -------------------------
        self.C = self.schema.num_columns
        self._sig_ids: Dict[str, int] = {}
        self._sig_effects: List[np.ndarray] = []  # per sig: [S, C] mode
        self._sig_effect_vals: List[np.ndarray] = []  # per sig: [S, C] val
        self._sig_effect_known: List[np.ndarray] = []  # per sig: [S] bool
        # column-wise effect-merge evidence across explored pre-states
        # (a stage lowers iff every column is keep-consistent OR
        # set-consistent — e.g. "add finalizer" is keep from a state
        # that already has it and set(1) from one that doesn't, which
        # merges to set(1)):
        self._sig_keep_ok: List[np.ndarray] = []  # per sig: [S, C] bool
        self._sig_set_ok: List[np.ndarray] = []  # per sig: [S, C] bool
        self._sig_set_val: List[np.ndarray] = []  # per sig: [S, C] int32
        self._ov_ids: Dict[str, int] = {}
        self._ov_rows: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        # per-sig set of exploration-state keys already explored (BFS cache)
        self._explored: Dict[int, set] = {}

        # Template-read analysis: the object paths stage templates read
        # beyond spec/labels/annotations (which are in the signature key).
        # Exploration states are keyed on (features, projection of these
        # paths), so objects that would render differently explore
        # separately and pre-state-dependent effects are detected.
        # metadata name/namespace/uid are excluded: they only feed env
        # funcs (NodeIPWith/PodIPWith) whose values never reach feature
        # columns — selectors on IP *values* are outside the subset.
        self._read_paths: List[Tuple[str, ...]] = []
        seen_paths = set()
        from kwok_tpu_torch.utils.gotpl import Template, template_read_paths

        for cs in self.compiled:
            if cs.next is None:
                continue
            for p in cs.next.patches:
                for path in template_read_paths(Template(p.template)):
                    if not path or path[0] not in ("status", "metadata"):
                        continue
                    if path[:2] in (
                        ("metadata", "name"),
                        ("metadata", "namespace"),
                        ("metadata", "uid"),
                        ("metadata", "labels"),
                        ("metadata", "annotations"),
                    ):
                        continue
                    if path not in seen_paths:
                        seen_paths.add(path)
                        self._read_paths.append(path)
        # bumped whenever signatures/effects/override classes grow, so the
        # simulator knows to re-upload TickParams
        self.version = 0

    # -- signature handling ----------------------------------------------------

    def _signature_key(self, obj: dict) -> str:
        meta = obj.get("metadata") or {}
        key = {
            "spec": obj.get("spec"),
            "labels": meta.get("labels"),
            "annotations": meta.get("annotations"),
            "ownerReferences": meta.get("ownerReferences"),
        }
        return hashlib.sha1(
            json.dumps(key, sort_keys=True, default=str).encode()
        ).hexdigest()

    def signature_for(self, obj: dict) -> int:
        """Signature id for an object, exploring its FSM on first sight."""
        obj = to_json_standard(obj)
        key = self._signature_key(obj)
        sig = self._sig_ids.get(key)
        if sig is None:
            sig = len(self._sig_effects)
            self._sig_ids[key] = sig
            self._sig_effects.append(np.zeros((self.num_stages, self.C), np.int32))
            self._sig_effect_vals.append(np.zeros((self.num_stages, self.C), np.int32))
            self._sig_effect_known.append(np.zeros(self.num_stages, np.bool_))
            self._sig_keep_ok.append(np.ones((self.num_stages, self.C), np.bool_))
            self._sig_set_ok.append(np.ones((self.num_stages, self.C), np.bool_))
            self._sig_set_val.append(np.zeros((self.num_stages, self.C), np.int32))
            self.version += 1
        self._explore(sig, obj)
        return sig

    def override_class_for(self, obj: dict) -> int:
        """Override-class id: rows sharing annotation-derived weight/delay
        overrides share a row in the override tables."""
        meta = obj.get("metadata") or {}
        ann = meta.get("annotations") or {}
        S = self.num_stages
        w = np.full(S, SENTINEL, np.int32)
        d = np.full(S, SENTINEL, np.int32)
        j = np.full(S, SENTINEL, np.int32)
        for i, sc in enumerate(self.scalars):
            if sc.weight_from_annotation and sc.weight_from_annotation in ann:
                v = _parse_int(ann[sc.weight_from_annotation])
                if v is not None:
                    w[i] = v
            if sc.duration_from_annotation and sc.duration_from_annotation in ann:
                ms = _parse_duration_ms(ann[sc.duration_from_annotation])
                if ms is not None:
                    d[i] = ms
            if sc.jitter_from_annotation and sc.jitter_from_annotation in ann:
                ms = _parse_duration_ms(ann[sc.jitter_from_annotation])
                if ms is not None:
                    j[i] = ms
        key = (w.tobytes(), d.tobytes(), j.tobytes())
        skey = hashlib.sha1(b"|".join(key)).hexdigest()
        ovc = self._ov_ids.get(skey)
        if ovc is None:
            ovc = len(self._ov_rows)
            self._ov_ids[skey] = ovc
            self._ov_rows.append((w, d, j))
            self.version += 1
        return ovc

    # -- abstract FSM exploration -----------------------------------------------

    def state_projection(self, obj: dict) -> str:
        """Hash of the template-read path values (see _read_paths)."""
        if not self._read_paths:
            return ""
        proj = []
        for path in self._read_paths:
            cur: Any = obj
            for seg in path:
                if isinstance(cur, dict):
                    cur = cur.get(seg)
                else:
                    cur = None
                    break
            proj.append(cur)
        return hashlib.sha1(
            json.dumps(proj, sort_keys=True, default=str).encode()
        ).hexdigest()

    def _state_key(self, obj: dict) -> Tuple:
        return (
            tuple(self.schema.extract_row(obj)),
            self.state_projection(obj),
        )

    def _explore(self, sig: int, start_obj: dict) -> None:
        """BFS over FSM states reachable from start_obj, recording each
        (stage -> feature effect) discovered along the way. States are
        keyed on (feature row, template-read projection): objects whose
        templates would render differently explore separately, and the
        per-(sig, stage) consistency assertion turns pre-state-dependent
        effects into StageCompileError. The seen-set is cached per
        signature, so admitting many identical objects explores once."""
        seen = self._explored.setdefault(sig, set())
        if self._state_key(start_obj) in seen:
            return
        worklist = [copy.deepcopy(start_obj)]
        while worklist:
            obj = worklist.pop()
            fkey = self._state_key(obj)
            if fkey in seen:
                continue
            if len(seen) >= MAX_EXPLORED_STATES:
                raise StageCompileError(
                    "FSM exploration exceeded "
                    f"{MAX_EXPLORED_STATES} states; stage set not "
                    "device-compilable"
                )
            seen.add(fkey)
            meta = obj.get("metadata") or {}
            matched = self.lifecycle.match(
                meta.get("labels") or {}, meta.get("annotations") or {}, obj
            )
            pre_row = np.array(self.schema.extract_row(obj), np.int32)
            for cs in matched:
                idx = self.compiled.index(cs)
                new_obj, mode, val, deleted = self._apply_stage(obj, cs)
                post = np.where(mode == MODE_SET, val, pre_row)
                known = self._sig_effect_known[sig]
                keep_ok = self._sig_keep_ok[sig][idx]
                set_ok = self._sig_set_ok[sig][idx]
                if not known[idx]:
                    keep_ok[:] = post == pre_row
                    set_ok[:] = True
                    self._sig_set_val[sig][idx] = post
                    known[idx] = True
                else:
                    keep_ok &= post == pre_row
                    set_ok &= post == self._sig_set_val[sig][idx]
                    if not np.all(keep_ok | set_ok):
                        bad = [
                            self.schema.columns[c].key
                            for c in np.nonzero(~(keep_ok | set_ok))[0]
                        ]
                        raise StageCompileError(
                            f"stage {cs.name!r}: effect depends on pre-state "
                            f"(columns {bad}); not device-compilable"
                        )
                # lowering: keep where keep-consistent, else set to the
                # (proven-common) post value
                new_mode = np.where(keep_ok, MODE_KEEP, MODE_SET).astype(np.int32)
                new_val = np.where(
                    new_mode == MODE_SET, self._sig_set_val[sig][idx], 0
                ).astype(np.int32)
                if not (
                    np.array_equal(new_mode, self._sig_effects[sig][idx])
                    and np.array_equal(new_val, self._sig_effect_vals[sig][idx])
                ):
                    self._sig_effects[sig][idx] = new_mode
                    self._sig_effect_vals[sig][idx] = new_val
                    self.version += 1
                if not deleted:
                    worklist.append(new_obj)

    def _apply_stage(self, obj: dict, cs: CompiledStage):
        """Host-render one stage against obj; return (new_obj, mode[C],
        val[C], deleted)."""
        obj = copy.deepcopy(obj)
        effects = self.lifecycle.effects(cs)
        touched_prefixes: List[Tuple[str, ...]] = []
        if effects is None:
            return obj, np.zeros(self.C, np.int32), np.zeros(self.C, np.int32), False

        meta = obj.get("metadata") or {}
        fin = effects.finalizers_patch(meta.get("finalizers") or [])
        if fin is not None:
            obj = apply_patch(obj, fin.data, fin.type)
            touched_prefixes.append(("metadata", "finalizers"))

        if effects.delete:
            mode = np.zeros(self.C, np.int32)
            val = np.zeros(self.C, np.int32)
            return obj, mode, val, True

        for p in effects.patches(obj, COMPILE_ENV_FUNCS):
            obj = apply_patch(obj, p.data, p.type)
            touched_prefixes.extend(_patch_prefix_paths(p.data))

        mode = np.zeros(self.C, np.int32)
        val = np.zeros(self.C, np.int32)
        new_row = self.schema.extract_row(obj)
        for ci, col in enumerate(self.schema.columns):
            if _is_touched(col.path_prefix, touched_prefixes):
                mode[ci] = MODE_SET
                val[ci] = new_row[ci]
        return obj, mode, val, False

    # -- dense tables -----------------------------------------------------------

    def effect_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """Stacked effect tensors [SIG, S, C] (mode, value)."""
        if not self._sig_effects:
            return (
                np.zeros((1, self.num_stages, self.C), np.int32),
                np.zeros((1, self.num_stages, self.C), np.int32),
            )
        return np.stack(self._sig_effects), np.stack(self._sig_effect_vals)

    def override_tables(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stacked override tensors [OVC, S] (weight, duration, jitter)."""
        if not self._ov_rows:
            z = np.full((1, self.num_stages), SENTINEL, np.int32)
            return z, z.copy(), z.copy()
        w = np.stack([r[0] for r in self._ov_rows])
        d = np.stack([r[1] for r in self._ov_rows])
        j = np.stack([r[2] for r in self._ov_rows])
        return w, d, j

    def extract_features(self, obj: dict) -> np.ndarray:
        return np.array(self.schema.extract_row(to_json_standard(obj)), np.int32)

    def deletion_ts_ms(self, obj: dict, epoch) -> int:
        """deletionTimestamp as virtual ms (SENTINEL when absent)."""
        meta = obj.get("metadata") or {}
        ts = meta.get("deletionTimestamp")
        if not ts:
            return SENTINEL
        t = parse_rfc3339(ts) if isinstance(ts, str) else ts
        if t is None:
            return SENTINEL
        return int((t - epoch).total_seconds() * 1000)


def _parse_int(s: str) -> Optional[int]:
    try:
        return int(str(s), 0)
    except ValueError:
        return None


def _parse_duration_ms(s: str) -> Optional[int]:
    sec = parse_go_duration(str(s))
    if sec is None:
        return None
    return int(sec * 1000)


def _patch_prefix_paths(data: Any, base: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    """All dict paths a merge patch writes (leaves and replaced subtrees)."""
    if not isinstance(data, dict):
        return [base]
    out: List[Tuple[str, ...]] = []
    for k, v in data.items():
        out.extend(_patch_prefix_paths(v, base + (str(k),)))
    return out


def _is_touched(col_prefix: Tuple[str, ...], touched: List[Tuple[str, ...]]) -> bool:
    """Does any written path overlap the column's read path?
    Overlap = one is a prefix of the other."""
    if not col_prefix:
        return bool(touched)
    for t in touched:
        n = min(len(t), len(col_prefix))
        if t[:n] == col_prefix[:n]:
            return True
    return False
