"""Host (CPU) Stage lifecycle engine — the reference backend and parity
oracle for the device kernel.

Semantics mirror reference pkg/utils/lifecycle/lifecycle.go:

- ``CompiledStage`` (NewStage:194-267): stages without a selector are
  dropped; matchLabels/matchAnnotations are exact set-selectors; jq
  matchExpressions compile to Requirements; the weight getter always
  has a static fallback (default 0); the delay getter exists only if a
  delay block does, with static duration defaulting to 0ms; the jitter
  getter exists only if either jitter field does.
- ``Lifecycle.match`` (:51-63): all stages whose selectors match.
- ``Lifecycle.select`` (Match:125-191): the weighted-random fallback
  ladder — all-error -> uniform(all); total==0 & no errors ->
  uniform(all); total==0 & some errors -> uniform(non-error);
  else weighted among weight>0.
- ``Lifecycle.list_all_possible`` (:66-122): same ladder without
  randomness, returning the candidate set.
- ``Stage.delay`` (:313-341): duration then jitter; jitter < duration
  returns jitter; else uniform in [duration, jitter).
- ``Next`` effects (next.go:31-96, finalizers.go:32-116).
"""

from __future__ import annotations

import datetime
import json
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from kwok_tpu_torch.api.types import Stage, StageNext
from kwok_tpu_torch.utils.expression import DurationGetter, IntGetter, Requirement
from kwok_tpu_torch.utils.gotpl import Renderer
from kwok_tpu_torch.utils.patch import wrap_json_patch_with_root, wrap_with_root

PATCH_TYPE_CONTENT = {
    "json": "application/json-patch+json",
    "merge": "application/merge-patch+json",
    "strategic": "application/strategic-merge-patch+json",
}


@dataclass
class Patch:
    """A materialized patch (reference next.go Patch struct)."""

    data: Any
    type: str  # json | merge | strategic
    subresource: str = ""
    impersonation: Optional[str] = None

    @property
    def content_type(self) -> str:
        return PATCH_TYPE_CONTENT[self.type]


class CompiledStage:
    """One compiled stage (reference lifecycle.go Stage struct:270-283)."""

    def __init__(self, stage: Stage):
        self.name = stage.name
        self.raw = stage
        sel = stage.selector
        assert sel is not None
        self.match_labels: Optional[Dict[str, str]] = (
            dict(sel.match_labels) if sel.match_labels else None
        )
        self.match_annotations: Optional[Dict[str, str]] = (
            dict(sel.match_annotations) if sel.match_annotations else None
        )
        self.requirements: List[Requirement] = [
            Requirement(e.key, e.operator, e.values) for e in sel.match_expressions
        ]
        self.next: Optional[StageNext] = stage.next
        self.immediate_next_stage = stage.immediate_next_stage

        self.weight_getter = IntGetter(
            stage.weight, stage.weight_from.expression_from if stage.weight_from else None
        )

        self.duration_getter: Optional[DurationGetter] = None
        self.jitter_getter: Optional[DurationGetter] = None
        if stage.delay is not None:
            d = stage.delay
            static = (d.duration_milliseconds or 0) / 1000.0
            self.duration_getter = DurationGetter(
                static, d.duration_from.expression_from if d.duration_from else None
            )
            if d.jitter_duration_milliseconds is not None or d.jitter_duration_from is not None:
                jitter_static = (
                    d.jitter_duration_milliseconds / 1000.0
                    if d.jitter_duration_milliseconds is not None
                    else None
                )
                self.jitter_getter = DurationGetter(
                    jitter_static,
                    d.jitter_duration_from.expression_from if d.jitter_duration_from else None,
                )

    def match(self, labels: Dict[str, str], annotations: Dict[str, str], data: Any) -> bool:
        if self.match_labels is not None:
            for k, v in self.match_labels.items():
                if labels.get(k) != v:
                    return False
        if self.match_annotations is not None:
            for k, v in self.match_annotations.items():
                if annotations.get(k) != v:
                    return False
        for req in self.requirements:
            if not req.matches(data):
                return False
        return True

    def weight(self, data: Any) -> Tuple[int, bool]:
        return self.weight_getter.get(to_json_standard(data))

    def delay(
        self,
        data: Any,
        now: datetime.datetime,
        rng: Optional[random.Random] = None,
    ) -> Tuple[float, bool]:
        """Delay seconds for this transition (lifecycle.go:313-341)."""
        if self.duration_getter is None:
            return 0.0, False
        data = to_json_standard(data)
        duration, ok = self.duration_getter.get(data, now)
        if not ok:
            return 0.0, False
        if self.jitter_getter is None:
            return duration, True
        jitter, ok = self.jitter_getter.get(data, now)
        if not ok:
            return duration, True
        if jitter < duration:
            return jitter, True
        if jitter > duration:
            r = rng.random() if rng is not None else random.random()
            duration += r * (jitter - duration)
        return duration, True


class NextEffects:
    """Materializes a stage's effects (reference next.go:31-96)."""

    def __init__(self, nxt: StageNext, renderer: Renderer):
        self.next = nxt
        self.renderer = renderer

    def finalizers_patch(self, meta_finalizers: List[str]) -> Optional[Patch]:
        """Finalizer add/remove/empty as RFC6902 ops (finalizers.go:32-116)."""
        if self.next.finalizers is None:
            return None
        f = self.next.finalizers
        ops = _finalizers_modify(meta_finalizers, f)
        if not ops:
            return None
        return Patch(data=ops, type="json")

    @property
    def event(self):
        return self.next.event

    @property
    def delete(self) -> bool:
        return self.next.delete

    def patches(self, resource: Any, extra_funcs: Optional[Dict[str, Callable]] = None) -> List[Patch]:
        out: List[Patch] = []
        for p in self.next.patches:
            ptype = p.type or "merge"
            if ptype == "json":
                data = self.renderer.render_to_json(p.template, resource, extra_funcs)
                data = wrap_json_patch_with_root(p.root, data or [])
            else:
                data = self.renderer.render_to_json(p.template, resource, extra_funcs)
                data = wrap_with_root(p.root, data)
            out.append(
                Patch(
                    data=data,
                    type=ptype,
                    subresource=p.subresource,
                    impersonation=p.impersonation.username if p.impersonation else None,
                )
            )
        return out


def _finalizers_modify(meta_finalizers: List[str], f) -> List[Dict[str, Any]]:
    is_empty = False
    ops: List[Dict[str, Any]] = []
    remove_values = [i.value for i in f.remove]
    add_values = [i.value for i in f.add]
    if f.empty:
        is_empty = True
    elif remove_values:
        removed = []
        for i in range(len(meta_finalizers) - 1, -1, -1):
            if meta_finalizers[i] in remove_values:
                removed.append({"op": "remove", "path": f"/metadata/finalizers/{i}"})
        if len(removed) == len(meta_finalizers):
            is_empty = True
        else:
            ops.extend(removed)

    if not is_empty:
        if add_values:
            ops.extend(_finalizers_add(meta_finalizers, add_values))
    else:
        if meta_finalizers:
            ops.append({"op": "remove", "path": "/metadata/finalizers"})
        if add_values:
            ops.extend(_finalizers_add([], add_values))
    return ops


def _finalizers_add(meta_finalizers: List[str], values: List[str]) -> List[Dict[str, Any]]:
    ops: List[Dict[str, Any]] = []
    if meta_finalizers:
        for v in values:
            if v in meta_finalizers:
                continue
            ops.append({"op": "add", "path": "/metadata/finalizers/-", "value": v})
    else:
        ops.append({"op": "add", "path": "/metadata/finalizers", "value": list(values)})
    return ops


class Lifecycle:
    """An ordered, compiled stage list (reference lifecycle.go:33-63)."""

    def __init__(self, stages: List[Stage], renderer: Optional[Renderer] = None):
        self.stages: List[CompiledStage] = []
        for s in stages:
            if s.selector is None:
                continue  # NewStage returns nil for selector-less stages
            self.stages.append(CompiledStage(s))
        self.renderer = renderer or Renderer()

    def match(
        self, labels: Dict[str, str], annotations: Dict[str, str], data: Any
    ) -> List[CompiledStage]:
        data = to_json_standard(data)
        return self._match_std(labels, annotations, data)

    def _match_std(
        self, labels: Dict[str, str], annotations: Dict[str, str], data: Any
    ) -> List[CompiledStage]:
        """match() over already-standardized data (internal fast path)."""
        return [s for s in self.stages if s.match(labels, annotations, data)]

    def select(
        self,
        labels: Dict[str, str],
        annotations: Dict[str, str],
        data: Any,
        rng: Optional[random.Random] = None,
    ) -> Optional[CompiledStage]:
        """Weighted-random choice with the reference fallback ladder
        (lifecycle.go:125-191)."""
        rng = rng or random
        data = to_json_standard(data)
        stages = self._match_std(labels, annotations, data)
        if not stages:
            return None
        if len(stages) == 1:
            return stages[0]

        weights: List[int] = []
        total = 0
        count_error = 0
        for s in stages:
            w, ok = s.weight_getter.get(data)
            if ok:
                total += w
                weights.append(w)
            else:
                weights.append(-1)
                count_error += 1

        if count_error == len(stages):
            return stages[rng.randrange(len(stages))]

        if total == 0:
            if count_error == 0:
                return stages[rng.randrange(len(stages))]
            with_weights = [s for i, s in enumerate(stages) if weights[i] >= 0]
            return with_weights[rng.randrange(len(with_weights))]

        off = rng.randrange(total)
        for i, s in enumerate(stages):
            if weights[i] <= 0:
                continue
            off -= weights[i]
            if off < 0:
                return s
        return stages[-1]

    def list_all_possible(
        self, labels: Dict[str, str], annotations: Dict[str, str], data: Any
    ) -> List[CompiledStage]:
        """Deterministic candidate set (lifecycle.go:66-122)."""
        data = to_json_standard(data)
        stages = self._match_std(labels, annotations, data)
        if len(stages) <= 1:
            return stages

        weights: List[int] = []
        total = 0
        count_error = 0
        for s in stages:
            w, ok = s.weight_getter.get(data)
            if ok:
                total += w
                weights.append(w)
            else:
                weights.append(-1)
                count_error += 1

        if count_error == len(stages):
            return stages
        if total == 0:
            if count_error == 0:
                return stages
            return [s for i, s in enumerate(stages) if weights[i] >= 0]
        return [s for i, s in enumerate(stages) if weights[i] > 0]

    def effects(self, stage: CompiledStage) -> Optional[NextEffects]:
        if stage.next is None:
            return None
        return NextEffects(stage.next, self.renderer)


def to_json_standard(obj: Any) -> Any:
    """Normalize to JSON-standard types (reference query.go:72-88
    ToJSONStandard): datetimes (from YAML timestamp parsing) become
    RFC3339 strings. Returns the original object unchanged (no copy)
    when it is already JSON-standard."""
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, datetime.datetime):
        if obj.tzinfo is None:
            obj = obj.replace(tzinfo=datetime.timezone.utc)
        return obj.isoformat().replace("+00:00", "Z")
    if isinstance(obj, datetime.date):
        return obj.isoformat()
    if isinstance(obj, dict):
        out = None
        for k, v in obj.items():
            nv = to_json_standard(v)
            if nv is not v and out is None:
                out = dict(obj)
            if out is not None:
                out[k] = nv
        return out if out is not None else obj
    if isinstance(obj, (list, tuple)):
        out_l = None
        for i, v in enumerate(obj):
            nv = to_json_standard(v)
            if nv is not v and out_l is None:
                out_l = list(obj)
            if out_l is not None:
                out_l[i] = nv
        if out_l is not None:
            return out_l
        return list(obj) if isinstance(obj, tuple) else obj
    return json.loads(json.dumps(obj, default=str))
