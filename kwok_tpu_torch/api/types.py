"""Stage CRD API types (kwok.x-k8s.io/v1alpha1-compatible).

Dataclass mirror of the reference API surface
(reference: pkg/apis/v1alpha1/stage_types.go:37-271), with YAML/dict
round-trip. These are the *internal* (hub) types: the deprecated
v1alpha1 `statusTemplate`/`statusSubresource`/`statusPatchAs` fields are
folded into `patches` on load, exactly like the reference conversion
(reference: pkg/apis/internalversion/conversion.go:394-425).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

API_VERSION = "kwok.x-k8s.io/v1alpha1"

PATCH_TYPE_JSON = "json"
PATCH_TYPE_MERGE = "merge"
PATCH_TYPE_STRATEGIC = "strategic"


@dataclass
class ResourceRef:
    """Which resource kind a Stage applies to (stage_types.go:70-78)."""

    api_group: str
    kind: str

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ResourceRef":
        return cls(api_group=d.get("apiGroup", "v1"), kind=d["kind"])

    def to_dict(self) -> Dict[str, Any]:
        return {"apiGroup": self.api_group, "kind": self.kind}


@dataclass
class SelectorRequirement:
    """One jq matchExpression (stage_types.go:106-121)."""

    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist
    values: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SelectorRequirement":
        return cls(
            key=d["key"],
            operator=d["operator"],
            values=[str(v) for v in d.get("values") or []],
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"key": self.key, "operator": self.operator}
        if self.values:
            out["values"] = list(self.values)
        return out


@dataclass
class StageSelector:
    """Label/annotation/jq selection (stage_types.go:88-104)."""

    match_labels: Dict[str, str] = field(default_factory=dict)
    match_annotations: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[SelectorRequirement] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["StageSelector"]:
        if d is None:
            return None
        return cls(
            match_labels=dict(d.get("matchLabels") or {}),
            match_annotations=dict(d.get("matchAnnotations") or {}),
            match_expressions=[
                SelectorRequirement.from_dict(e) for e in d.get("matchExpressions") or []
            ],
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.match_labels:
            out["matchLabels"] = dict(self.match_labels)
        if self.match_annotations:
            out["matchAnnotations"] = dict(self.match_annotations)
        if self.match_expressions:
            out["matchExpressions"] = [e.to_dict() for e in self.match_expressions]
        return out


@dataclass
class ExpressionFrom:
    """An expression-backed value source (stage_types.go:130-150)."""

    expression_from: str

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["ExpressionFrom"]:
        if d is None:
            return None
        return cls(expression_from=d["expressionFrom"])

    def to_dict(self) -> Dict[str, Any]:
        return {"expressionFrom": self.expression_from}


@dataclass
class StageDelay:
    """Transition delay with optional jitter / per-object overrides
    (stage_types.go:123-151)."""

    duration_milliseconds: Optional[int] = None
    duration_from: Optional[ExpressionFrom] = None
    jitter_duration_milliseconds: Optional[int] = None
    jitter_duration_from: Optional[ExpressionFrom] = None

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["StageDelay"]:
        if d is None:
            return None
        return cls(
            duration_milliseconds=d.get("durationMilliseconds"),
            duration_from=ExpressionFrom.from_dict(d.get("durationFrom")),
            jitter_duration_milliseconds=d.get("jitterDurationMilliseconds"),
            jitter_duration_from=ExpressionFrom.from_dict(d.get("jitterDurationFrom")),
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.duration_milliseconds is not None:
            out["durationMilliseconds"] = self.duration_milliseconds
        if self.duration_from is not None:
            out["durationFrom"] = self.duration_from.to_dict()
        if self.jitter_duration_milliseconds is not None:
            out["jitterDurationMilliseconds"] = self.jitter_duration_milliseconds
        if self.jitter_duration_from is not None:
            out["jitterDurationFrom"] = self.jitter_duration_from.to_dict()
        return out


@dataclass
class StageEvent:
    """Event emitted when the stage fires (stage_types.go:216-227)."""

    type: str = ""
    reason: str = ""
    message: str = ""

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["StageEvent"]:
        if d is None:
            return None
        return cls(
            type=d.get("type", ""),
            reason=d.get("reason", ""),
            message=d.get("message", ""),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {"type": self.type, "reason": self.reason, "message": self.message}


@dataclass
class FinalizerItem:
    value: str

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FinalizerItem":
        return cls(value=d["value"])

    def to_dict(self) -> Dict[str, Any]:
        return {"value": self.value}


@dataclass
class StageFinalizers:
    """Finalizer add/remove/empty ops (stage_types.go:229-243)."""

    add: List[FinalizerItem] = field(default_factory=list)
    remove: List[FinalizerItem] = field(default_factory=list)
    empty: bool = False

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["StageFinalizers"]:
        if d is None:
            return None
        return cls(
            add=[FinalizerItem.from_dict(i) for i in d.get("add") or []],
            remove=[FinalizerItem.from_dict(i) for i in d.get("remove") or []],
            empty=bool(d.get("empty", False)),
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.add:
            out["add"] = [i.to_dict() for i in self.add]
        if self.remove:
            out["remove"] = [i.to_dict() for i in self.remove]
        if self.empty:
            out["empty"] = True
        return out


@dataclass
class ImpersonationConfig:
    username: str

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["ImpersonationConfig"]:
        if d is None:
            return None
        return cls(username=d["username"])

    def to_dict(self) -> Dict[str, Any]:
        return {"username": self.username}


@dataclass
class StagePatch:
    """One templated patch (stage_types.go:180-214)."""

    subresource: str = ""
    root: str = ""
    template: str = ""
    type: Optional[str] = None  # json | merge | strategic; None -> merge
    impersonation: Optional[ImpersonationConfig] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StagePatch":
        return cls(
            subresource=d.get("subresource", ""),
            root=d.get("root", ""),
            template=d.get("template", ""),
            type=d.get("type"),
            impersonation=ImpersonationConfig.from_dict(d.get("impersonation")),
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.subresource:
            out["subresource"] = self.subresource
        if self.root:
            out["root"] = self.root
        if self.template:
            out["template"] = self.template
        if self.type is not None:
            out["type"] = self.type
        if self.impersonation is not None:
            out["impersonation"] = self.impersonation.to_dict()
        return out


@dataclass
class StageNext:
    """Stage effects (stage_types.go:153-178), with the deprecated
    statusTemplate fields folded into patches (conversion.go:394-425)."""

    event: Optional[StageEvent] = None
    finalizers: Optional[StageFinalizers] = None
    delete: bool = False
    patches: List[StagePatch] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["StageNext"]:
        if d is None:
            return None
        patches = [StagePatch.from_dict(p) for p in d.get("patches") or []]
        status_template = d.get("statusTemplate", "")
        if status_template and not patches:
            impersonation = None
            patch_as = d.get("statusPatchAs")
            if patch_as is not None:
                impersonation = ImpersonationConfig.from_dict(patch_as)
            patches = [
                StagePatch(
                    subresource=d.get("statusSubresource") or "status",
                    root="status",
                    template=status_template,
                    impersonation=impersonation,
                )
            ]
        return cls(
            event=StageEvent.from_dict(d.get("event")),
            finalizers=StageFinalizers.from_dict(d.get("finalizers")),
            delete=bool(d.get("delete", False)),
            patches=patches,
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.event is not None:
            out["event"] = self.event.to_dict()
        if self.finalizers is not None:
            out["finalizers"] = self.finalizers.to_dict()
        if self.delete:
            out["delete"] = True
        if self.patches:
            out["patches"] = [p.to_dict() for p in self.patches]
        return out


@dataclass
class Stage:
    """A single lifecycle stage (stage_types.go:37-68)."""

    name: str
    resource_ref: ResourceRef
    selector: Optional[StageSelector] = None
    weight: int = 0
    weight_from: Optional[ExpressionFrom] = None
    delay: Optional[StageDelay] = None
    next: Optional[StageNext] = None
    immediate_next_stage: bool = False

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "Stage":
        """Parse a full Stage manifest (apiVersion/kind/metadata/spec)."""
        if "spec" in doc:
            meta = doc.get("metadata") or {}
            name = meta.get("name", "")
            spec = doc["spec"]
        else:  # bare spec with a name
            name = doc.get("name", "")
            spec = doc
        return cls(
            name=name,
            resource_ref=ResourceRef.from_dict(spec["resourceRef"]),
            selector=StageSelector.from_dict(spec.get("selector")),
            weight=int(spec.get("weight", 0)),
            weight_from=ExpressionFrom.from_dict(spec.get("weightFrom")),
            delay=StageDelay.from_dict(spec.get("delay")),
            next=StageNext.from_dict(spec.get("next")),
            immediate_next_stage=bool(spec.get("immediateNextStage", False)),
        )

    def to_dict(self) -> Dict[str, Any]:
        spec: Dict[str, Any] = {"resourceRef": self.resource_ref.to_dict()}
        if self.selector is not None:
            spec["selector"] = self.selector.to_dict()
        if self.weight:
            spec["weight"] = self.weight
        if self.weight_from is not None:
            spec["weightFrom"] = self.weight_from.to_dict()
        if self.delay is not None:
            spec["delay"] = self.delay.to_dict()
        if self.next is not None:
            spec["next"] = self.next.to_dict()
        if self.immediate_next_stage:
            spec["immediateNextStage"] = True
        return {
            "apiVersion": API_VERSION,
            "kind": "Stage",
            "metadata": {"name": self.name},
            "spec": spec,
        }
