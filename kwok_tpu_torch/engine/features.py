"""Feature schema: selector expressions -> dense int32 bitmask columns.

The device kernel cannot run jq over JSON, so the stage compiler maps
every distinct selector matchExpression key (plus matchLabels /
matchAnnotations pairs) in a stage set to one int32 *bitmask column*:

- bit 0: the expression produced at least one output NOT in the
  column's value vocabulary ("other");
- bits 1..30: one bit per vocabulary value (the union of all selector
  values mentioned for that key across the stage set).

With that encoding every reference selector operator
(reference: pkg/utils/expression/selector.go:60-120) becomes a single
masked test on the column value F:

- In(vals)       -> (F & mask(vals)) != 0
- NotIn(vals)    -> (F & mask(vals)) == 0
- Exists         -> F != 0
- DoesNotExist   -> F == 0

i.e. uniformly ``((F & mask) != 0) ^ negate`` with mask=0xFFFFFFFF for
the existence operators.

Host-side extraction runs the real kq query per column (exact parity
with the host engine); on-device, stage effects update columns via the
compiler's abstract-FSM exploration (see compiler.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from kwok_tpu_torch.api.types import Stage
from kwok_tpu_torch.utils.expression import value_as_string
from kwok_tpu_torch.utils.kq import Field as KqField
from kwok_tpu_torch.utils.kq import Iterate, Path, Pipe, Query

OTHER_BIT = 1  # bit 0
MAX_VOCAB = 30

# Mask covering "any output at all" for Exists/DoesNotExist tests.
ALL_MASK = 0xFFFFFFFF


@dataclass
class FeatureColumn:
    """One selector key -> one int32 bitmask column."""

    key: str  # canonical expression source ("label:app=..." for labels)
    query: Optional[Query]  # None for label/annotation columns
    label_key: Optional[str] = None  # matchLabels column
    annotation_key: Optional[str] = None  # matchAnnotations column
    vocab: Dict[str, int] = field(default_factory=dict)  # value -> bit index (>=1)
    path_prefix: Tuple[str, ...] = ()  # dict path read by the query

    def vocab_bit(self, value: str) -> int:
        """Bit for a vocabulary value, allocating if new."""
        if value not in self.vocab:
            if len(self.vocab) >= MAX_VOCAB:
                raise ValueError(
                    f"selector value vocabulary overflow on column {self.key!r}"
                )
            self.vocab[value] = 1 + len(self.vocab)
        return self.vocab[value]

    def mask_for(self, values: Sequence[str]) -> int:
        m = 0
        for v in values:
            m |= 1 << self.vocab_bit(v)
        return m

    def extract(self, obj: Any, labels: Dict[str, str], annotations: Dict[str, str]) -> int:
        """Host-side: evaluate this column's bitmask for one object."""
        if self.label_key is not None:
            v = labels.get(self.label_key)
            outputs = [] if v is None else [v]
        elif self.annotation_key is not None:
            v = annotations.get(self.annotation_key)
            outputs = [] if v is None else [v]
        else:
            out = self.query.execute(obj)
            outputs = out or []
        bits = 0
        for o in outputs:
            s = value_as_string(o)
            if s is not None and s in self.vocab:
                bits |= 1 << self.vocab[s]
            else:
                bits |= OTHER_BIT
        return bits


def query_path_prefix(src: str) -> Tuple[str, ...]:
    """The dict path a query reads, up to the first iterate/filter —
    used by the compiler's merge-patch touch rule."""
    q = Query(src)
    ast = q._ast
    node = ast
    if isinstance(node, Pipe):
        node = node.stages[0]
    if not isinstance(node, Path):
        return ()
    prefix: List[str] = []
    for op in node.ops:
        if isinstance(op, KqField):
            prefix.append(op.name)
        elif isinstance(op, Iterate):
            break
        else:  # pragma: no cover
            break
    return tuple(prefix)


class FeatureSchema:
    """Column registry for one compiled stage set."""

    def __init__(self) -> None:
        self.columns: List[FeatureColumn] = []
        self._by_key: Dict[str, int] = {}

    def column_for_expression(self, src: str) -> int:
        key = f"expr:{src}"
        idx = self._by_key.get(key)
        if idx is None:
            col = FeatureColumn(
                key=key, query=Query(src), path_prefix=query_path_prefix(src)
            )
            idx = len(self.columns)
            self.columns.append(col)
            self._by_key[key] = idx
        return idx

    def column_for_label(self, label_key: str) -> int:
        key = f"label:{label_key}"
        idx = self._by_key.get(key)
        if idx is None:
            col = FeatureColumn(
                key=key,
                query=None,
                label_key=label_key,
                path_prefix=("metadata", "labels", label_key),
            )
            idx = len(self.columns)
            self.columns.append(col)
            self._by_key[key] = idx
        return idx

    def column_for_annotation(self, annotation_key: str) -> int:
        key = f"annotation:{annotation_key}"
        idx = self._by_key.get(key)
        if idx is None:
            col = FeatureColumn(
                key=key,
                query=None,
                annotation_key=annotation_key,
                path_prefix=("metadata", "annotations", annotation_key),
            )
            idx = len(self.columns)
            self.columns.append(col)
            self._by_key[key] = idx
        return idx

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def extract_row(self, obj: Any) -> List[int]:
        """Full feature vector for one JSON-standard object."""
        meta = obj.get("metadata") or {}
        labels = meta.get("labels") or {}
        annotations = meta.get("annotations") or {}
        return [c.extract(obj, labels, annotations) for c in self.columns]


@dataclass(frozen=True)
class CompiledCondition:
    """One matchExpression compiled to a masked column test:
    matches iff ((F[col] & mask) != 0) ^ negate."""

    col: int
    mask: int
    negate: bool


def compile_selector(schema: FeatureSchema, stage: Stage) -> List[CompiledCondition]:
    """Compile a stage's selector to masked column tests."""
    sel = stage.selector
    conds: List[CompiledCondition] = []
    if sel is None:
        return conds
    for k, v in (sel.match_labels or {}).items():
        col = schema.column_for_label(k)
        mask = schema.columns[col].mask_for([v])
        conds.append(CompiledCondition(col, mask, False))
    for k, v in (sel.match_annotations or {}).items():
        col = schema.column_for_annotation(k)
        mask = schema.columns[col].mask_for([v])
        conds.append(CompiledCondition(col, mask, False))
    for e in sel.match_expressions:
        col = schema.column_for_expression(e.key)
        fc = schema.columns[col]
        if e.operator == "In":
            conds.append(CompiledCondition(col, fc.mask_for(e.values), False))
        elif e.operator == "NotIn":
            conds.append(CompiledCondition(col, fc.mask_for(e.values), True))
        elif e.operator == "Exists":
            conds.append(CompiledCondition(col, ALL_MASK, False))
        elif e.operator == "DoesNotExist":
            conds.append(CompiledCondition(col, ALL_MASK, True))
        else:
            raise ValueError(f"operator {e.operator!r} is not supported")
    return conds
