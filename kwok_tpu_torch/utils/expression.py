"""Selector requirements and value getters over kq queries.

Mirrors reference pkg/utils/expression:
- Requirement (selector.go:28-120): key query + In/NotIn/Exists/DoesNotExist,
  values compared as strings (bool -> "true"/"false", ints base-10).
- IntGetter (value_int_from.go:40-80): expression result overrides the
  static value; empty result falls back to the static value; empty-string
  or unparsable results are "not ok".
- DurationGetter (value_duration_from.go:40-79): expression result is
  either an RFC3339 timestamp (duration = t - now) or a Go duration
  string; falls back to the static value on empty result.
"""

from __future__ import annotations

import datetime
import re
from typing import Any, List, Optional, Sequence

from kwok_tpu_torch.utils.kq import KqCompileError, Query

OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"

_OPS = (OP_IN, OP_NOT_IN, OP_EXISTS, OP_DOES_NOT_EXIST)


class Requirement:
    """One selector matchExpression (reference selector.go:28-91)."""

    def __init__(self, key: str, operator: str, values: Optional[Sequence[str]] = None):
        values = list(values or [])
        if operator in (OP_IN, OP_NOT_IN):
            if not values:
                raise ValueError("for 'in', 'notin' operators, values set can't be empty")
        elif operator in (OP_EXISTS, OP_DOES_NOT_EXIST):
            if values:
                raise ValueError("values set must be empty for exists and does not exist")
        else:
            raise ValueError(f"operator {operator!r} is not supported")
        self.key = key
        self.operator = operator
        self.values = values
        self.query = Query(key)

    def matches(self, data: Any) -> bool:
        out = self.query.execute(data)
        if not out:
            # None (error) and [] are both "no data" (selector.go:66-76).
            return self.operator in (OP_NOT_IN, OP_DOES_NOT_EXIST)
        if self.operator == OP_IN:
            return _has_values(out, self.values)
        if self.operator == OP_NOT_IN:
            return not _has_values(out, self.values)
        if self.operator == OP_EXISTS:
            return _exists_value(out)
        return not _exists_value(out)


def value_as_string(d: Any) -> Optional[str]:
    """Selector value stringification (selector.go:96-110 hasValue):
    strings as-is, bools lowercase, ints base-10; other types don't
    participate in In/NotIn comparison."""
    if isinstance(d, bool):
        return "true" if d else "false"
    if isinstance(d, str):
        return d
    if isinstance(d, int):
        return str(d)
    return None


_value_as_string = value_as_string


def _has_values(out: List[Any], values: Sequence[str]) -> bool:
    for d in out:
        s = _value_as_string(d)
        if s is not None and s in values:
            return True
    return False


def _exists_value(out: List[Any]) -> bool:
    return any(d is not None for d in out)


# ---------------------------------------------------------------------------
# Duration parsing (Go time.ParseDuration-compatible subset)
# ---------------------------------------------------------------------------

_GO_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_GO_UNIT_SECONDS = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
}


def parse_go_duration(s: str) -> Optional[float]:
    """Parse a Go duration string ("1.5h30m", "10s") to seconds."""
    s = s.strip()
    if not s:
        return None
    neg = False
    if s[0] in "+-":
        neg = s[0] == "-"
        s = s[1:]
    if s == "0":
        return 0.0
    pos = 0
    total = 0.0
    while pos < len(s):
        m = _GO_DURATION_RE.match(s, pos)
        if m is None:
            return None
        total += float(m.group(1)) * _GO_UNIT_SECONDS[m.group(2)]
        pos = m.end()
    return -total if neg else total


def parse_rfc3339(s: str) -> Optional[datetime.datetime]:
    try:
        if s.endswith("Z"):
            s = s[:-1] + "+00:00"
        # RFC 3339 allows any number of fractional digits, but
        # fromisoformat before Python 3.11 accepts exactly 3 or 6 —
        # normalize ("00:00:00.5" -> "00:00:00.500000")
        m = re.match(r"^(.*T\d{2}:\d{2}:\d{2})\.(\d+)(.*)$", s)
        if m:
            frac = (m.group(2) + "000000")[:6]
            s = f"{m.group(1)}.{frac}{m.group(3)}"
        t = datetime.datetime.fromisoformat(s)
        if t.tzinfo is None:
            t = t.replace(tzinfo=datetime.timezone.utc)
        return t
    except ValueError:
        return None


class IntGetter:
    """Static int64 optionally overridden by an expression
    (reference value_int_from.go:28-80)."""

    def __init__(self, value: Optional[int], expression: Optional[str]):
        self.value = value
        self.query = Query(expression) if expression else None

    def get(self, data: Any) -> tuple:
        """Returns (value, ok)."""
        if self.query is None:
            if self.value is None:
                return 0, False
            return self.value, True
        out = self.query.execute(data)
        # Runtime query errors are swallowed to an empty result by the
        # reference (query.go:57-59 returns nil, nil), so both None and []
        # fall back to the static value.
        if not out:
            if self.value is not None:
                return self.value, True
            return 0, False
        first = out[0]
        if isinstance(first, str):
            if first == "":
                return 0, False
            try:
                return int(first, 0), True
            except ValueError:
                return 0, False
        if isinstance(first, bool):
            pass  # falls through to static fallback, like the Go default case
        elif isinstance(first, (int, float)):
            return int(first), True
        if self.value is not None:
            return self.value, True
        return 0, False


class DurationGetter:
    """Static duration (seconds) optionally overridden by an expression
    yielding an RFC3339 deadline or Go duration string
    (reference value_duration_from.go:28-79)."""

    def __init__(self, value_seconds: Optional[float], expression: Optional[str]):
        self.value = value_seconds
        self.query = Query(expression) if expression else None

    def get(self, data: Any, now: datetime.datetime) -> tuple:
        """Returns (seconds, ok)."""
        if self.query is None:
            if self.value is None:
                return 0.0, False
            return self.value, True
        out = self.query.execute(data)
        # None (swallowed error) and [] both mean "no data" -> static fallback.
        if not out:
            if self.value is not None:
                return self.value, True
            return 0.0, False
        first = out[0]
        if isinstance(first, str):
            if first == "":
                return 0.0, False
            t = parse_rfc3339(first)
            if t is not None:
                return (t - now).total_seconds(), True
            d = parse_go_duration(first)
            if d is not None:
                return d, True
        return 0.0, False


def compile_requirements(exprs: Sequence[dict]) -> List[Requirement]:
    """Build Requirements from matchExpressions dicts; raises
    KqCompileError/ValueError for out-of-subset queries."""
    reqs = []
    for e in exprs:
        reqs.append(Requirement(e["key"], e["operator"], e.get("values")))
    return reqs


__all__ = [
    "Requirement",
    "IntGetter",
    "DurationGetter",
    "compile_requirements",
    "parse_go_duration",
    "parse_rfc3339",
    "KqCompileError",
    "OP_IN",
    "OP_NOT_IN",
    "OP_EXISTS",
    "OP_DOES_NOT_EXIST",
]
