"""Prometheus text-format parsing.

A frozen copy of ``kwok_tpu_torch/utils/promtext.py`` (``iter_samples``
and its helpers, at the commit that added this benchmark), so that the
benchmark reads ``/metrics`` the same way whatever the program does to
its own parser.  Handles quoted label values holding commas and
escaped quotes."""
from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

__all__ = ["iter_samples"]

_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_ESCAPES = {"\\": "\\", '"': '"', "n": "\n"}


def _unescape(value: str) -> str:
    """Left-to-right escape scan — sequential whole-string replaces
    would corrupt an escaped backslash followed by 'n' into a
    newline."""
    if "\\" not in value:
        return value
    out = []
    i = 0
    n = len(value)
    while i < n:
        c = value[i]
        if c == "\\" and i + 1 < n:
            nxt = value[i + 1]
            out.append(_ESCAPES.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def iter_samples(text: str) -> Iterator[Tuple[str, Dict[str, str], float]]:
    """Yield (metric_name, labels, value) for each sample line."""
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series, _, val = line.rpartition(" ")
        if not series:
            continue
        try:
            fval = float(val)
        except ValueError:
            continue
        labels: Dict[str, str] = {}
        name = series
        if "{" in series:
            name, _, lbl = series.partition("{")
            labels = {k: _unescape(v) for k, v in _LABEL_RE.findall(lbl)}
        yield name.strip(), labels, fval
