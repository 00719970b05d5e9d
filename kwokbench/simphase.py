"""Reads the program's ``kwok_sim_phase_seconds{kind,phase}`` family: the
time of each phase of ``DeviceSimulator``'s work, observed by the program
itself, from the text that the process's ``/metrics`` serves
(``telemetry.registry().expose()``), parsed with the frozen
``promtext.py``.  A program without the family reads ``None``."""

from __future__ import annotations

from typing import Dict, List, Optional

from kwokbench import promtext

FAMILY = "kwok_sim_phase_seconds"


def exposition() -> str:
    """The process's telemetry exposition; the program is loaded only
    when a reader runs, never when one is found."""
    from kwok_tpu_torch.utils import telemetry

    return telemetry.registry().expose()


def totals(text: str, phase: str) -> Dict[str, List[float]]:
    """``{kind: [seconds, observations]}`` of one phase."""
    out: Dict[str, List[float]] = {}
    for name, labels, value in promtext.iter_samples(text):
        if labels.get("phase") != phase:
            continue
        if name == FAMILY + "_sum":
            out.setdefault(labels.get("kind", ""), [0.0, 0.0])[0] += value
        elif name == FAMILY + "_count":
            out.setdefault(labels.get("kind", ""), [0.0, 0.0])[1] += value
    return {kind: t for kind, t in out.items() if t[1] > 0}


def ms_per_call(text: str, phase: str) -> Optional[float]:
    """The phase's mean time a call of each kind, added over the kinds,
    in ms: with one ``tick_many`` of each kind a macro-tick, the phase's
    ms a pod+node macro-tick."""
    t = totals(text, phase)
    return sum(s / n for s, n in t.values()) * 1e3 if t else None


def seconds(text: str, phase: str) -> Optional[float]:
    """The phase's seconds, added over its observations and kinds."""
    t = totals(text, phase)
    return sum(s for s, _ in t.values()) if t else None
