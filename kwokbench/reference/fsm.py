"""The plain Stage FSM, replayed one row at a time.

The semantics of kwok's stage engine as a row of a tick-based simulator
sees them, over the hand-written stage sets of a configuration's
reference file (``configs/<config>.reference.json``):

- time advances in ticks of ``tick_ms``; at tick t (0-based, counted
  from admission) the clock reads ``(t + 1) * tick_ms``;
- an admitted row is matched at its first tick; a row whose timer has
  come (``fire_at <= now``) fires its stage: the stage's effects are
  applied to its fields, a deleting stage ends the row, and a row that
  lives on is matched again at once;
- a match chooses among the stages whose selector holds: by weight among
  those of positive weight, uniformly among all matched when no weight
  is positive, by the tick's choice draw; the timer is the stage's delay,
  drawn up to its jitter by the tick's jitter draw; with no stage
  matched the row waits for ever;
- the draws of tick t for row i are ``uniform(k, N)[i]`` of the tick's
  second (choice) and third (jitter) split key (``threefry.py``).

It imports nothing of the program under test and reads nothing the
program made: the stage sets, the seed and the row indices are all it
takes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from kwokbench.reference import threefry

IDLE = -1
NEVER = 2**31 - 1


def load_reference(config: dict, config_dir: str) -> dict:
    with open(os.path.join(config_dir, config["reference"])) as f:
        return json.load(f)


def _holds(fields: dict, cond: Sequence) -> bool:
    name, op = cond[0], cond[1]
    v = fields[name]
    present = bool(v) if isinstance(v, list) else v is not None
    if op == "Exists":
        return present
    if op == "DoesNotExist":
        return not present
    values = cond[2]
    inside = any(x in values for x in v) if isinstance(v, list) else v in values
    if op == "In":
        return inside
    if op == "NotIn":
        return not inside
    raise ValueError(f"unknown operator {op!r}")


class StageSet:
    """One kind's stages from the reference file, with their matches
    memoized by the state of the fields."""

    def __init__(self, kind: dict):
        self.initial = dict(kind["initial"])
        self.stages = kind["stages"]
        self.names = [s["name"] for s in self.stages]
        self._match: Dict[tuple, List[int]] = {}

    @staticmethod
    def _key(fields: dict) -> tuple:
        return tuple((k, tuple(v) if isinstance(v, list) else v) for k, v in sorted(fields.items()))

    def matched(self, fields: dict) -> List[int]:
        key = self._key(fields)
        got = self._match.get(key)
        if got is None:
            got = self._match[key] = [
                i for i, s in enumerate(self.stages) if all(_holds(fields, c) for c in s["when"])]
        return got

    def choose(self, matched: List[int], u: np.float32) -> int:
        weights = [max(0, int(self.stages[i]["weight"])) for i in matched]
        if sum(weights) == 0:
            weights = [1] * len(matched)
        total = sum(weights)
        r = min(int(np.float32(u) * np.float32(total)), total - 1)
        cum = 0
        for i, w in zip(matched, weights):
            cum += w
            if cum > r:
                return i
        raise AssertionError("no stage chosen")

    def delay(self, i: int, u: np.float32) -> int:
        st = self.stages[i]
        d, j = int(st["delay_ms"]), st["jitter_ms"]
        if j is None:
            return max(d, 0)
        j = int(j)
        if j < d:
            return max(j, 0)
        return max(d + int(np.float32(u) * np.float32(j - d)), 0)


def replay(stage_set: StageSet, seed: int, rows: Sequence[int], n_ticks: int, tick_ms: int,
           u_choice: Optional[np.ndarray] = None, u_jitter: Optional[np.ndarray] = None
           ) -> np.ndarray:
    """The fired stage of each of ``rows`` at each of ``n_ticks`` ticks
    from admission (all rows admitted alike before the first tick), as a
    ``[n_ticks, len(rows)]`` int16 array, ``IDLE`` where none fired.
    ``u_choice`` / ``u_jitter`` (``[n_ticks, len(rows)]``) replace the
    draws; by default they are threefry's from ``seed``."""
    if u_choice is None or u_jitter is None:
        keys = threefry.key_chain(threefry.key_of_seed(seed), n_ticks)
        u_choice = threefry.uniform_rows(keys[:, 1], rows)
        u_jitter = threefry.uniform_rows(keys[:, 2], rows)
    out = np.full((n_ticks, len(rows)), IDLE, np.int16)
    for c in range(len(rows)):
        fields = dict(stage_set.initial)
        stage, fire_at, t = IDLE, NEVER, 0  # admitted: matched at tick 0
        while t < n_ticks:
            now = (t + 1) * tick_ms
            if stage != IDLE:
                if fire_at > now:
                    if fire_at == NEVER:
                        break
                    t = max(t, -(-fire_at // tick_ms) - 1)
                    continue
                out[t, c] = stage
                st = stage_set.stages[stage]
                fields.update({k: (list(v) if isinstance(v, list) else v)
                               for k, v in st["set"].items()})
                if st["delete"]:
                    break
            matched = stage_set.matched(fields)
            if not matched:
                break
            stage = stage_set.choose(matched, u_choice[t, c])
            fire_at = now + stage_set.delay(stage, u_jitter[t, c])
            t += 1
    return out
