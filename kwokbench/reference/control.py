"""The draws of the reference, and of its control.

The control is the reference computed one precision below the one the
configuration states: the simulator draws its choices and jitters as
float32, so the control rounds each draw to bfloat16 (round to nearest,
ties to even) before it is used.
"""

from __future__ import annotations

import numpy as np

from kwokbench.reference import threefry


def draws(seed: int, rows, n_ticks: int):
    """(choice, jitter) draws of ``rows`` at each tick: ``[n_ticks, R]`` float32."""
    keys = threefry.key_chain(threefry.key_of_seed(seed), n_ticks)
    return threefry.uniform_rows(keys[:, 1], rows), threefry.uniform_rows(keys[:, 2], rows)


def bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16, as float32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    with np.errstate(over="ignore"):
        r = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return r.view(np.float32)


def bf16_draws(pair):
    return tuple(bfloat16(u) for u in pair)
