"""The least time of the tick kernel, and the card's peaks.

Copied from ``chip_smoke.py`` (``row_bytes``, ``tick_bound`` and their
constants, at the commit that added this benchmark), so that the
yardstick stays where a change to the program cannot move it.

Peaks of one NVIDIA H100 SXM: 3.35 TB/s of HBM (NVIDIA's data sheet).
The integer rate is this repository's own derivation, not a data-sheet
figure: each of an SM's four schedulers issues one warp instruction a
clock, 128 lanes an SM, 132 SMs at 1.98 GHz (the width behind the
card's 67 TFLOP/s of float32 without the FMA doubling).  The tick
kernel is bound by bytes at the shapes measured here, so its share
rests on the published figure.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# The operation count is a floor, so that the bound stays a least time:
# per row and tick the fire test (3: compare, two ands); per rematching
# row one match pass (3 per condition) and one draw (threefry2x32: 2 +
# 20 rounds x 3 + 5 key injections x 2, then 3 to make the float).  The
# jitter draw and the choice pass are not counted.
DRAW_OPS = 2 + 20 * 3 + 5 * 2 + 3
COND_OPS = 3
ROW_TICK_OPS = 3


def row_bytes(C: int) -> int:
    """Bytes of one row a tick pass must read and write once: the C
    feature words, sig, ovc, stage, fire_at, del_ts and the two flags
    read; the features, stage, fire_at and the flags written."""
    read = C * 4 + 5 * 4 + 2
    written = C * 4 + 2 * 4 + 2
    return read + written


def tick_bound(S: int, KC: int, C: int, param_bytes: int, n: int, ticks: int,
               rematches: float, out_bytes: int):
    """Least time of one launch of ``ticks`` ticks over ``n`` rows with
    ``rematches`` rematching rows in all: (seconds, "bytes" | "operations")."""
    nbytes = n * row_bytes(C) + out_bytes + param_bytes
    ops = n * ticks * ROW_TICK_OPS + rematches * (DRAW_OPS + S * KC * COND_OPS)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
