"""Threefry-2x32 (20 rounds) in NumPy and plain Python integers.

A frozen, independent statement of the generator the simulator draws
from, written from the algorithm (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011) and the conventions of
``jax.random`` with ``jax_threefry_partitionable=True``:

- a key is a pair of 32-bit words; the key of seed ``s`` is
  ``(0, s mod 2**32)``;
- ``split(key, n)[j] = threefry(key, (0, j))``;
- ``uniform(key, n)[i]`` takes ``x0 ^ x1`` of ``threefry(key, (0, i))``,
  keeps its top 23 bits as the mantissa of a float32 in [1, 2) and
  subtracts 1.

It imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key_of_seed(seed: int):
    return (0, int(seed) & M32)


def threefry_int(k0: int, k1: int, x0: int, x1: int):
    """One block on Python integers (for the sequential key chain)."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def threefry_np(k0, k1, x0, x1):
    """Blocks on uint32 arrays; ``k0``/``k1`` broadcast against the counters."""
    k0 = np.asarray(k0, np.uint32)
    k1 = np.asarray(k1, np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(KS_PARITY))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key_chain(key, n_ticks: int, n_split: int = 3):
    """The keys a simulator splits at each of ``n_ticks`` ticks: tick t
    splits its key into ``n_split`` and keeps the first for tick t + 1.
    Returns a ``[n_ticks, n_split, 2]`` uint32 array of tick t's split keys
    (``[:, 1:]`` are the ones drawn from)."""
    chain = np.empty((n_ticks, 2), np.uint32)  # tick t's key, before its split
    k0, k1 = key
    for t in range(n_ticks):
        chain[t] = k0, k1
        k0, k1 = threefry_int(k0, k1, 0, 0)
    out = np.empty((n_ticks, n_split, 2), np.uint32)
    for j in range(n_split):
        y0, y1 = threefry_np(chain[:, 0], chain[:, 1], np.zeros(n_ticks, np.uint32),
                             np.full(n_ticks, j, np.uint32))
        out[:, j, 0], out[:, j, 1] = y0, y1
    return out


def uniform_rows(keys: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``uniform(keys[t], N)[rows]`` for every t: a ``[T, R]`` float32
    array, from ``[T, 2]`` keys and ``R`` row indices."""
    rows = np.asarray(rows, np.uint32)[None, :]
    x0, x1 = threefry_np(keys[:, :1], keys[:, 1:2], np.zeros_like(rows), rows)
    bits = ((x0 ^ x1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(bits.view(np.float32) - np.float32(1.0), np.float32(0.0))
