"""Threefry-2x32 counter-based PRNG, bit-exact with ``jax.random``.

Plain PyTorch version of the generator the tick kernel draws from
(``csrc/threefry.cuh`` is the device version).  It reproduces
``jax.random`` with the threefry2x32 implementation and
``jax_threefry_partitionable=True``:

- a key is a ``[2]`` uint32 pair; ``prng_key(seed)`` is ``[0, seed]``
  (the low 32 bits of the seed), as ``jax.random.PRNGKey`` gives it;
- ``split(key, n)[j]`` is ``threefry(key, (0, j))``;
- ``uniform(key, n)[i]`` takes the bits ``x0 ^ x1`` of
  ``threefry(key, (0, i))``, keeps the top 23 as the mantissa of a
  float in [1, 2) and subtracts 1.

So a row's draw depends only on the key and the row's index, which is
what lets the kernel draw in registers, one thread per row, and what
lets a shard of rows draw its own: ``uniform(key, n, offset)`` is
``uniform(key, offset + n)[offset:]``.

torch has no uint32 arithmetic (and few uint32 ops of any kind on
CUDA), so uint32 tensors are only ever reinterpreted with ``view``:
the words are held in int64 and masked to 32 bits after every add and
shift.
"""

from __future__ import annotations

import numpy as np
import torch

from kwok_tpu_torch.ops.device import resolve_device

M32 = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 words.

    ``k0``/``k1`` are the key words (ints or 0-d tensors), ``x0``/``x1``
    the counter words; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the uint32 pair ``[0, seed mod 2**32]``,
    on the card unless ``device`` says otherwise."""
    key = torch.from_numpy(np.array([0, int(seed) & M32], np.uint32))
    return key.to(resolve_device(device))


def _words(key: torch.Tensor):
    k = key.view(torch.int32).to(torch.int64) & M32
    return k[0], k[1]


def _as_uint32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> the same bits as a uint32 tensor."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).view(torch.uint32)


def _counter(n: int, device, offset: int = 0) -> torch.Tensor:
    if offset < 0 or offset + n > 2**32:
        raise ValueError(f"counters [{offset}, {offset + n}) do not fit uint32")
    return torch.arange(offset, offset + n, dtype=torch.int64, device=device)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: ``[n, 2]`` uint32 keys."""
    k0, k1 = _words(key)
    cnt = _counter(n, key.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(cnt), cnt)
    return _as_uint32(torch.stack([y0, y1], dim=1))


def bits(key: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, (offset + n,))[offset:]`` as int64 words in
    [0, 2**32)."""
    k0, k1 = _words(key)
    cnt = _counter(n, key.device, offset)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(cnt), cnt)
    return y0 ^ y1


def uniform(key: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, (offset + n,))[offset:]``: float32 in [0, 1)."""
    b = (bits(key, n, offset) >> 9) | 0x3F800000
    f = b.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f, 0.0)
