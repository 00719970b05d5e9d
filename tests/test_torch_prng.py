"""kwok_tpu_torch.ops.prng equals jax.random bit for bit.

The tick draws every random number from threefry2x32; the port
reproduces jax.random's split and uniform (threefry_partitionable on),
so the simulators on both packages can be held to exact equality.
"""

import jax
import numpy as np
import pytest
import torch

from kwok_tpu_torch.ops import prng

SEEDS = [0, 1, 42, 2**31 - 1, -1, 2**32 + 5]
LENGTHS = [1, 2, 3, 7, 64, 1001]


def bits_u32(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_prngkey(seed):
    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)), prng.prng_key(seed, 'cpu').numpy())
    assert prng.prng_key(seed, 'cpu').dtype == torch.uint32


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_uniform_bit_exact(seed, n):
    jkey, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed, 'cpu')
    assert np.array_equal(np.asarray(jax.random.split(jkey, n)), prng.split(tkey, n).numpy())
    ju = np.asarray(jax.random.uniform(jkey, (n,)))
    tu = prng.uniform(tkey, n).numpy()
    assert tu.dtype == np.float32
    assert np.array_equal(bits_u32(ju), bits_u32(tu))
    assert np.array_equal(
        np.asarray(jax.random.bits(jkey, (n,))), prng.bits(tkey, n).numpy().astype(np.uint32)
    )


def test_fifty_step_key_chain():
    """The tick's chain: key, k_choice, k_jitter = split(key, 3)."""
    jkey, tkey = jax.random.PRNGKey(7), prng.prng_key(7, 'cpu')
    for step in range(50):
        jk = jax.random.split(jkey, 3)
        tk = prng.split(tkey, 3)
        assert np.array_equal(np.asarray(jk), tk.numpy()), step
        for j in (1, 2):
            assert np.array_equal(
                bits_u32(jax.random.uniform(jk[j], (33,))), bits_u32(prng.uniform(tk[j], 33))
            ), (step, j)
        jkey, tkey = jk[0], tk[0]


def test_uniform_is_mantissa_of_top_bits():
    """uniform = bitcast((bits >> 9) | 0x3F800000) - 1, in [0, 1)."""
    key = prng.prng_key(3, 'cpu')
    b = prng.bits(key, 4096).numpy().astype(np.uint32)
    want = ((b >> 9) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    got = prng.uniform(key, 4096).numpy()
    assert np.array_equal(bits_u32(got), bits_u32(want))
    assert got.min() >= 0.0 and got.max() < 1.0
