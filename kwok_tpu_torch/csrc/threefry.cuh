// Threefry-2x32 (20 rounds) as a device function, bit-exact with
// jax.random under jax_threefry_partitionable=True.
//
// Replaces the jax.random draws inside kwok_tpu/ops/tick.py::_tick_impl
// (split at :144, uniform at :167 and :183).  The plain PyTorch version
// is kwok_tpu_torch/ops/prng.py.  A row's draw is threefry(key, (0, row)),
// so each thread draws for its own row in registers: no state is shared
// between threads and the order of blocks does not matter.
#pragma once

#include <stdint.h>

namespace kwok {

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32(key, (c0, c1)) -> (x0, x1).  All arithmetic is uint32,
// so adds wrap as the reference's do.
__device__ __forceinline__ void threefry2x32(Key key, uint32_t c0, uint32_t c1,
                                             uint32_t* out0, uint32_t* out1) {
  const uint32_t ks[3] = {key.k0, key.k1, key.k0 ^ key.k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *out0 = x0;
  *out1 = x1;
}

// jax.random.split(key, n)[j]
__device__ __forceinline__ Key split_at(Key key, uint32_t j) {
  Key k;
  threefry2x32(key, 0u, j, &k.k0, &k.k1);
  return k;
}

// jax.random.uniform(key, (n,))[i] for i < 2**32: the top 23 bits of
// x0 ^ x1 as the mantissa of a float in [1, 2), minus 1, at least 0.
__device__ __forceinline__ float uniform_at(Key key, uint32_t i) {
  uint32_t x0, x1;
  threefry2x32(key, 0u, i, &x0, &x1);
  const uint32_t b = ((x0 ^ x1) >> 9) | 0x3F800000u;
  return fmaxf(__fsub_rn(__uint_as_float(b), 1.0f), 0.0f);
}

}  // namespace kwok
