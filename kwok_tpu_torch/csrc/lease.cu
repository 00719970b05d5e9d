// The lease-renewal lane's tick as one CUDA kernel for Hopper (sm_90a).
//
// Replaces kwok_tpu/ops/tick.py::lease_tick (:305, body _lease_tick_impl
// :290-302).  The plain PyTorch version is _lease_tick_impl in
// kwok_tpu_torch/ops/tick.py.  Per slot i of the lane:
//
//   key, k  = split(key)                 (threefry(key, (0, 0)), (0, 1))
//   due[i]  = fire_at[i] <= now
//   lag[i]  = due ? now - fire_at[i] : 0
//   fire[i] = due ? now + renew + trunc(uniform(k)[i] * float(jitter))
//                 : fire_at[i]
//
// Design.  Slots never interact, so one thread owns one slot.  The
// uniform of slot i depends only on k and i, so a thread draws it in
// registers, and only when its slot is due: the reference draws for
// every slot and discards the rest, which changes no bit.  Every thread
// derives k from the OLD key itself (one threefry), and thread 0 writes
// the advanced key into a fresh output tensor, so no block ever reads a
// key that another block has already advanced.  fire_at is written into
// a fresh tensor too: the caller's lane is left as it was.
//
// Bound.  Per slot 4 bytes are read and 9 written (fire_at, due, lag);
// a due slot adds two threefry evaluations.  At the lane's sizes (tens
// of thousands of slots) the kernel is bound by its launch, far below
// either term.
//
// Arithmetic follows XLA exactly: the int32 adds and the subtraction go
// through uint32 (they wrap as XLA's do); the jitter product is one
// rounded float32 multiply then a truncation toward zero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

// Mirrors the ctypes.Structure in kwok_tpu_torch/ops/kernels.py.
struct LeaseArgs {
  const int32_t* fire_in;  // [n]
  const uint32_t* key_in;  // [2]
  int32_t* fire_out;       // [n]
  uint8_t* due;            // [n] bool
  int32_t* lag;            // [n]
  uint32_t* key_out;       // [2]
  int64_t n;
  int32_t now;
  int32_t renew_ms;
  int32_t jitter_ms;
};

namespace {

constexpr int BLOCK = 256;

__global__ void lease_tick_kernel(LeaseArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const kwok::Key key{a.key_in[0], a.key_in[1]};
  if (i == 0) {
    const kwok::Key next = kwok::split_at(key, 0u);
    a.key_out[0] = next.k0;
    a.key_out[1] = next.k1;
  }
  if (i >= a.n) return;
  const int32_t f = a.fire_in[i];
  const bool due = f <= a.now;
  int32_t fire = f;
  int32_t lag = 0;
  if (due) {
    const float u = kwok::uniform_at(kwok::split_at(key, 1u), (uint32_t)i);
    const int32_t jit = __float2int_rz(__fmul_rn(u, __int2float_rn(a.jitter_ms)));
    fire = (int32_t)((uint32_t)a.now + (uint32_t)a.renew_ms + (uint32_t)jit);
    lag = (int32_t)((uint32_t)a.now - (uint32_t)f);
  }
  a.fire_out[i] = fire;
  a.due[i] = due;
  a.lag[i] = lag;
}

}  // namespace

extern "C" int kwok_lease_tick(const LeaseArgs* args, void* stream) {
  const LeaseArgs a = *args;
  if (a.n <= 0 || a.n > 0xFFFFFFFFll) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((a.n + BLOCK - 1) / BLOCK);
  lease_tick_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
