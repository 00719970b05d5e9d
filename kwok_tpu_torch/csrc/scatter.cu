// Dirty-row scatter into the device SoA, for Hopper (sm_90a).
//
// Replaces kwok_tpu/ops/tick.py::_scatter_rows_impl (:246-275), eight
// .at[rows].set(...) updates, with one launch that writes all eight
// columns of a row from one thread.  The plain PyTorch version is in
// kwok_tpu_torch/ops/tick.py.
//
// Bound: bytes.  Each batch row is read once ((C + 5) * 4 + 2 bytes plus
// its index) and written once; there is no arithmetic to speak of.
// Duplicate indices (the power-of-two padding repeats a real row) carry
// equal values, so the order in which threads write them does not matter.
// The wrapper (kwok_tpu_torch/ops/tick.py::scatter_rows) has checked that
// every index lies in [0, n).

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrors the ctypes.Structure in kwok_tpu_torch/ops/kernels.py.
struct ScatterArgs {
  // SoA columns, updated in place
  int32_t* features;  // [N, C]
  int32_t* sig;
  int32_t* ovc;
  int32_t* stage;
  int32_t* fire_at;
  uint8_t* active;
  uint8_t* rematch;
  int32_t* del_ts;
  // the batch
  const int32_t* rows;      // [B]
  const int32_t* src_features;  // [B, C]
  const int32_t* src_sig;
  const int32_t* src_ovc;
  const int32_t* src_stage;
  const int32_t* src_fire_at;
  const uint8_t* src_active;
  const uint8_t* src_rematch;
  const int32_t* src_del_ts;
  int64_t b;
  int32_t C;
};

namespace {

__global__ void scatter_rows_kernel(ScatterArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b) return;
  const int64_t r = a.rows[i];
  for (int c = 0; c < a.C; ++c) a.features[r * a.C + c] = a.src_features[i * a.C + c];
  a.sig[r] = a.src_sig[i];
  a.ovc[r] = a.src_ovc[i];
  a.stage[r] = a.src_stage[i];
  a.fire_at[r] = a.src_fire_at[i];
  a.active[r] = a.src_active[i];
  a.rematch[r] = a.src_rematch[i];
  a.del_ts[r] = a.src_del_ts[i];
}

}  // namespace

extern "C" int kwok_scatter_rows(const ScatterArgs* args, void* stream) {
  const ScatterArgs a = *args;
  if (a.b <= 0 || a.C <= 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((a.b + 255) / 256);
  scatter_rows_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
