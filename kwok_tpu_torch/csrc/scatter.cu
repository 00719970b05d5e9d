// Dirty-row scatter into the device SoA, for Hopper (sm_90a).
//
// Replaces kwok_tpu/ops/tick.py::_scatter_rows_impl (:246-275), eight
// .at[rows].set(...) updates of the SoA.  It is the device end of one
// path from the simulator's host mirror to its SoA
// (kwok_tpu_torch/engine/simulator.py::_flush_pending): the host gathers
// the batch into one pinned buffer and checks its rows there
// (kwok_tpu_torch/ops/tick.py::pack_batch), one asynchronous copy brings
// the buffer to the card on the stream the tick runs on, and this kernel
// writes it into the SoA.  The plain PyTorch version is
// _scatter_rows_impl in kwok_tpu_torch/ops/tick.py.
//
// Bound: bytes.  Each batch row is read once ((C + 6) * 4 + 2 bytes with
// its index) and written once; there is no arithmetic.  At the churn's
// 30,000 rows of C = 13 that is ~4.7 MB, ~1.4 us at 3.35 TB/s, less than
// a launch.  What costs on the way is the host: the path it replaces made
// nine pageable uploads, a device sync for the range check and a 2-D
// fancy-indexed gather per flush.
//
// The batch is one buffer of segments, each 16-byte aligned, in the
// order of the fields below: rows [B], features [B, C], sig, ovc, stage,
// fire_at [B] int32, active, rematch [B] bytes, del_ts [B] int32.  The
// features are one flat loop over the B x C words: lane j reads word j of
// the block (coalesced across the warp) and writes
// features[rows[j / C] * C + j % C], so neighbouring lanes write
// neighbouring words of one row.  The seven other columns take one lane
// per batch row, each reading its segment coalesced.  Loops stride over
// the grid, which covers the B x C words up to 16 blocks an SM.
// Duplicate rows carry equal values, so the order in which lanes write
// them does not matter.  The wrapper (kwok_tpu_torch/ops/kernels.py::
// scatter_rows) has checked on the host that every row lies in [0, n)
// and that B x C < 2^31.

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
  // the segments of the packed batch, one buffer on the card
  const int32_t* rows;          // [B]
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

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 16;

__global__ void __launch_bounds__(kThreads) scatter_rows_kernel(const ScatterArgs a) {
  const uint32_t stride = gridDim.x * kThreads;
  const uint32_t first = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t C = (uint32_t)a.C;
  const uint32_t words = (uint32_t)a.b * C;
  for (uint32_t j = first; j < words; j += stride) {
    const uint32_t i = j / C;
    const int64_t r = __ldg(a.rows + i);
    a.features[r * C + (j - i * C)] = __ldg(a.src_features + j);
  }
  for (uint32_t i = first; i < (uint32_t)a.b; i += stride) {
    const int64_t r = __ldg(a.rows + i);
    a.sig[r] = __ldg(a.src_sig + i);
    a.ovc[r] = __ldg(a.src_ovc + i);
    a.stage[r] = __ldg(a.src_stage + i);
    a.fire_at[r] = __ldg(a.src_fire_at + i);
    a.active[r] = __ldg(a.src_active + i) != 0;
    a.rematch[r] = __ldg(a.src_rematch + i) != 0;
    a.del_ts[r] = __ldg(a.src_del_ts + i);
  }
}

}  // namespace

extern "C" int kwok_scatter_rows(const ScatterArgs* args, void* stream) {
  const ScatterArgs a = *args;
  if (a.b <= 0 || a.C <= 0 || a.b * a.C >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t need = (a.b * a.C + kThreads - 1) / kThreads;
  const int64_t most = (int64_t)sms * kBlocksPerSM;
  const unsigned grid = (unsigned)(need < most ? need : most);
  scatter_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
