// The Stage-FSM tick as one CUDA kernel for Hopper (sm_90a).
//
// Replaces three jitted functions of kwok_tpu/ops/tick.py that share one
// body, _tick_impl (:141-219, with match_stages :107-119 and
// _weighted_choice :122-138 inlined):
//   MODE_SINGLE  tick               (:217)      one tick, per-row outputs
//   MODE_COLLECT run_ticks_collect  (:222-243)  K ticks, [K, N] int8 stages
//   MODE_COUNT   run_ticks          (:308-325)  K ticks, total fired count
// and, launched once per row shard with the shard's global row offset,
// the two jitted functions of kwok_tpu/parallel/mesh.py:
//   MODE_SINGLE  sharded_tick       (:94-113)
//   MODE_COUNT   sharded_run_ticks  (:116-135)
// The plain PyTorch versions are in kwok_tpu_torch/ops/tick.py and
// kwok_tpu_torch/parallel/mesh.py.
//
// Design.  Rows never interact, so one thread owns one row for all K
// ticks: the row's scalars live in registers and its [C] feature row in
// shared memory (transposed, so a runtime column index costs no bank
// conflict), and the row state is read once and written once per call
// whatever K is.  The condition and per-stage tables sit in shared
// memory; the effect and override tables are gathered through the
// read-only cache, since only fired or rematching rows touch them.
// Matching, weighted choice and the two threefry draws run only for
// rows that rematch this tick: the reference computes them for every
// row and discards the rest, and a row's draws depend on nothing but
// the key and its index, so skipping them changes no bit.  That index is
// global: a shard passes the index of its first row as row_offset, so a
// sharded run draws exactly what an unsharded one does.
//
// The key chain (split(key, 3) each tick) does not depend on the data.
// A one-thread kernel computes it first into a [K, 4] schedule and
// writes the final key and clock into fresh output tensors, so no block
// of the row kernel can see a clock or key that another has advanced.
//
// Bound.  Per row and call, ~74 bytes are read and ~62 written (13-column
// pod rows), plus one byte per tick in MODE_COLLECT; each rematching row
// costs two threefry evaluations and S x KC condition tests per tick.
// At the pod set's churn the integer work, not the bytes, is the larger
// term (chip_smoke.py computes both from each run's data).
//
// Arithmetic follows XLA exactly: int32 adds that may overflow go
// through uint32; float32 products are one rounded multiply then a
// truncation toward zero (__int2float_rn, __fmul_rn, __float2int_rz).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int32_t SENTINEL = -2147483647 - 1;  // compiler.py SENTINEL
constexpr int32_t IDLE = -1;
constexpr int32_t NEVER = 2147483647;

constexpr int MODE_SINGLE = 0;
constexpr int MODE_COLLECT = 1;
constexpr int MODE_COUNT = 2;

// per-stage flag bits in the shared stage table
constexpr int F_HAS_JITTER = 1;
constexpr int F_D_FROM_DEL_TS = 2;
constexpr int F_J_FROM_DEL_TS = 4;
constexpr int F_DELETE = 8;

}  // namespace

// Mirrors the ctypes.Structure in kwok_tpu_torch/ops/kernels.py field
// for field.
struct TickArgs {
  // TickParams
  const int32_t* cond_col;       // [S, KC]
  const int32_t* cond_mask;      // [S, KC]
  const uint8_t* cond_neg;       // [S, KC]
  const uint8_t* cond_valid;     // [S, KC]
  const int32_t* w_static;       // [S]
  const int32_t* d_static;       // [S]
  const int32_t* j_static;       // [S]
  const uint8_t* has_jitter;     // [S]
  const uint8_t* d_from_del_ts;  // [S]
  const uint8_t* j_from_del_ts;  // [S]
  const uint8_t* stage_delete;   // [S]
  const int32_t* eff_mode;       // [SIG, S, C]
  const int32_t* eff_val;        // [SIG, S, C]
  const int32_t* ov_w;           // [OVC, S]
  const int32_t* ov_d;           // [OVC, S]
  const int32_t* ov_j;           // [OVC, S]
  // SoA, updated in place
  int32_t* features;  // [N, C]
  const int32_t* sig;
  const int32_t* ovc;
  int32_t* stage;
  int32_t* fire_at;
  uint8_t* active;
  uint8_t* rematch;
  const int32_t* del_ts;
  const int32_t* now_in;   // []
  const uint32_t* key_in;  // [2]
  int32_t* now_out;        // [] fresh
  uint32_t* key_out;       // [2] fresh
  uint32_t* sched;         // [K, 4] scratch: choice key, jitter key
  // outputs
  uint8_t* fired;        // [N]     MODE_SINGLE
  int32_t* fired_stage;  // [N]     MODE_SINGLE
  uint8_t* deleted;      // [N]     MODE_SINGLE
  int8_t* stages;        // [K, N]  MODE_COLLECT
  int32_t* count;        // []      MODE_SINGLE and MODE_COUNT, zeroed by the caller
  int64_t n;
  int64_t row_offset;  // global index of row 0 (a shard's first row)
  int32_t S, KC, C, SIG, OVC;
  int32_t dt_ms, num_ticks, mode;
};

namespace {

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t clampi(int32_t v, int32_t lo, int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
// int32(u * float32(x)): XLA's convert then multiply then truncate
__device__ __forceinline__ int32_t scale_trunc(float u, int32_t x) {
  return __float2int_rz(__fmul_rn(u, __int2float_rn(x)));
}

__global__ void key_schedule_kernel(TickArgs a) {
  kwok::Key key{a.key_in[0], a.key_in[1]};
  int32_t now = *a.now_in;
  for (int t = 0; t < a.num_ticks; ++t) {
    const kwok::Key kc = kwok::split_at(key, 1);
    const kwok::Key kj = kwok::split_at(key, 2);
    a.sched[4 * t + 0] = kc.k0;
    a.sched[4 * t + 1] = kc.k1;
    a.sched[4 * t + 2] = kj.k0;
    a.sched[4 * t + 3] = kj.k1;
    key = kwok::split_at(key, 0);
    now = wadd(now, a.dt_ms);
  }
  a.key_out[0] = key.k0;
  a.key_out[1] = key.k1;
  *a.now_out = now;
}

struct Shared {
  int32_t* feat;   // [C][BLOCK]
  int32_t* ccol;   // [S*KC]: column, or -1 for an unused condition slot
  int32_t* cmask;  // [S*KC]
  int32_t* cneg;   // [S*KC]
  int32_t* sw;     // [S] static weight
  int32_t* sd;     // [S] static delay
  int32_t* sj;     // [S] static jitter
  int32_t* sflag;  // [S] F_* bits
};

// selector match of stage s for this thread's feature row
__device__ __forceinline__ bool match_stage(const Shared& sh, int s, int KC) {
  bool m = true;
  for (int k = 0; k < KC; ++k) {
    const int i = s * KC + k;
    const int col = sh.ccol[i];
    if (col >= 0) {
      const bool test = (sh.feat[col * BLOCK + threadIdx.x] & sh.cmask[i]) != 0;
      m = m && (test != (sh.cneg[i] != 0));
    }
  }
  return m;
}

__device__ __forceinline__ int32_t stage_weight(const Shared& sh, const int32_t* ovw_row,
                                                int s) {
  const int32_t w = __ldg(ovw_row + s);
  return w != SENTINEL ? w : sh.sw[s];
}

template <int MODE>
__global__ void __launch_bounds__(BLOCK) tick_rows_kernel(TickArgs a) {
  extern __shared__ int32_t smem[];
  const int S = a.S, KC = a.KC, C = a.C;
  Shared sh;
  sh.feat = smem;
  sh.ccol = sh.feat + C * BLOCK;
  sh.cmask = sh.ccol + S * KC;
  sh.cneg = sh.cmask + S * KC;
  sh.sw = sh.cneg + S * KC;
  sh.sd = sh.sw + S;
  sh.sj = sh.sd + S;
  sh.sflag = sh.sj + S;

  const int tid = threadIdx.x;
  for (int i = tid; i < S * KC; i += BLOCK) {
    sh.ccol[i] = a.cond_valid[i] ? a.cond_col[i] : -1;
    sh.cmask[i] = a.cond_mask[i];
    sh.cneg[i] = a.cond_neg[i];
  }
  for (int s = tid; s < S; s += BLOCK) {
    sh.sw[s] = a.w_static[s];
    sh.sd[s] = a.d_static[s];
    sh.sj[s] = a.j_static[s];
    sh.sflag[s] = (a.has_jitter[s] ? F_HAS_JITTER : 0) |
                  (a.d_from_del_ts[s] ? F_D_FROM_DEL_TS : 0) |
                  (a.j_from_del_ts[s] ? F_J_FROM_DEL_TS : 0) |
                  (a.stage_delete[s] ? F_DELETE : 0);
  }
  const int64_t row0 = (int64_t)blockIdx.x * BLOCK;
  const int64_t left = a.n - row0;
  const int nrows = left < BLOCK ? (int)left : BLOCK;
  // coalesced load of the block's [nrows, C] features, transposed
  for (int i = tid; i < nrows * C; i += BLOCK) {
    const int r = i / C;
    sh.feat[(i - r * C) * BLOCK + r] = a.features[row0 * C + i];
  }
  __syncthreads();

  const int64_t row = row0 + tid;
  int32_t fired_total = 0;
  if (tid < nrows) {
    const int32_t sg = clampi(a.sig[row], 0, a.SIG - 1);
    const int32_t oc = clampi(a.ovc[row], 0, a.OVC - 1);
    const int32_t* ovw_row = a.ov_w + (int64_t)oc * S;
    const int32_t* ovd_row = a.ov_d + (int64_t)oc * S;
    const int32_t* ovj_row = a.ov_j + (int64_t)oc * S;
    const int32_t dts = a.del_ts[row];
    const bool has_dl = dts != SENTINEL;
    int32_t st = a.stage[row];
    int32_t fa = a.fire_at[row];
    bool act = a.active[row] != 0;
    bool rm = a.rematch[row] != 0;
    int32_t now = *a.now_in;
    const uint32_t urow = (uint32_t)(a.row_offset + row);

    for (int t = 0; t < a.num_ticks; ++t) {
      now = wadd(now, a.dt_ms);
      // 1. fire
      const bool fired = act && st >= 0 && fa <= now;
      const int32_t sc = clampi(st, 0, S - 1);
      // 2. effects of the fired stage
      if (fired) {
        const int64_t off = ((int64_t)sg * S + sc) * C;
        for (int c = 0; c < C; ++c) {
          if (__ldg(a.eff_mode + off + c) == 1) {
            sh.feat[c * BLOCK + tid] = __ldg(a.eff_val + off + c);
          }
        }
      }
      const bool del_now = fired && (sh.sflag[sc] & F_DELETE);
      act = act && !del_now;
      // 3. rematch: fresh transitions and host-forced
      const bool do_match = act && (fired || rm);
      const int32_t old_stage = st;
      if (do_match) {
        // 4. match + weighted choice (cumulative-sum inversion)
        uint32_t total = 0, nmatch = 0;
        for (int s = 0; s < S; ++s) {
          if (match_stage(sh, s, KC)) {
            nmatch += 1;
            const int32_t w = stage_weight(sh, ovw_row, s);
            if (w > 0) total += (uint32_t)w;
          }
        }
        const bool use_w = (int32_t)total > 0;
        const int32_t ptot = use_w ? (int32_t)total : (int32_t)nmatch;
        const bool any_match = ptot > 0;
        const kwok::Key kc{a.sched[4 * t + 0], a.sched[4 * t + 1]};
        const float u = kwok::uniform_at(kc, urow);
        int32_t r = scale_trunc(u, ptot);
        r = min(r, max(wsub(ptot, 1), 0));
        int32_t choice = 0;  // argmax of an all-false mask
        uint32_t cum = 0;
        for (int s = 0; s < S; ++s) {
          const bool m = match_stage(sh, s, KC);
          int32_t p;
          if (use_w) {
            const int32_t w = m ? stage_weight(sh, ovw_row, s) : 0;
            p = w > 0 ? w : 0;
          } else {
            p = m ? 1 : 0;
          }
          cum += (uint32_t)p;
          if ((int32_t)cum > r) {
            choice = s;
            break;
          }
        }
        const int32_t ns = any_match ? choice : IDLE;
        // 5. timers
        const int32_t nsc = clampi(ns, 0, S - 1);
        const int32_t d_over = __ldg(ovd_row + nsc);
        const int32_t j_over = __ldg(ovj_row + nsc);
        const int flags = sh.sflag[nsc];
        int32_t d = d_over != SENTINEL ? d_over : sh.sd[nsc];
        if ((flags & F_D_FROM_DEL_TS) && has_dl) d = wsub(dts, now);
        int32_t j = j_over != SENTINEL ? j_over : sh.sj[nsc];
        if ((flags & F_J_FROM_DEL_TS) && has_dl) j = wsub(dts, now);
        const bool has_j = (flags & F_HAS_JITTER) && j != SENTINEL;
        int32_t delay = d;
        if (has_j) {
          if (j < d) {
            delay = j;
          } else {
            const kwok::Key kj{a.sched[4 * t + 2], a.sched[4 * t + 3]};
            const float uj = kwok::uniform_at(kj, urow);
            const int32_t span = max(wsub(j, d), 0);
            delay = wadd(d, scale_trunc(uj, span));
          }
        }
        delay = max(delay, 0);
        st = ns;
        fa = any_match ? wadd(now, delay) : NEVER;
      }
      if (!act) fa = NEVER;
      rm = false;
      fired_total += fired ? 1 : 0;
      if (MODE == MODE_COLLECT) {
        a.stages[(int64_t)t * a.n + row] = (int8_t)(fired ? old_stage : IDLE);
      } else if (MODE == MODE_SINGLE) {
        a.fired[row] = fired;
        a.fired_stage[row] = fired ? old_stage : IDLE;
        a.deleted[row] = del_now;
      }
    }
    if (a.num_ticks > 0) {
      a.stage[row] = st;
      a.fire_at[row] = fa;
      a.active[row] = act;
      a.rematch[row] = 0;
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * C; i += BLOCK) {
    const int r = i / C;
    a.features[row0 * C + i] = sh.feat[(i - r * C) * BLOCK + r];
  }
  if (MODE != MODE_COLLECT) {
    // block sum of fires, then one atomic add (integer, so exact)
    int32_t v = fired_total;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    __shared__ int32_t warp_sums[BLOCK / 32];
    if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
    __syncthreads();
    if (tid < 32) {
      v = tid < BLOCK / 32 ? warp_sums[tid] : 0;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
      if (tid == 0 && v != 0) atomicAdd(a.count, v);
    }
  }
}

template <int MODE>
cudaError_t launch_rows(const TickArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tick_rows_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.n + BLOCK - 1) / BLOCK);
  tick_rows_kernel<MODE><<<grid, BLOCK, smem, stream>>>(a);
  return cudaGetLastError();
}

__global__ void threefry_draws_kernel(const uint32_t* key, int64_t n, uint32_t* pairs,
                                      float* u) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const kwok::Key k{key[0], key[1]};
  const kwok::Key y = kwok::split_at(k, (uint32_t)i);
  pairs[2 * i] = y.k0;
  pairs[2 * i + 1] = y.k1;
  u[i] = kwok::uniform_at(k, (uint32_t)i);
}

}  // namespace

extern "C" {

// Dynamic shared memory the row kernel needs for these widths.
size_t kwok_tick_smem_bytes(int32_t S, int32_t KC, int32_t C) {
  return sizeof(int32_t) * ((size_t)C * BLOCK + 3 * (size_t)S * KC + 4 * (size_t)S);
}

// Runs the key schedule, then num_ticks ticks over every row.  Returns
// the first CUDA error, 0 on a clean launch.
int kwok_tick_rows(const TickArgs* args, void* stream) {
  const TickArgs a = *args;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.num_ticks <= 0 || a.n <= 0 || a.S <= 0 || a.KC <= 0 || a.C <= 0 ||
      a.SIG <= 0 || a.OVC <= 0 || a.row_offset < 0 ||
      a.row_offset + a.n > 0x100000000ll) {
    return (int)cudaErrorInvalidValue;
  }
  key_schedule_kernel<<<1, 1, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = kwok_tick_smem_bytes(a.S, a.KC, a.C);
  switch (a.mode) {
    case MODE_SINGLE:
      err = launch_rows<MODE_SINGLE>(a, smem, s);
      break;
    case MODE_COLLECT:
      err = launch_rows<MODE_COLLECT>(a, smem, s);
      break;
    case MODE_COUNT:
      err = launch_rows<MODE_COUNT>(a, smem, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// split(key, n) as [n, 2] pairs and uniform(key, n), through the same
// device functions the tick uses; for checking them against prng.py.
int kwok_threefry_draws(const uint32_t* key, int64_t n, uint32_t* pairs, float* u,
                        void* stream) {
  if (n <= 0 || n > 0xFFFFFFFFll) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n + 255) / 256);
  threefry_draws_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(key, n, pairs, u);
  return (int)cudaGetLastError();
}

}  // extern "C"
