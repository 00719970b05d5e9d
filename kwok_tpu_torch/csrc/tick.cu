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
// Bound.  Per row and call, ~74 bytes are read and ~62 written (13-column
// pod rows), plus one byte per tick in MODE_COLLECT; each rematching row
// costs two threefry evaluations and S x KC condition tests per tick.
// At K = 8 the bytes are the larger term, over hundreds of ticks the
// integer work (chip_smoke.py computes both from each run's data).  In
// steady state only ~5% of pod rows fire or rematch on a tick, ~1.6 rows
// of a warp's 32, and 80% of warps hold one: one thread walking its row
// through the effects, the match and the choice would leave the rest of
// its warp idle on every tick.
//
// Design.  Rows never interact.  Each block stages its rows' features in
// shared memory for all K ticks, transposed with a row stride of
// BLOCK + 1, so that the lanes of a warp reading one column of their own
// rows, and the lanes of a segment (below) reading several columns of
// one row, fall in distinct banks.  The row state is read once and
// written once per call whatever K is.  Each tick:
//   - per lane: the fire test, the delete flag and the rematch flag of
//     its own row, kept in registers; __ballot_sync gives the warp the
//     masks of its fired and of its rematching rows;
//   - effects, the warp on one fired row at a time (two, a half-warp
//     each, when C <= 16): lane c loads column c's (mode, value) pair of
//     the row's (signature, stage), coalesced, and writes the row's
//     shared feature;
//   - draws, compacted over the block: a barrier counts the block's
//     rematching rows (~6 of 128) and thread i draws both uniforms of
//     the i-th into shared memory, so that one warp draws for up to 32
//     rows where each warp would draw for its ~1.6; a second barrier
//     hands them over;
//   - match and choice, a segment of W lanes per rematching row, W the
//     smallest power of two >= min(S, 32) (at least 2), 32 / W rows a
//     pass: lane l tests stage chunk * W + l against a condition table
//     transposed to [KC][S] (neighbouring lanes read neighbouring words)
//     and padded with always-true conditions to a multiple of four and
//     with never-matching stages to a multiple of W, so the test runs
//     without branches, and loads its weight from the row's override row
//     (coalesced).  The weight total is a segmented scan and the match
//     count a popcount of the segment's ballot; the choice is the first
//     lane whose running sum, carried across chunks when S > 32, passes
//     r, found by ballot and __ffs.  The owning lane takes it by shuffle;
//   - timers, per lane for its own row.
// The segment width is a template parameter, so its scans unroll.  Lanes
// past n take part in every ballot, shuffle and barrier as inactive
// rows.
// Matching, choice and draws run only for rows that rematch this tick:
// the reference computes them for every row and discards the rest, and a
// row's draws depend on nothing but the key and its index, so skipping
// them changes no bit.  That index is global: a shard passes the index
// of its first row as row_offset, so a sharded run draws exactly what an
// unsharded one does.
//
// The key chain (split(key, 3) each tick) does not depend on the data.
// A one-thread kernel computes it first into a [K, 4] schedule and
// writes the final key and clock into fresh output tensors, so no block
// of the row kernel can see a clock or key that another has advanced.
//
// Arithmetic follows XLA exactly: int32 adds that may overflow go
// through uint32, and the weight total and running sum are uint32 sums
// read as int32, which is what the reference's wrapping int32 sum and
// cumsum give in any order of addition; float32 products are one
// rounded multiply then a truncation toward zero (__int2float_rn,
// __fmul_rn, __float2int_rz).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int LD = BLOCK + 1;  // row stride of the shared feature tile
constexpr unsigned FULL = 0xFFFFFFFFu;
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

// A condition of the shared table is {x, mask} with x = 2 * (the tile
// offset of its column) + 1 if negated.  An unused condition slot holds
// {1, 0}, which always passes, a padding stage {0, 0}, which never does.
constexpr int KC_STEP = 4;  // conditions are tested KC_STEP at a time

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
  const int2* cond;      // [KC4][SP] conditions
  const int32_t* sw;     // [SP] static weight, 0 for a padding stage
  const int32_t* sd;     // [S] static delay
  const int32_t* sj;     // [S] static jitter
  const int32_t* sflag;  // [S] F_* bits
  int32_t* feat;         // [C][LD]: column c of the block's row r at c * LD + r
};

// Segment width: W = 1 << logw lanes, the smallest power of two, at
// least 2, that is >= min(S, 32).
inline int segment_logw(int S) {
  int logw = 1;
  while ((1 << logw) < S && logw < 5) ++logw;
  return logw;
}

// The shared condition table's padded sizes: KC up to a multiple of
// KC_STEP, S up to a multiple of the segment width.
__host__ __device__ inline int padded_kc(int KC) {
  return (KC + KC_STEP - 1) / KC_STEP * KC_STEP;
}
inline int padded_s(int S) {
  const int w = 1 << segment_logw(S);
  return (S + w - 1) / w * w;
}

// Inclusive sum over the lanes of a segment of W lanes, in uint32.
template <int W>
__device__ __forceinline__ uint32_t segment_scan(uint32_t v, int sl) {
#pragma unroll
  for (int d = 1; d < W; d <<= 1) {
    const uint32_t t = __shfl_up_sync(FULL, v, d, W);
    if (sl >= d) v += t;
  }
  return v;
}

// Stage s (s < SP; a padding stage past S never matches) for block row
// r: its selector match, and its weight when it matched with a positive
// weight (else 0).
__device__ __forceinline__ void probe(const Shared& sh, const int32_t* ovw_row, int s, int r,
                                      int S, int KC4, int SP, bool& m, uint32_t& pw) {
  const int32_t w_over = s < S ? __ldg(ovw_row + s) : SENTINEL;
  const int32_t* f = sh.feat + r;
  const int2* c = sh.cond + s;
  bool hit = true;
  for (int k = 0; k < KC4; k += KC_STEP) {
#pragma unroll
    for (int j = 0; j < KC_STEP; ++j) {
      const int2 q = c[(k + j) * SP];
      hit &= ((f[q.x >> 1] & q.y) != 0) != (q.x & 1);
    }
  }
  const int32_t w = w_over != SENTINEL ? w_over : sh.sw[s];
  m = hit;
  pw = (hit && w > 0) ? (uint32_t)w : 0u;
}

// Match and weighted choice for block row r by the W = 1 << LOGW lanes
// of one segment; every lane of the segment returns the row's next stage
// (IDLE when no stage matches).  u is the row's choice uniform.  Called
// by all 32 lanes together.
template <int LOGW>
__device__ __forceinline__ int32_t choose(const Shared& sh, const int32_t* ovw_row, int r,
                                          float u, int S, int KC4, int SP, int lane) {
  constexpr int W = 1 << LOGW;
  constexpr unsigned BITS = W == 32 ? FULL : (1u << (W & 31)) - 1u;
  const int sl = lane & (W - 1);
  const int shift = lane & ~(W - 1);  // where the segment's bits sit in a ballot
  const unsigned upto = (2u << sl) - 1u;  // this lane and the ones before it
  const int chunks = SP >> LOGW;
  // stages 0..W-1: match, positive weight, running sum of the weights
  bool m;
  uint32_t pw;
  probe(sh, ovw_row, sl, r, S, KC4, SP, m, pw);
  const uint32_t cw0 = segment_scan<W>(pw, sl);
  const unsigned mb0 = (__ballot_sync(FULL, m) >> shift) & BITS;
  const uint32_t tw0 = __shfl_sync(FULL, cw0, W - 1, W);
  uint32_t total = tw0;
  int32_t nmatch = __popc(mb0);
  for (int ch = 1; ch < chunks; ++ch) {
    probe(sh, ovw_row, (ch << LOGW) + sl, r, S, KC4, SP, m, pw);
    total += __shfl_sync(FULL, segment_scan<W>(pw, sl), W - 1, W);
    nmatch += __popc((__ballot_sync(FULL, m) >> shift) & BITS);
  }
  // weighted among the positive weights when their total is positive,
  // else uniform among the matched
  const bool use_w = (int32_t)total > 0;
  const int32_t ptot = use_w ? (int32_t)total : nmatch;
  int32_t lim = scale_trunc(u, ptot);
  lim = min(lim, max(wsub(ptot, 1), 0));
  // the first stage whose running sum, read as int32, passes lim; when
  // any stage matches, the last one does (its running sum is ptot), so
  // the padding stages after it need no test
  const uint32_t cum0 = use_w ? cw0 : (uint32_t)__popc(mb0 & upto);
  const unsigned hit0 = (__ballot_sync(FULL, (int32_t)cum0 > lim) >> shift) & BITS;
  int32_t choice = hit0 ? __ffs(hit0) - 1 : -1;
  if (chunks > 1) {
    uint32_t carry = use_w ? tw0 : (uint32_t)__popc(mb0);
    for (int ch = 1; ch < chunks; ++ch) {
      const int s = (ch << LOGW) + sl;
      probe(sh, ovw_row, s, r, S, KC4, SP, m, pw);
      const uint32_t cw = segment_scan<W>(pw, sl);
      const unsigned mb = (__ballot_sync(FULL, m) >> shift) & BITS;
      const uint32_t cum = carry + (use_w ? cw : (uint32_t)__popc(mb & upto));
      const unsigned hit = (__ballot_sync(FULL, (int32_t)cum > lim) >> shift) & BITS;
      if (choice < 0 && hit) choice = (ch << LOGW) + __ffs(hit) - 1;
      carry += use_w ? __shfl_sync(FULL, cw, W - 1, W) : (uint32_t)__popc(mb);
    }
  }
  // argmax of an all-false mask is 0
  return ptot > 0 ? max(choice, 0) : IDLE;
}

// Copies the block's [count / C, C] rows of features between device
// memory g and the transposed shared tile, 16 bytes at a time where g is
// aligned for it.
template <bool TO_DEVICE>
__device__ __forceinline__ void tile_copy(int32_t* g, int32_t* feat, int count, int C) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int nv = count >> 2;
    int4* g4 = reinterpret_cast<int4*>(g);
    for (int v = threadIdx.x; v < nv; v += BLOCK) {
      int r = (4 * v) / C;
      int c = 4 * v - r * C;
      int o[4];  // tile offsets of the vector's four elements
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = c * LD + r;
        if (++c == C) {
          c = 0;
          ++r;
        }
      }
      if (TO_DEVICE) {
        g4[v] = make_int4(feat[o[0]], feat[o[1]], feat[o[2]], feat[o[3]]);
      } else {
        const int4 q = g4[v];
        feat[o[0]] = q.x;
        feat[o[1]] = q.y;
        feat[o[2]] = q.z;
        feat[o[3]] = q.w;
      }
    }
    done = nv << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += BLOCK) {
    const int r = i / C;
    const int c = i - r * C;
    if (TO_DEVICE) {
      g[i] = feat[c * LD + r];
    } else {
      feat[c * LD + r] = g[i];
    }
  }
}

// Blocks of 128 rows and at most 48 registers a thread, so that ten
// blocks fit on an SM: the tick's chains of shuffles, shared loads and
// barriers want many warps, and smaller blocks wait less at a barrier.
template <int MODE, int LOGW>
__global__ void __launch_bounds__(BLOCK, 10) tick_rows_kernel(TickArgs a) {
  constexpr int PER_WARP = 32 >> LOGW;  // rematching rows a pass serves
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ unsigned remask[BLOCK / 32];  // each warp's rematching rows this tick
  __shared__ float qu[BLOCK];              // the block's rows' choice uniforms
  __shared__ float qj[BLOCK];              // and jitter uniforms
  const int S = a.S, KC = a.KC, C = a.C;
  const int KC4 = padded_kc(KC), SP = ((S + (1 << LOGW) - 1) >> LOGW) << LOGW;
  int2* cond = reinterpret_cast<int2*>(smem);
  int32_t* sw = smem + 2 * KC4 * SP;
  int32_t* sd = sw + SP;
  int32_t* sj = sd + S;
  int32_t* sflag = sj + S;
  int32_t* feat = sflag + S;

  const int tid = threadIdx.x;
  for (int i = tid; i < KC4 * SP; i += BLOCK) {
    const int k = i / SP;
    const int s = i - k * SP;
    int2 q = make_int2(s < S ? 1 : 0, 0);
    if (s < S && k < KC && a.cond_valid[s * KC + k]) {
      q = make_int2(2 * a.cond_col[s * KC + k] * LD + (a.cond_neg[s * KC + k] ? 1 : 0),
                    a.cond_mask[s * KC + k]);
    }
    cond[i] = q;
  }
  for (int s = tid; s < SP; s += BLOCK) sw[s] = s < S ? a.w_static[s] : 0;
  for (int s = tid; s < S; s += BLOCK) {
    sd[s] = a.d_static[s];
    sj[s] = a.j_static[s];
    sflag[s] = (a.has_jitter[s] ? F_HAS_JITTER : 0) |
               (a.d_from_del_ts[s] ? F_D_FROM_DEL_TS : 0) |
               (a.j_from_del_ts[s] ? F_J_FROM_DEL_TS : 0) |
               (a.stage_delete[s] ? F_DELETE : 0);
  }
  const int64_t row0 = (int64_t)blockIdx.x * BLOCK;
  const int64_t left = a.n - row0;
  const int nrows = left < BLOCK ? (int)left : BLOCK;
  tile_copy<false>(a.features + row0 * C, feat, nrows * C, C);
  __syncthreads();
  const Shared sh{cond, sw, sd, sj, sflag, feat};

  // Every thread runs every tick, lanes past n as inactive rows, so that
  // each ballot, shuffle and barrier has the whole warp and block.
  const int lane = tid & 31;
  const int wrow = tid - lane;  // block row of the warp's lane 0
  const int seg = lane >> LOGW;
  const int64_t row = row0 + tid;
  const bool mine = tid < nrows;
  int32_t sg = 0, oc = 0, dts = SENTINEL, st = IDLE, fa = NEVER;
  bool act = false, rm = false;
  if (mine) {
    sg = clampi(a.sig[row], 0, a.SIG - 1);
    oc = clampi(a.ovc[row], 0, a.OVC - 1);
    dts = a.del_ts[row];
    st = a.stage[row];
    fa = a.fire_at[row];
    act = a.active[row] != 0;
    rm = a.rematch[row] != 0;
  }
  const int32_t ov_off = oc * S;       // OVC * S < 2**31 (kwok_tick_rows)
  const int32_t eff_sig = sg * S * C;  // SIG * S * C < 2**31
  int8_t* stage_out = MODE == MODE_COLLECT ? a.stages + row : nullptr;
  int32_t now = *a.now_in;
  int32_t fired_total = 0;

  for (int t = 0; t < a.num_ticks; ++t) {
    now = wadd(now, a.dt_ms);
    // 1. fire
    const bool fired = act && st >= 0 && fa <= now;
    const int32_t sc = clampi(st, 0, S - 1);
    // 2. effects of the fired stage: lane c loads column c of a fired
    // row's (mode, value) pairs; two rows at a time, one a half-warp,
    // when C <= 16
    const int32_t eff_off = eff_sig + sc * C;
    unsigned fm = __ballot_sync(FULL, fired);
    if (C <= 16) {
      const int c = lane & 15;
      while (fm) {
        const int src0 = __ffs(fm) - 1;
        fm &= fm - 1;
        const int src1 = __ffs(fm) - 1;  // -1 when there is no second row
        fm &= fm - 1;
        const int src = lane < 16 ? src0 : src1;
        const int32_t off = __shfl_sync(FULL, eff_off, src < 0 ? 0 : src);
        if (src >= 0 && c < C) {
          const int32_t md = __ldg(a.eff_mode + (off + c));
          const int32_t v = __ldg(a.eff_val + (off + c));
          if (md == 1) feat[c * LD + wrow + src] = v;
        }
      }
    } else {
      for (; fm; fm &= fm - 1) {
        const int src = __ffs(fm) - 1;
        const int32_t off = __shfl_sync(FULL, eff_off, src);
        for (int c = lane; c < C; c += 32) {
          const int32_t md = __ldg(a.eff_mode + (off + c));
          const int32_t v = __ldg(a.eff_val + (off + c));
          if (md == 1) feat[c * LD + wrow + src] = v;
        }
      }
    }
    const bool del_now = fired && (sflag[sc] & F_DELETE);
    act = act && !del_now;
    // 3. rematch: fresh transitions and host-forced
    const bool do_match = act && (fired || rm);
    const int32_t old_stage = st;
    const unsigned todo = __ballot_sync(FULL, do_match);
    if (lane == 0) remask[tid >> 5] = todo;
    // the barrier also orders the effects before the match reads them
    const int nq = __syncthreads_count(do_match);
    if (nq > 0) {
      // 4a. draws, compacted over the block: thread i draws both
      // uniforms of the block's i-th rematching row
      if (tid < nq) {
        int k = tid, w = 0;
        unsigned m = remask[0];
        for (int c = __popc(m); k >= c; c = __popc(m)) {
          k -= c;
          m = remask[++w];
        }
        for (; k > 0; --k) m &= m - 1;
        const int r = (w << 5) + __ffs(m) - 1;
        const uint32_t urow = (uint32_t)(a.row_offset + row0 + r);
        const kwok::Key kc{__ldg(a.sched + 4 * t + 0), __ldg(a.sched + 4 * t + 1)};
        const kwok::Key kj{__ldg(a.sched + 4 * t + 2), __ldg(a.sched + 4 * t + 3)};
        qu[r] = kwok::uniform_at(kc, urow);
        qj[r] = kwok::uniform_at(kj, urow);
      }
      __syncthreads();
    }
    if (todo) {
      // 4b. match + weighted choice, a segment per rematching row
      int32_t ns = IDLE;
      for (unsigned pend = todo; pend;) {
        unsigned m = pend;
        for (int i = 0; i < seg; ++i) m &= m - 1;
        const int src = m ? __ffs(m) - 1 : 0;  // this segment's row this pass
        const int32_t soc = __shfl_sync(FULL, oc, src);
        const int32_t got =
            choose<LOGW>(sh, a.ov_w + soc * S, wrow + src, qu[wrow + src], S, KC4, SP, lane);
        const bool pending = (pend >> lane) & 1u;
        const int rank = __popc(pend & ((1u << lane) - 1u));
        const int32_t back = __shfl_sync(FULL, got, (rank & (PER_WARP - 1)) << LOGW);
        if (pending && rank < PER_WARP) ns = back;
        pend = __ballot_sync(FULL, pending && rank >= PER_WARP);
      }
      if (do_match) {
        // 5. timers
        const bool any_match = ns != IDLE;
        const int32_t nsc = clampi(ns, 0, S - 1);
        const int32_t d_over = __ldg(a.ov_d + (ov_off + nsc));
        const int32_t j_over = __ldg(a.ov_j + (ov_off + nsc));
        const bool has_dl = dts != SENTINEL;
        const int flags = sflag[nsc];
        int32_t d = d_over != SENTINEL ? d_over : sd[nsc];
        if ((flags & F_D_FROM_DEL_TS) && has_dl) d = wsub(dts, now);
        int32_t j = j_over != SENTINEL ? j_over : sj[nsc];
        if ((flags & F_J_FROM_DEL_TS) && has_dl) j = wsub(dts, now);
        const bool has_j = (flags & F_HAS_JITTER) && j != SENTINEL;
        int32_t delay = d;
        if (has_j) {
          if (j < d) {
            delay = j;
          } else {
            const int32_t span = max(wsub(j, d), 0);
            delay = wadd(d, scale_trunc(qj[tid], span));
          }
        }
        delay = max(delay, 0);
        st = ns;
        fa = any_match ? wadd(now, delay) : NEVER;
      }
    }
    if (!act) fa = NEVER;
    rm = false;
    fired_total += fired ? 1 : 0;
    if (mine) {
      if (MODE == MODE_COLLECT) {
        *stage_out = (int8_t)(fired ? old_stage : IDLE);
      } else if (MODE == MODE_SINGLE) {
        a.fired[row] = fired;
        a.fired_stage[row] = fired ? old_stage : IDLE;
        a.deleted[row] = del_now;
      }
    }
    if (MODE == MODE_COLLECT) stage_out += a.n;
  }
  if (mine) {
    a.stage[row] = st;
    a.fire_at[row] = fa;
    a.active[row] = act;
    a.rematch[row] = 0;
  }
  __syncthreads();
  tile_copy<true>(a.features + row0 * C, feat, nrows * C, C);
  if (MODE != MODE_COLLECT) {
    // block sum of fires, then one atomic add (integer, so exact)
    int32_t v = fired_total;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
    __shared__ int32_t warp_sums[BLOCK / 32];
    if (lane == 0) warp_sums[tid >> 5] = v;
    __syncthreads();
    if (tid < 32) {
      v = tid < BLOCK / 32 ? warp_sums[tid] : 0;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
      if (tid == 0 && v != 0) atomicAdd(a.count, v);
    }
  }
}

template <int MODE, int LOGW>
cudaError_t launch_rows(const TickArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tick_rows_kernel<MODE, LOGW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.n + BLOCK - 1) / BLOCK);
  tick_rows_kernel<MODE, LOGW><<<grid, BLOCK, smem, stream>>>(a);
  return cudaGetLastError();
}

// The row kernel of this mode at the segment width of a.S.
template <int MODE>
cudaError_t launch_mode(const TickArgs& a, size_t smem, cudaStream_t stream) {
  switch (segment_logw(a.S)) {
    case 1:
      return launch_rows<MODE, 1>(a, smem, stream);
    case 2:
      return launch_rows<MODE, 2>(a, smem, stream);
    case 3:
      return launch_rows<MODE, 3>(a, smem, stream);
    case 4:
      return launch_rows<MODE, 4>(a, smem, stream);
    default:
      return launch_rows<MODE, 5>(a, smem, stream);
  }
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

// Dynamic shared memory the row kernel needs for these widths: the
// padded [KC4][SP] condition pairs and [SP] weights, the three [S] stage
// tables and the [C][LD] feature tile.
size_t kwok_tick_smem_bytes(int32_t S, int32_t KC, int32_t C) {
  const size_t sp = padded_s(S);
  return sizeof(int32_t) *
         (2 * (size_t)padded_kc(KC) * sp + sp + 3 * (size_t)S + (size_t)C * LD);
}

// Runs the key schedule, then num_ticks ticks over every row.  Returns
// the first CUDA error, 0 on a clean launch.
int kwok_tick_rows(const TickArgs* args, void* stream) {
  const TickArgs a = *args;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.num_ticks <= 0 || a.n <= 0 || a.S <= 0 || a.KC <= 0 || a.C <= 0 ||
      a.SIG <= 0 || a.OVC <= 0 || a.row_offset < 0 ||
      a.row_offset + a.n > 0x100000000ll || (int64_t)a.SIG * a.S * a.C > 0x7FFFFFFFll ||
      (int64_t)a.OVC * a.S > 0x7FFFFFFFll) {
    return (int)cudaErrorInvalidValue;
  }
  key_schedule_kernel<<<1, 1, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = kwok_tick_smem_bytes(a.S, a.KC, a.C);
  switch (a.mode) {
    case MODE_SINGLE:
      err = launch_mode<MODE_SINGLE>(a, smem, s);
      break;
    case MODE_COLLECT:
      err = launch_mode<MODE_COLLECT>(a, smem, s);
      break;
    case MODE_COUNT:
      err = launch_mode<MODE_COUNT>(a, smem, s);
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
