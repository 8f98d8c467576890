// Window-batched fused multi-head attention with a periodic additive bias
// (Swin's window attention) on the packed projection output, for Hopper
// (sm_90a): the forward, and the backward with d(bias).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/fused_mha_bias.py
// `fused_mha_bias` (its forward `_fwd_kernel` and its backward
// `_bwd_kernel`). Same function, not the same plan. A TPU program holds a
// whole [S, S] score matrix and the bias block of a head group in VMEM, and
// its backward accumulates d(bias) in an output block that stays resident
// while a sequential grid sweeps the batch rows of one period index. Here a
// score row does not fit shared memory next to the tiles, and blocks run in
// parallel in no order.
//
//   qkv  [B, S, 3F] (F = nh * D), [q heads | k heads | v heads], read in
//        place: q of head h at column h * D, k at F + h * D, v at 2F + h * D
//   bias [R, nh, S, S] f32; batch row b uses bias[b mod R]
//   out  [B, S, F]; dout [B, S, F]; dqkv [B, S, 3F]; dbias [R, nh, S, S]
//   s = (q . k) * scale + bias; sigma = softmax(s) in f32; out = sigma v
//   with sigma rounded to the input type before the product (bf16).
//   backward: dsigma = dO . v; ds = sigma (dsigma - r), r = sum_j dsigma_j
//   sigma_j, in f32; dbias[r] = sum_t ds[t * R + r] in f32; dq = scale ds
//   k, dk = scale ds^T q (ds rounded before its products), dv = sigma^T dO
//   (rounded before it). Tail columns past S (S = 392 and 196 are not
//   multiples of the tiles) score -inf, so they never enter a max or a sum.
//
// Bound: bytes. At swin-t's first stage (B = 256 sequences of S = 392, nh
// = 3, D = 32) the forward reads qkv (57.8 MB) and the bias (14.7 MB) and
// writes 19.3 MB; the full S x S products are 15.1 GFLOP, and the live
// blocks below 39% of that. The TPU kernel does the full S x S work, 8x
// (W_g = 8) or 4x (W_g = 4) the work of attention window by window,
// because the bias carries -1e9 between the grouped windows (and inside
// the shifted windows). The bf16 kernels skip that work (mhb_*):
//   * a live-block plan read from the bias values and nothing else (no
//     window length or W_g reaches the kernels; the function takes any
//     bias): mhb_plan, a first launch of the forward entry point, marks
//     (query tile, key tile) pairs of 64 x 64 of each bias[r, h] live
//     where an entry exceeds -5e8 (kLive), in plan [R, nh, nt, nt]
//     uint8. A query tile holding a row with no live entry keeps every key
//     tile: the full pass gives that row its near-uniform softmax over all
//     keys. ops/fused_mha_bias.py `fused_mha_bias_plan` is its plain twin.
//   * Skipping is exact. A skipped entry has bias <= -5e8 and its row has
//     a live entry, so its weight exp(s - m) is 0 in f32 whenever the gap
//     between the row's best live score and the skipped score exceeds 104
//     (exp underflows to 0): for a bias whose masked entries are <= -1e9
//     and live ones >= -b_live, as long as |q . k * scale| < (1e9 - b_live
//     - 104) / 2, about 5e8 for Swin. The full pass's sums are the skipped
//     ones plus exact zeros, and an online softmax that starts on a dead
//     tile rescales it by exp(-1e9 - m) = 0: the results agree.
//   * Every pass honours the plan. The forward (mhb_fwd: one CTA per 64
//     query rows x head x two batch rows, key sub-tiles of 64) visits the
//     live key tiles of its query tile's plan row, and saves the row
//     statistics m and 1/l (f32 [2, B, nh, S]) with the plan for the
//     backward. The backward does no statistics
//     pass: mhb_dq sweeps the live key tiles twice in one pipeline, first
//     summing r exactly from the scores and dP = dO V^T (r from the
//     rounded output fails the per-row limit on rows that sit on few
//     keys, which Swin's shifted windows have), then forming dS and dQ;
//     it stores r. mhb_db runs one CTA per 64 x 64 block of dbias[r, h]:
//     a dead block is written as zeros with no loads; a live one walks
//     the batch rows t * R + r in order of t through a ring of 1-3 stages
//     (the next rows' q, dO, k, v tiles and row statistics in flight while
//     this row's are used), summing dS in registers (the TPU kernel's
//     order, no atomics: two launches agree bitwise), and writes the
//     block once. mhb_dkv (one CTA per 64 key rows, the products
//     transposed) visits the live query tiles of its key tile's plan
//     column: FA-2's dK/dV. These passes double-buffer their other
//     sequence's tiles and bias blocks through shared memory with
//     cp.async.
//   * The bias tile is most of what a tile moves (16 KB f32 against 8 KB
//     of K and V at head dim 32). So a CTA of the forward, dQ and dK/dV
//     takes two batch rows of one period, one per group of 4 warps, and
//     stages each bias block once for both (one row a CTA at head dim 256,
//     for shared memory). The bias is staged as 16-byte row pieces, not
//     read per lane from L2, and so are the row statistics of dK/dV and
//     d(bias).
//   * Latency. After skipping, a CTA sees 2-3 key tiles, so its prologue
//     counts: one warp reads its plan row (32 tiles a load) and places
//     the live tiles by a ballot, and the many small CTAs hide each
//     other's loads. Measured on an H100, CTAs that walked several batch
//     rows one after another, their bias blocks resident in shared memory,
//     ran slower (1.2-1.8x): two an SM, fewer in the grid.
//   * mma.sync m16n8k16 bf16 x bf16 -> f32, each warp owning 16 rows of the
//     CTA's block, so the row statistics reduce inside a quad of lanes; P
//     and dS go from the accumulators to the next product's A operand in
//     registers. At head dim 32 the tensor cores are not the limit (one
//     [S, S] x 32 product at stage 1 is 7.5 GFLOP, about 8 us).
// f32 (parity runs, not speed): the full S x S work with plain FMAs on the
// CUDA cores (never TF32), one warp per row and one lane per column of a
// 32-wide tile of the other sequence, and a four-pass backward that
// recomputes the row statistics (bias_*_f32). Head dims: any multiple of 8
// up to 256, built for D buckets of 32, 64, 128 and 256.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attention_tiles.cuh"

namespace {

using namespace tiles;
constexpr float kNeg = -1e30f;  // the running max's start, below any score

struct Params {
  const void* qkv;    // [B, S, 3F]
  const float* bias;  // [R, nh, S, S]
  const void* dout;   // [B, S, F] (backward)
  void* out;          // forward: [B, S, F]; backward: dqkv [B, S, 3F]
  float* dbias;       // backward: [R, nh, S, S]
  float* m;           // row statistics [B, nh, S]: the max,
  float* il;          //   1 / sum of exp(s - max),
  float* r;           //   and the in-row term
  unsigned char* plan;  // bf16: live (query tile, key tile) [R, nh, nt, nt]
  int B, S, nh, D, F, R;
  int nt;             // ceil(S / 64), the plan's tiles a side
  float scale;
};

// ------------------------------------------------------------ helpers
// row `row` of bias[period, h] (rows past S read row S - 1: their results
// are never stored)
__device__ __forceinline__ long long bias_row(const Params& p, int period,
                                              int h, int row) {
  return (((long long)period * p.nh + h) * p.S + min(row, p.S - 1)) * p.S;
}
// the score of (row, col) from the scaled product x: -inf past the
// sequence (a tile's tail, outside the softmax), else x plus the bias
__device__ __forceinline__ float biased(float x, const float* brow, int col,
                                        int S) {
  return col < S ? x + brow[col] : -INFINITY;
}

// the bf16 kernels' views of one (batch row, head)
struct Bf16Head {
  const bf16 *q, *k, *v, *dout;
};
__device__ __forceinline__ Bf16Head bf16_head(const Params& p, int b, int h) {
  Bf16Head v;
  v.q = static_cast<const bf16*>(p.qkv) + (long long)b * p.S * 3 * p.F +
        (long long)h * p.D;
  v.k = v.q + p.F;
  v.v = v.q + 2 * p.F;
  v.dout = p.dout ? static_cast<const bf16*>(p.dout) +
                        (long long)b * p.S * p.F + (long long)h * p.D
                  : nullptr;
  return v;
}

// ------------------------------------------------------- bf16: the plan
constexpr float kLive = -5e8f;  // a bias entry above this is live
constexpr int PT = 64;          // plan tiles: 64 query rows x 64 keys

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// bias[period, h] as a pointer to its [S, S] matrix
__device__ __forceinline__ const float* bias_head(const Params& p, int period,
                                                  int h) {
  return p.bias + ((long long)period * p.nh + h) * p.S * p.S;
}

// the plan's byte of (period, h, query tile qt, key tile 0)
__device__ __forceinline__ const unsigned char* plan_row(const Params& p,
                                                         int period, int h,
                                                         int qt) {
  return p.plan + (((long long)period * p.nh + h) * p.nt + qt) * p.nt;
}

// Stage the f32 block rows [row0, row0 + ROWS) x columns [col0, col0 +
// COLS) of a bias matrix bh [S, S] into dst [ROWS][ld]: 16-byte copies
// when S is a multiple of 4 (every row 16-byte aligned), else 4-byte
// ones; entries past S are zero-filled (the passes score them -inf).
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_bias(float* dst, int ld, const float* bh,
                                           int S, int row0, int col0,
                                           int tid) {
  if ((S & 3) == 0) {
    constexpr int CPR = COLS / 4;
#pragma unroll 4
    for (int c = tid; c < ROWS * CPR; c += kThreads) {
      const int r = c / CPR, cc = (c % CPR) * 4;
      const bool ok = row0 + r < S && col0 + cc < S;
      cp_async16(dst + r * ld + cc,
                 ok ? bh + (long long)(row0 + r) * S + col0 + cc : bh, ok);
    }
  } else {
    for (int c = tid; c < ROWS * COLS; c += kThreads) {
      const int r = c / COLS, cc = c % COLS;
      const bool ok = row0 + r < S && col0 + cc < S;
      cp_async4(dst + r * ld + cc,
                ok ? bh + (long long)(row0 + r) * S + col0 + cc : bh, ok);
    }
  }
}

// stage the n floats src[0, n) (entries at or past `valid` zero-filled)
// into dst
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int n,
                                          int valid, int tid) {
  for (int i = tid; i < n; i += kThreads)
    cp_async4(dst + i, i < valid ? src + i : src, i < valid);
}

// The starts of the BK-wide sub-tiles of the live plan tiles, in order,
// into list; `pl` walks the plan's tiles with stride `stride` (a query
// tile's row of key tiles: 1; a key tile's column of query tiles: nt).
// One warp reads 32 tiles' bytes at once and places them by a ballot.
// With `all_if_none` an empty list becomes every sub-tile.
template <int BK>
__device__ __forceinline__ int live_list(const unsigned char* pl, int stride,
                                         int nt, int S, short* list,
                                         bool all_if_none) {
  constexpr int SUB = PT / BK;
  __shared__ int count;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, last = nt - 1;
    // sub-tiles of the last tile, which S may cut short
    const int last_subs = (S - last * PT + BK - 1) / BK;
    int n = 0;
    for (int i0 = 0; i0 < nt; i0 += 32) {
      const int i = i0 + lane;
      const bool live = i < nt && pl[(long long)i * stride] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int at = n + __popc(m & ((1u << lane) - 1)) * SUB;
        for (int c = 0; c < (i == last ? last_subs : SUB); ++c)
          list[at + c] = static_cast<short>(i * PT + c * BK);
      }
      n += __popc(m) * SUB;
      if (last - i0 < 32 && last >= i0 && ((m >> (last - i0)) & 1))
        n -= SUB - last_subs;
    }
    if (n == 0 && all_if_none) {
      for (int c = lane * BK; c < S; c += 32 * BK)
        list[c / BK] = static_cast<short>(c);
      n = (S + BK - 1) / BK;
    }
    if (lane == 0) count = n;
  }
  __syncthreads();
  return count;
}

// grid (nt, nh, R), kPlanThreads: which key tiles of rows [64 qt, 64 qt +
// 64) of bias[period, h] hold a live entry, a warp a row at a time with
// four 16-byte loads a lane in flight. A query tile with a row that has
// no live entry keeps every key tile (the full pass gives that row its
// near-uniform softmax over all keys). Writes plan[period, h, qt, :].
constexpr int kPlanThreads = 512;
__global__ void __launch_bounds__(kPlanThreads) mhb_plan(Params p) {
  __shared__ int live[512];  // nt <= 512 (S < 32768)
  __shared__ int dead_row;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = blockIdx.x, h = blockIdx.y, period = blockIdx.z;
  for (int i = tid; i < p.nt; i += kPlanThreads) live[i] = 0;
  if (tid == 0) dead_row = 0;
  __syncthreads();
  const float* bh = bias_head(p, period, h);
  for (int rr = warp; rr < PT; rr += kPlanThreads / 32) {
    const int row = qt * PT + rr;
    if (row >= p.S) break;
    const float* br = bh + (long long)row * p.S;
    bool any = false;
    if ((p.S & 3) == 0) {  // 16-byte loads, 128 columns a load, 4 at once
      for (int c0 = 0; c0 < p.S; c0 += 512) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + 128 * u + 4 * lane;
          v[u] = c < p.S ? *reinterpret_cast<const float4*>(br + c)
                         : make_float4(kNeg, kNeg, kNeg, kNeg);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool hit = v[u].x > kLive || v[u].y > kLive ||
                           v[u].z > kLive || v[u].w > kLive;
          const unsigned m = __ballot_sync(0xffffffffu, hit);
          const int t0 = (c0 + 128 * u) / PT;
          if (lane == 0 && (m & 0xffffu)) live[t0] = 1;
          if (lane == 0 && (m >> 16)) live[t0 + 1] = 1;
          any |= m != 0;
        }
      }
    } else {
      for (int c0 = 0; c0 < p.S; c0 += 32) {
        const int c = c0 + lane;
        const unsigned m =
            __ballot_sync(0xffffffffu, c < p.S && br[c] > kLive);
        if (lane == 0 && m) live[c0 / PT] = 1;
        any |= m != 0;
      }
    }
    if (lane == 0 && !any) dead_row = 1;
  }
  __syncthreads();
  unsigned char* out = p.plan +
                       (((long long)period * p.nh + h) * p.nt + qt) * p.nt;
  for (int i = tid; i < p.nt; i += kPlanThreads)
    out[i] = dead_row ? 1 : static_cast<unsigned char>(live[i]);
}

// The batch row of thread group `half` (of RW) of a forward, dQ or dK/dV
// CTA: grid.z = R * ceil(B / R / RW) runs the rows t * R + period of one
// period RW at a time, t = RW * (z / R) + half, so the groups share their
// bias blocks, staged once for all of them. A group past the period's
// last row recomputes that row and stores nothing (own = false).
struct PairRow {
  int b, period;
  bool own;
};
template <int RW>
__device__ __forceinline__ PairRow pair_row(const Params& p, int half) {
  PairRow r;
  const int rows = p.B / p.R, t = blockIdx.z / p.R * RW + half;
  r.period = blockIdx.z % p.R;
  r.own = t < rows;
  r.b = min(t, rows - 1) * p.R + r.period;
  return r;
}

// ------------------------------------------------------------ bf16 forward
// grid (nt, nh, R * ceil(B / R / RW)); RW groups of 4 warps x 16 query
// rows, group i taking batch row b_i (see pair_row); the live key tiles of
// the query tile's plan row in sub-tiles of BK, each group's K and V and
// the shared bias block double-buffered; stores out and the row
// statistics m, 1/l.
template <int DM, int BK, int RW>
__global__ void __launch_bounds__(kThreads * RW) mhb_fwd(Params p) {
  constexpr int BQ = 64, LD = DM + 8, NT = BK / 8, BL = BK + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = threadIdx.x / kThreads;
  bf16* Qs = reinterpret_cast<bf16*>(smem) + half * BQ * LD;  // [RW][BQ][LD]
  bf16* Ks = reinterpret_cast<bf16*>(smem) + RW * BQ * LD +
             half * 4 * BK * LD;  // [RW][K, V][2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;
  // [2][BQ][BL]
  float* Bs = reinterpret_cast<float*>(reinterpret_cast<bf16*>(smem) +
                                       RW * (BQ + 4 * BK) * LD);
  short* list = reinterpret_cast<short*>(Bs + 2 * BQ * BL);
  const int tid = threadIdx.x % kThreads, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x, q0 = qt * BQ, h = blockIdx.y;
  const PairRow pr = pair_row<RW>(p, half);
  const int b = pr.b, period = pr.period;
  const long long rs = 3LL * p.F;
  const Bf16Head hp = bf16_head(p, b, h);
  const float* bh = bias_head(p, period, h);
  const int n = live_list<BK>(plan_row(p, period, h, qt), 1, p.nt, p.S, list,
                              true);
  auto stage_kv = [&](int buf, int k0) {
    stage<BK, DM>(Ks + buf * BK * LD, LD, hp.k, rs, k0, p.S, p.D, tid);
    stage<BK, DM>(Vs + buf * BK * LD, LD, hp.v, rs, k0, p.S, p.D, tid);
    stage_bias<BQ / RW, BK>(Bs + (buf * BQ + half * (BQ / RW)) * BL, BL, bh,
                            p.S, q0 + half * (BQ / RW), k0, tid);
  };
  stage<BQ, DM>(Qs, LD, hp.q, rs, q0, p.S, p.D, tid);
  stage_kv(0, list[0]);
  cp_async_commit();

  float o[DM / 8][4];
#pragma unroll
  for (int d = 0; d < DM / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int r0 = warp * 16 + g;  // this lane's rows r0 and r0 + 8

  for (int it = 0; it < n; ++it) {
    const int buf = it & 1, k0 = list[it];
    if (it + 1 < n) {
      stage_kv(buf ^ 1, list[it + 1]);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* K = Ks + buf * BK * LD;
    const bf16* V = Vs + buf * BK * LD;
    const float* Bb = Bs + buf * BQ * BL;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mm_abt<NT, DM>(s, Qs, K, LD, r0, g, t);

    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const float x = k0 + c < p.S ? s[j][e] * p.scale +
                                           Bb[(r0 + 8 * (e >> 1)) * BL + c]
                                     : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = __expf(m[r] - mn);
      m[r] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = __expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += x;
        s[j][e] = x;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = corr[r] * l[r] + quad_sum(sum[r]);
#pragma unroll
    for (int d = 0; d < DM / 8; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[0];
      o[d][2] *= corr[1];
      o[d][3] *= corr[1];
    }
    mm_pb<BK / 16, DM>(o, s, V, LD, g, t);
    __syncthreads();  // the next iteration overwrites this buffer
  }

  bf16* ob = static_cast<bf16*>(p.out) + (long long)b * p.S * p.F +
             (long long)h * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= p.S || !pr.own) continue;
    const float inv = 1.f / l[r];
    if (t == 0) {
      const long long i = ((long long)b * p.nh + h) * p.S + row;
      p.m[i] = m[r];
      p.il[i] = inv;
    }
    bf16* orow = ob + (long long)row * p.F;
#pragma unroll
    for (int d = 0; d < DM / 8; ++d) {
      const int col = d * 8 + 2 * t;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
    }
  }
}

// ----------------------------------------------- bf16 backward: r and dQ
// grid (nt, nh, R * ceil(B / R / RW)); RW groups of 4 warps x 16 query
// rows, group i taking batch row b_i (see pair_row). Two sweeps over the
// live key sub-tiles (BK wide) of the query tile's plan row, one
// pipeline: the first sums each row's r = sum_j sigma_j dsigma_j exactly
// (sigma from the forward's m and 1/l, dsigma = dO V^T), the second forms
// dS = sigma (dsigma - r) and dQ. Stores dQ and r (for the other passes).
template <int DM, int BK, int RW>
__global__ void __launch_bounds__(kThreads * RW) mhb_dq(Params p) {
  constexpr int BQ = 64, LD = DM + 8, NT = BK / 8, BL = BK + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = threadIdx.x / kThreads;
  // [RW][q, dout rows][BQ][LD], then [RW][K, V][2][BK][LD]
  bf16* Qs = reinterpret_cast<bf16*>(smem) + half * 2 * BQ * LD;
  bf16* Os = Qs + BQ * LD;
  bf16* Ks = reinterpret_cast<bf16*>(smem) + RW * 2 * BQ * LD +
             half * 4 * BK * LD;
  bf16* Vs = Ks + 2 * BK * LD;
  float* Bs = reinterpret_cast<float*>(reinterpret_cast<bf16*>(smem) +
                                       RW * (2 * BQ + 4 * BK) * LD);
  short* list = reinterpret_cast<short*>(Bs + 2 * BQ * BL);  // Bs [2][BQ][BL]
  const int tid = threadIdx.x % kThreads, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x, q0 = qt * BQ, h = blockIdx.y;
  const PairRow pr = pair_row<RW>(p, half);
  const int b = pr.b, period = pr.period;
  const long long rs = 3LL * p.F;
  const Bf16Head hp = bf16_head(p, b, h);
  const float* bh = bias_head(p, period, h);
  const int n = live_list<BK>(plan_row(p, period, h, qt), 1, p.nt, p.S, list,
                              true);
  auto stage_kv = [&](int buf, int k0) {
    stage<BK, DM>(Ks + buf * BK * LD, LD, hp.k, rs, k0, p.S, p.D, tid);
    stage<BK, DM>(Vs + buf * BK * LD, LD, hp.v, rs, k0, p.S, p.D, tid);
    stage_bias<BQ / RW, BK>(Bs + (buf * BQ + half * (BQ / RW)) * BL, BL, bh,
                            p.S, q0 + half * (BQ / RW), k0, tid);
  };
  stage<BQ, DM>(Qs, LD, hp.q, rs, q0, p.S, p.D, tid);
  stage<BQ, DM>(Os, LD, hp.dout, p.F, q0, p.S, p.D, tid);
  stage_kv(0, list[0]);
  cp_async_commit();

  const int r0 = warp * 16 + g;
  float mr[2], il[2], rr[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    const long long i = ((long long)b * p.nh + h) * p.S + row;
    mr[r] = row < p.S ? p.m[i] : 0.f;
    il[r] = row < p.S ? p.il[i] : 0.f;
  }
  float dq[DM / 8][4];
#pragma unroll
  for (int d = 0; d < DM / 8; ++d)
    dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  for (int it = 0; it < 2 * n; ++it) {
    const int buf = it & 1, k0 = list[it < n ? it : it - n];
    if (it + 1 < 2 * n) {
      stage_kv(buf ^ 1, list[it + 1 < n ? it + 1 : it + 1 - n]);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* K = Ks + buf * BK * LD;
    const bf16* V = Vs + buf * BK * LD;
    const float* Bb = Bs + buf * BQ * BL;
    if (it == n) {  // the first sweep is done: r of rows r0, r0 + 8
#pragma unroll
      for (int r = 0; r < 2; ++r) rr[r] = quad_sum(rr[r]);
    }
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mm_abt<NT, DM>(s, Qs, K, LD, r0, g, t);
    mm_abt<NT, DM>(dp, Os, V, LD, r0, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = j * 8 + 2 * t + (e & 1);
        const float x = k0 + c < p.S ? s[j][e] * p.scale +
                                           Bb[(r0 + 8 * r) * BL + c]
                                     : -INFINITY;
        s[j][e] = __expf(x - mr[r]) * il[r];  // sigma
      }
    if (it < n) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) rr[e >> 1] += s[j][e] * dp[j][e];
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = s[j][e] * (dp[j][e] - rr[e >> 1]);  // dS
      mm_pb<BK / 16, DM>(dq, s, K, LD, g, t);  // dS rounded to bf16 here
    }
    __syncthreads();
  }

  bf16* dqb = static_cast<bf16*>(p.out) + (long long)b * p.S * rs +
              (long long)h * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= p.S || !pr.own) continue;
    if (t == 0) p.r[((long long)b * p.nh + h) * p.S + row] = rr[r];
    bf16* drow = dqb + (long long)row * rs;
#pragma unroll
    for (int d = 0; d < DM / 8; ++d) {
      const int col = d * 8 + 2 * t;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(drow + col) = __floats2bfloat162_rn(
            dq[d][2 * r] * p.scale, dq[d][2 * r + 1] * p.scale);
    }
  }
}

// ----------------------------------------------------------- bf16 d(bias)
// grid (nt * nt, nh, R); 4 warps x 16 query rows. The CTA owns the 64 x 64
// block (query tile, key tile) of dbias[period = z, h]. A block the plan
// marks dead is written as zeros, with no loads. A live one keeps its
// bias entries (staged once) and its dS sums while it walks the batch
// rows b = t * R + period in order of t, with a ring of NB stages (q, dO,
// k and v tiles and the rows' m, 1/l and r): the next NB - 1 rows load
// while this one is used. It writes the block once at the end.
template <int DM, int NB>
__global__ void __launch_bounds__(kThreads) mhb_db(Params p) {
  constexpr int BQ = 64, BK = 64, LD = DM + 8, NT = BK / 8, BL = BK + 4;
  constexpr int TILE = BQ * LD;                        // elements of a tile
  constexpr int STAGE = 4 * TILE * 2 + 3 * BQ * 4;     // bytes of a stage
  extern __shared__ __align__(16) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem + NB * STAGE);  // [BQ][BL]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x / p.nt, kt = blockIdx.x % p.nt;
  const int q0 = qt * BQ, k0 = kt * BK;
  const int h = blockIdx.y, period = blockIdx.z;
  const long long rs = 3LL * p.F;
  float* db = p.dbias + ((long long)period * p.nh + h) * p.S * p.S;
  if (!plan_row(p, period, h, qt)[kt]) {
    for (int i = tid; i < BQ * BK; i += kThreads) {
      const int row = q0 + i / BK, col = k0 + i % BK;
      if (row < p.S && col < p.S) db[(long long)row * p.S + col] = 0.f;
    }
    return;
  }
  // stage `buf`: q, dout, k, v tiles, then m, 1/l, r of the 64 query rows
  auto stage_row = [&](int buf, int tb) {
    const int b = tb * p.R + period;
    const Bf16Head hp = bf16_head(p, b, h);
    bf16* T = reinterpret_cast<bf16*>(smem + buf * STAGE);
    stage<BQ, DM>(T, LD, hp.q, rs, q0, p.S, p.D, tid);
    stage<BQ, DM>(T + TILE, LD, hp.dout, p.F, q0, p.S, p.D, tid);
    stage<BK, DM>(T + 2 * TILE, LD, hp.k, rs, k0, p.S, p.D, tid);
    stage<BK, DM>(T + 3 * TILE, LD, hp.v, rs, k0, p.S, p.D, tid);
    float* St = reinterpret_cast<float*>(T + 4 * TILE);
    const long long st = ((long long)b * p.nh + h) * p.S + q0;
    stage_f32(St, p.m + st, BQ, p.S - q0, tid);
    stage_f32(St + BQ, p.il + st, BQ, p.S - q0, tid);
    stage_f32(St + 2 * BQ, p.r + st, BQ, p.S - q0, tid);
  };
  const int n_t = p.B / p.R;
  stage_bias<BQ, BK>(Bs, BL, bias_head(p, period, h), p.S, q0, k0, tid);
  cp_async_commit();
  for (int i = 0; i < NB - 1; ++i) {
    if (i < n_t) stage_row(i, i);
    cp_async_commit();
  }

  const int r0 = warp * 16 + g;
  float acc[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c)
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  for (int tb = 0; tb < n_t; ++tb) {
    const int nxt = tb + NB - 1;
    if (nxt < n_t) stage_row(nxt % NB, nxt);
    cp_async_commit();
    cp_async_wait<NB - 1>();
    __syncthreads();
    const bf16* T = reinterpret_cast<const bf16*>(smem + (tb % NB) * STAGE);
    const float* St = reinterpret_cast<const float*>(T + 4 * TILE);
    float mr[2], il[2], rr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mr[r] = St[r0 + 8 * r];
      il[r] = St[BQ + r0 + 8 * r];
      rr[r] = St[2 * BQ + r0 + 8 * r];
    }
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
    mm_abt<NT, DM>(s, T, T + 2 * TILE, LD, r0, g, t);
    mm_abt<NT, DM>(dp, T + TILE, T + 3 * TILE, LD, r0, g, t);
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = c * 8 + 2 * t + (e & 1);
        const float x = k0 + col < p.S ? s[c][e] * p.scale +
                                             Bs[(r0 + 8 * r) * BL + col]
                                       : -INFINITY;
        acc[c][e] += __expf(x - mr[r]) * il[r] * (dp[c][e] - rr[r]);
      }
    __syncthreads();  // the ring's next stage overwrites these tiles
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = q0 + r0 + (e >> 1) * 8;
    if (row >= p.S) continue;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const int col = k0 + c * 8 + 2 * t + (e & 1);
      if (col < p.S) db[(long long)row * p.S + col] = acc[c][e];
    }
  }
}

// ------------------------------------------------------------ bf16 dK/dV
// grid (nt, nh, R * ceil(B / R / RW)); RW groups of 4 warps x 16 key
// rows, group i taking batch row b_i (see pair_row); the live query
// sub-tiles (BQ wide) of the key tile's plan column, each group's q, dO
// and query rows' m, 1/l and r, and the shared bias block
// double-buffered. The products run transposed: S^T = K Q^T, dP^T = V
// dout^T, so each warp's rows are keys and the query index runs along the
// accumulator's columns. A key tile no query reaches writes zeros.
template <int DM, int BQ, int RW>
__global__ void __launch_bounds__(kThreads * RW) mhb_dkv(Params p) {
  constexpr int BKR = 64, LD = DM + 8, NT = BQ / 8, BL = BKR + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = threadIdx.x / kThreads;
  // [RW][K, V rows][BKR][LD], then [RW][q, dout][2][BQ][LD]
  bf16* Ks = reinterpret_cast<bf16*>(smem) + half * 2 * BKR * LD;
  bf16* Vs = Ks + BKR * LD;
  bf16* Qs = reinterpret_cast<bf16*>(smem) + RW * 2 * BKR * LD +
             half * 4 * BQ * LD;
  bf16* Os = Qs + 2 * BQ * LD;
  float* Ss = reinterpret_cast<float*>(reinterpret_cast<bf16*>(smem) +
                                       RW * (2 * BKR + 4 * BQ) * LD) +
              half * 2 * 3 * BQ;  // [RW][2][3][BQ]
  float* Bs = reinterpret_cast<float*>(reinterpret_cast<bf16*>(smem) +
                                       RW * (2 * BKR + 4 * BQ) * LD) +
              RW * 2 * 3 * BQ;    // [2][BQ][BL]
  short* list = reinterpret_cast<short*>(Bs + 2 * BQ * BL);
  const int tid = threadIdx.x % kThreads, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kt = blockIdx.x, k0 = kt * BKR, h = blockIdx.y;
  const PairRow pr = pair_row<RW>(p, half);
  const int b = pr.b, period = pr.period;
  const long long rs = 3LL * p.F;
  const Bf16Head hp = bf16_head(p, b, h);
  const long long st = ((long long)b * p.nh + h) * p.S;
  const float* bh = bias_head(p, period, h);
  const int n = live_list<BQ>(plan_row(p, period, h, 0) + kt, p.nt, p.nt,
                              p.S, list, false);
  auto stage_q = [&](int buf, int qs) {
    stage<BQ, DM>(Qs + buf * BQ * LD, LD, hp.q, rs, qs, p.S, p.D, tid);
    stage<BQ, DM>(Os + buf * BQ * LD, LD, hp.dout, p.F, qs, p.S, p.D, tid);
    stage_bias<BQ / RW, BKR>(Bs + (buf * BQ + half * (BQ / RW)) * BL, BL, bh,
                             p.S, qs + half * (BQ / RW), k0, tid);
    float* S3 = Ss + buf * 3 * BQ;  // the query rows' m, 1/l, r
    stage_f32(S3, p.m + st + qs, BQ, p.S - qs, tid);
    stage_f32(S3 + BQ, p.il + st + qs, BQ, p.S - qs, tid);
    stage_f32(S3 + 2 * BQ, p.r + st + qs, BQ, p.S - qs, tid);
  };
  stage<BKR, DM>(Ks, LD, hp.k, rs, k0, p.S, p.D, tid);
  stage<BKR, DM>(Vs, LD, hp.v, rs, k0, p.S, p.D, tid);
  if (n > 0) stage_q(0, list[0]);
  cp_async_commit();

  const int r0 = warp * 16 + g;
  float dk[DM / 8][4], dv[DM / 8][4];
#pragma unroll
  for (int d = 0; d < DM / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int buf = it & 1, qs = list[it];
    if (it + 1 < n) {
      stage_q(buf ^ 1, list[it + 1]);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Q = Qs + buf * BQ * LD;
    const bf16* O = Os + buf * BQ * LD;
    const float* Bb = Bs + buf * BQ * BL;
    const float* S3 = Ss + buf * 3 * BQ;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mm_abt<NT, DM>(s, Ks, Q, LD, r0, g, t);   // S^T  [keys x queries]
    mm_abt<NT, DM>(dp, Vs, O, LD, r0, g, t);  // dP^T
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t + e;
        const bool qok = qs + c < p.S;
        const float mq = S3[c], iq = S3[BQ + c], rq = S3[2 * BQ + c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kr = r0 + r * 8;
          const float x = (qok && k0 + kr < p.S)
                              ? s[j][2 * r + e] * p.scale + Bb[c * BL + kr]
                              : -INFINITY;
          const float sg = __expf(x - mq) * iq;
          s[j][2 * r + e] = sg;                                // P^T
          dp[j][2 * r + e] = sg * (dp[j][2 * r + e] - rq);     // dS^T
        }
      }
    mm_pb<BQ / 16, DM>(dv, s, O, LD, g, t);   // dV += P^T dout
    mm_pb<BQ / 16, DM>(dk, dp, Q, LD, g, t);  // dK += dS^T q
    __syncthreads();
  }

  bf16* dkb = static_cast<bf16*>(p.out) + (long long)b * p.S * rs + p.F +
              (long long)h * p.D;
  bf16* dvb = dkb + p.F;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + r * 8;
    if (key >= p.S || !pr.own) continue;
    const long long off = (long long)key * rs;
#pragma unroll
    for (int d = 0; d < DM / 8; ++d) {
      const int col = d * 8 + 2 * t;
      if (col < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + off + col) =
            __floats2bfloat162_rn(dk[d][2 * r] * p.scale,
                                  dk[d][2 * r + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + off + col) =
            __floats2bfloat162_rn(dv[d][2 * r], dv[d][2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------- f32 path
// One warp per row of the CTA's block (RW rows per warp), one lane per
// column of a 32-wide tile of the other sequence; lane L owns the output
// columns d = L + 32 i.
constexpr int RW = 4;                    // rows per warp
constexpr int FROWS = 4 * RW;            // rows per CTA
constexpr int FT = 32;                   // tile of the other sequence

// the f32 kernels' views of one (batch row, head)
struct F32Head {
  const float *q, *k, *v, *dout;
  long long rs;  // qkv row stride (3F)
};
__device__ __forceinline__ F32Head f32_head(const Params& p, int b, int h) {
  F32Head v;
  v.rs = 3LL * p.F;
  v.q = static_cast<const float*>(p.qkv) + (long long)b * p.S * v.rs +
        (long long)h * p.D;
  v.k = v.q + p.F;
  v.v = v.q + 2 * p.F;
  v.dout = p.dout ? static_cast<const float*>(p.dout) +
                        (long long)b * p.S * p.F + (long long)h * p.D
                  : nullptr;
  return v;
}

// grid (ceil(S / 16), nh, B)
template <int DM>
__global__ void __launch_bounds__(kThreads) bias_fwd_f32(Params p) {
  constexpr int LD = DM + 1, ND = DM / 32;
  extern __shared__ float fsm[];
  float* Qs = fsm;                 // [FROWS][DM]
  float* Ks = Qs + FROWS * DM;     // [FT][LD]
  float* Vs = Ks + FT * LD;        // [FT][DM]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * FROWS, h = blockIdx.y, b = blockIdx.z;
  const F32Head hd = f32_head(p, b, h);
  const int n_kt = (p.S + FT - 1) / FT;
  load_f32<FROWS, DM>(Qs, DM, hd.q, hd.rs, q0, p.S, p.D, tid);

  float m[RW], l[RW], acc[RW][ND];
  const float* brow[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
    brow[r] = p.bias + bias_row(p, b % p.R, h, q0 + warp * RW + r);
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[r][i] = 0.f;
  }
  for (int it = 0; it < n_kt; ++it) {
    __syncthreads();
    load_f32<FT, DM>(Ks, LD, hd.k, hd.rs, it * FT, p.S, p.D, tid);
    load_f32<FT, DM>(Vs, DM, hd.v, hd.rs, it * FT, p.S, p.D, tid);
    __syncthreads();
    const int col = it * FT + lane;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = warp * RW + r;
      float x = 0.f;
      for (int d = 0; d < DM; ++d) x = fmaf(Qs[lr * DM + d], Ks[lane * LD + d], x);
      x = biased(x * p.scale, brow[r], col, p.S);
      const float mn = fmaxf(m[r], warp_max(x));
      const float corr = expf(m[r] - mn);
      const float e = expf(x - mn);
      l[r] = corr * l[r] + warp_sum(e);
      m[r] = mn;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[r][i] *= corr;
      for (int j = 0; j < FT; ++j) {
        const float pj = __shfl_sync(0xffffffffu, e, j);
#pragma unroll
        for (int i = 0; i < ND; ++i)
          acc[r][i] = fmaf(pj, Vs[j * DM + lane + 32 * i], acc[r][i]);
      }
    }
  }
  float* ob = static_cast<float*>(p.out) + (long long)b * p.S * p.F +
              (long long)h * p.D;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    if (row >= p.S) continue;
    float* orow = ob + (long long)row * p.F;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      if (lane + 32 * i < p.D) orow[lane + 32 * i] = acc[r][i] / l[r];
  }
}

// grid (ceil(S / 16), nh, B): the row statistics m, 1/l, r
template <int DM>
__global__ void __launch_bounds__(kThreads) bias_stats_f32(Params p) {
  constexpr int LD = DM + 1;
  extern __shared__ float fsm[];
  float* Qs = fsm;                 // [FROWS][DM]
  float* Os = Qs + FROWS * DM;     // [FROWS][DM] dout
  float* Ks = Os + FROWS * DM;     // [FT][LD]
  float* Vs = Ks + FT * LD;        // [FT][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * FROWS, h = blockIdx.y, b = blockIdx.z;
  const F32Head hd = f32_head(p, b, h);
  const int n_kt = (p.S + FT - 1) / FT;
  load_f32<FROWS, DM>(Qs, DM, hd.q, hd.rs, q0, p.S, p.D, tid);
  load_f32<FROWS, DM>(Os, DM, hd.dout, p.F, q0, p.S, p.D, tid);
  float m[RW], l[RW], rr[RW];
  const float* brow[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = kNeg;
    l[r] = rr[r] = 0.f;
    brow[r] = p.bias + bias_row(p, b % p.R, h, q0 + warp * RW + r);
  }
  for (int it = 0; it < n_kt; ++it) {
    __syncthreads();
    load_f32<FT, DM>(Ks, LD, hd.k, hd.rs, it * FT, p.S, p.D, tid);
    load_f32<FT, DM>(Vs, LD, hd.v, hd.rs, it * FT, p.S, p.D, tid);
    __syncthreads();
    const int col = it * FT + lane;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = warp * RW + r;
      float x = 0.f, dp = 0.f;
      for (int d = 0; d < DM; ++d) {
        x = fmaf(Qs[lr * DM + d], Ks[lane * LD + d], x);
        dp = fmaf(Os[lr * DM + d], Vs[lane * LD + d], dp);
      }
      x = biased(x * p.scale, brow[r], col, p.S);
      const float mn = fmaxf(m[r], warp_max(x));
      const float corr = expf(m[r] - mn);
      const float e = expf(x - mn);
      l[r] = corr * l[r] + warp_sum(e);
      rr[r] = corr * rr[r] + warp_sum(e * dp);
      m[r] = mn;
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    if (row >= p.S || lane != 0) continue;
    const long long i = ((long long)b * p.nh + h) * p.S + row;
    p.m[i] = m[r];
    p.il[i] = 1.f / l[r];
    p.r[i] = rr[r] / l[r];
  }
}

// grid (ceil(S / 16), nh, B)
template <int DM>
__global__ void __launch_bounds__(kThreads) bias_dq_f32(Params p) {
  constexpr int LD = DM + 1, ND = DM / 32;
  extern __shared__ float fsm[];
  float* Qs = fsm;                 // [FROWS][DM]
  float* Os = Qs + FROWS * DM;     // [FROWS][DM] dout
  float* Ks = Os + FROWS * DM;     // [FT][LD]
  float* Vs = Ks + FT * LD;        // [FT][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * FROWS, h = blockIdx.y, b = blockIdx.z;
  const F32Head hd = f32_head(p, b, h);
  const int n_kt = (p.S + FT - 1) / FT;
  load_f32<FROWS, DM>(Qs, DM, hd.q, hd.rs, q0, p.S, p.D, tid);
  load_f32<FROWS, DM>(Os, DM, hd.dout, p.F, q0, p.S, p.D, tid);

  float mr[RW], il[RW], rr[RW], acc[RW][ND];
  const float* brow[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    const long long i = ((long long)b * p.nh + h) * p.S + row;
    mr[r] = row < p.S ? p.m[i] : 0.f;
    il[r] = row < p.S ? p.il[i] : 0.f;
    rr[r] = row < p.S ? p.r[i] : 0.f;
    brow[r] = p.bias + bias_row(p, b % p.R, h, row);
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[r][j] = 0.f;
  }
  for (int it = 0; it < n_kt; ++it) {
    __syncthreads();
    load_f32<FT, DM>(Ks, LD, hd.k, hd.rs, it * FT, p.S, p.D, tid);
    load_f32<FT, DM>(Vs, LD, hd.v, hd.rs, it * FT, p.S, p.D, tid);
    __syncthreads();
    const int col = it * FT + lane;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = warp * RW + r;
      float x = 0.f, dp = 0.f;
      for (int d = 0; d < DM; ++d) {
        x = fmaf(Qs[lr * DM + d], Ks[lane * LD + d], x);
        dp = fmaf(Os[lr * DM + d], Vs[lane * LD + d], dp);
      }
      x = biased(x * p.scale, brow[r], col, p.S);
      const float ds = expf(x - mr[r]) * il[r] * (dp - rr[r]);
      for (int j = 0; j < FT; ++j) {
        const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int i = 0; i < ND; ++i)
          acc[r][i] = fmaf(dj, Ks[j * LD + lane + 32 * i], acc[r][i]);
      }
    }
  }
  float* dqb = static_cast<float*>(p.out) + (long long)b * p.S * hd.rs +
               (long long)h * p.D;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    if (row >= p.S) continue;
    float* drow = dqb + (long long)row * hd.rs;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      if (lane + 32 * i < p.D) drow[lane + 32 * i] = acc[r][i] * p.scale;
  }
}

// grid (ceil(S / 16) * ceil(S / 32), nh, R): the CTA owns the 16 x 32
// block (query rows, key columns) of dbias[R = z, h] and sums its dS over
// the batch rows t * R + z in order of t, in registers; one write
template <int DM>
__global__ void __launch_bounds__(kThreads) bias_db_f32(Params p) {
  constexpr int LD = DM + 1;
  extern __shared__ float fsm[];
  float* Qs = fsm;                 // [FROWS][DM]
  float* Os = Qs + FROWS * DM;     // [FROWS][DM] dout
  float* Ks = Os + FROWS * DM;     // [FT][LD]
  float* Vs = Ks + FT * LD;        // [FT][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_kt = (p.S + FT - 1) / FT;
  const int q0 = (blockIdx.x / n_kt) * FROWS, k0 = (blockIdx.x % n_kt) * FT;
  const int h = blockIdx.y, period = blockIdx.z, col = k0 + lane;
  long long boff[RW];
  float bv[RW], acc[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    boff[r] = bias_row(p, period, h, q0 + warp * RW + r);
    bv[r] = col < p.S ? p.bias[boff[r] + col] : -INFINITY;
    acc[r] = 0.f;
  }
  for (int tb = 0; tb < p.B / p.R; ++tb) {
    const int b = tb * p.R + period;
    const F32Head hd = f32_head(p, b, h);
    __syncthreads();  // every warp is done with the previous row's tiles
    load_f32<FROWS, DM>(Qs, DM, hd.q, hd.rs, q0, p.S, p.D, tid);
    load_f32<FROWS, DM>(Os, DM, hd.dout, p.F, q0, p.S, p.D, tid);
    load_f32<FT, DM>(Ks, LD, hd.k, hd.rs, k0, p.S, p.D, tid);
    load_f32<FT, DM>(Vs, LD, hd.v, hd.rs, k0, p.S, p.D, tid);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = warp * RW + r, row = q0 + lr;
      const long long i = ((long long)b * p.nh + h) * p.S + row;
      const bool ok = row < p.S;
      float x = 0.f, dp = 0.f;
      for (int d = 0; d < DM; ++d) {
        x = fmaf(Qs[lr * DM + d], Ks[lane * LD + d], x);
        dp = fmaf(Os[lr * DM + d], Vs[lane * LD + d], dp);
      }
      x = x * p.scale + bv[r];
      if (ok) acc[r] += expf(x - p.m[i]) * p.il[i] * (dp - p.r[i]);
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r)
    if (q0 + warp * RW + r < p.S && col < p.S)
      p.dbias[boff[r] + col] = acc[r];
}

// grid (ceil(S / 16), nh, B): one warp per key row, one lane per query of
// a 32-wide query tile
template <int DM>
__global__ void __launch_bounds__(kThreads) bias_dkv_f32(Params p) {
  constexpr int LD = DM + 1, ND = DM / 32;
  extern __shared__ float fsm[];
  float* Ks = fsm;                 // [FROWS][DM]
  float* Vs = Ks + FROWS * DM;     // [FROWS][DM]
  float* Qs = Vs + FROWS * DM;     // [FT][LD]
  float* Os = Qs + FT * LD;        // [FT][LD] dout
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * FROWS, h = blockIdx.y, b = blockIdx.z;
  const F32Head hd = f32_head(p, b, h);
  const long long st = ((long long)b * p.nh + h) * p.S;
  const float* bh = p.bias + bias_row(p, b % p.R, h, 0);
  const int n_qt = (p.S + FT - 1) / FT;
  load_f32<FROWS, DM>(Ks, DM, hd.k, hd.rs, k0, p.S, p.D, tid);
  load_f32<FROWS, DM>(Vs, DM, hd.v, hd.rs, k0, p.S, p.D, tid);

  float dk[RW][ND], dv[RW][ND];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < ND; ++i) dk[r][i] = dv[r][i] = 0.f;
  for (int qt = 0; qt < n_qt; ++qt) {
    __syncthreads();
    load_f32<FT, DM>(Qs, LD, hd.q, hd.rs, qt * FT, p.S, p.D, tid);
    load_f32<FT, DM>(Os, LD, hd.dout, p.F, qt * FT, p.S, p.D, tid);
    __syncthreads();
    const int qi = qt * FT + lane;
    const bool qok = qi < p.S;
    const float mq = qok ? p.m[st + qi] : 0.f, iq = qok ? p.il[st + qi] : 0.f;
    const float rq = qok ? p.r[st + qi] : 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = warp * RW + r, key = k0 + lr;
      float x = 0.f, dp = 0.f;
      for (int d = 0; d < DM; ++d) {
        x = fmaf(Qs[lane * LD + d], Ks[lr * DM + d], x);
        dp = fmaf(Os[lane * LD + d], Vs[lr * DM + d], dp);
      }
      x = (qok && key < p.S) ? x * p.scale + bh[(long long)qi * p.S + key]
                             : -INFINITY;
      const float sg = expf(x - mq) * iq;
      const float ds = sg * (dp - rq);
      for (int j = 0; j < FT; ++j) {
        const float pj = __shfl_sync(0xffffffffu, sg, j);
        const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          dv[r][i] = fmaf(pj, Os[j * LD + lane + 32 * i], dv[r][i]);
          dk[r][i] = fmaf(dj, Qs[j * LD + lane + 32 * i], dk[r][i]);
        }
      }
    }
  }
  float* dkb = static_cast<float*>(p.out) + (long long)b * p.S * hd.rs + p.F +
               (long long)h * p.D;
  float* dvb = dkb + p.F;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int key = k0 + warp * RW + r;
    if (key >= p.S) continue;
    const long long off = (long long)key * hd.rs;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      if (lane + 32 * i < p.D) {
        dkb[off + lane + 32 * i] = dk[r][i] * p.scale;
        dvb[off + lane + 32 * i] = dv[r][i];
      }
  }
}

// ------------------------------------------------------------- launchers
enum Kind { kPlan = 0, kFwd = 1, kStats = 2, kDq = 3, kDb = 4, kDkv = 5 };

template <typename Kern>
cudaError_t launch(Kern kern, dim3 grid, size_t smem, const Params& p,
                   cudaStream_t st, int threads = kThreads) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int DM>
cudaError_t launch_bf16(int kind, const Params& p, cudaStream_t st) {
  constexpr int LD = DM + 8;
  // key sub-tiles of the forward: 64 wide, 32 at the widest head dim
  constexpr int FBK = DM > 128 ? 32 : 64;
  // batch rows a CTA of the forward, dQ and dK/dV takes (sharing their bias
  // blocks): 2, 1 at the widest head dim (shared memory)
  constexpr int RW = DM > 128 ? 1 : 2;
  // the ring of the d(bias) pass: 3 stages, 2 at 128, 1 at 256
  constexpr int NB = DM > 128 ? 1 : (DM > 64 ? 2 : 3);
  constexpr size_t E = sizeof(bf16), F = sizeof(float);
  // the live sub-tile list (shorts, 32-wide sub-tiles at most)
  const size_t list = ((size_t)(p.S + 31) / 32 * 2 + 15) / 16 * 16;
  const int rows = p.B / p.R;
  const dim3 grid(p.nt, p.nh, p.R * ((rows + RW - 1) / RW));
  if (kind == kPlan) {
    mhb_plan<<<dim3(p.nt, p.nh, p.R), kPlanThreads, 0, st>>>(p);
    return cudaGetLastError();
  }
  if (kind == kFwd)
    return launch(mhb_fwd<DM, FBK, RW>, grid,
                  RW * (64 + 4 * FBK) * LD * E + 2 * 64 * (FBK + 4) * F +
                      list,
                  p, st, kThreads * RW);
  if (kind == kDq)
    return launch(mhb_dq<DM, 32, RW>, grid,
                  RW * (2 * 64 + 4 * 32) * LD * E + 2 * 64 * 36 * F + list, p,
                  st, kThreads * RW);
  if (kind == kDb)
    return launch(mhb_db<DM, NB>, dim3(p.nt * p.nt, p.nh, p.R),
                  NB * (4 * 64 * LD * E + 3 * 64 * F) + 64 * 68 * F, p, st);
  return launch(mhb_dkv<DM, 32, RW>, grid,
                RW * ((2 * 64 + 4 * 32) * LD * E + 2 * 3 * 32 * F) +
                    2 * 32 * 68 * F + list,
                p, st, kThreads * RW);
}

template <int DM>
cudaError_t launch_f32(int kind, const Params& p, cudaStream_t st) {
  constexpr int LD = DM + 1;
  constexpr size_t F = sizeof(float);
  const int n_q = (p.S + FROWS - 1) / FROWS, n_k = (p.S + FT - 1) / FT;
  const dim3 grid(n_q, p.nh, p.B);
  if (kind == kFwd)
    return launch(bias_fwd_f32<DM>, grid, (FROWS * DM + FT * LD + FT * DM) * F,
                  p, st);
  const size_t sm = (2 * FROWS * DM + 2 * FT * LD) * F;
  if (kind == kStats) return launch(bias_stats_f32<DM>, grid, sm, p, st);
  if (kind == kDq) return launch(bias_dq_f32<DM>, grid, sm, p, st);
  if (kind == kDb)
    return launch(bias_db_f32<DM>, dim3(n_q * n_k, p.nh, p.R), sm, p, st);
  return launch(bias_dkv_f32<DM>, grid, sm, p, st);
}

cudaError_t run(int kind, const Params& p, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    if (p.D <= 32) return launch_bf16<32>(kind, p, st);
    if (p.D <= 64) return launch_bf16<64>(kind, p, st);
    if (p.D <= 128) return launch_bf16<128>(kind, p, st);
    return launch_bf16<256>(kind, p, st);
  }
  if (dtype == 0) {
    if (p.D <= 32) return launch_f32<32>(kind, p, st);
    if (p.D <= 64) return launch_f32<64>(kind, p, st);
    if (p.D <= 128) return launch_f32<128>(kind, p, st);
    return launch_f32<256>(kind, p, st);
  }
  return cudaErrorInvalidValue;
}

bool fill(Params& p, int B, int S, int nh, int D, int R, float scale) {
  if (B < 1 || B > 65535 || S < 1 || S >= 32768 || nh < 1 || nh > 65535 ||
      D < 8 || D > 256 || D % 8 || R < 1 || B % R)
    return false;
  p.B = B; p.S = S; p.nh = nh; p.D = D; p.F = nh * D; p.R = R;
  p.nt = (S + 63) / 64;
  p.scale = scale;
  return true;
}

}  // namespace

extern "C" {

// qkv [B, S, 3F], bias [R, nh, S, S] f32 -> out [B, S, F]; dtype: 0 =
// float32, 1 = bfloat16. bf16 also writes the plan [R, nh, nt, nt] uint8
// (nt = ceil(S / 64); a first launch reads it from the bias) and the row
// statistics ml [2, B, nh, S] f32 (m, 1/l) the backward takes; f32
// ignores plan and ml (its backward recomputes them).
int pt_fused_mha_bias_fwd(const void* qkv, const float* bias, void* out,
                          float* ml, unsigned char* plan, int B, int S,
                          int nh, int D, int R, float scale, int dtype,
                          void* stream) {
  // an error an earlier runtime call left pending is returned (and so
  // cleared), never dropped: the wrapper raises it
  if (cudaError_t pending = cudaGetLastError()) return pending;
  Params p{};
  p.qkv = qkv; p.bias = bias; p.out = out;
  if (!fill(p, B, S, nh, D, R, scale)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype != 1) return run(kFwd, p, dtype, st);
  const long long n = (long long)B * nh * S;
  p.m = ml;
  p.il = ml + n;
  p.plan = plan;
  if (cudaError_t e = run(kPlan, p, dtype, st)) return e;
  return run(kFwd, p, dtype, st);
}

// dqkv [B, S, 3F] and dbias [R, nh, S, S] f32 from qkv, bias and dout
// [B, S, F]. bf16: ml and plan are the forward's; r is f32 scratch [B,
// nh, S]; three launches in order on the stream: r and dQ, d(bias),
// dK/dV. f32: ml [2, B, nh, S] and r are scratch, plan is ignored; four
// launches: the row statistics, dQ, d(bias), dK/dV.
int pt_fused_mha_bias_bwd(const void* qkv, const float* bias, const void* dout,
                          void* dqkv, float* dbias, float* ml, float* r,
                          unsigned char* plan, int B, int S, int nh, int D,
                          int R, float scale, int dtype, void* stream) {
  if (cudaError_t pending = cudaGetLastError()) return pending;
  Params p{};
  p.qkv = qkv; p.bias = bias; p.dout = dout; p.out = dqkv; p.dbias = dbias;
  if (!fill(p, B, S, nh, D, R, scale)) return cudaErrorInvalidValue;
  const long long n = (long long)B * nh * S;
  p.m = ml;
  p.il = ml + n;
  p.r = r;
  p.plan = plan;
  auto st = static_cast<cudaStream_t>(stream);
  const int bf16_kinds[3] = {kDq, kDb, kDkv};
  const int f32_kinds[4] = {kStats, kDq, kDb, kDkv};
  const int* kinds = dtype == 1 ? bf16_kinds : f32_kinds;
  for (int i = 0; i < (dtype == 1 ? 3 : 4); ++i)
    if (cudaError_t e = run(kinds[i], p, dtype, st)) return e;
  return cudaSuccess;
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
