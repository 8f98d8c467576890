// Window-batched fused multi-head attention with a periodic additive bias
// (Swin's window attention) on the packed projection output, for Hopper
// (sm_90a): the forward, and the backward with d(bias) (four passes behind
// one entry point).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/fused_mha_bias.py
// `fused_mha_bias` (its forward `_fwd_kernel` and its backward
// `_bwd_kernel`). Same function, not the same plan. A TPU program holds a
// whole [S, S] score matrix and the bias block of a head group in VMEM, and
// its backward accumulates d(bias) in an output block that stays resident
// while a sequential grid sweeps the batch rows of one period index. Here a
// score row does not fit shared memory next to the tiles, and blocks run in
// parallel in no order. So:
//   * forward: one CTA per (64 query rows, head, batch row) streams the key
//     tiles with an online softmax, adding bias[b mod R, h] to the f32
//     scores as they come out of the tensor cores;
//   * backward, pass 1 (one CTA per 64 query rows x head x batch row):
//     each query row's max m, 1/sum and the exact in-row term r = sum_j
//     dsigma_j sigma_j (online, from the scores and dP = dO V^T, never from
//     the rounded output); pass 2 (the same grid): dQ; pass 3: d(bias), one
//     CTA per 64 x 64 block (query tile, key tile) of bias[r, h], which no
//     other CTA touches: it walks the batch rows t * R + r in order, t = 0
//     .. B/R - 1, recomputing that row's scores and dP for its block and
//     summing dS in registers, and writes the block once. No atomics, so
//     d(bias) is summed in the TPU kernel's order and two launches give
//     bitwise-equal results; pass 4 (one CTA per 64 key rows, the products
//     transposed): dK and dV, FA-2's split.
//     The row statistics are the only scratch, f32 [3, B, nh, S].
//
//   qkv  [B, S, 3F] (F = nh * D), [q heads | k heads | v heads], read in
//        place: q of head h at column h * D, k at F + h * D, v at 2F + h * D
//   bias [R, nh, S, S] f32; batch row b uses bias[b mod R]
//   out  [B, S, F]; dout [B, S, F]; dqkv [B, S, 3F]; dbias [R, nh, S, S]
//   s = (q . k) * scale + bias; sigma = softmax(s) in f32; out = sigma v
//   with sigma rounded to the input type before the product (bf16).
//   backward: dsigma = dO . v; ds = sigma (dsigma - r) in f32; dbias[r] =
//   sum_t ds[t * R + r] in f32; dq = scale ds k, dk = scale ds^T q (ds
//   rounded before its products), dv = sigma^T dO (rounded before it).
//   The bias's -1e9 between grouped windows is finite and stays so: every
//   row has its own window's keys, and exp(-1e9 - m) is exactly 0 in f32.
//   Tail columns past S (S = 392 and 196 are not multiples of the tiles)
//   score -inf, so they never enter the max or the sum.
//
// Bound: at swin-t's first stage (B = 256 sequences of S = 392, nh = 3,
// D = 32) the forward reads qkv (57.8 MB) and the bias (14.7 MB) and writes
// 19.3 MB, against 15.1 GFLOP for the two [S, S] x D products: bytes-bound
// on the H100. The work is the full S x S of the TPU kernel, block-diagonal
// -1e9 included: 8x (wg = 8) or 4x (wg = 4) the work of attention window
// by window. Skipping key tiles whose bias is all -1e9 is later work. Design
// (simple first, the design of #9, fused_mha.cu):
//   * bf16: mma.sync m16n8k16 bf16 x bf16 -> f32, each warp owning 16 rows
//     of the CTA's block, so the row statistics reduce inside a quad of
//     lanes; P and dS go from the accumulators to the next product's A
//     operand in registers; the bias is read from device memory (L2) by
//     each lane at its own accumulator positions;
//   * the other sequence's tiles are double-buffered in shared memory with
//     cp.async; rows past S and columns past D are zero-filled as staged;
//   * f32: plain FMAs on the CUDA cores (never TF32), one warp per row and
//     one lane per column of a 32-wide tile of the other sequence; this
//     path serves parity runs, not speed.
// `wgmma`, TMA and warp specialisation are later work. Head dims: any
// multiple of 8 up to 256, built for D buckets of 32, 64, 128 and 256.
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
  float* m;           // backward row statistics [B, nh, S]: the max,
  float* il;          //   1 / sum of exp(s - max),
  float* r;           //   and the in-row term
  int B, S, nh, D, F, R;
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

// ------------------------------------------------------------ bf16 forward
// grid (ceil(S / 64), nh, B); 4 warps x 16 query rows; key tiles of BK
template <int DM, int BK>
__global__ void __launch_bounds__(kThreads) bias_fwd_bf16(Params p) {
  constexpr int BQ = 64, LD = DM + 8, NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;       // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;   // [2][BK][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long rs = 3LL * p.F;
  const Bf16Head hp = bf16_head(p, b, h);
  const int n_kb = (p.S + BK - 1) / BK;

  stage<BQ, DM>(Qs, LD, hp.q, rs, q0, p.S, p.D, tid);
  stage<BK, DM>(Ks, LD, hp.k, rs, 0, p.S, p.D, tid);
  stage<BK, DM>(Vs, LD, hp.v, rs, 0, p.S, p.D, tid);
  cp_async_commit();

  float o[DM / 8][4];
#pragma unroll
  for (int n = 0; n < DM / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int r0 = warp * 16 + g;  // this lane's rows r0 and r0 + 8
  const float* brow[2] = {p.bias + bias_row(p, b % p.R, h, q0 + r0),
                          p.bias + bias_row(p, b % p.R, h, q0 + r0 + 8)};

  for (int it = 0; it < n_kb; ++it) {
    const int buf = next_tiles<BK, DM>(Ks, Vs, LD, hp.k, hp.v, rs, rs, it,
                                       n_kb, p.S, p.D, tid);
    const bf16* K = Ks + buf * BK * LD;
    const bf16* V = Vs + buf * BK * LD;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mm_abt<NT, DM>(s, Qs, K, LD, r0, g, t);

    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = it * BK + j * 8 + 2 * t + (e & 1);
        const float x = biased(s[j][e] * p.scale, brow[e >> 1], col, p.S);
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
    for (int n = 0; n < DM / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    mm_pb<BK / 16, DM>(o, s, V, LD, g, t);
    __syncthreads();  // the next iteration overwrites this buffer
  }

  bf16* ob = static_cast<bf16*>(p.out) + (long long)b * p.S * p.F +
             (long long)h * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= p.S) continue;
    const float inv = 1.f / l[r];
    bf16* orow = ob + (long long)row * p.F;
#pragma unroll
    for (int n = 0; n < DM / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

// --------------------------------------------- bf16 backward, row stats
// grid (ceil(S / 64), nh, B); 4 warps x 16 query rows; key tiles of BK.
// Online over the key tiles: the max m, the sum l of exp(s - m) and
// rr = sum exp(s - m) * dsigma, rescaled together; stores m, 1/l, rr/l.
template <int DM, int BK>
__global__ void __launch_bounds__(kThreads) bias_stats_bf16(Params p) {
  constexpr int BQ = 64, LD = DM + 8, NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + BQ * LD;        // dout rows
  bf16* Ks = Os + BQ * LD;        // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;    // [2][BK][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long rs = 3LL * p.F;
  const Bf16Head hp = bf16_head(p, b, h);
  const int n_kb = (p.S + BK - 1) / BK;

  stage<BQ, DM>(Qs, LD, hp.q, rs, q0, p.S, p.D, tid);
  stage<BQ, DM>(Os, LD, hp.dout, p.F, q0, p.S, p.D, tid);
  stage<BK, DM>(Ks, LD, hp.k, rs, 0, p.S, p.D, tid);
  stage<BK, DM>(Vs, LD, hp.v, rs, 0, p.S, p.D, tid);
  cp_async_commit();

  const int r0 = warp * 16 + g;
  const float* brow[2] = {p.bias + bias_row(p, b % p.R, h, q0 + r0),
                          p.bias + bias_row(p, b % p.R, h, q0 + r0 + 8)};
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, rr[2] = {0.f, 0.f};

  for (int it = 0; it < n_kb; ++it) {
    const int buf = next_tiles<BK, DM>(Ks, Vs, LD, hp.k, hp.v, rs, rs, it,
                                       n_kb, p.S, p.D, tid);
    const bf16* K = Ks + buf * BK * LD;
    const bf16* V = Vs + buf * BK * LD;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mm_abt<NT, DM>(s, Qs, K, LD, r0, g, t);
    mm_abt<NT, DM>(dp, Os, V, LD, r0, g, t);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = it * BK + j * 8 + 2 * t + (e & 1);
        const float x = biased(s[j][e] * p.scale, brow[e >> 1], col, p.S);
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
    float sum[2] = {0.f, 0.f}, sr[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = __expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += x;
        sr[e >> 1] += x * dp[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = corr[r] * l[r] + quad_sum(sum[r]);
      rr[r] = corr[r] * rr[r] + quad_sum(sr[r]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= p.S || t != 0) continue;
    const long long i = ((long long)b * p.nh + h) * p.S + row;
    p.m[i] = m[r];
    p.il[i] = 1.f / l[r];
    p.r[i] = rr[r] / l[r];
  }
}

// --------------------------------------------------------------- bf16 dQ
// grid (ceil(S / 64), nh, B); 4 warps x 16 query rows; key tiles of BK
template <int DM, int BK>
__global__ void __launch_bounds__(kThreads) bias_dq_bf16(Params p) {
  constexpr int BQ = 64, LD = DM + 8, NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + BQ * LD;        // dout rows
  bf16* Ks = Os + BQ * LD;        // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;    // [2][BK][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long rs = 3LL * p.F;
  const Bf16Head hp = bf16_head(p, b, h);
  const int n_kb = (p.S + BK - 1) / BK;

  stage<BQ, DM>(Qs, LD, hp.q, rs, q0, p.S, p.D, tid);
  stage<BQ, DM>(Os, LD, hp.dout, p.F, q0, p.S, p.D, tid);
  stage<BK, DM>(Ks, LD, hp.k, rs, 0, p.S, p.D, tid);
  stage<BK, DM>(Vs, LD, hp.v, rs, 0, p.S, p.D, tid);
  cp_async_commit();

  const int r0 = warp * 16 + g;
  const float* brow[2] = {p.bias + bias_row(p, b % p.R, h, q0 + r0),
                          p.bias + bias_row(p, b % p.R, h, q0 + r0 + 8)};
  float mr[2], il[2], rr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    const long long i = ((long long)b * p.nh + h) * p.S + row;
    mr[r] = row < p.S ? p.m[i] : 0.f;
    il[r] = row < p.S ? p.il[i] : 0.f;
    rr[r] = row < p.S ? p.r[i] : 0.f;
  }
  float dq[DM / 8][4];
#pragma unroll
  for (int n = 0; n < DM / 8; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int it = 0; it < n_kb; ++it) {
    const int buf = next_tiles<BK, DM>(Ks, Vs, LD, hp.k, hp.v, rs, rs, it,
                                       n_kb, p.S, p.D, tid);
    const bf16* K = Ks + buf * BK * LD;
    const bf16* V = Vs + buf * BK * LD;
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
        const int r = e >> 1;
        const int col = it * BK + j * 8 + 2 * t + (e & 1);
        const float x = biased(s[j][e] * p.scale, brow[r], col, p.S);
        s[j][e] = __expf(x - mr[r]) * il[r] * (dp[j][e] - rr[r]);  // dS
      }
    mm_pb<BK / 16, DM>(dq, s, K, LD, g, t);  // dS rounded to bf16 here
    __syncthreads();
  }

  bf16* dqb = static_cast<bf16*>(p.out) + (long long)b * p.S * rs +
              (long long)h * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= p.S) continue;
    bf16* drow = dqb + (long long)row * rs;
#pragma unroll
    for (int n = 0; n < DM / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(drow + col) = __floats2bfloat162_rn(
            dq[n][2 * r] * p.scale, dq[n][2 * r + 1] * p.scale);
    }
  }
}

// ----------------------------------------------------------- bf16 d(bias)
// grid (ceil(S / 64) * ceil(S / 64), nh, R); 4 warps x 16 query rows. The
// CTA owns the 64 x 64 block (query tile, key tile) of dbias[R = z, h]: its
// bias entries and its dS sums stay in registers while it walks the batch
// rows b = t * R + z in order of t (staging that row's q, dO, k and v
// tiles), and it writes the block once at the end.
template <int DM>
__global__ void __launch_bounds__(kThreads) bias_db_bf16(Params p) {
  constexpr int BQ = 64, BK = 64, LD = DM + 8, NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + BQ * LD;        // dout rows
  bf16* Ks = Os + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_kt = (p.S + BK - 1) / BK;
  const int q0 = (blockIdx.x / n_kt) * BQ, k0 = (blockIdx.x % n_kt) * BK;
  const int h = blockIdx.y, period = blockIdx.z;
  const long long rs = 3LL * p.F;
  const int r0 = warp * 16 + g;
  const long long boff[2] = {bias_row(p, period, h, q0 + r0),
                             bias_row(p, period, h, q0 + r0 + 8)};

  // this lane's bias entries (rows r0, r0 + 8; columns k0 + j*8 + 2t + c)
  // and dS sums; columns past S score -inf
  float bv[NT][4], acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + j * 8 + 2 * t + (e & 1);
      bv[j][e] = col < p.S ? p.bias[boff[e >> 1] + col] : -INFINITY;
      acc[j][e] = 0.f;
    }

  for (int tb = 0; tb < p.B / p.R; ++tb) {
    const int b = tb * p.R + period;
    const Bf16Head hp = bf16_head(p, b, h);
    stage<BQ, DM>(Qs, LD, hp.q, rs, q0, p.S, p.D, tid);
    stage<BQ, DM>(Os, LD, hp.dout, p.F, q0, p.S, p.D, tid);
    stage<BK, DM>(Ks, LD, hp.k, rs, k0, p.S, p.D, tid);
    stage<BK, DM>(Vs, LD, hp.v, rs, k0, p.S, p.D, tid);
    cp_async_commit();
    float mr[2], il[2], rr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + r * 8;
      const long long i = ((long long)b * p.nh + h) * p.S + row;
      mr[r] = row < p.S ? p.m[i] : 0.f;
      il[r] = row < p.S ? p.il[i] : 0.f;
      rr[r] = row < p.S ? p.r[i] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mm_abt<NT, DM>(s, Qs, Ks, LD, r0, g, t);
    mm_abt<NT, DM>(dp, Os, Vs, LD, r0, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float x = s[j][e] * p.scale + bv[j][e];
        acc[j][e] += __expf(x - mr[r]) * il[r] * (dp[j][e] - rr[r]);
      }
    __syncthreads();  // the next batch row overwrites the tiles
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = q0 + r0 + (e >> 1) * 8;
    if (row >= p.S) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = k0 + j * 8 + 2 * t + (e & 1);
      if (col < p.S) p.dbias[boff[e >> 1] + col] = acc[j][e];
    }
  }
}

// ------------------------------------------------------------ bf16 dK/dV
// grid (ceil(S / 64), nh, B); 4 warps x 16 key rows; query tiles of BQ.
// The products run transposed: S^T = K Q^T, dP^T = V dout^T, so each
// warp's rows are keys and the query index runs along the accumulator's
// columns.
template <int DM, int BQ>
__global__ void __launch_bounds__(kThreads) bias_dkv_bf16(Params p) {
  constexpr int BKR = 64, LD = DM + 8, NT = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BKR * LD;
  bf16* Qs = Vs + BKR * LD;      // [2][BQ][LD]
  bf16* Os = Qs + 2 * BQ * LD;   // [2][BQ][LD] dout rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BKR, h = blockIdx.y, b = blockIdx.z;
  const long long rs = 3LL * p.F;
  const Bf16Head hp = bf16_head(p, b, h);
  const long long st = ((long long)b * p.nh + h) * p.S;
  const float *mb = p.m + st, *ilb = p.il + st, *rb = p.r + st;
  const float* bh = p.bias + bias_row(p, b % p.R, h, 0);
  const int n_qt = (p.S + BQ - 1) / BQ;

  stage<BKR, DM>(Ks, LD, hp.k, rs, k0, p.S, p.D, tid);
  stage<BKR, DM>(Vs, LD, hp.v, rs, k0, p.S, p.D, tid);
  stage<BQ, DM>(Qs, LD, hp.q, rs, 0, p.S, p.D, tid);
  stage<BQ, DM>(Os, LD, hp.dout, p.F, 0, p.S, p.D, tid);
  cp_async_commit();

  const int r0 = warp * 16 + g;
  float dk[DM / 8][4], dv[DM / 8][4];
#pragma unroll
  for (int n = 0; n < DM / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qt = 0; qt < n_qt; ++qt) {
    const int buf = next_tiles<BQ, DM>(Qs, Os, LD, hp.q, hp.dout, rs, p.F, qt,
                                       n_qt, p.S, p.D, tid);
    const bf16* Q = Qs + buf * BQ * LD;
    const bf16* O = Os + buf * BQ * LD;
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
        const int qi = qt * BQ + j * 8 + 2 * t + e;
        const bool qok = qi < p.S;
        const float mq = qok ? mb[qi] : 0.f, iq = qok ? ilb[qi] : 0.f;
        const float rq = qok ? rb[qi] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = k0 + r0 + r * 8;
          const float x = (qok && key < p.S)
                              ? s[j][2 * r + e] * p.scale +
                                    bh[(long long)qi * p.S + key]
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
    if (key >= p.S) continue;
    const long long off = (long long)key * rs;
#pragma unroll
    for (int n = 0; n < DM / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + off + col) =
            __floats2bfloat162_rn(dk[n][2 * r] * p.scale,
                                  dk[n][2 * r + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + off + col) =
            __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
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
enum Kind { kFwd = 0, kStats = 1, kDq = 2, kDb = 3, kDkv = 4 };

template <typename Kern>
cudaError_t launch(Kern kern, dim3 grid, size_t smem, const Params& p,
                   cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int DM>
cudaError_t launch_bf16(int kind, const Params& p, cudaStream_t st) {
  constexpr int LD = DM + 8;
  // key tiles of the forward: 64 wide, 32 at the widest head dim
  constexpr int FBK = DM > 128 ? 32 : 64;
  constexpr size_t E = sizeof(bf16);
  const int n_t = (p.S + 63) / 64;
  const dim3 grid(n_t, p.nh, p.B);
  const size_t bwd_smem = (2 * 64 + 4 * 32) * LD * E;
  if (kind == kFwd)
    return launch(bias_fwd_bf16<DM, FBK>, grid, (64 + 4 * FBK) * LD * E, p,
                  st);
  if (kind == kStats)
    return launch(bias_stats_bf16<DM, 32>, grid, bwd_smem, p, st);
  if (kind == kDq) return launch(bias_dq_bf16<DM, 32>, grid, bwd_smem, p, st);
  if (kind == kDb)
    return launch(bias_db_bf16<DM>, dim3(n_t * n_t, p.nh, p.R),
                  4 * 64 * LD * E, p, st);
  return launch(bias_dkv_bf16<DM, 32>, grid, bwd_smem, p, st);
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
  p.scale = scale;
  return true;
}

}  // namespace

extern "C" {

// qkv [B, S, 3F], bias [R, nh, S, S] f32 -> out [B, S, F]; dtype: 0 =
// float32, 1 = bfloat16
int pt_fused_mha_bias_fwd(const void* qkv, const float* bias, void* out,
                          int B, int S, int nh, int D, int R, float scale,
                          int dtype, void* stream) {
  // an error an earlier runtime call left pending is returned (and so
  // cleared), never dropped: the wrapper raises it
  if (cudaError_t pending = cudaGetLastError()) return pending;
  Params p{};
  p.qkv = qkv; p.bias = bias; p.out = out;
  if (!fill(p, B, S, nh, D, R, scale)) return cudaErrorInvalidValue;
  return run(kFwd, p, dtype, static_cast<cudaStream_t>(stream));
}

// dqkv [B, S, 3F] and dbias [R, nh, S, S] f32 from qkv, bias and dout
// [B, S, F]; stats: f32 scratch [3, B, nh, S] for the row max, 1/sum and
// in-row term. Four launches in order on the stream: the row statistics,
// dQ, d(bias), dK/dV.
int pt_fused_mha_bias_bwd(const void* qkv, const float* bias, const void* dout,
                          void* dqkv, float* dbias, float* stats, int B, int S,
                          int nh, int D, int R, float scale, int dtype,
                          void* stream) {
  if (cudaError_t pending = cudaGetLastError()) return pending;
  Params p{};
  p.qkv = qkv; p.bias = bias; p.dout = dout; p.out = dqkv; p.dbias = dbias;
  if (!fill(p, B, S, nh, D, R, scale)) return cudaErrorInvalidValue;
  const long long n = (long long)B * nh * S;
  p.m = stats;
  p.il = stats + n;
  p.r = stats + 2 * n;
  auto st = static_cast<cudaStream_t>(stream);
  const int kinds[4] = {kStats, kDq, kDb, kDkv};
  for (int kind : kinds)
    if (cudaError_t e = run(kind, p, dtype, st)) return e;
  return cudaSuccess;
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
