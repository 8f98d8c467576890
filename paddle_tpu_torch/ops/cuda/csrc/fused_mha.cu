// Fused whole-sequence multi-head attention for short sequences on the
// packed projection output, for Hopper (sm_90a): the forward and the
// backward (three passes behind one entry point).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/fused_mha.py
// `fused_mha` (its forward `_fwd_kernel` and its backward `_bwd_kernel`).
// Same function, not the same plan: a TPU program holds the whole [S, S]
// score matrix of a group of heads in VMEM and the backward emits dq, dk
// and dv in one program. Here a score row does not fit: at S = 512 a
// 64-row tile of f32 scores is 128 KiB and one head's K and V another 128
// KiB, against 227 KiB of shared memory. So, FlashAttention-2's plan, in
// blocks of 64 rows at head dims up to 64 (two CTAs an SM), 128 above:
//   * forward: one CTA per (block of query rows, head, batch row) streams
//     the key tiles with an online softmax (the same function) and writes
//     out and lse = m + log(l) [B, nh, S] f32, the backward's one residual;
//   * backward: the r pass (a CTA per block of query rows) forms each
//     row's exact in-row term r = sum_j dsigma_j sigma_j from lse (S and
//     dP of every key tile); the dQ pass (per block of query rows) forms
//     dQ; the dK/dV pass (per block of key rows, the products transposed)
//     forms dK and dV: nine [S, S] x D products, no atomics, r the only
//     scratch, f32 [B, nh, S].
//
//   qkv  [B, S, 3F] (F = nh * D), [q heads | k heads | v heads], read in
//        place: q of head h at column h * D, k at F + h * D, v at 2F + h * D
//   out  [B, S, F]; dout [B, S, F]; dqkv [B, S, 3F] in the packed layout
//   s = (q . k) * scale; s = -1e30 where col >= lim (lim = kv_len, or
//   lens[b] per batch row) or, under causal, where row < col; sigma =
//   softmax(s) in f32; with dropout p = sigma * keep * 1/(1-p); out = p v
//   with p rounded to the input type before the product (bf16).
//   backward: dsigma = (dO . v) * keep/(1-p); ds = sigma (dsigma - r);
//   dq = scale ds k, dk = scale ds^T q (ds rounded before its products),
//   dv = (sigma * keep/(1-p))^T dO (rounded before its product).
//   A row whose every key is masked (lens[b] <= 0) averages all S keys,
//   as the TPU kernel's -1e30 scores do. Query rows past lens[b] attend
//   the row's valid keys like any other row.
//
// Dropout: a stateless counter-based generator, the same in the plain
// PyTorch version (ops/fused_mha.py): bits(b, h, row, col) =
// fmix32(fmix32(fmix32(seed + b * nh + h) + row) + col) (murmur3's
// finaliser, uint32 arithmetic); keep iff bits >= thresh = floor(p *
// 2^32). The seed is read from device memory (one int32), so the caller
// never syncs. Every pass regenerates the same mask.
//
// Bound: at bert-base (B=32, S=512, nh=12, D=64) the forward's two
// [S, S] x D products are ~26 GFLOP against ~100 MB of qkv and output:
// about the same time at the tensor-core peak as at the memory rate; the
// backward is operation-bound. Dropout adds a floor of integer work: one
// fmix32 (two multiplies, three shift-xors), an add, a compare and a
// select per score and pass, 100.7 M scores a layer at bert-base.
//   * bf16: #6's warpgroup kernels (flash_wg.cuh: wgmma, TMA, one producer
//     warp and consumer warpgroups of 64 rows; one consumer at head dims
//     up to 64: short rows give a CTA few key tiles, and a second CTA on
//     the SM hides one's prologue and epilogue) instantiated with MHA = true,
//     which compiles in the per-batch-row key limit, the keep mask drawn
//     in the accumulator layout (one fmix32 per score; the head key and
//     row hashes once per CTA or query tile) and the r pass. The packed
//     q, k and v are TMA views of qkv with its strides, so rows past S
//     (S = 197 is ragged) and columns past D (80 in the 128 bucket) arrive
//     as zeros and are masked behind one uniform branch per tile. Head
//     dims: any multiple of 8 up to 256, in buckets of 64, 128 and 256;
//   * f32: plain FMAs on the CUDA cores (never TF32), one warp per row and
//     one lane per column of a 32-wide tile of the other sequence, the
//     backward's row statistics (m, 1/l, r) recomputed by a pass of its
//     own; this path serves parity runs, not speed.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError(); a
// view TMA cannot take returns cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attention_tiles.cuh"
#include "flash_wg.cuh"  // the bf16 kernels, instantiated with MHA = true

namespace {

using namespace tiles;
constexpr float kNeg = -1e30f;

struct Params {
  const void* qkv;   // [B, S, 3F]
  const void* dout;  // [B, S, F] (backward)
  void* out;         // forward: [B, S, F]; backward: dqkv [B, S, 3F]
  float* m;          // backward row statistics [B, nh, S]: the max,
  float* il;         //   1 / sum of exp(s - max),
  float* r;          //   and the in-row term
  const int* lens;   // [B] valid keys per batch row, or null
  const int* seed;   // one int32, or null without dropout
  int B, S, nh, D, F, kv_len, causal, drop;
  float scale;
  unsigned thresh;   // keep iff bits >= thresh
  float inv;         // 1 / (1 - p), the kept entries' scale
};

// ------------------------------------------------------------ helpers
using wg::fmix32;  // the generator's finaliser, shared with the bf16 kernels
__device__ __forceinline__ uint32_t head_key(const Params& p, int b, int h) {
  if (!p.drop) return 0u;
  return fmix32(static_cast<uint32_t>(*p.seed) +
                static_cast<uint32_t>(b * p.nh + h));
}
__device__ __forceinline__ uint32_t row_hash(uint32_t k1, int row) {
  return fmix32(k1 + static_cast<uint32_t>(row));
}
// the keep-scale of (row, col): 1/(1-p) or 0; 1 without dropout
__device__ __forceinline__ float keep(const Params& p, uint32_t rh, int col) {
  if (!p.drop) return 1.f;
  return fmix32(rh + static_cast<uint32_t>(col)) >= p.thresh ? p.inv : 0.f;
}

// keys >= the limit are masked; 0 when every key of the batch row is
__device__ __forceinline__ int key_limit(const Params& p, int b) {
  const int lim = p.lens ? p.lens[b] : p.kv_len;
  return lim < p.S ? (lim > 0 ? lim : 0) : p.S;
}
// the scaled score x of (row, col): -inf past the sequence (a tile's
// tail, outside the softmax), -1e30 where masked
__device__ __forceinline__ float masked(float x, int row, int col, int S,
                                        int lim, int causal) {
  if (col >= S) return -INFINITY;
  if (col >= lim || (causal && row < col)) return kNeg;
  return x;
}
// key tiles of width BK a block of query rows [q0, q0 + BQ) must visit
__device__ __forceinline__ int key_tiles(int q0, int BQ, int BK, int S,
                                         int lim, int causal) {
  if (lim == 0) return (S + BK - 1) / BK;  // every key masked: all of them
  int n = (lim + BK - 1) / BK;
  if (causal) n = min(n, (q0 + BQ + BK - 1) / BK);
  return n;
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
  int lim;
  uint32_t k1;
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
  v.lim = key_limit(p, b);
  v.k1 = head_key(p, b, h);
  return v;
}

// grid (ceil(S / 16), nh, B)
template <int DM>
__global__ void __launch_bounds__(kThreads) fwd_f32(Params p) {
  constexpr int LD = DM + 1, ND = DM / 32;
  extern __shared__ float fsm[];
  float* Qs = fsm;                 // [FROWS][DM]
  float* Ks = Qs + FROWS * DM;     // [FT][LD]
  float* Vs = Ks + FT * LD;        // [FT][DM]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * FROWS, h = blockIdx.y, b = blockIdx.z;
  const F32Head hd = f32_head(p, b, h);
  const int n_kt = key_tiles(q0, FROWS, FT, p.S, hd.lim, p.causal);
  load_f32<FROWS, DM>(Qs, DM, hd.q, hd.rs, q0, p.S, p.D, tid);

  float m[RW], l[RW], acc[RW][ND];
  uint32_t rh[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
    rh[r] = row_hash(hd.k1, q0 + warp * RW + r);
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
      const int lr = warp * RW + r, row = q0 + lr;
      float x = 0.f;
      for (int d = 0; d < DM; ++d) x = fmaf(Qs[lr * DM + d], Ks[lane * LD + d], x);
      x = masked(x * p.scale, row, col, p.S, hd.lim, p.causal);
      const float mn = fmaxf(m[r], warp_max(x));
      const float corr = expf(m[r] - mn);
      const float e = expf(x - mn);
      l[r] = corr * l[r] + warp_sum(e);
      m[r] = mn;
      const float pr = e * keep(p, rh[r], col);
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[r][i] *= corr;
      for (int j = 0; j < FT; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
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
__global__ void __launch_bounds__(kThreads) stats_f32(Params p) {
  constexpr int LD = DM + 1;
  extern __shared__ float fsm[];
  float* Qs = fsm;                 // [FROWS][DM]
  float* Os = Qs + FROWS * DM;     // [FROWS][DM] dout
  float* Ks = Os + FROWS * DM;     // [FT][LD]
  float* Vs = Ks + FT * LD;        // [FT][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * FROWS, h = blockIdx.y, b = blockIdx.z;
  const F32Head hd = f32_head(p, b, h);
  const int n_kt = key_tiles(q0, FROWS, FT, p.S, hd.lim, p.causal);
  load_f32<FROWS, DM>(Qs, DM, hd.q, hd.rs, q0, p.S, p.D, tid);
  load_f32<FROWS, DM>(Os, DM, hd.dout, p.F, q0, p.S, p.D, tid);
  float m[RW], l[RW], rr[RW];
  uint32_t rh[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = kNeg;
    l[r] = rr[r] = 0.f;
    rh[r] = row_hash(hd.k1, q0 + warp * RW + r);
  }
  for (int it = 0; it < n_kt; ++it) {
    __syncthreads();
    load_f32<FT, DM>(Ks, LD, hd.k, hd.rs, it * FT, p.S, p.D, tid);
    load_f32<FT, DM>(Vs, LD, hd.v, hd.rs, it * FT, p.S, p.D, tid);
    __syncthreads();
    const int col = it * FT + lane;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = warp * RW + r, row = q0 + lr;
      float x = 0.f, dp = 0.f;
      for (int d = 0; d < DM; ++d) {
        x = fmaf(Qs[lr * DM + d], Ks[lane * LD + d], x);
        dp = fmaf(Os[lr * DM + d], Vs[lane * LD + d], dp);
      }
      x = masked(x * p.scale, row, col, p.S, hd.lim, p.causal);
      const float mn = fmaxf(m[r], warp_max(x));
      const float corr = expf(m[r] - mn);
      const float e = expf(x - mn);
      l[r] = corr * l[r] + warp_sum(e);
      rr[r] = corr * rr[r] + warp_sum(e * (dp * keep(p, rh[r], col)));
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
__global__ void __launch_bounds__(kThreads) dq_f32(Params p) {
  constexpr int LD = DM + 1, ND = DM / 32;
  extern __shared__ float fsm[];
  float* Qs = fsm;                 // [FROWS][DM]
  float* Os = Qs + FROWS * DM;     // [FROWS][DM] dout
  float* Ks = Os + FROWS * DM;     // [FT][LD]
  float* Vs = Ks + FT * LD;        // [FT][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * FROWS, h = blockIdx.y, b = blockIdx.z;
  const F32Head hd = f32_head(p, b, h);
  const int n_kt = key_tiles(q0, FROWS, FT, p.S, hd.lim, p.causal);
  load_f32<FROWS, DM>(Qs, DM, hd.q, hd.rs, q0, p.S, p.D, tid);
  load_f32<FROWS, DM>(Os, DM, hd.dout, p.F, q0, p.S, p.D, tid);

  float mr[RW], il[RW], rr[RW], acc[RW][ND];
  uint32_t rh[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    const long long i = ((long long)b * p.nh + h) * p.S + row;
    mr[r] = row < p.S ? p.m[i] : 0.f;
    il[r] = row < p.S ? p.il[i] : 0.f;
    rr[r] = row < p.S ? p.r[i] : 0.f;
    rh[r] = row_hash(hd.k1, row);
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
      const int lr = warp * RW + r, row = q0 + lr;
      float x = 0.f, dp = 0.f;
      for (int d = 0; d < DM; ++d) {
        x = fmaf(Qs[lr * DM + d], Ks[lane * LD + d], x);
        dp = fmaf(Os[lr * DM + d], Vs[lane * LD + d], dp);
      }
      x = masked(x * p.scale, row, col, p.S, hd.lim, p.causal);
      const float sg = expf(x - mr[r]) * il[r];
      const float ds = sg * (dp * keep(p, rh[r], col) - rr[r]);
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

// grid (ceil(S / 16), nh, B): one warp per key row, one lane per query of
// a 32-wide query tile
template <int DM>
__global__ void __launch_bounds__(kThreads) dkv_f32(Params p) {
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
  const int qt0 = (p.causal && hd.lim > 0) ? k0 / FT : 0;
  const int n_qt = (hd.lim == 0 || k0 < hd.lim) ? (p.S + FT - 1) / FT : 0;
  load_f32<FROWS, DM>(Ks, DM, hd.k, hd.rs, k0, p.S, p.D, tid);
  load_f32<FROWS, DM>(Vs, DM, hd.v, hd.rs, k0, p.S, p.D, tid);

  float dk[RW][ND], dv[RW][ND];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < ND; ++i) dk[r][i] = dv[r][i] = 0.f;
  for (int qt = qt0; qt < n_qt; ++qt) {
    __syncthreads();
    load_f32<FT, DM>(Qs, LD, hd.q, hd.rs, qt * FT, p.S, p.D, tid);
    load_f32<FT, DM>(Os, LD, hd.dout, p.F, qt * FT, p.S, p.D, tid);
    __syncthreads();
    const int qi = qt * FT + lane;
    const bool qok = qi < p.S;
    const float mq = qok ? p.m[st + qi] : 0.f, iq = qok ? p.il[st + qi] : 0.f;
    const float rq = qok ? p.r[st + qi] : 0.f;
    const uint32_t qh = row_hash(hd.k1, qi);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = warp * RW + r, key = k0 + lr;
      float x = 0.f, dp = 0.f;
      for (int d = 0; d < DM; ++d) {
        x = fmaf(Qs[lane * LD + d], Ks[lr * DM + d], x);
        dp = fmaf(Os[lane * LD + d], Vs[lr * DM + d], dp);
      }
      x = qok ? masked(x * p.scale, qi, key, p.S, hd.lim, p.causal)
              : -INFINITY;
      const float sg = expf(x - mq) * iq;
      const float kp = keep(p, qh, key);
      const float pd = sg * kp;
      const float ds = sg * (dp * kp - rq);
      for (int j = 0; j < FT; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pd, j);
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
enum Kind { kFwd = 0, kStats = 1, kDq = 2, kDkv = 3 };

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
cudaError_t launch_f32(int kind, const Params& p, cudaStream_t st) {
  constexpr int LD = DM + 1;
  constexpr size_t F = sizeof(float);
  const dim3 grid((p.S + FROWS - 1) / FROWS, p.nh, p.B);
  if (kind == kFwd)
    return launch(fwd_f32<DM>, grid, (FROWS * DM + FT * LD + FT * DM) * F, p,
                  st);
  const size_t sm = (2 * FROWS * DM + 2 * FT * LD) * F;
  if (kind == kStats) return launch(stats_f32<DM>, grid, sm, p, st);
  if (kind == kDq) return launch(dq_f32<DM>, grid, sm, p, st);
  return launch(dkv_f32<DM>, grid, sm, p, st);
}

cudaError_t run_f32(int kind, const Params& p, cudaStream_t st) {
  if (p.D <= 64) return launch_f32<64>(kind, p, st);
  if (p.D <= 128) return launch_f32<128>(kind, p, st);
  return launch_f32<256>(kind, p, st);
}

// the bf16 kernels' view of the packed tensors: q, k and v the [B, S, nh,
// D] column blocks of qkv (element strides S * 3F, 3F, D), dq, dk and dv
// those of dqkv
wg::Params wg_params(const Params& f, const void* qkv, float* lse) {
  wg::Params w{};
  const long long rs = 3LL * f.F;
  const bf16* q = static_cast<const bf16*>(qkv);
  w.q = q;
  w.k = q + f.F;
  w.v = q + 2 * f.F;
  w.q_sb = w.k_sb = w.v_sb = w.o_sb = (long long)f.S * rs;
  w.q_ss = w.k_ss = w.v_ss = w.o_ss = rs;
  w.q_sh = w.k_sh = w.v_sh = w.o_sh = f.D;
  w.B = f.B; w.H = f.nh; w.Sq = w.Sk = f.S; w.D = f.D;
  w.kv_lim = f.kv_len;
  w.causal = f.causal;
  w.scale = f.scale;
  w.lse = lse;
  w.lens = f.lens;
  w.seed = f.seed;
  w.thresh = f.thresh;
  w.inv = f.inv;
  w.drop = f.drop;
  return w;
}

bool fill(Params& p, int B, int S, int nh, int D, int kv_len, int causal,
          float scale, unsigned thresh, float inv) {
  if (B < 1 || B > 65535 || S < 1 || nh < 1 || nh > 65535 || D < 8 ||
      D > 256 || D % 8 || (nh * D) % 128 || kv_len < 1)
    return false;
  p.B = B; p.S = S; p.nh = nh; p.D = D; p.F = nh * D;
  p.kv_len = kv_len < S ? kv_len : S;
  p.causal = causal;
  p.scale = scale;
  p.thresh = thresh;
  p.inv = inv;
  p.drop = p.seed != nullptr && thresh > 0u;
  return true;
}

}  // namespace

extern "C" {

// qkv [B, S, 3F] -> out [B, S, F] and (bf16) lse [B, nh, S] f32; lens
// [B] int32 or null (then kv_len masks, kv_len >= S: none); seed one int32
// or null (no dropout); dtype: 0 = float32 (lse null), 1 = bfloat16
int pt_fused_mha_fwd(const void* qkv, void* out, float* lse, const int* lens,
                     const int* seed, int B, int S, int nh, int D, int kv_len,
                     int causal, float scale, unsigned thresh, float inv,
                     int dtype, void* stream) {
  // an error an earlier runtime call left pending is returned (and so
  // cleared), never dropped: the wrapper raises it
  if (cudaError_t pending = cudaGetLastError()) return pending;
  Params p{};
  p.qkv = qkv; p.out = out; p.lens = lens; p.seed = seed;
  if (!fill(p, B, S, nh, D, kv_len, causal, scale, thresh, inv))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!lse) return cudaErrorInvalidValue;
    wg::Params w = wg_params(p, qkv, lse);
    w.out = out;
    return wg::run_bf16<true>(wg::kFwd, w, st);
  }
  if (dtype == 0) return run_f32(kFwd, p, st);
  return cudaErrorInvalidValue;
}

// dqkv [B, S, 3F] from qkv, dout [B, S, F] and (bf16) the forward's lse.
// scratch: bf16, f32 [B, nh, S] for r; f32, [3, B, nh, S] for the row max,
// 1/sum and r. Three launches in order on the stream: bf16, the r pass,
// dQ, dK/dV; f32, the row statistics, dQ, dK/dV.
int pt_fused_mha_bwd(const void* qkv, const void* dout, const float* lse,
                     void* dqkv, float* scratch, const int* lens,
                     const int* seed, int B, int S, int nh, int D, int kv_len,
                     int causal, float scale, unsigned thresh, float inv,
                     int dtype, void* stream) {
  if (cudaError_t pending = cudaGetLastError()) return pending;
  Params p{};
  p.qkv = qkv; p.dout = dout; p.out = dqkv; p.lens = lens; p.seed = seed;
  if (!fill(p, B, S, nh, D, kv_len, causal, scale, thresh, inv))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!lse) return cudaErrorInvalidValue;
    wg::Params w = wg_params(p, qkv, const_cast<float*>(lse));
    w.dout = dout;
    w.r = scratch;
    w.delta = scratch;
    __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(dqkv);
    if (cudaError_t e = wg::run_bf16<true>(wg::kR, w, st)) return e;
    w.out = dq;
    if (cudaError_t e = wg::run_bf16<true>(wg::kDq, w, st)) return e;
    w.out = dq + p.F;
    w.out2 = dq + 2 * p.F;
    return wg::run_bf16<true>(wg::kDkv, w, st);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  const long long n = (long long)B * nh * S;
  p.m = scratch;
  p.il = scratch + n;
  p.r = scratch + 2 * n;
  const int kinds[3] = {kStats, kDq, kDkv};
  for (int kind : kinds)
    if (cudaError_t e = run_f32(kind, p, st)) return e;
  return cudaSuccess;
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
