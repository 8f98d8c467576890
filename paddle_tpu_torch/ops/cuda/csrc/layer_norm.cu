// LayerNorm over the last axis for Hopper (sm_90a): the forward, and the
// backward with d(gamma) and d(beta).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/layer_norm.py
// `fused_layer_norm` (the forward `_fwd_kernel`, and `_bwd_kernel` of its
// custom VJP). Same function, not the same schedule: the TPU walks row
// blocks in order on one core and carries the d(gamma)/d(beta) sums in a
// VMEM scratch from one grid step to the next; here a persistent grid of
// CTAs each takes a contiguous range of rows, writes its own partial sums,
// and a second launch adds the partials in a fixed order (no atomics: two
// launches are bitwise equal).
//
//   x, out, dy, dx [R, H] contiguous, float32 or bfloat16, H % 8 == 0;
//   gamma, beta [H] in x's type, or null; mu, rsig [R] float32.
//   forward: s1 = sum x, s2 = sum x^2 in f32 (one pass, as the TPU kernel:
//     the variance is E[x^2] - E[x]^2 clamped at 0), mu = s1 / H,
//     rsig = 1 / sqrt(var + eps), out = (x - mu) * rsig * gamma + beta
//     rounded to x's type.
//   backward: xhat = (x - mu) * rsig from the saved statistics,
//     dyg = dy * gamma, a = sum(dyg * xhat) / H, b = sum(dyg) / H,
//     dx = rsig * (dyg - xhat * a - b); d(gamma) = sum over rows of
//     dy * xhat and d(beta) = sum over rows of dy, both f32.
//
// Bound: bytes (a few operations per element). The forward reads x once
// from device memory and writes out; the backward reads dy and x once and
// writes dx. The launch (variant, threads, vectors a thread, rows a group,
// CTAs) comes from `ln_plan` in ../layer_norm.py; the entry points check
// it and refuse a plan that does not cover the row. Design against the
// bound:
//   * "rows" (a row of at most 1024 16-byte vectors): every row is read
//     from device memory once. Each thread copies its own vectors of the
//     rows ahead into a ring in shared memory with cp.async (16 bytes a
//     copy, neighbouring threads on neighbouring vectors) and reads back
//     only what it copied, so the copies need no barrier and keep bytes in
//     flight while the thread computes.
//     - forward `ln_fwd_rows`: a group of `warps` warps takes a row, NV
//       vectors a lane (lanes past the row's end predicated), a ring of
//       up to 4 rows; s1 and s2 reduce by shuffles (then in shared memory
//       across the group's warps, one barrier a row); gamma and beta stay
//       in registers over the persistent walk;
//     - backward `ln_bwd_rows`: each thread owns the same NV column
//       vectors in every row, so its d(gamma)/d(beta) sums stay in
//       registers for the CTA's whole range of rows; rows go in groups of
//       K, two groups in the ring; each row's a and b reduce by shuffles
//       and one shared-memory exchange (one barrier a group), and dx is
//       formed from the ring. The saved mu and rsig of a group are read a
//       group ahead, one value a lane, and spread by shuffles. Narrow rows
//       put several row slots in a CTA; their sums meet in shared memory,
//       in slot order, at the end.
//   * "loop" (wider rows): a CTA takes a row at a time and reads it twice,
//     the second time from L2 (`ln_fwd_loop`; `ln_bwd_loop`, which keeps
//     the CTA's d(gamma)/d(beta) partial in its own slice of the partials
//     buffer), so any H runs.
//   * the partials' sum `ln_bwd_sum` spreads over the card: a CTA takes
//     128 columns of the [G, 2H] partials, its 16 warps ordered chunks of
//     the G partials, and the chunks meet in warp order; it is launched as
//     the row pass's programmatic dependent, so its launch overlaps the row
//     pass's end.
// The statistics and the outputs use round-to-nearest intrinsics so that
// no multiply-add is contracted: each step rounds as the plain PyTorch
// version does, and only the order of the sums differs.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxThreads = 512;  // every kernel's CTA limit (<= 128
                                  // registers a thread)
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kSumWarps = 16;     // partials' sum: warps a CTA
constexpr int kSumCols = 128;     // partials' sum: columns a CTA (a float4
                                  // a lane)
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory a CTA
constexpr int kFwdStages = 4;     // forward ring: rows a slot holds
constexpr int kBwdStages = 2;     // backward ring: groups a thread holds

// a 16-byte vector of T, held raw and widened to f32 where it is used
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void widen(const uint4& r, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float (&v)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
};

template <typename T>
__device__ __forceinline__ uint4 ld16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__device__ __forceinline__ void st16(T* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// N consecutive f32 values as float4s
template <int N>
__device__ __forceinline__ void ld_f32(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + i);
    v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
  }
}

template <int N>
__device__ __forceinline__ void st_f32(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the first row of CTA c's range when R rows are split over G CTAs
__device__ __forceinline__ long long range_start(long long c, int R,
                                                 int G) {
  return c * R / G;
}

// the row's statistics from its sums
__device__ __forceinline__ void stats(float s1, float s2, float n, float eps,
                                      float& mu, float& rs) {
  mu = __fdiv_rn(s1, n);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mu, mu)),
                          0.f);
  rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// one output vector from x's widened vector and gamma's and beta's raw
// ones (read where has_g, has_b)
template <typename T>
__device__ __forceinline__ uint4 normed(float (&v)[Vec<T>::N], float mu,
                                        float rs, bool has_g, const uint4& g,
                                        bool has_b, const uint4& b) {
  constexpr int N = Vec<T>::N;
  float gv[N], bv[N];
  Vec<T>::widen(g, gv);
  Vec<T>::widen(b, bv);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    float y = __fmul_rn(__fsub_rn(v[e], mu), rs);
    if (has_g) y = __fmul_rn(y, gv[e]);
    if (has_b) y = __fadd_rn(y, bv[e]);
    v[e] = y;
  }
  return Vec<T>::pack(v);
}

struct FwdParams {
  const void* x;
  const void* g;  // null: no gamma
  const void* b;  // null: no beta
  void* out;
  float* mu;
  float* rs;
  int R, H;
  float eps;
  int warps;      // rows: warps a row
};

// one ring slot a thread owns: vector i of the thread's stage `st` block
// of `per` vectors (neighbouring threads on neighbouring 16 bytes)
__device__ __forceinline__ uint4* ring_slot(uint4* ring, int st, int per,
                                            int i) {
  return ring + (long long)st * per + i * blockDim.x + threadIdx.x;
}

// grid: the plan's CTAs, persistent; blockDim a multiple of 32 * warps:
// blockDim / (32 * warps) row slots, each a group of `warps` warps taking
// rows blockIdx * slots + slot + it * gridDim * slots (it = 0, 1, ...);
// lane c of a slot holds vectors c, c + 32 * warps, ... (NV of them) of
// the row. Each thread copies its own vectors kFwdStages - 1 rows ahead
// into a ring in dynamic shared memory ([kFwdStages][NV][blockDim] 16-byte
// vectors) with cp.async, and reads back only what it copied; each
// iteration commits one cp.async group, empty or not.
template <int NV, typename T>
__global__ void __launch_bounds__(kMaxThreads) ln_fwd_rows(FwdParams p) {
  constexpr int N = Vec<T>::N;
  extern __shared__ uint4 ring[];
  __shared__ float red[2][kMaxWarps][2];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tpr = 32 * p.warps, slot = tid / tpr, c = tid % tpr;
  const int slots = blockDim.x / tpr, nv = p.H / N, per = NV * blockDim.x;
  const T* x = static_cast<const T*>(p.x);
  const T* g = static_cast<const T*>(p.g);
  const T* b = static_cast<const T*>(p.b);
  T* out = static_cast<T*>(p.out);
  const float n = static_cast<float>(p.H);

  uint4 gr[NV] = {}, br[NV] = {};
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = c + i * tpr;
    if (j < nv) {
      if (g) gr[i] = ld16(g + j * N);
      if (b) br[i] = ld16(b + j * N);
    }
  }
  const long long first = (long long)blockIdx.x * slots;
  const long long step = (long long)gridDim.x * slots;
  // the CTA's trip count: every thread meets the barrier and commits
  const long long trips = first < p.R ? (p.R - first + step - 1) / step : 0;
  auto fetch = [&](long long it) {
    const long long row = first + slot + it * step;
    if (it < trips && row < p.R) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = c + i * tpr;
        if (j < nv)
          tiles::cp_async16(ring_slot(ring, it % kFwdStages, per, i),
                            x + row * p.H + j * N, true);
      }
    }
    tiles::cp_async_commit();
  };
  for (int s = 0; s + 1 < kFwdStages; ++s) fetch(s);
  for (long long it = 0; it < trips; ++it) {
    fetch(it + kFwdStages - 1);
    tiles::cp_async_wait<kFwdStages - 1>();
    const long long row = first + slot + it * step;
    const int st = it % kFwdStages;
    float s1 = 0.f, s2 = 0.f;
    if (row < p.R) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (c + i * tpr >= nv) continue;
        float v[N];
        Vec<T>::widen(*ring_slot(ring, st, per, i), v);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          s1 = __fadd_rn(s1, v[e]);
          s2 = __fadd_rn(s2, __fmul_rn(v[e], v[e]));
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (p.warps > 1) {
      float(*r)[2] = red[it & 1];
      if (lane == 0) {
        r[warp][0] = s1;
        r[warp][1] = s2;
      }
      // one barrier a row: red is double-buffered, and a warp writes this
      // buffer again only after the next row's barrier
      __syncthreads();
      s1 = s2 = 0.f;
      for (int w = slot * p.warps; w < (slot + 1) * p.warps; ++w) {
        s1 = __fadd_rn(s1, r[w][0]);
        s2 = __fadd_rn(s2, r[w][1]);
      }
    }
    if (row < p.R) {
      float mu, rs;
      stats(s1, s2, n, p.eps, mu, rs);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = c + i * tpr;
        if (j >= nv) continue;
        float v[N];
        Vec<T>::widen(*ring_slot(ring, st, per, i), v);
        st16(out + row * p.H + j * N,
             normed<T>(v, mu, rs, g, gr[i], b, br[i]));
      }
      if (c == 0) {
        p.mu[row] = mu;
        p.rs[row] = rs;
      }
    }
  }
  tiles::cp_async_wait<0>();
}

// block-wide sum of s1 and s2 over the CTA's warps in warp order (red
// double-buffered by the caller's parity, one barrier)
__device__ __forceinline__ void block_sum2(float (*red)[2], float& s1,
                                           float& s2) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red[warp][0] = s1;
    red[warp][1] = s2;
  }
  __syncthreads();
  s1 = s2 = 0.f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) {
    s1 = __fadd_rn(s1, red[w][0]);
    s2 = __fadd_rn(s2, red[w][1]);
  }
}

// grid: the plan's CTAs, persistent over rows, one row at a time; thread t
// takes vectors t, t + blockDim, ...; the row is read a second time (from
// L2) to write the output
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) ln_fwd_loop(FwdParams p) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[2][kMaxWarps][2];
  const int nv = p.H / N;
  const T* g = static_cast<const T*>(p.g);
  const T* b = static_cast<const T*>(p.b);
  const float n = static_cast<float>(p.H);
  int it = 0;
  for (long long row = blockIdx.x; row < p.R; row += gridDim.x, ++it) {
    const T* x = static_cast<const T*>(p.x) + row * p.H;
    T* out = static_cast<T*>(p.out) + row * p.H;
    float s1 = 0.f, s2 = 0.f;
    for (int j = threadIdx.x; j < nv; j += blockDim.x) {
      float v[N];
      Vec<T>::widen(ld16(x + j * N), v);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        s1 = __fadd_rn(s1, v[e]);
        s2 = __fadd_rn(s2, __fmul_rn(v[e], v[e]));
      }
    }
    block_sum2(red[it & 1], s1, s2);
    float mu, rs;
    stats(s1, s2, n, p.eps, mu, rs);
    for (int j = threadIdx.x; j < nv; j += blockDim.x) {
      float v[N];
      Vec<T>::widen(ld16(x + j * N), v);
      const uint4 gr = g ? ld16(g + j * N) : uint4{};
      const uint4 br = b ? ld16(b + j * N) : uint4{};
      st16(out + j * N, normed<T>(v, mu, rs, g, gr, b, br));
    }
    if (threadIdx.x == 0) {
      p.mu[row] = mu;
      p.rs[row] = rs;
    }
  }
}

struct BwdParams {
  const void* dy;
  const void* x;
  const float* mu;
  const float* rs;
  const void* g;  // null: no gamma
  void* dx;
  float* part;    // [gridDim][2][H]: each CTA's d(gamma), d(beta) sums
  int R, H;
  int tpr;        // rows: threads a row slot
};

// one row's a, b terms of a thread's vector: sa += dyg * xhat, sb += dyg
template <typename T>
__device__ __forceinline__ void ab_terms(const uint4& d, const uint4& xv,
                                         bool has_g, const uint4& g,
                                         float mu, float rs, float& sa,
                                         float& sb) {
  constexpr int N = Vec<T>::N;
  float dv[N], xf[N], gv[N];
  Vec<T>::widen(d, dv);
  Vec<T>::widen(xv, xf);
  Vec<T>::widen(g, gv);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float xh = __fmul_rn(__fsub_rn(xf[e], mu), rs);
    const float dyg = has_g ? __fmul_rn(dv[e], gv[e]) : dv[e];
    sa = __fadd_rn(sa, __fmul_rn(dyg, xh));
    sb = __fadd_rn(sb, dyg);
  }
}

// one row's dx vector, and its terms of d(gamma) (dy * xhat) and d(beta)
// (dy) in tg, tb
template <typename T>
__device__ __forceinline__ uint4 dx_terms(const uint4& d, const uint4& xv,
                                          bool has_g, const uint4& g,
                                          float mu, float rs, float a,
                                          float b, float (&tg)[Vec<T>::N],
                                          float (&tb)[Vec<T>::N]) {
  constexpr int N = Vec<T>::N;
  float dv[N], xf[N], gv[N];
  Vec<T>::widen(d, dv);
  Vec<T>::widen(xv, xf);
  Vec<T>::widen(g, gv);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float xh = __fmul_rn(__fsub_rn(xf[e], mu), rs);
    const float dyg = has_g ? __fmul_rn(dv[e], gv[e]) : dv[e];
    tg[e] = __fmul_rn(dv[e], xh);
    tb[e] = dv[e];
    xf[e] = __fmul_rn(rs, __fsub_rn(__fsub_rn(dyg, __fmul_rn(xh, a)), b));
  }
  return Vec<T>::pack(xf);
}

// grid G: CTA c takes rows [c R / G, (c + 1) R / G); blockDim = slots *
// tpr; thread c of a row slot owns vectors c, c + tpr, ... (NV of them) of
// every row; the slot takes rows base + slot * K + k (k < K) of each group
// of slots * K rows. Each thread copies its own vectors of dy and x
// kBwdStages - 1 groups ahead into a ring in dynamic shared memory
// ([kBwdStages][K][2][NV][blockDim] 16-byte vectors) with cp.async, and
// reads back only what it copied (each iteration commits one cp.async
// group, empty or not); with several slots the ring then holds the slots'
// [slots][2][H] sums.
template <int NV, int K, typename T>
__global__ void __launch_bounds__(kMaxThreads) ln_bwd_rows(BwdParams p) {
  constexpr int N = Vec<T>::N;
  extern __shared__ uint4 ring[];
  __shared__ float red[2][kMaxWarps][K][2];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tpr = p.tpr, slot = tid / tpr, c = tid % tpr;
  const int slots = blockDim.x / tpr, wps = tpr / 32, nv = p.H / N;
  const int per = NV * blockDim.x;  // vectors of one row of one tensor
  const T* dy = static_cast<const T*>(p.dy);
  const T* x = static_cast<const T*>(p.x);
  const T* g = static_cast<const T*>(p.g);
  T* dx = static_cast<T*>(p.dx);
  const float n = static_cast<float>(p.H);
  const long long r0 = range_start(blockIdx.x, p.R, gridDim.x);
  const long long r1 = range_start(blockIdx.x + 1, p.R, gridDim.x);
  const long long span = (long long)slots * K;
  const long long groups = (r1 - r0 + span - 1) / span;

  uint4 gr[NV] = {};
  float ag[NV][N], ab[NV][N];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (g && c + i * tpr < nv) gr[i] = ld16(g + (c + i * tpr) * N);
#pragma unroll
    for (int e = 0; e < N; ++e) ag[i][e] = ab[i][e] = 0.f;
  }
  // ring stage st, row k of the group, tensor t (0: dy, 1: x): stage block
  // ((st * K + k) * 2 + t) of `per` vectors
  auto fetch = [&](long long it) {
    if (it < groups) {
      const long long rb = r0 + it * span + (long long)slot * K;
      const int st = it % kBwdStages;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (rb + k >= r1) continue;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int j = c + i * tpr;
          if (j >= nv) continue;
          const long long off = (rb + k) * p.H + j * N;
          tiles::cp_async16(ring_slot(ring, (st * K + k) * 2, per, i),
                            dy + off, true);
          tiles::cp_async16(ring_slot(ring, (st * K + k) * 2 + 1, per, i),
                            x + off, true);
        }
      }
    }
    tiles::cp_async_commit();
  };
  // the statistics of the slot's rows of group `it`: lane k < K of each
  // warp holds row k's mu, lane K + k its rsig (read a group ahead, spread
  // by shuffles)
  auto stats_of = [&](long long it) {
    const long long row = r0 + it * span + (long long)slot * K + lane % K;
    if (it >= groups || lane >= 2 * K || row >= r1) return 0.f;
    return lane < K ? p.mu[row] : p.rs[row];
  };
  for (int s = 0; s + 1 < kBwdStages; ++s) fetch(s);
  float cur = stats_of(0);
  // the trip count is the CTA's, so every thread meets the barrier
  for (long long it = 0; it < groups; ++it) {
    fetch(it + kBwdStages - 1);
    const float nxt = stats_of(it + 1);
    tiles::cp_async_wait<kBwdStages - 1>();
    const long long rb = r0 + it * span + (long long)slot * K;
    const int st = it % kBwdStages;
    float(*r)[K][2] = red[it & 1];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float sa = 0.f, sb = 0.f;
      const float mu = __shfl_sync(0xffffffffu, cur, k);
      const float rs = __shfl_sync(0xffffffffu, cur, K + k);
      if (rb + k < r1) {
#pragma unroll
        for (int i = 0; i < NV; ++i)
          if (c + i * tpr < nv)
            ab_terms<T>(*ring_slot(ring, (st * K + k) * 2, per, i),
                        *ring_slot(ring, (st * K + k) * 2 + 1, per, i), g,
                        gr[i], mu, rs, sa, sb);
      }
      sa = warp_sum(sa);
      sb = warp_sum(sb);
      if (lane == 0) {
        r[warp][k][0] = sa;
        r[warp][k][1] = sb;
      }
    }
    // one barrier a group: red is double-buffered, and a warp writes this
    // buffer again only after the next group's barrier
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float mu = __shfl_sync(0xffffffffu, cur, k);
      const float rs = __shfl_sync(0xffffffffu, cur, K + k);
      if (rb + k >= r1) continue;
      float a = 0.f, b = 0.f;
      for (int w = slot * wps; w < (slot + 1) * wps; ++w) {
        a = __fadd_rn(a, r[w][k][0]);
        b = __fadd_rn(b, r[w][k][1]);
      }
      a = __fdiv_rn(a, n);
      b = __fdiv_rn(b, n);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = c + i * tpr;
        if (j >= nv) continue;
        float tg[N], tb[N];
        st16(dx + (rb + k) * p.H + j * N,
             dx_terms<T>(*ring_slot(ring, (st * K + k) * 2, per, i),
                         *ring_slot(ring, (st * K + k) * 2 + 1, per, i), g,
                         gr[i], mu, rs, a, b, tg, tb));
#pragma unroll
        for (int e = 0; e < N; ++e) {
          ag[i][e] = __fadd_rn(ag[i][e], tg[e]);
          ab[i][e] = __fadd_rn(ab[i][e], tb[e]);
        }
      }
    }
    cur = nxt;
  }
  tiles::cp_async_wait<0>();
  asm volatile("griddepcontrol.launch_dependents;");
  float* part = p.part + (long long)blockIdx.x * 2 * p.H;
  if (slots == 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = c + i * tpr;
      if (j >= nv) continue;
      st_f32<N>(part + j * N, ag[i]);
      st_f32<N>(part + p.H + j * N, ab[i]);
    }
    return;
  }
  // several row slots: their sums meet in the ring, in slot order, once
  // every thread is done with it
  __syncthreads();
  float* sums = reinterpret_cast<float*>(ring);
  float* mine = sums + (long long)slot * 2 * p.H;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = c + i * tpr;
    if (j >= nv) continue;
    st_f32<N>(mine + j * N, ag[i]);
    st_f32<N>(mine + p.H + j * N, ab[i]);
  }
  __syncthreads();
  for (int col = tid; col < 2 * p.H; col += blockDim.x) {
    float s = 0.f;
    for (int sl = 0; sl < slots; ++sl)
      s = __fadd_rn(s, sums[(long long)sl * 2 * p.H + col]);
    part[col] = s;
  }
}

// grid G: CTA c takes rows [c R / G, (c + 1) R / G) one at a time; thread
// t takes vectors t, t + blockDim, ... and keeps its columns' d(gamma),
// d(beta) sums in the CTA's slice of the partials (the first row writes
// it); the row is read a second time (from L2) to form dx
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) ln_bwd_loop(BwdParams p) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[2][kMaxWarps][2];
  const int nv = p.H / N;
  const T* g = static_cast<const T*>(p.g);
  const float n = static_cast<float>(p.H);
  const long long r0 = range_start(blockIdx.x, p.R, gridDim.x);
  const long long r1 = range_start(blockIdx.x + 1, p.R, gridDim.x);
  float* part = p.part + (long long)blockIdx.x * 2 * p.H;
  int it = 0;
  for (long long row = r0; row < r1; ++row, ++it) {
    const T* dy = static_cast<const T*>(p.dy) + row * p.H;
    const T* x = static_cast<const T*>(p.x) + row * p.H;
    T* dx = static_cast<T*>(p.dx) + row * p.H;
    const float mu = p.mu[row], rs = p.rs[row];
    float sa = 0.f, sb = 0.f;
    for (int j = threadIdx.x; j < nv; j += blockDim.x) {
      const uint4 gr = g ? ld16(g + j * N) : uint4{};
      ab_terms<T>(ld16(dy + j * N), ld16(x + j * N), g, gr, mu, rs, sa,
                  sb);
    }
    block_sum2(red[it & 1], sa, sb);
    const float a = __fdiv_rn(sa, n), b = __fdiv_rn(sb, n);
    for (int j = threadIdx.x; j < nv; j += blockDim.x) {
      const uint4 gr = g ? ld16(g + j * N) : uint4{};
      float tg[N], tb[N];
      st16(dx + j * N, dx_terms<T>(ld16(dy + j * N), ld16(x + j * N), g, gr,
                                   mu, rs, a, b, tg, tb));
      if (row > r0) {
        float og[N], ob[N];
        ld_f32<N>(part + j * N, og);
        ld_f32<N>(part + p.H + j * N, ob);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          tg[e] = __fadd_rn(og[e], tg[e]);
          tb[e] = __fadd_rn(ob[e], tb[e]);
        }
      }
      st_f32<N>(part + j * N, tg);
      st_f32<N>(part + p.H + j * N, tb);
    }
  }
}

// grid ceil(2H / kSumCols), kSumWarps warps: CTA i takes columns
// [kSumCols i, kSumCols (i + 1)) of the [G][2H] partials, four a lane;
// warp w adds partials [w G / kSumWarps, (w + 1) G / kSumWarps) in order,
// then the chunks meet in warp order
__global__ void __launch_bounds__(kSumWarps * 32)
    ln_bwd_sum(const float* part, int G, int H, float* dg, float* db) {
  __shared__ float4 chunk[kSumWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // launched as the row pass's programmatic dependent: wait until its
  // partials are complete and visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long w2 = 2LL * H;
  const long long col = (long long)blockIdx.x * kSumCols + 4 * lane;
  const int g0 = warp * G / kSumWarps, g1 = (warp + 1) * G / kSumWarps;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < w2) {
#pragma unroll 4
    for (int i = g0; i < g1; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(part + i * w2 + col);
      s.x = __fadd_rn(s.x, v.x);
      s.y = __fadd_rn(s.y, v.y);
      s.z = __fadd_rn(s.z, v.z);
      s.w = __fadd_rn(s.w, v.w);
    }
  }
  chunk[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || col >= w2) return;
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int w = 0; w < kSumWarps; ++w) {
    const float4 v = chunk[w][lane];
    t.x = __fadd_rn(t.x, v.x);
    t.y = __fadd_rn(t.y, v.y);
    t.z = __fadd_rn(t.z, v.z);
    t.w = __fadd_rn(t.w, v.w);
  }
  // H % 8 == 0: the four columns lie all in d(gamma) or all in d(beta)
  float* o = col < H ? dg + col : db + (col - H);
  *reinterpret_cast<float4*>(o) = t;
}

// the plan's launch shape, checked against the row before any launch
bool bad_launch(int R, int H, int threads, int grid) {
  return R < 1 || H < 8 || H % 8 || threads < 32 || threads % 32 ||
         threads > kMaxThreads || grid < 1;
}

// launch a "rows" kernel with `smem` bytes of dynamic shared memory
template <typename P>
cudaError_t launch_rows(void (*kernel)(P), const P& p, int threads,
                        int grid, size_t smem, cudaStream_t st) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(FwdParams p, int variant, int threads, int warps, int vecs,
                int grid, cudaStream_t st) {
  if (variant == 1) {
    ln_fwd_loop<T><<<grid, threads, 0, st>>>(p);
    return cudaGetLastError();
  }
  constexpr int N = Vec<T>::N;
  // rows: a slot's lanes must cover the row
  if (variant != 0 || warps < 1 || threads % (32 * warps) ||
      (long long)32 * warps * vecs * N < p.H)
    return cudaErrorInvalidValue;
  p.warps = warps;
  const size_t smem = (size_t)kFwdStages * vecs * threads * 16;
  switch (vecs) {
    case 1: return launch_rows(ln_fwd_rows<1, T>, p, threads, grid, smem, st);
    case 2: return launch_rows(ln_fwd_rows<2, T>, p, threads, grid, smem, st);
    case 3: return launch_rows(ln_fwd_rows<3, T>, p, threads, grid, smem, st);
    case 4: return launch_rows(ln_fwd_rows<4, T>, p, threads, grid, smem, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd(BwdParams p, float* dg, float* db, int variant, int threads,
                int tpr, int vecs, int k, int grid, cudaStream_t st) {
  constexpr int N = Vec<T>::N;
  if (grid > p.R) return cudaErrorInvalidValue;  // no CTA without rows
  cudaError_t e = cudaErrorInvalidValue;
  if (variant == 1) {
    ln_bwd_loop<T><<<grid, threads, 0, st>>>(p);
    e = cudaGetLastError();
  } else if (variant == 0 && tpr >= 32 && tpr % 32 == 0 &&
             threads % tpr == 0 && (long long)tpr * vecs * N >= p.H) {
    p.tpr = tpr;
    // the ring; it also holds the slots' sums, which never need more
    const size_t smem = (size_t)kBwdStages * k * 2 * vecs * threads * 16;
    if (vecs == 1 && k == 4)
      e = launch_rows(ln_bwd_rows<1, 4, T>, p, threads, grid, smem, st);
    if (vecs == 1 && k == 2)
      e = launch_rows(ln_bwd_rows<1, 2, T>, p, threads, grid, smem, st);
    if (vecs == 2 && k == 2)
      e = launch_rows(ln_bwd_rows<2, 2, T>, p, threads, grid, smem, st);
  }
  if (e != cudaSuccess) return e;
  // the partials' sum may launch while the row pass ends (it waits for
  // the row pass's partials itself)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((2LL * p.H + kSumCols - 1) / kSumCols));
  cfg.blockDim = dim3(kSumWarps * 32);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* part = p.part;
  return cudaLaunchKernelEx(&cfg, ln_bwd_sum, part, grid, p.H, dg, db);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, gamma, beta and out share it);
// gamma and beta may be null. variant 0 ("rows": `warps` warps a row,
// `vecs` vectors a lane) or 1 ("loop"); `threads` a CTA, `grid` CTAs.
int pt_layer_norm_fwd(const void* x, const void* gamma, const void* beta,
                      void* out, float* mu, float* rs, int R, int H,
                      float eps, int dtype, int variant, int threads,
                      int warps, int vecs, int grid, void* stream) {
  // an error an earlier runtime call left pending is returned (and so
  // cleared), never dropped: the wrapper raises it
  if (cudaError_t pending = cudaGetLastError()) return pending;
  if (bad_launch(R, H, threads, grid)) return cudaErrorInvalidValue;
  FwdParams p{x, gamma, beta, out, mu, rs, R, H, eps, 1};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return fwd<bf16>(p, variant, threads, warps, vecs, grid, st);
  if (dtype == 0)
    return fwd<float>(p, variant, threads, warps, vecs, grid, st);
  return cudaErrorInvalidValue;
}

// part: [grid][2][H] float32 scratch; dgamma and dbeta [H] float32
// (computed whether or not gamma exists). variant 0 ("rows": row slots of
// `tpr` threads, `vecs` vectors a thread, `k` rows a group) or 1
// ("loop"); `threads` a CTA, `grid` CTAs (at most R).
int pt_layer_norm_bwd(const void* dy, const void* x, const float* mu,
                      const float* rs, const void* gamma, void* dx,
                      float* part, float* dgamma, float* dbeta, int R, int H,
                      int dtype, int variant, int threads, int tpr, int vecs,
                      int k, int grid, void* stream) {
  if (cudaError_t pending = cudaGetLastError()) return pending;
  if (bad_launch(R, H, threads, grid)) return cudaErrorInvalidValue;
  BwdParams p{dy, x, mu, rs, gamma, dx, part, R, H, 0};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bwd<bf16>(p, dgamma, dbeta, variant, threads, tpr, vecs, k, grid,
                     st);
  if (dtype == 0)
    return bwd<float>(p, dgamma, dbeta, variant, threads, tpr, vecs, k,
                      grid, st);
  return cudaErrorInvalidValue;
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
