// LayerNorm over the last axis for Hopper (sm_90a): the forward, and the
// backward with d(gamma) and d(beta).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/layer_norm.py
// `fused_layer_norm` (the forward `_fwd_kernel`, and `_bwd_kernel` of its
// custom VJP). Same function, not the same schedule: the TPU walks row
// blocks in order on one core and carries the d(gamma)/d(beta) sums in a
// VMEM scratch from one grid step to the next; here the row blocks run in
// parallel, each writes its own partial sums, and a second small launch
// adds the partials in block order (no atomics: two launches are bitwise
// equal).
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
// writes dx. Design against that:
//   * 16-byte vector loads and stores, neighbouring lanes on neighbouring
//     vectors;
//   * forward: one warp per row; the sums reduce by warp shuffles, then
//     the warp reads its row again (from L1/L2, not device memory) to
//     write the output, so any H is taken without holding the row in
//     registers;
//   * backward: one CTA per block of kBwdRows rows, each thread owning
//     the same columns in every row, so its d(gamma)/d(beta) sums stay in
//     shared memory without a race; per row, a and b reduce across the CTA
//     in a fixed order; the partials [blocks, 2, H] are summed by
//     `ln_bwd_sum` column by column in block order.
// The statistics and the output use round-to-nearest intrinsics so that no
// multiply-add is contracted: each step rounds as the plain PyTorch version
// does, and only the order of the sums differs.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kFwdWarps = 4;      // forward: rows per CTA, one per warp
constexpr int kBwdThreads = 256;
constexpr int kBwdRows = 16;      // backward: rows per CTA (the wrapper's
                                  // partial buffer holds ceil(R / 16) blocks)

// a 16-byte vector of T, widened to f32
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void load(const bf16* p, float (&v)[8]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(bf16* p, const float (&v)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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
};

// grid ceil(R / kFwdWarps); one warp per row
template <typename T>
__global__ void __launch_bounds__(kFwdWarps * 32) ln_fwd(FwdParams p) {
  constexpr int N = Vec<T>::N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kFwdWarps + warp;
  if (row >= p.R) return;
  const int nv = p.H / N;
  const T* x = static_cast<const T*>(p.x) + (long long)row * p.H;
  const T* g = static_cast<const T*>(p.g);
  const T* b = static_cast<const T*>(p.b);
  T* out = static_cast<T*>(p.out) + (long long)row * p.H;

  float s1 = 0.f, s2 = 0.f;
  for (int j = lane; j < nv; j += 32) {
    float v[N];
    Vec<T>::load(x + j * N, v);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      s1 = __fadd_rn(s1, v[e]);
      s2 = __fadd_rn(s2, __fmul_rn(v[e], v[e]));
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float n = static_cast<float>(p.H);
  const float mu = __fdiv_rn(s1, n);
  const float var =
      fmaxf(__fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mu, mu)), 0.f);
  const float rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, p.eps)));

  for (int j = lane; j < nv; j += 32) {
    float v[N], gv[N], bv[N];
    Vec<T>::load(x + j * N, v);
    if (g) Vec<T>::load(g + j * N, gv);
    if (b) Vec<T>::load(b + j * N, bv);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float y = __fmul_rn(__fsub_rn(v[e], mu), rs);
      if (g) y = __fmul_rn(y, gv[e]);
      if (b) y = __fadd_rn(y, bv[e]);
      v[e] = y;
    }
    Vec<T>::store(out + j * N, v);
  }
  if (lane == 0) {
    p.mu[row] = mu;
    p.rs[row] = rs;
  }
}

struct BwdParams {
  const void* dy;
  const void* x;
  const float* mu;
  const float* rs;
  const void* g;  // null: no gamma
  void* dx;
  float* part;    // [ceil(R / kBwdRows)][2][H]
  int R, H;
};

// grid ceil(R / kBwdRows); dynamic shared memory 2 * H floats
template <typename T>
__global__ void __launch_bounds__(kBwdThreads) ln_bwd(BwdParams p) {
  constexpr int N = Vec<T>::N, W = kBwdThreads / 32;
  extern __shared__ float acc[];  // [2][N][nv]: d(gamma), d(beta) sums
  __shared__ float red[2][W];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nv = p.H / N;
  const T* g = static_cast<const T*>(p.g);
  // column j * N + e of d(gamma) sits at acc[e * nv + j] (d(beta) H words
  // on): neighbouring threads on neighbouring words. Every thread zeroes,
  // sums and writes only the columns it owns, so no barrier guards acc.
  for (int j = tid; j < nv; j += kBwdThreads)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e * nv + j] = acc[p.H + e * nv + j] = 0.f;
  const float n = static_cast<float>(p.H);
  const int r0 = blockIdx.x * kBwdRows;
  const int r1 = min(r0 + kBwdRows, p.R);

  for (int row = r0; row < r1; ++row) {
    const float mu = p.mu[row], rs = p.rs[row];
    const T* dy = static_cast<const T*>(p.dy) + (long long)row * p.H;
    const T* x = static_cast<const T*>(p.x) + (long long)row * p.H;
    float sa = 0.f, sb = 0.f;
    for (int j = tid; j < nv; j += kBwdThreads) {
      float dv[N], xv[N], gv[N];
      Vec<T>::load(dy + j * N, dv);
      Vec<T>::load(x + j * N, xv);
      if (g) Vec<T>::load(g + j * N, gv);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float xh = __fmul_rn(__fsub_rn(xv[e], mu), rs);
        const float dyg = g ? __fmul_rn(dv[e], gv[e]) : dv[e];
        sa = __fadd_rn(sa, __fmul_rn(dyg, xh));
        sb = __fadd_rn(sb, dyg);
        float* ag = acc + e * nv + j;
        *ag = __fadd_rn(*ag, __fmul_rn(dv[e], xh));
        ag[p.H] = __fadd_rn(ag[p.H], dv[e]);
      }
    }
    sa = warp_sum(sa);
    sb = warp_sum(sb);
    if (lane == 0) {
      red[0][warp] = sa;
      red[1][warp] = sb;
    }
    __syncthreads();
    sa = sb = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      sa = __fadd_rn(sa, red[0][w]);
      sb = __fadd_rn(sb, red[1][w]);
    }
    __syncthreads();  // red is written again for the next row
    const float a = __fdiv_rn(sa, n), b = __fdiv_rn(sb, n);
    T* dx = static_cast<T*>(p.dx) + (long long)row * p.H;
    for (int j = tid; j < nv; j += kBwdThreads) {
      float dv[N], xv[N], gv[N];
      Vec<T>::load(dy + j * N, dv);
      Vec<T>::load(x + j * N, xv);
      if (g) Vec<T>::load(g + j * N, gv);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float xh = __fmul_rn(__fsub_rn(xv[e], mu), rs);
        const float dyg = g ? __fmul_rn(dv[e], gv[e]) : dv[e];
        dv[e] = __fmul_rn(
            rs, __fsub_rn(__fsub_rn(dyg, __fmul_rn(xh, a)), b));
      }
      Vec<T>::store(dx + j * N, dv);
    }
  }
  // each thread writes the columns it owns (no __syncthreads needed)
  float* part = p.part + (long long)blockIdx.x * 2 * p.H;
  for (int j = tid; j < nv; j += kBwdThreads)
#pragma unroll
    for (int e = 0; e < N; ++e) {
      part[j * N + e] = acc[e * nv + j];
      part[p.H + j * N + e] = acc[p.H + e * nv + j];
    }
}

// grid ceil(H / 256): one thread per column sums the blocks' partials in
// block order
__global__ void __launch_bounds__(256)
    ln_bwd_sum(const float* part, int nb, int H, float* dg, float* db) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= H) return;
  float sg = 0.f, sb = 0.f;
  for (int i = 0; i < nb; ++i) {
    sg = __fadd_rn(sg, part[(2LL * i) * H + c]);
    sb = __fadd_rn(sb, part[(2LL * i + 1) * H + c]);
  }
  dg[c] = sg;
  db[c] = sb;
}

bool bad_sizes(int R, int H) {
  return R < 1 || H < 8 || H % 8 || H > 16384;
}

template <typename T>
cudaError_t fwd(const FwdParams& p, cudaStream_t st) {
  ln_fwd<T><<<(p.R + kFwdWarps - 1) / kFwdWarps, kFwdWarps * 32, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const BwdParams& p, float* dg, float* db, cudaStream_t st) {
  const size_t smem = 2 * (size_t)p.H * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ln_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int nb = (p.R + kBwdRows - 1) / kBwdRows;
  ln_bwd<T><<<nb, kBwdThreads, smem, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ln_bwd_sum<<<(p.H + 255) / 256, 256, 0, st>>>(p.part, nb, p.H, dg, db);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, gamma, beta and out share it);
// gamma and beta may be null
int pt_layer_norm_fwd(const void* x, const void* gamma, const void* beta,
                      void* out, float* mu, float* rs, int R, int H,
                      float eps, int dtype, void* stream) {
  // an error an earlier runtime call left pending is returned (and so
  // cleared), never dropped: the wrapper raises it
  if (cudaError_t pending = cudaGetLastError()) return pending;
  if (bad_sizes(R, H)) return cudaErrorInvalidValue;
  FwdParams p{x, gamma, beta, out, mu, rs, R, H, eps};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return fwd<bf16>(p, st);
  if (dtype == 0) return fwd<float>(p, st);
  return cudaErrorInvalidValue;
}

// part: [ceil(R / 16)][2][H] float32 scratch; dgamma and dbeta [H] float32
// (computed whether or not gamma and beta exist)
int pt_layer_norm_bwd(const void* dy, const void* x, const float* mu,
                      const float* rs, const void* gamma, void* dx,
                      float* part, float* dgamma, float* dbeta, int R, int H,
                      int dtype, void* stream) {
  if (cudaError_t pending = cudaGetLastError()) return pending;
  if (bad_sizes(R, H)) return cudaErrorInvalidValue;
  BwdParams p{dy, x, mu, rs, gamma, dx, part, R, H};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return bwd<bf16>(p, dgamma, dbeta, st);
  if (dtype == 0) return bwd<float>(p, dgamma, dbeta, st);
  return cudaErrorInvalidValue;
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
