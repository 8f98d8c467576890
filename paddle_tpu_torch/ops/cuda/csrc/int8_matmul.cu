// Weight-only int8 GEMM for Hopper (sm_90a): y = (x @ widen(q)) * s.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/int8_matmul.py
// `int8_matmul` (its `_kernel` body; `int8_linear_nd` is the N-d wrapper
// around it). Same function, not the same tiling: the TPU kernel keeps the
// whole K extent of a weight tile resident in VMEM and lets one grid step
// produce an [mt, bn] output tile; here one CTA owns one [BM, BN] output
// tile and loops over K in BK-wide chunks staged through shared memory.
//
//   x   [M, K]  fp32 or bf16, row-major, contiguous
//   q   [K, N]  int8 (layout "kn")  or  [N, K] int8 (layout "nk")
//   s   [N]     f32 scale per output channel
//   y   [M, N]  x's dtype:  y[m, n] = cast((sum_k x[m, k] * q(k, n)) * s[n])
//
// Bound: at decode widths (M = 8) device-memory bytes, the K*N int8 weight
// read dominating; at static prefill (M = 1024) tensor-core operations.
// Design against that:
//   * the int8 codes travel global -> shared memory as int8 (16-byte loads
//     in the "nk" layout the model uses) and are widened in registers while
//     the mma fragments are built; no dequantized weight ever exists in
//     device memory;
//   * bf16 x: mma.sync m16n8k16 bf16 x bf16 -> f32 on the tensor cores.
//     Widening int8 to bf16 is exact (|code| <= 127), so this is the TPU
//     kernel's widen-then-dot with an f32 accumulator;
//   * fp32 x: plain f32 FMAs on the CUDA cores (never TF32), each thread a
//     4x4 register tile of the output;
//   * double-buffered shared memory: the next chunk's global loads are in
//     flight while the current chunk is multiplied;
//   * the per-channel scale multiplies the f32 accumulator in the epilogue,
//     then the cast to x's dtype; M and N edges are masked there, K edges
//     are zero-filled when staged.
// Inputs: M >= 1, N >= 1, K a multiple of 16, 16-byte aligned bases.
//
// Plain C interface (loaded with ctypes): the entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // tensor-core kernel: 4 warps

__device__ __forceinline__ uint32_t widen_pair(int8_t lo, int8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo),
                                           static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// bf16 x on the tensor cores. WM x WN warps, each owning TM x TN mma tiles
// of 16 x 8 outputs: BM = 16*WM*TM rows, BN = 8*WN*TN columns per CTA.
// Shared memory holds x as bf16 [BM][BK] and the codes as int8 [BN][BK]
// (the "kn" layout is transposed while it is staged).
template <int WM, int WN, int TM, int TN, int BK, bool NK>
struct TcCfg {
  static constexpr int BM = 16 * WM * TM;
  static constexpr int BN = 8 * WN * TN;
  static constexpr int APAD = BK + 8;    // bf16 row stride, 16-byte multiple
  static constexpr int BPAD = BK + 16;   // int8 row stride, 16-byte multiple
  static constexpr int XV = BM * BK / 8 / kThreads;   // uint4 of x / thread
  static constexpr int WV = BN * BK / 16 / kThreads;  // uint4 of q / thread
  static constexpr int WE = BK * BN / kThreads;       // bytes of q / thread
  static_assert(WM * WN * 32 == kThreads, "4 warps");
  static_assert(BK % 16 == 0, "BK is whole mma steps");
  static_assert(XV * 8 * kThreads == BM * BK, "x tile splits evenly");
  static_assert(!NK || WV * 16 * kThreads == BN * BK, "q tile splits evenly");
  static_assert(NK || WE * kThreads == BK * BN, "q tile splits evenly");
};

template <int WM, int WN, int TM, int TN, int BK, bool NK>
__global__ void __launch_bounds__(kThreads)
    int8_mm_tc_kernel(const __nv_bfloat16* __restrict__ x,
                      const int8_t* __restrict__ q,
                      const float* __restrict__ s,
                      __nv_bfloat16* __restrict__ y, int M, int N, int K) {
  using C = TcCfg<WM, WN, TM, TN, BK, NK>;
  __shared__ __align__(16) __nv_bfloat16 As[2][C::BM][C::APAD];
  __shared__ __align__(16) int8_t Bs[2][C::BN][C::BPAD];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;

  uint4 xr[C::XV];
  uint4 wr[NK ? C::WV : 1];
  int8_t we[NK ? 1 : C::WE];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < C::XV; ++i) {
      const int v = tid + i * kThreads;
      const int row = v / (BK / 8), gk = k0 + (v % (BK / 8)) * 8;
      const int gm = m0 + row;
      xr[i] = (gm < M && gk < K)
                  ? *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk)
                  : make_uint4(0, 0, 0, 0);
    }
    if constexpr (NK) {
#pragma unroll
      for (int i = 0; i < C::WV; ++i) {
        const int v = tid + i * kThreads;
        const int row = v / (BK / 16), gk = k0 + (v % (BK / 16)) * 16;
        const int gn = n0 + row;
        wr[i] = (gn < N && gk < K)
                    ? *reinterpret_cast<const uint4*>(q + (size_t)gn * K + gk)
                    : make_uint4(0, 0, 0, 0);
      }
    } else {
      // "kn": neighbouring threads read neighbouring columns of one row
#pragma unroll
      for (int i = 0; i < C::WE; ++i) {
        const int e = tid + i * kThreads;
        const int gk = k0 + e / C::BN, gn = n0 + e % C::BN;
        we[i] = (gk < K && gn < N) ? q[(size_t)gk * N + gn] : int8_t(0);
      }
    }
  };

  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < C::XV; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&As[buf][v / (BK / 8)][(v % (BK / 8)) * 8]) =
          xr[i];
    }
    if constexpr (NK) {
#pragma unroll
      for (int i = 0; i < C::WV; ++i) {
        const int v = tid + i * kThreads;
        *reinterpret_cast<uint4*>(
            &Bs[buf][v / (BK / 16)][(v % (BK / 16)) * 16]) = wr[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < C::WE; ++i) {
        const int e = tid + i * kThreads;
        Bs[buf][e % C::BN][e / C::BN] = we[i];
      }
    }
  };

  float acc[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int nk = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[TM][4], b[TN][2];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = (wm * TM + i) * 16 + g;
        a[i][0] = ld32(&As[buf][r][kk + 2 * t]);
        a[i][1] = ld32(&As[buf][r + 8][kk + 2 * t]);
        a[i][2] = ld32(&As[buf][r][kk + 2 * t + 8]);
        a[i][3] = ld32(&As[buf][r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int8_t* p = &Bs[buf][(wn * TN + j) * 8 + g][kk + 2 * t];
        b[j][0] = widen_pair(p[0], p[1]);
        b[j][1] = widen_pair(p[8], p[9]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r0 = m0 + (wm * TM + i) * 16 + g;
      const int c0 = n0 + (wn * TN + j) * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= M) continue;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = c0 + u;
          if (c < N)
            y[(size_t)r * N + c] = __float2bfloat16(acc[i][j][2 * h + u] * s[c]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 x on the CUDA cores: 256 threads, a 64 x 64 output tile, BK = 16.
// x is staged transposed (As[k][m]) and the codes widened to f32 as they
// are staged (Bs[k][n]), so the inner loop is two shared-memory reads per
// four FMAs.
constexpr int kF32Threads = 256;
constexpr int kFB = 64, kFK = 16;

template <bool NK>
__global__ void __launch_bounds__(kF32Threads)
    int8_mm_f32_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ s, float* __restrict__ y,
                       int M, int N, int K) {
  __shared__ float As[kFK][kFB + 4];
  __shared__ float Bs[kFK][kFB + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kFB, n0 = blockIdx.x * kFB;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kFK) {
    {  // x: 64 rows x 16 columns = one float4 per thread
      const int row = tid / 4, gk = k0 + (tid % 4) * 4, gm = m0 + row;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gm < M) v = *reinterpret_cast<const float4*>(x + (size_t)gm * K + gk);
      As[(tid % 4) * 4 + 0][row] = v.x;
      As[(tid % 4) * 4 + 1][row] = v.y;
      As[(tid % 4) * 4 + 2][row] = v.z;
      As[(tid % 4) * 4 + 3][row] = v.w;
    }
    if constexpr (NK) {  // 64 code rows of 16 bytes
      if (tid < kFB) {
        const int gn = n0 + tid;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (gn < N) v = *reinterpret_cast<const uint4*>(q + (size_t)gn * K + k0);
        const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int k = 0; k < kFK; ++k) Bs[k][tid] = static_cast<float>(b[k]);
      }
    } else {  // 16 code rows of 64 bytes, one byte per thread per pass
#pragma unroll
      for (int i = 0; i < kFK * kFB / kF32Threads; ++i) {
        const int e = tid + i * kF32Threads;
        const int kk = e / kFB, gn = n0 + e % kFB;
        Bs[kk][e % kFB] =
            gn < N ? static_cast<float>(q[(size_t)(k0 + kk) * N + gn]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < N) y[(size_t)r * N + c] = acc[i][j] * s[c];
    }
  }
}

template <int WM, int WN, int TM, int TN, int BK, bool NK>
cudaError_t launch_tc(const void* x, const void* q, const float* s, void* y,
                      int M, int N, int K, cudaStream_t stream) {
  using C = TcCfg<WM, WN, TM, TN, BK, NK>;
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  int8_mm_tc_kernel<WM, WN, TM, TN, BK, NK><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q), s,
      static_cast<__nv_bfloat16*>(y), M, N, K);
  return cudaGetLastError();
}

// skinny M (decode steps): a 16 x 32 tile, BK = 128, so the weight stream
// is spread over N / 32 CTAs; otherwise a 64 x 64 tile, BK = 32
template <bool NK>
cudaError_t launch_bf16(const void* x, const void* q, const float* s, void* y,
                        int M, int N, int K, cudaStream_t stream) {
  if (M <= 16) return launch_tc<1, 4, 1, 1, 128, NK>(x, q, s, y, M, N, K, stream);
  return launch_tc<2, 2, 2, 4, 32, NK>(x, q, s, y, M, N, K, stream);
}

template <bool NK>
cudaError_t launch_f32(const void* x, const void* q, const float* s, void* y,
                       int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kFB - 1) / kFB, (M + kFB - 1) / kFB);
  int8_mm_f32_kernel<NK><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q), s,
      static_cast<float*>(y), M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// layout: 0 = "kn" (q [K, N]), 1 = "nk" (q [N, K]);
// dtype: 0 = float32, 1 = bfloat16 (x and y share it)
int pt_int8_matmul(const void* x, const void* q, const float* s, void* y,
                   int M, int N, int K, int layout, int dtype, void* stream) {
  // an error an earlier runtime call left pending is returned (and so
  // cleared), never dropped: the wrapper raises it
  if (cudaError_t pending = cudaGetLastError()) return pending;
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0 || M > 65535 * 16)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return layout == 1 ? launch_bf16<true>(x, q, s, y, M, N, K, st)
                       : launch_bf16<false>(x, q, s, y, M, N, K, st);
  if (dtype == 0)
    return layout == 1 ? launch_f32<true>(x, q, s, y, M, N, K, st)
                       : launch_f32<false>(x, q, s, y, M, N, K, st);
  return cudaErrorInvalidValue;
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
