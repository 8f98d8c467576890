// Weight-only int8 GEMM for Hopper (sm_90a): y = (x @ widen(q)) * s.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/int8_matmul.py
// `int8_matmul` (its `_kernel` body; `int8_linear_nd` is the N-d wrapper
// around it). Same function, not the same tiling: the TPU kernel keeps the
// whole K extent of a weight tile resident in VMEM and lets one grid step
// produce an [mt, bn] output tile; here the K extent streams through
// shared memory.
//
//   x   [M, K]  fp32 or bf16, row-major, contiguous
//   q   [K, N]  int8 (layout "kn")  or  [N, K] int8 (layout "nk")
//   s   [N]     f32 scale per output channel
//   y   [M, N]  x's dtype:  y[m, n] = cast((sum_k x[m, k] * q(k, n)) * s[n])
//               or, bf16 x with the "nk" layout only, f32: the sum times
//               the scale uncast (a tensor-parallel rank's partial product
//               of a row-parallel layer, summed over the ranks in f32)
//
// Bound: device-memory bytes up to M of about 150 (the K x N codes
// dominate: 2 M operations a code against the card's 295 a byte), so at
// every decode, speculative-verify and paged-prefill width the model runs
// (M = 8, 72, 128); tensor-core operations at the static prefill (M =
// 1024).
//
// The main path, bf16 x with the "nk" layout (every projection and the LM
// head of the model; kernel i8_wg), computes y^T = W x^T with the
// operands swapped: the weight is the wgmma's A operand, 64 output
// channels a consumer warpgroup, and the tokens are its N dimension (NT =
// 8, 16, 32, 64 or 128 a CTA), so a decode step's 8 tokens fill an
// m64n8k16 MMA instead of padding half of a 16-row A operand.
//   * One producer warp keeps TMA loads in flight into a ring of stages
//     (full / empty mbarriers): a stage is 128 codes of every channel of
//     the CTA (a 2-D UINT8 map of q [N, K], 128-byte swizzled) and the
//     same 128 columns of the CTA's NT rows of x (two bf16 boxes, K-major
//     as wgmma's B wants it). Rows past M or N and columns past K arrive
//     as zero fill.
//   * Each consumer thread reads its A fragment from the swizzled codes
//     (conflict-free 16-bit loads) and widens it in registers, exactly:
//     the code's sign bit flipped gives c + 128, which as the low
//     mantissa byte of 2^23 makes the f32 2^23 + c + 128; subtracting
//     2^23 + 128 leaves c exactly, and one cvt.rn.bf16x2.f32 packs two
//     codes (|c| <= 127 fits bf16's 8 significant bits). No dequantized
//     weight exists in device memory.
//   * Decode widths (bytes in flight first): rings of 4-8 stages hold 32
//     KB or more of codes a CTA, two CTAs an SM, and the K extent is split
//     over a thread-block cluster of 2 or 4 CTAs while the launch still
//     fits the card at once (the host chooses NT and the cluster size: see
//     ops/cuda/int8_matmul.py `wg_plan`; clusters of 8 ran slower). The
//     cluster's partial sums meet in distributed shared memory: each CTA
//     stores its f32 tile, and rank r sums channel slice r over ranks 0,
//     1, .. in that order. One launch, no atomics, no scratch: two
//     launches agree bitwise.
//   * Prefill widths: two consumer warpgroups (128 channels) x 128 tokens
//     a CTA on m64n128k16 MMAs where N gives enough such tiles, else one
//     warpgroup x 64 tokens.
//   * Epilogue: the scale multiplies the f32 sum, then the cast to bf16
//     (or none, for f32 y); the [channel, token] tile goes through shared
//     memory so y [token, channel] is written along its rows.
// The other forms serve no main path and keep the first design (simple,
// mma.sync and CUDA cores): bf16 x with the "kn" layout (int8_mm_tc, a
// 64 x 64 or 16 x 32 output tile a CTA, 4 warps of mma.sync m16n8k16,
// the codes transposed while staged, double-buffered shared memory) and
// fp32 x in either layout (int8_mm_f32: plain f32 FMAs, never TF32, a 64 x
// 64 tile per 256 threads, each a 4 x 4 register tile; parity runs).
// Inputs: M >= 1, N >= 1, K a multiple of 16, 16-byte aligned bases.
//
// Plain C interface (loaded with ctypes): the entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // mma.sync kernel: 4 warps

// ===================================================== bf16 "nk": i8_wg
constexpr int KC = 128;  // codes a chunk: one 128-byte swizzled row

// NT tokens (the wgmma's N) a CTA, NWG consumer warpgroups along the
// channels (64 each) times KS along the chunks (warpgroup k takes chunks
// k, k + KS, ..), a ring of ST stages
template <int NT, int NWG, int KS, int ST>
struct WgCfg {
  static constexpr int CH = 64 * NWG;             // channels a CTA
  static constexpr uint32_t QB = CH * KC;         // code bytes a stage
  static constexpr uint32_t XB = NT * KC * 2;     // x bytes a stage
  static constexpr uint32_t STAGE = QB + XB;
  static constexpr int CONSUMERS = 4 * NWG * KS;  // consumer warps
  static constexpr int THREADS = 32 * CONSUMERS + 32;  // + producer warp
  static constexpr int RLD = CH + 4;              // f32 [KS][NT][RLD] sums
  static constexpr size_t SMEM = 1024 + ST * STAGE;
  static_assert(NT % 8 == 0 && NT <= 128, "wgmma N");
  static_assert(KS * NT * RLD * 4 <= ST * STAGE, "the sums fit the ring");
  static_assert(SMEM <= 232448, "shared memory");
};

// two int8 codes (bits 0-7, 8-15) as a bf16 pair, exactly: the sign bits
// flipped give c + 128 in [1, 255]; as the low mantissa byte of 2^23
// (0x4B000000) that is the f32 2^23 + c + 128, and subtracting 2^23 + 128
// (8388736) leaves c; |c| <= 127 fits bf16's 8 significant bits
__device__ __forceinline__ uint32_t widen2(uint32_t pair) {
  const uint32_t u = pair ^ 0x8080u;
  const float lo =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds16(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// grid (ceil(N / CH) * cs, ceil(M / NT)), clusters of cs CTAs along x:
// channel tile blockIdx.x / cs, cluster rank r takes code chunks [r * per,
// min(nkc, (r + 1) * per)) of 128 columns.
// four consecutive outputs of a row: n is a multiple of 4, so with N a
// multiple of 4 the row's 4 values are 8 (bf16) or 16 (f32) bytes aligned
__device__ __forceinline__ void store4(bf16* yr, float4 v, int n, int N) {
  if (n + 3 < N && (N & 3) == 0) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(yr) = u;
  } else {
    const float vs[4] = {v.x, v.y, v.z, v.w};
    for (int u = 0; u < 4 && n + u < N; ++u) yr[u] = __float2bfloat16(vs[u]);
  }
}

__device__ __forceinline__ void store4(float* yr, float4 v, int n, int N) {
  if (n + 3 < N && (N & 3) == 0) {
    *reinterpret_cast<float4*>(yr) = v;
  } else {
    const float vs[4] = {v.x, v.y, v.z, v.w};
    for (int u = 0; u < 4 && n + u < N; ++u) yr[u] = vs[u];
  }
}

template <int NT, int NWG, int KS, int ST, typename YT>
__global__ void
__launch_bounds__(WgCfg<NT, NWG, KS, ST>::THREADS, NWG == 1 ? 2 : 1)
    i8_wg(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tx, const float* __restrict__ s,
          YT* __restrict__ y, int M, int N, int K, int per, int cs) {
  using C = WgCfg<NT, NWG, KS, ST>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align1k(smem_raw);
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  __shared__ __align__(16) float scale[C::CH];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = cs > 1 ? static_cast<int>(hopper::cluster_rank()) : 0;
  const int n0 = blockIdx.x / cs * C::CH, m0 = blockIdx.y * NT;
  const int nkc = (K + KC - 1) / KC;
  const int c0 = min(nkc, rank * per), n_chunks = min(nkc, c0 + per) - c0;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(&full[i], 1);
      // lane 0 of each warp of the warpgroups that consume a chunk
      hopper::mbar_init(&empty[i], 4 * NWG);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the CTA's scales, loaded while the main loop runs
  const float sv = tid < C::CH && n0 + tid < N ? s[n0 + tid] : 0.f;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  const int cw = warp / 4 % NWG, kw = warp / 4 / NWG, wq = warp % 4;
  const int g = lane / 4, t = lane % 4;
  if (warp == C::CONSUMERS) {  // ------------------------------- producer
    if (lane == 0) {
      for (int i = 0; i < n_chunks; ++i) {
        const int st = i % ST, k0 = (c0 + i) * KC;
        hopper::mbar_wait(&empty[st], ((i / ST) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[st], C::STAGE);
        unsigned char* p = ring + st * C::STAGE;
        hopper::tma_load2(p, &tq, &full[st], k0, n0);
        hopper::tma_load2(p + C::QB, &tx, &full[st], k0, m0);
        hopper::tma_load2(p + C::QB + NT * 128, &tx, &full[st], k0 + 64, m0);
      }
    }
  } else {  // ------------------------------------------------- consumers
    // this thread's A rows: r (k pairs at bytes 2t, 2t + 8 of each 16-byte
    // step) and r + 8; both sit at swizzle phase g
    const int r = 64 * cw + 16 * wq + g;
    for (int i = kw; i < n_chunks; i += KS) {
      const int st = i % ST;
      hopper::mbar_wait(&full[st], (i / ST) & 1);
      const unsigned char* qs = ring + st * C::STAGE;
      const bf16* xs = reinterpret_cast<const bf16*>(qs + C::QB);
      uint32_t a[KC / 16][4];
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        const unsigned char* p0 = qs + r * 128 + ((kk ^ g) << 4) + 2 * t;
        a[kk][0] = widen2(lds16(p0));
        a[kk][1] = widen2(lds16(p0 + 8 * 128));
        a[kk][2] = widen2(lds16(p0 + 8));
        a[kk][3] = widen2(lds16(p0 + 8 * 128 + 8));
      }
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        hopper::mma_rk(acc, a[kk], hopper::kdesc(xs, NT, 0, kk));
      hopper::wg_commit();
      hopper::wg_wait0();
      hopper::fence_regs(acc);
      hopper::fence_regs(a);
      hopper::release(&empty[st], lane);
    }
  }
  if (tid < C::CH) scale[tid] = sv;
  __syncthreads();  // every stage consumed: the ring is free

  // this CTA's f32 tile [NT tokens][CH channels] in the ring: each chunk
  // warpgroup's partial, then their sum in warpgroup order
  float* red = reinterpret_cast<float*>(ring);
  if (warp < C::CONSUMERS) {
    float* mine = red + kw * NT * C::RLD;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[(8 * j + 2 * t + (e & 1)) * C::RLD + 64 * cw + 16 * wq + g +
             8 * (e >> 1)] = acc[4 * j + e];
  }
  if (KS > 1) {
    __syncthreads();
    for (int i = tid; i < NT * C::RLD; i += C::THREADS)
      for (int k = 1; k < KS; ++k) red[i] += red[k * NT * C::RLD + i];
  }
  if (cs > 1)
    hopper::cluster_sync();
  else
    __syncthreads();
  // rank r: channels [r * CH / cs, (r + 1) * CH / cs) of the tile, four
  // a thread, the ranks' partial sums added in rank order; y written
  // along its rows
  const int quads = C::CH / cs / 4, cr = rank * C::CH / cs;
  for (int idx = tid; idx < NT * quads; idx += C::THREADS) {
    const int tok = idx / quads, c = cr + 4 * (idx % quads);
    const float* p = red + tok * C::RLD + c;
    float4 v = cs > 1 ? hopper::ld_dsmem4(p, 0)
                      : *reinterpret_cast<const float4*>(p);
    for (int q = 1; q < cs; ++q) {
      const float4 w = hopper::ld_dsmem4(p, q);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    const int m = m0 + tok, n = n0 + c;
    if (m >= M) continue;
    const float4 sc = *reinterpret_cast<const float4*>(scale + c);
    v.x *= sc.x;
    v.y *= sc.y;
    v.z *= sc.z;
    v.w *= sc.w;
    store4(y + (size_t)m * N + n, v, n, N);
  }
  if (cs > 1) hopper::cluster_sync();  // no CTA leaves while read
}

template <int NT, int NWG, int KS, int ST, typename YT>
cudaError_t launch_wg(const void* x, const void* q, const float* s, void* y,
                      int M, int N, int K, int cs, cudaStream_t stream) {
  using C = WgCfg<NT, NWG, KS, ST>;
  CUtensorMap tq, tx;
  if (!hopper::tensor_map_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, N, K,
                             K, KC, C::CH) ||
      !hopper::tensor_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M,
                             K, K, 64, NT))
    return cudaErrorInvalidValue;
  const int nkc = (K + KC - 1) / KC;
  const int per = (nkc + cs - 1) / cs;
  auto kern = i8_wg<NT, NWG, KS, ST, YT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + C::CH - 1) / C::CH * cs, (M + NT - 1) / NT, 1);
  cfg.blockDim = dim3(C::THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, tq, tx, s, static_cast<YT*>(y), M, N,
                         K, per, cs);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// NT (tokens a CTA) and the cluster size come from the host's plan
template <typename YT>
cudaError_t launch_nk_bf16(const void* x, const void* q, const float* s,
                           void* y, int M, int N, int K, int nt, int cs,
                           cudaStream_t st) {
  if (cs != 1 && cs != 2 && cs != 4) return cudaErrorInvalidValue;
  switch (nt) {
    case 8: return launch_wg<8, 1, 2, 8, YT>(x, q, s, y, M, N, K, cs, st);
    case 16: return launch_wg<16, 1, 2, 8, YT>(x, q, s, y, M, N, K, cs, st);
    case 32: return launch_wg<32, 1, 2, 6, YT>(x, q, s, y, M, N, K, cs, st);
    case 64: return launch_wg<64, 1, 2, 4, YT>(x, q, s, y, M, N, K, cs, st);
    case 128: return launch_wg<128, 2, 1, 4, YT>(x, q, s, y, M, N, K, cs, st);
    default: return cudaErrorInvalidValue;
  }
}

// ============================================ bf16 "kn": int8_mm_tc
__device__ __forceinline__ uint32_t widen_pair(int8_t lo, int8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo),
                                           static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
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

// WM x WN warps, each owning TM x TN mma tiles of 16 x 8 outputs: BM =
// 16*WM*TM rows, BN = 8*WN*TN columns per CTA. Shared memory holds x as
// bf16 [BM][BK] and the codes as int8 [BN][BK], transposed from q [K, N]
// while staged.
template <int WM, int WN, int TM, int TN, int BK>
struct TcCfg {
  static constexpr int BM = 16 * WM * TM;
  static constexpr int BN = 8 * WN * TN;
  static constexpr int APAD = BK + 8;    // bf16 row stride, 16-byte multiple
  static constexpr int BPAD = BK + 16;   // int8 row stride, 16-byte multiple
  static constexpr int XV = BM * BK / 8 / kThreads;   // uint4 of x / thread
  static constexpr int WE = BK * BN / kThreads;       // bytes of q / thread
  static_assert(WM * WN * 32 == kThreads, "4 warps");
  static_assert(BK % 16 == 0, "BK is whole mma steps");
  static_assert(XV * 8 * kThreads == BM * BK, "x tile splits evenly");
  static_assert(WE * kThreads == BK * BN, "q tile splits evenly");
};

template <int WM, int WN, int TM, int TN, int BK>
__global__ void __launch_bounds__(kThreads)
    int8_mm_tc(const bf16* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ s, bf16* __restrict__ y, int M,
               int N, int K) {
  using C = TcCfg<WM, WN, TM, TN, BK>;
  __shared__ __align__(16) bf16 As[2][C::BM][C::APAD];
  __shared__ __align__(16) int8_t Bs[2][C::BN][C::BPAD];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;

  uint4 xr[C::XV];
  int8_t we[C::WE];

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
    // neighbouring threads read neighbouring columns of one row
#pragma unroll
    for (int i = 0; i < C::WE; ++i) {
      const int e = tid + i * kThreads;
      const int gk = k0 + e / C::BN, gn = n0 + e % C::BN;
      we[i] = (gk < K && gn < N) ? q[(size_t)gk * N + gn] : int8_t(0);
    }
  };

  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < C::XV; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&As[buf][v / (BK / 8)][(v % (BK / 8)) * 8]) =
          xr[i];
    }
#pragma unroll
    for (int i = 0; i < C::WE; ++i) {
      const int e = tid + i * kThreads;
      Bs[buf][e % C::BN][e / C::BN] = we[i];
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
            y[(size_t)r * N + c] =
                __float2bfloat16(acc[i][j][2 * h + u] * s[c]);
        }
      }
    }
  }
}

template <int WM, int WN, int TM, int TN, int BK>
cudaError_t launch_tc(const void* x, const void* q, const float* s, void* y,
                      int M, int N, int K, cudaStream_t stream) {
  using C = TcCfg<WM, WN, TM, TN, BK>;
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  int8_mm_tc<WM, WN, TM, TN, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(q), s,
      static_cast<bf16*>(y), M, N, K);
  return cudaGetLastError();
}

// skinny M: a 16 x 32 tile, BK = 128; otherwise a 64 x 64 tile, BK = 32
cudaError_t launch_kn_bf16(const void* x, const void* q, const float* s,
                           void* y, int M, int N, int K, cudaStream_t stream) {
  if (M <= 16) return launch_tc<1, 4, 1, 1, 128>(x, q, s, y, M, N, K, stream);
  return launch_tc<2, 2, 2, 4, 32>(x, q, s, y, M, N, K, stream);
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
// dtype: 0 = float32, 1 = bfloat16 (x's; y shares it unless y_f32);
// nt, cs: bf16 "nk" only, the tokens a CTA (8, 16, 32, 64, 128) and the
// cluster size (1, 2, 4) of the host's plan; ignored otherwise;
// y_f32: 1 writes an f32 y from bf16 x ("nk" only)
int pt_int8_matmul(const void* x, const void* q, const float* s, void* y,
                   int M, int N, int K, int layout, int dtype, int nt, int cs,
                   int y_f32, void* stream) {
  // an error an earlier runtime call left pending is returned (and so
  // cleared), never dropped: the wrapper raises it
  if (cudaError_t pending = cudaGetLastError()) return pending;
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0 || M > 65535 * 16)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (y_f32 && (dtype != 1 || layout != 1)) return cudaErrorInvalidValue;
  if (dtype == 1 && layout == 1)
    return y_f32 ? launch_nk_bf16<float>(x, q, s, y, M, N, K, nt, cs, st)
                 : launch_nk_bf16<bf16>(x, q, s, y, M, N, K, nt, cs, st);
  if (dtype == 1) return launch_kn_bf16(x, q, s, y, M, N, K, st);
  if (dtype == 0)
    return layout == 1 ? launch_f32<true>(x, q, s, y, M, N, K, st)
                       : launch_f32<false>(x, q, s, y, M, N, K, st);
  return cudaErrorInvalidValue;
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
