// Multi-token ("prefix") attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels paddle_tpu/ops/pallas/paged_attention.py
// `paged_prefix_attention_kernel` (`_kernel_multi`, fp pools) and
// `paged_prefix_attention_q8_kernel` (`_kernel_multi_q8`, int8 code pools +
// per-(row, head) f32 scales). One primitive serves suffix prefill after a
// partial prefix hit, every window of chunked prefill and every speculative
// verify window.
//
//   q       [B, S, H, D]   fp32 or bf16; query row i of batch row b sits at
//                          global position start[b] + i
//   pools   [NB, bs, H, D] same dtype as q                      (fp form)
//           [NB, bs, H, D] int8 codes + [NB, bs, H] f32 scales  (q8 form)
//   tables  [B, MB] int32 block ids (0 = trash block)
//   start   [B] int32 (>= 0)
//   out     [B, S, H, D]   q's dtype
//
// Row i of batch row b attends pool column c iff c <= start[b] + i and
// c < MB * bs (the table's extent). Same function as the TPU kernel, not its
// schedule: the TPU grid walks (batch row, table slot) in order and keeps
// every head's [S, 1] softmax state in VMEM scratch; here one CTA owns one
// (head, batch row, tile of kRows query rows), one warp per query row.
//
// Bound: device-memory bytes at the serving shapes (a window of S <= 128
// rows over <= 256 cached columns does ~2*S flops per K/V element it reads,
// far below the ~295 flop/byte where the tensor cores would become the
// limit). Design against that bound, simple first:
//   * the CTA stages kCols pool columns of K and V (codes, for q8) at a time
//     into shared memory with 16-byte loads, once for all its warps, so a
//     K/V row is read from device memory once per tile of kRows query rows,
//     not once per row; staged data keeps its storage type and is widened in
//     registers (int8 codes are never dequantized in memory);
//   * the CTA stops at its largest frontier, min(start + last row, MB*bs-1):
//     table slots past it are never read, and slot indices never reach MB;
//   * each warp scores kGroup columns at a time (lanes spread over D, one
//     warp-wide sum per column, the kGroup sums interleaved), keeps its
//     row's online softmax (max, sum, acc) in f32 registers and skips tiles
//     past its own frontier;
//   * the q8 form keeps the TPU kernel's factored scales: the K scale
//     multiplies the score, the V scale the probability.
// Head dims: any multiple of 8 up to 256. Each lane owns NV = ceil(D / 32)
// elements; where D is not a multiple of 32 (gpt3-2.7b's 80) the kernel is
// instantiated at 32 * NV, stages its tiles element by element with the
// columns d >= D zero-filled, and masks q's loads and the output's stores
// at d >= D, so the pools are read in place, never padded.
// `wgmma` on a real [S, kCols] score tile and TMA staging are later work.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kRows = 8;     // query rows per CTA, one warp each
constexpr int kCols = 16;    // pool columns staged per tile
constexpr int kGroup = 4;    // columns a warp scores together
constexpr int kThreads = kRows * 32;
constexpr int kMaxD = 256;
constexpr float kNeg = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// NV contiguous elements at p (global or shared), widened to f32: 16-byte
// pieces when the slice is a multiple of 16 bytes, one 8- or 4-byte load
// when it is that size, element loads otherwise. Every slice starts at a
// multiple of its own size from a 16-byte aligned base.
template <typename T, int NV>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[NV]) {
  constexpr int kBytes = NV * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int c = 0; c < NV / kPer; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_f32<T>(e[i]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < NV; ++i) out[i] = to_f32<T>(e[i]);
  } else if constexpr (kBytes == 4) {
    const unsigned int raw = *reinterpret_cast<const unsigned int*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < NV; ++i) out[i] = to_f32<T>(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) out[i] = to_f32<T>(p[i]);
  }
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (H, B, ceil(S / kRows)); block kThreads.
// Q8 = false: KT = QT, scales unused. Q8 = true: KT = int8_t, scales used.
template <typename QT, typename KT, bool Q8, int NV, bool PART>
__global__ void __launch_bounds__(kThreads)
    paged_prefix_kernel(const QT* __restrict__ q,
                        const KT* __restrict__ k_pool,
                        const float* __restrict__ k_scale,
                        const KT* __restrict__ v_pool,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ tables,
                        const int* __restrict__ start, QT* __restrict__ out,
                        int S, int H, int NB, int bs, int MB, int Dr,
                        float scale) {
  constexpr int D = 32 * NV;            // the lanes' (and tiles') extent
  const int Dm = PART ? Dr : D;         // the head dim in memory
  constexpr int kVec = 16 / static_cast<int>(sizeof(KT));  // elems / 16 B
  constexpr int kPieces = D / kVec;                // 16-byte pieces per row
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = row0 + warp;                       // this warp's query row
  const bool active = i < S;

  // frontiers (last attended column, inclusive) in 64 bits: start + row
  // may pass the table's extent, which the wrapper keeps below 2^31
  const int64_t width = static_cast<int64_t>(MB) * bs;
  const int64_t st = start[b];
  const int last_row = min(row0 + kRows, S) - 1;
  const int F = static_cast<int>(min64(st + last_row, width - 1));  // CTA
  const int f = active ? static_cast<int>(min64(st + i, width - 1)) : -1;
  const int* trow = tables + static_cast<int64_t>(b) * MB;

  __shared__ __align__(16) KT k_s[kCols][D];
  __shared__ __align__(16) KT v_s[kCols][D];
  __shared__ float ks_s[kCols];
  __shared__ float vs_s[kCols];

  const int64_t qo = ((static_cast<int64_t>(b) * S + (active ? i : 0)) * H +
                      h) * Dm + lane * NV;
  float qv[NV];
  if (active && PART) {
#pragma unroll
    for (int e = 0; e < NV; ++e)
      qv[e] = lane * NV + e < Dm ? to_f32<QT>(q[qo + e]) : 0.f;
  } else if (active) {
    load_vec<QT, NV>(q + qo, qv);
  } else {
#pragma unroll
    for (int e = 0; e < NV; ++e) qv[e] = 0.f;
  }
  float m = kNeg, l = 0.f;
  float acc[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) acc[e] = 0.f;

  for (int c0 = 0; c0 <= F; c0 += kCols) {
    __syncthreads();  // the previous tile's readers are done with it
    if constexpr (PART) {
      // rows of Dr elements need not be 16-byte aligned: element loads
      // (moved as raw bits), the lanes' columns past Dr zero-filled
      using Raw = typename std::conditional<
          sizeof(KT) == 4, uint32_t,
          typename std::conditional<sizeof(KT) == 2, uint16_t,
                                    uint8_t>::type>::type;
      const Raw* kr = reinterpret_cast<const Raw*>(k_pool);
      const Raw* vr = reinterpret_cast<const Raw*>(v_pool);
      for (int t = threadIdx.x; t < kCols * D; t += kThreads) {
        const int cc = t / D;
        const int d = t - cc * D;
        const int c = c0 + cc;
        Raw kx = 0, vx = 0;
        if (c <= F && d < Dm) {
          const int blk = min(max(trow[c / bs], 0), NB - 1);
          const int64_t row = static_cast<int64_t>(blk) * bs + c % bs;
          const int64_t off = (row * H + h) * Dm + d;
          kx = kr[off];
          vx = vr[off];
        }
        reinterpret_cast<Raw*>(&k_s[cc][0])[d] = kx;
        reinterpret_cast<Raw*>(&v_s[cc][0])[d] = vx;
      }
    } else {
      for (int t = threadIdx.x; t < kCols * kPieces; t += kThreads) {
        const int cc = t / kPieces;
        const int piece = t - cc * kPieces;
        const int c = c0 + cc;
        uint4 kraw = make_uint4(0u, 0u, 0u, 0u), vraw = kraw;
        if (c <= F) {
          // a table entry outside [0, NB) would read outside the pool;
          // clamping keeps the read in bounds (the engine never emits one)
          const int blk = min(max(trow[c / bs], 0), NB - 1);
          const int64_t row = static_cast<int64_t>(blk) * bs + c % bs;
          const int64_t off = (row * H + h) * D + piece * kVec;
          kraw = *reinterpret_cast<const uint4*>(k_pool + off);
          vraw = *reinterpret_cast<const uint4*>(v_pool + off);
        }
        *reinterpret_cast<uint4*>(&k_s[cc][piece * kVec]) = kraw;
        *reinterpret_cast<uint4*>(&v_s[cc][piece * kVec]) = vraw;
      }
    }
    if constexpr (Q8) {
      for (int cc = threadIdx.x; cc < kCols; cc += kThreads) {
        const int c = c0 + cc;
        float a = 0.f, z = 0.f;
        if (c <= F) {
          const int blk = min(max(trow[c / bs], 0), NB - 1);
          const int64_t row = static_cast<int64_t>(blk) * bs + c % bs;
          a = k_scale[row * H + h];
          z = v_scale[row * H + h];
        }
        ks_s[cc] = a;
        vs_s[cc] = z;
      }
    }
    __syncthreads();
    if (c0 > f) continue;                         // warp-uniform
    const int n = min(kCols, f - c0 + 1);         // columns this row sees
    for (int g = 0; g < n; g += kGroup) {
      float s[kGroup];
      float vr[kGroup][NV];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int cc = min(g + u, kCols - 1);     // in bounds; masked below
        float kr[NV];
        load_vec<KT, NV>(&k_s[cc][lane * NV], kr);
        load_vec<KT, NV>(&v_s[cc][lane * NV], vr[u]);
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < NV; ++e) d += qv[e] * kr[e];
        s[u] = d;
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) s[u] = warp_sum(s[u]);
      float mx = m;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int cc = min(g + u, kCols - 1);
        if constexpr (Q8) s[u] *= ks_s[cc] * scale;
        else s[u] *= scale;
        if (g + u >= n) s[u] = kNeg;
        mx = fmaxf(mx, s[u]);
      }
      const float corr = expf(m - mx);
      float p[kGroup], psum = 0.f;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        p[u] = (g + u < n) ? expf(s[u] - mx) : 0.f;
        psum += p[u];
        if constexpr (Q8) p[u] *= vs_s[min(g + u, kCols - 1)];
      }
      l = l * corr + psum;
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        float a = acc[e] * corr;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) a += p[u] * vr[u][e];
        acc[e] = a;
      }
      m = mx;
    }
  }

  if (active) {
    const float L = fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < NV; ++e)
      if (!PART || lane * NV + e < Dm) out[qo + e] = from_f32<QT>(acc[e] / L);
  }
}

template <typename QT, typename KT, bool Q8, bool PART>
cudaError_t launch_d(const void* q, const void* k, const float* ks,
                     const void* v, const float* vs, const int* tables,
                     const int* start, void* out, int B, int S, int H, int D,
                     int NB, int bs, int MB, float scale,
                     cudaStream_t stream) {
  const dim3 grid(H, B, (S + kRows - 1) / kRows);
  const dim3 block(kThreads);
  const auto* qp = static_cast<const QT*>(q);
  const auto* kp = static_cast<const KT*>(k);
  const auto* vp = static_cast<const KT*>(v);
  auto* op = static_cast<QT*>(out);
#define PT_CASE(NV)                                                        \
  case NV:                                                                 \
    paged_prefix_kernel<QT, KT, Q8, NV, PART><<<grid, block, 0, stream>>>( \
        qp, kp, ks, vp, vs, tables, start, op, S, H, NB, bs, MB, D, scale); \
    break;
  switch ((D + 31) / 32) {
    PT_CASE(1)
    PT_CASE(2)
    PT_CASE(3)
    PT_CASE(4)
    PT_CASE(5)
    PT_CASE(6)
    PT_CASE(7)
    PT_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_CASE
  return cudaGetLastError();
}

// head dims that are a multiple of 32 take the unmasked instantiation
template <typename QT, typename KT, bool Q8>
cudaError_t launch(const void* q, const void* k, const float* ks,
                   const void* v, const float* vs, const int* tables,
                   const int* start, void* out, int B, int S, int H, int D,
                   int NB, int bs, int MB, float scale, cudaStream_t stream) {
  if (D % 32 == 0)
    return launch_d<QT, KT, Q8, false>(q, k, ks, v, vs, tables, start, out, B,
                                       S, H, D, NB, bs, MB, scale, stream);
  return launch_d<QT, KT, Q8, true>(q, k, ks, v, vs, tables, start, out, B, S,
                                    H, D, NB, bs, MB, scale, stream);
}

bool bad_shape(int B, int S, int H, int D, int NB, int bs, int MB) {
  return B < 0 || B > 65535 || S < 1 || S > 65535 * kRows || H < 1 ||
         H > 65535 || D < 8 || D > kMaxD || D % 8 != 0 || NB < 1 ||
         bs < 1 || MB < 1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it)
int pt_paged_prefix_attention(const void* q, const void* k_pool,
                              const void* v_pool, const int* tables,
                              const int* start, void* out, int B, int S,
                              int H, int D, int NB, int bs, int MB,
                              float scale, int dtype, void* stream) {
  // an error an earlier runtime call left pending is returned (and so
  // cleared), never dropped: the wrapper raises it
  if (cudaError_t pending = cudaGetLastError()) return pending;
  if (bad_shape(B, S, H, D, NB, bs, MB)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float, false>(q, k_pool, nullptr, v_pool, nullptr,
                                       tables, start, out, B, S, H, D, NB, bs,
                                       MB, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pool, nullptr, v_pool, nullptr, tables, start, out, B, S, H, D,
        NB, bs, MB, scale, s);
  return cudaErrorInvalidValue;
}

// qdtype: 0 = float32, 1 = bfloat16 (q and out); codes int8, scales f32
int pt_paged_prefix_attention_q8(const void* q, const void* k_codes,
                                 const float* k_scale, const void* v_codes,
                                 const float* v_scale, const int* tables,
                                 const int* start, void* out, int B, int S,
                                 int H, int D, int NB, int bs, int MB,
                                 float scale, int qdtype, void* stream) {
  // an error an earlier runtime call left pending is returned (and so
  // cleared), never dropped: the wrapper raises it
  if (cudaError_t pending = cudaGetLastError()) return pending;
  if (bad_shape(B, S, H, D, NB, bs, MB)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (qdtype == 0)
    return launch<float, int8_t, true>(q, k_codes, k_scale, v_codes, v_scale,
                                       tables, start, out, B, S, H, D, NB, bs,
                                       MB, scale, s);
  if (qdtype == 1)
    return launch<__nv_bfloat16, int8_t, true>(
        q, k_codes, k_scale, v_codes, v_scale, tables, start, out, B, S, H, D,
        NB, bs, MB, scale, s);
  return cudaErrorInvalidValue;
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
