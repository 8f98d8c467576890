// Single-token decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels paddle_tpu/ops/pallas/paged_attention.py
// `paged_attention_kernel` (fp pools) and `paged_attention_q8_kernel` (int8
// code pools + per-(row, head) f32 scales). Same function, not the same
// schedule: the TPU grid walks (batch row, table slot) in order and carries
// the online-softmax state in VMEM scratch; here one CTA owns one
// (batch row, head) pair and its warps split the row's token positions.
//
//   q       [B, 1, H, D]  fp32 or bf16
//   pools   [NB, bs, H, D] same dtype as q      (fp form)
//           [NB, bs, H, D] int8 codes + [NB, bs, H] f32 scales  (q8 form)
//   tables  [B, MB] int32 block ids (0 = trash block)
//   lens    [B] int32 attendable rows per batch row
//   out     [B, 1, H, D]  q's dtype
//
// Bound: device-memory bytes. Each (row, head) reads lens[b] K and V rows of
// D elements once and does 4 flops per element read, far below the ~20
// flop/byte an H100's f32 CUDA cores need before compute would matter.
// Design against that bound:
//   * only table slots j < ceil(lens[b] / bs) are ever read (padding entries
//     point at the trash block and are never touched);
//   * lanes spread over D, so a warp reads one K or V row as one coalesced
//     segment (16 bytes a lane at D=128 bf16);
//   * each warp issues the K and V loads of kUnroll positions before it
//     uses any of them, keeping 2*kUnroll loads in flight per lane;
//   * scores, softmax and the accumulator stay f32 in registers; warps merge
//     their (max, sum, acc) states through shared memory once at the end.
// Rows with lens == 0 produce zeros. The q8 form keeps the TPU kernel's
// factored scales: the K scale multiplies the score, the V scale the
// probability, so codes are widened to f32 and never dequantized in memory.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
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

// NV contiguous elements at p, widened to f32. One vector load when the
// lane's slice is 4, 8 or 16 bytes (the wrapper guarantees 16-byte aligned
// bases, and every slice starts at a multiple of its own size).
template <typename T, int NV>
__device__ __forceinline__ void load_slice(const T* __restrict__ p,
                                           float (&out)[NV]) {
  constexpr int kBytes = NV * static_cast<int>(sizeof(T));
  if constexpr (kBytes == 16 || kBytes == 8 || kBytes == 4) {
    using Vec = typename std::conditional<
        kBytes == 16, uint4,
        typename std::conditional<kBytes == 8, uint2, unsigned int>::type>::
        type;
    const Vec raw = *reinterpret_cast<const Vec*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < NV; ++i) out[i] = to_f32<T>(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) out[i] = to_f32<T>(p[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One CTA per (head, batch row): blockIdx.x = h, blockIdx.y = b.
// Q8 = false: KT = QT, scales unused. Q8 = true: KT = int8_t, scales used.
template <typename QT, typename KT, bool Q8, int NV>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                        const float* __restrict__ k_scale,
                        const KT* __restrict__ v_pool,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ tables,
                        const int* __restrict__ lens, QT* __restrict__ out,
                        int H, int NB, int bs, int MB, float scale) {
  constexpr int D = 32 * NV;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // lens past the table width would index past the row's table; the
  // reference masks columns >= MB * bs, so clamping is the same function
  const int n = min(max(lens[b], 0), MB * bs);
  const int* trow = tables + static_cast<int64_t>(b) * MB;
  const int64_t qo = (static_cast<int64_t>(b) * H + h) * D;

  float qv[NV];
  load_slice<QT, NV>(q + qo + lane * NV, qv);

  float m = kNeg, l = 0.f;
  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;

  for (int base = warp; base < n; base += kWarps * kUnroll) {
    float kr[kUnroll][NV], vr[kUnroll][NV], ks[kUnroll], vs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kWarps;
      if (j < n) {
        // a table entry outside [0, NB) would read outside the pool;
        // clamping keeps the read in bounds (the engine never emits one)
        const int blk = min(max(trow[j / bs], 0), NB - 1);
        const int64_t row = static_cast<int64_t>(blk) * bs + j % bs;
        const int64_t off = (row * H + h) * D + lane * NV;
        load_slice<KT, NV>(k_pool + off, kr[u]);
        load_slice<KT, NV>(v_pool + off, vr[u]);
        if constexpr (Q8) {
          ks[u] = k_scale[row * H + h];
          vs[u] = v_scale[row * H + h];
        }
      } else {
#pragma unroll
        for (int i = 0; i < NV; ++i) kr[u][i] = vr[u][i] = 0.f;
        ks[u] = vs[u] = 0.f;
      }
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) d += qv[i] * kr[u][i];
      d = warp_sum(d);
      if constexpr (Q8) d *= ks[u] * scale;
      else d *= scale;
      s[u] = (base + u * kWarps < n) ? d : kNeg;
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, s[u]);
    const float corr = expf(m - mx);
    float p[kUnroll], psum = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      p[u] = (base + u * kWarps < n) ? expf(s[u] - mx) : 0.f;
      psum += p[u];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float a = acc[i] * corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if constexpr (Q8) a += (p[u] * vs[u]) * vr[u][i];
        else a += p[u] * vr[u][i];
      }
      acc[i] = a;
    }
    m = mx;
  }

  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) sm_acc[warp][lane * NV + i] = acc[i];
  __syncthreads();

  float M = kNeg;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w]);
  float w_scale[kWarps];
  float L = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    w_scale[w] = expf(sm_m[w] - M);
    L += sm_l[w] * w_scale[w];
  }
  L = fmaxf(L, 1e-30f);  // lens == 0 rows: acc is 0, output is 0
  for (int d = threadIdx.x; d < D; d += kWarps * 32) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += sm_acc[w][d] * w_scale[w];
    out[qo + d] = from_f32<QT>(o / L);
  }
}

template <typename QT, typename KT, bool Q8>
cudaError_t launch(const void* q, const void* k, const float* ks,
                   const void* v, const float* vs, const int* tables,
                   const int* lens, void* out, int B, int H, int D, int NB,
                   int bs, int MB, float scale, cudaStream_t stream) {
  const dim3 grid(H, B);
  const dim3 block(kWarps * 32);
  const auto* qp = static_cast<const QT*>(q);
  const auto* kp = static_cast<const KT*>(k);
  const auto* vp = static_cast<const KT*>(v);
  auto* op = static_cast<QT*>(out);
#define PT_CASE(NV)                                                        \
  case NV:                                                                 \
    paged_decode_kernel<QT, KT, Q8, NV><<<grid, block, 0, stream>>>(       \
        qp, kp, ks, vp, vs, tables, lens, op, H, NB, bs, MB, scale);       \
    break;
  switch (D / 32) {
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

bool bad_shape(int B, int H, int D, int NB, int bs, int MB) {
  return B < 0 || B > 65535 || H < 1 || D < 32 || D > kMaxD || D % 32 != 0 ||
         NB < 1 || bs < 1 || MB < 1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it)
int pt_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                       const int* tables, const int* lens, void* out, int B,
                       int H, int D, int NB, int bs, int MB, float scale,
                       int dtype, void* stream) {
  if (bad_shape(B, H, D, NB, bs, MB)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float, false>(q, k_pool, nullptr, v_pool, nullptr,
                                       tables, lens, out, B, H, D, NB, bs, MB,
                                       scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pool, nullptr, v_pool, nullptr, tables, lens, out, B, H, D, NB,
        bs, MB, scale, s);
  return cudaErrorInvalidValue;
}

// qdtype: 0 = float32, 1 = bfloat16 (q and out); codes int8, scales f32
int pt_paged_attention_q8(const void* q, const void* k_codes,
                          const float* k_scale, const void* v_codes,
                          const float* v_scale, const int* tables,
                          const int* lens, void* out, int B, int H, int D,
                          int NB, int bs, int MB, float scale, int qdtype,
                          void* stream) {
  if (bad_shape(B, H, D, NB, bs, MB)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (qdtype == 0)
    return launch<float, int8_t, true>(q, k_codes, k_scale, v_codes, v_scale,
                                       tables, lens, out, B, H, D, NB, bs, MB,
                                       scale, s);
  if (qdtype == 1)
    return launch<__nv_bfloat16, int8_t, true>(q, k_codes, k_scale, v_codes,
                                               v_scale, tables, lens, out, B,
                                               H, D, NB, bs, MB, scale, s);
  return cudaErrorInvalidValue;
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
