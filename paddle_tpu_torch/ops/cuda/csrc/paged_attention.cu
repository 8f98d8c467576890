// Single-token decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels paddle_tpu/ops/pallas/paged_attention.py
// `paged_attention_kernel` (fp pools) and `paged_attention_q8_kernel` (int8
// code pools + per-(row, head) f32 scales). Same function, not the same
// schedule: the TPU grid walks (batch row, table slot) in order and carries
// the online-softmax state in VMEM scratch; here the row's positions are
// split into partitions of kPart, one CTA each (flash-decoding), and the
// partitions' states are merged in a fixed order.
//
//   q       [B, 1, H, D]  fp32 or bf16
//   pools   [NB, bs, H, D] same dtype as q      (fp form)
//           [NB, bs, H, D] int8 codes + [NB, bs, H] f32 scales  (q8 form)
//   tables  [B, MB] int32 block ids (0 = trash block)
//   lens    [B] int32 attendable rows per batch row
//   out     [B, 1, H, D]  q's dtype
//   scratch f32 [B, H, NP, D + 2], NP = ceil(MB * bs / kPart): the
//           partitions' (acc, max, sum) of rows with more than one; may be
//           null when NP = 1 (every row one partition: no merge launch)
//
// Bound: device-memory bytes. Each (row, head) reads lens[b] K and V rows of
// D elements once and does 4 flops per element read, far below the ~20
// flop/byte an H100's f32 CUDA cores need before compute would matter. At
// decode shapes (B = 8 rows of a few hundred positions) those bytes take
// ~2 us, so the kernel is bound by latency: how many dependent trips to
// device memory a position costs, and how many positions are in flight.
// Design against that:
//   * a grid of (partition, head, row) CTAs, 128 threads each, a partition
//     kPart = 64 positions: 4 of 16-position blocks, so a row of 256
//     positions spreads over 4 CTAs and the grid covers the card at B = 8;
//     CTAs past a row's last partition exit at once;
//   * a group of G lanes owns one position: each lane one 16-byte chunk of
//     the row (8 bf16, 4 f32; 8 bytes of int8 codes), G a power of two
//     covering the head dim (16 lanes at D = 128 and at gpt3-2.7b's 80,
//     whose lanes past D are masked, so pools are read in place, never
//     padded), so a score reduces in log2(G) shuffles and a warp scores
//     32 / G positions at once;
//   * two dependent trips: every group first loads the table entries of
//     all its positions (kUB at a time), then issues all their K and V
//     chunk loads (and the int8 scales) before using any;
//   * scores, softmax and the accumulator stay f32 in registers; the
//     groups merge their (max, sum, acc) through shared memory, then the
//     partitions through the scratch in a second small launch (skipped by
//     rows of one partition, whose CTA writes the output itself). No
//     atomics: every sum runs in a fixed order, so two launches agree
//     bitwise.
// Head dims: any multiple of 8 up to 256, instantiated at NV = ceil(D / 32)
// (the widest row a group covers is 32 NV). Rows with lens == 0 produce
// zeros; table entries are clamped to [0, NB), lens to MB * bs. The q8 form
// keeps the TPU kernel's factored scales: the K scale multiplies the
// score, the V scale the probability, so codes are widened to f32 and
// never dequantized in memory.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThr = 128;   // threads a CTA
constexpr int kPart = 64;   // positions a CTA (partition)
constexpr int kUB = 8;      // positions a group keeps in flight
constexpr int kMaxD = 256;
constexpr float kNeg = -1e30f;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// E elements of T (8, 16 or 32 bytes) as 32-bit words, one or two vector
// loads; widened to f32 from the words' bits (no local array is addressed,
// so the words stay in registers)
template <typename T, int E>
constexpr int kWords = E * static_cast<int>(sizeof(T)) / 4;
template <typename T, int E>
__device__ __forceinline__ void load_words(const T* p,
                                           uint32_t (&w)[kWords<T, E>]) {
  if constexpr (kWords<T, E> == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < kWords<T, E> / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  }
}
template <typename T, int E>
__device__ __forceinline__ void widen(const uint32_t (&w)[kWords<T, E>],
                                      float (&out)[E]) {
#pragma unroll
  for (int i = 0; i < kWords<T, E>; ++i) {
    if constexpr (sizeof(T) == 4) {
      out[i] = __uint_as_float(w[i]);
    } else if constexpr (sizeof(T) == 2) {  // bf16: the f32's top half
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {  // int8 codes
#pragma unroll
      for (int k = 0; k < 4; ++k)
        out[4 * i + k] =
            static_cast<float>(static_cast<int8_t>((w[i] >> (8 * k)) & 0xffu));
    }
  }
}

// The lane layout of a position's row for pool element KT at NV = ceil(D /
// 32): chunks of E elements (16 bytes of fp, 8 of int8 codes), NC chunks
// in the widest row 32 NV, G lanes a position (the next power of two, at
// most 32), C chunks a lane, NG groups a CTA, U positions a group.
template <typename KT, int NV>
struct Layout {
  static constexpr int E = sizeof(KT) == 4 ? 4 : 8;
  static constexpr int NC = 32 * NV / E;
  static constexpr int G = NC > 16 ? 32 : NC > 8 ? 16 : NC > 4 ? 8 : NC > 2 ? 4 : 2;
  static constexpr int C = (NC + G - 1) / G;
  static constexpr int NG = kThr / G;
  static constexpr int U = kPart / NG;
};

// One CTA per (partition, head, batch row): blockIdx = (part, h, b).
// Q8 = false: KT = QT, scales unused. Q8 = true: KT = int8_t, scales used.
// (The bound's 1 block per SM lets ptxas take the registers it needs: with
// the thread count alone it held the 16-lane instantiations, D = 80 and
// 128, to 80 registers and spilled.)
template <int NV, bool Q8, typename QT, typename KT>
__global__ void __launch_bounds__(kThr, 1)
    decode_part(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                const float* __restrict__ k_scale,
                const KT* __restrict__ v_pool,
                const float* __restrict__ v_scale,
                const int* __restrict__ tables, const int* __restrict__ lens,
                QT* __restrict__ out, float* __restrict__ scratch, int H,
                int NB, int bs, int MB, int D, int NP, float scale) {
  using L = Layout<KT, NV>;
  constexpr int E = L::E, G = L::G, C = L::C, NG = L::NG, U = L::U;
  constexpr int KW = kWords<KT, E>, QW = kWords<QT, E>;
  const int part = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  // lens past the table width would index past the row's table; the
  // reference masks columns >= MB * bs, so clamping is the same function
  const int n = min(max(lens[b], 0), MB * bs);
  const int np = max((n + kPart - 1) / kPart, 1);  // an empty row: one
  if (part >= np) return;
  const int tid = threadIdx.x, grp = tid / G, gl = tid % G;
  const int* trow = tables + static_cast<int64_t>(b) * MB;
  const int64_t qo = (static_cast<int64_t>(b) * H + h) * D;

  float qv[C][E];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d0 = (gl + c * G) * E;
    uint32_t w[QW];
#pragma unroll
    for (int i = 0; i < QW; ++i) w[i] = 0u;
    if (d0 < D) load_words<QT, E>(q + qo + d0, w);
    widen<QT, E>(w, qv[c]);
  }
  float m = kNeg, l = 0.f, acc[C][E];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[c][e] = 0.f;

#pragma unroll
  for (int u0 = 0; u0 < U; u0 += kUB) {
    // this group's positions j = p0 + grp + NG u: table entries first, then
    // every K and V chunk (and scale) before any is used
    int64_t row[kUB];
    bool live[kUB];
#pragma unroll
    for (int u = 0; u < kUB; ++u) {
      const int j = part * kPart + grp + NG * (u0 + u);
      live[u] = u0 + u < U && j < n;
      // a table entry outside [0, NB) would read outside the pool;
      // clamping keeps the read in bounds (the engine never emits one)
      const int blk = live[u] ? min(max(trow[j / bs], 0), NB - 1) : 0;
      row[u] = static_cast<int64_t>(blk) * bs + j % bs;
    }
    uint32_t kr[kUB][C][KW], vr[kUB][C][KW];
    float ks[kUB], vs[kUB];
#pragma unroll
    for (int u = 0; u < kUB; ++u) {
      const int64_t base = (row[u] * H + h) * D;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int d0 = (gl + c * G) * E;
#pragma unroll
        for (int i = 0; i < KW; ++i) kr[u][c][i] = vr[u][c][i] = 0u;
        if (live[u] && d0 < D) {
          load_words<KT, E>(k_pool + base + d0, kr[u][c]);
          load_words<KT, E>(v_pool + base + d0, vr[u][c]);
        }
      }
      if constexpr (Q8) {
        ks[u] = live[u] ? k_scale[row[u] * H + h] : 0.f;
        vs[u] = live[u] ? v_scale[row[u] * H + h] : 0.f;
      }
    }
    float s[kUB];
#pragma unroll
    for (int u = 0; u < kUB; ++u) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float kf[E];
        widen<KT, E>(kr[u][c], kf);
#pragma unroll
        for (int e = 0; e < E; ++e) d += qv[c][e] * kf[e];
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      if constexpr (Q8) d *= ks[u] * scale;
      else d *= scale;
      s[u] = live[u] ? d : kNeg;
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUB; ++u) mx = fmaxf(mx, s[u]);
    const float corr = expf(m - mx);
    float p[kUB], psum = 0.f;
#pragma unroll
    for (int u = 0; u < kUB; ++u) {
      p[u] = live[u] ? expf(s[u] - mx) : 0.f;
      psum += p[u];
    }
    l = l * corr + psum;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[c][e] *= corr;
#pragma unroll
    for (int u = 0; u < kUB; ++u) {
      const float pu = Q8 ? p[u] * vs[u] : p[u];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float vf[E];
        widen<KT, E>(vr[u][c], vf);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[c][e] += pu * vf[e];
      }
    }
    m = mx;
  }

  // the groups' states, merged in group order
  __shared__ float sm_m[NG], sm_l[NG];
  __shared__ float sm_acc[NG][32 * NV];
  if (gl == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d0 = (gl + c * G) * E;
    if (d0 < 32 * NV)
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[grp][d0 + e] = acc[c][e];
  }
  __syncthreads();
  float M = kNeg;
#pragma unroll
  for (int g = 0; g < NG; ++g) M = fmaxf(M, sm_m[g]);
  float w[NG], Ls = 0.f;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    w[g] = expf(sm_m[g] - M);
    Ls += sm_l[g] * w[g];
  }
  const int64_t pi = (static_cast<int64_t>(b) * H + h) * NP + part;
  float* pacc = scratch + pi * (D + 2);
  for (int d = tid; d < D; d += kThr) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) a += sm_acc[g][d] * w[g];
    if (np == 1)  // lens == 0 rows: acc is 0, the output is 0
      out[qo + d] = from_f32<QT>(a / fmaxf(Ls, 1e-30f));
    else
      pacc[d] = a;
  }
  if (np > 1 && tid == 0) {
    pacc[D] = M;
    pacc[D + 1] = Ls;
  }
}

// One CTA per (head, batch row) with more than one partition: the
// partitions' states merged in partition order.
template <typename QT>
__global__ void __launch_bounds__(kThr)
    decode_merge(const int* __restrict__ lens,
                 const float* __restrict__ scratch, QT* __restrict__ out,
                 int H, int bs, int MB, int D, int NP) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int n = min(max(lens[b], 0), MB * bs);
  const int np = (n + kPart - 1) / kPart;
  if (np <= 1) return;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const float* part = scratch + bh * NP * (D + 2);
  float M = kNeg;
  for (int i = 0; i < np; ++i) M = fmaxf(M, part[i * (D + 2) + D]);
  float Ls = 0.f;
  for (int i = 0; i < np; ++i)
    Ls += part[i * (D + 2) + D + 1] * expf(part[i * (D + 2) + D] - M);
  for (int d = threadIdx.x; d < D; d += kThr) {
    float a = 0.f;
    for (int i = 0; i < np; ++i)
      a += part[i * (D + 2) + d] * expf(part[i * (D + 2) + D] - M);
    out[bh * D + d] = from_f32<QT>(a / Ls);
  }
}

// partitions a row of MB * bs positions can have
int partitions(int bs, int MB) {
  return static_cast<int>((static_cast<long long>(MB) * bs + kPart - 1) /
                          kPart);
}

template <bool Q8, typename QT, typename KT>
cudaError_t launch(const void* q, const void* k, const float* ks,
                   const void* v, const float* vs, const int* tables,
                   const int* lens, void* out, float* scratch, int B, int H,
                   int D, int NB, int bs, int MB, float scale,
                   cudaStream_t stream) {
  const int NP = partitions(bs, MB);
  const dim3 grid(NP, H, B);
  const auto* qp = static_cast<const QT*>(q);
  const auto* kp = static_cast<const KT*>(k);
  const auto* vp = static_cast<const KT*>(v);
  auto* op = static_cast<QT*>(out);
#define PT_CASE(NV)                                                         \
  case NV:                                                                  \
    decode_part<NV, Q8, QT, KT><<<grid, kThr, 0, stream>>>(                 \
        qp, kp, ks, vp, vs, tables, lens, op, scratch, H, NB, bs, MB, D, NP, \
        scale);                                                             \
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
  if (cudaError_t e = cudaGetLastError()) return e;
  if (NP == 1) return cudaSuccess;
  decode_merge<QT><<<dim3(H, B), kThr, 0, stream>>>(lens, scratch, op, H, bs,
                                                    MB, D, NP);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int D, int NB, int bs, int MB) {
  return B < 0 || B > 65535 || H < 1 || H > 65535 || D < 8 || D > kMaxD ||
         D % 8 != 0 || NB < 1 || bs < 1 || MB < 1 ||
         static_cast<long long>(MB) * bs >= (1ll << 31);
}

}  // namespace

extern "C" {

// positions a partition (kPart): the scratch holds B * H * NP * (D + 2)
// f32, NP = ceil(MB * bs / kPart)
int pt_paged_attention_part() { return kPart; }

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it)
int pt_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                       const int* tables, const int* lens, void* out,
                       float* scratch, int B, int H, int D, int NB, int bs,
                       int MB, float scale, int dtype, void* stream) {
  // an error an earlier runtime call left pending is returned (and so
  // cleared), never dropped: the wrapper raises it
  if (cudaError_t pending = cudaGetLastError()) return pending;
  if (bad_shape(B, H, D, NB, bs, MB) ||
      (scratch == nullptr && partitions(bs, MB) > 1))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<false, float, float>(q, k_pool, nullptr, v_pool, nullptr,
                                       tables, lens, out, scratch, B, H, D,
                                       NB, bs, MB, scale, s);
  if (dtype == 1)
    return launch<false, __nv_bfloat16, __nv_bfloat16>(
        q, k_pool, nullptr, v_pool, nullptr, tables, lens, out, scratch, B,
        H, D, NB, bs, MB, scale, s);
  return cudaErrorInvalidValue;
}

// qdtype: 0 = float32, 1 = bfloat16 (q and out); codes int8, scales f32
int pt_paged_attention_q8(const void* q, const void* k_codes,
                          const float* k_scale, const void* v_codes,
                          const float* v_scale, const int* tables,
                          const int* lens, void* out, float* scratch, int B,
                          int H, int D, int NB, int bs, int MB, float scale,
                          int qdtype, void* stream) {
  // an error an earlier runtime call left pending is returned (and so
  // cleared), never dropped: the wrapper raises it
  if (cudaError_t pending = cudaGetLastError()) return pending;
  if (bad_shape(B, H, D, NB, bs, MB) ||
      (scratch == nullptr && partitions(bs, MB) > 1))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (qdtype == 0)
    return launch<true, float, int8_t>(q, k_codes, k_scale, v_codes, v_scale,
                                       tables, lens, out, scratch, B, H, D,
                                       NB, bs, MB, scale, s);
  if (qdtype == 1)
    return launch<true, __nv_bfloat16, int8_t>(
        q, k_codes, k_scale, v_codes, v_scale, tables, lens, out, scratch, B,
        H, D, NB, bs, MB, scale, s);
  return cudaErrorInvalidValue;
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
