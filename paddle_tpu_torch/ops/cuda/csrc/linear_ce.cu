// Fused LM head + softmax cross-entropy, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/linear_ce.py
// `linear_cross_entropy` (its forward `_fwd_kernel`; the backward is plain
// matmuls in the JAX package and in the port). Same function, not the same
// tiling: the TPU kernel walks the vocabulary sequentially for one token
// block, carrying the running max, sum-exp and gold logit in VMEM scratch;
// here the vocabulary of a token tile is split over several CTAs so that
// T = 6144 tokens fill the SMs, each CTA walks its share in 128-wide tiles
// keeping the running triple in registers, and a second small kernel merges
// the partial triples.
//
//   x       [T, H] bf16 or f32, row-major, contiguous
//   w       [V, H] ("vh", the tied embedding) or [H, V] ("hv", an untied
//           head; rows ldw >= V apart), x's dtype
//   labels  [T] int32
//   loss    [T] f32 = lse - logit[label];  lse [T] f32
//
// The [T, V] logits never reach device memory: each [64, 128] tile lives in
// the accumulator registers of the CTA that computed it. Columns past V (the
// ragged tail: bert's V = 30522 is not a multiple of 128) are masked to
// -1e30; a label matches exactly one column; a label outside [0, V) adds
// nothing to the gold logit, as in the TPU kernel.
//
// Bound: 2 T H V tensor-core operations (1.27e12 at T = 6144, H = 2048,
// V = 50304: 1.28 ms at 989 TFLOP/s). Design against that:
//   * bf16: mma.sync m16n8k16 bf16 x bf16 -> f32; 4 warps, each owning 16
//     token rows and all 128 columns of the tile, so the row statistics
//     reduce inside a quad of lanes;
//   * the H contraction runs in 32-wide chunks of x and w double-buffered in
//     shared memory with cp.async ("hv" tiles are staged as they lie and
//     read transposed from shared memory);
//   * x tiles are re-read once per vocabulary tile (from L2; 64 x H bf16);
//   * f32: plain FMAs on the CUDA cores (never TF32), a 64 x 64 tile per
//     256-thread CTA, each thread a 4 x 4 register tile; parity runs only.
//
// Plain C interface (loaded with ctypes): two entry points, the tile kernel
// and the merge, each launching on the given stream without synchronising
// and returning cudaGetLastError(). The caller provides the [3, nsplit, T]
// f32 scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- bf16
constexpr int kThreads = 128;
constexpr int BT = 64, BV = 128, BK = 32;
constexpr int XLD = BK + 8;    // x chunk [BT][XLD]
constexpr int WLD = BK + 8;    // "vh" chunk [BV][WLD]
constexpr int HLD = BV + 8;    // "hv" chunk [BK][HLD]

// grid (ceil(T / BT), nsplit): CTA (i, s) takes token rows i*BT.. and the
// vocabulary tiles [s * tps, min((s + 1) * tps, n_vt))
template <bool VH>
__global__ void __launch_bounds__(kThreads)
    lce_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const int* __restrict__ labels, float* __restrict__ part, int T,
             int H, int V, int ldw, int tps) {
  __shared__ __align__(16) bf16 Xs[2][BT * XLD];
  __shared__ __align__(16) bf16 Ws[2][VH ? BV * WLD : BK * HLD];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int t0 = blockIdx.x * BT, split = blockIdx.y;
  const int n_vt = (V + BV - 1) / BV;
  const int vt0 = split * tps, vt1 = min(n_vt, vt0 + tps);
  const int nk = (H + BK - 1) / BK;
  const int r0 = warp * 16 + g;

  int lab[2];
  float m[2] = {kNeg, kNeg}, s[2] = {0.f, 0.f}, gold[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t0 + r0 + 8 * r;
    lab[r] = row < T ? labels[row] : -1;
  }

  auto stage = [&](int buf, int v0, int k0) {
    // x: BT rows x BK columns, 4 chunks of 16 bytes a row
    for (int c = tid; c < BT * (BK / 8); c += kThreads) {
      const int r = c / (BK / 8), k = k0 + (c % (BK / 8)) * 8;
      const bool ok = t0 + r < T && k < H;
      cp_async16(&Xs[buf][r * XLD + (c % (BK / 8)) * 8],
                 ok ? x + (size_t)(t0 + r) * H + k : x, ok);
    }
    if constexpr (VH) {  // BV rows of w [V, H]
      for (int c = tid; c < BV * (BK / 8); c += kThreads) {
        const int r = c / (BK / 8), k = k0 + (c % (BK / 8)) * 8;
        const bool ok = v0 + r < V && k < H;
        cp_async16(&Ws[buf][r * WLD + (c % (BK / 8)) * 8],
                   ok ? w + (size_t)(v0 + r) * H + k : w, ok);
      }
    } else {  // BK rows of w [H, V], BV columns each
      for (int c = tid; c < BK * (BV / 8); c += kThreads) {
        const int r = c / (BV / 8), v = v0 + (c % (BV / 8)) * 8;
        const bool ok = k0 + r < H && v < V;
        cp_async16(&Ws[buf][r * HLD + (c % (BV / 8)) * 8],
                   ok ? w + (size_t)(k0 + r) * ldw + v : w, ok);
      }
    }
    cp_async_commit();
  };

  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * BV;
    float acc[BV / 8][4];
#pragma unroll
    for (int n = 0; n < BV / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    stage(0, v0, 0);
    for (int kt = 0; kt < nk; ++kt) {
      const int buf = kt & 1;
      if (kt + 1 < nk) {
        stage(buf ^ 1, v0, (kt + 1) * BK);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* X = Xs[buf];
      const bf16* W = Ws[buf];
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[4];
        a[0] = ld32(X + r0 * XLD + kk + 2 * t);
        a[1] = ld32(X + (r0 + 8) * XLD + kk + 2 * t);
        a[2] = ld32(X + r0 * XLD + kk + 2 * t + 8);
        a[3] = ld32(X + (r0 + 8) * XLD + kk + 2 * t + 8);
#pragma unroll
        for (int n = 0; n < BV / 8; ++n) {
          if constexpr (VH) {
            const bf16* b = W + (n * 8 + g) * WLD + kk + 2 * t;
            mma(acc[n], a, ld32(b), ld32(b + 8));
          } else {
            const bf16* b = W + (kk + 2 * t) * HLD + n * 8 + g;
            mma(acc[n], a, pack2(b, b + HLD),
                pack2(b + 8 * HLD, b + 9 * HLD));
          }
        }
      }
      __syncthreads();  // the next stage overwrites this buffer
    }
    // online softmax over this tile's columns
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < BV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = v0 + n * 8 + 2 * t + (e & 1);
        float z = acc[n][e];
        if (col >= V) z = kNeg;
        if (col == lab[e >> 1]) gold[e >> 1] += z;
        acc[n][e] = z;
        mx[e >> 1] = fmaxf(mx[e >> 1], z);
      }
    float mn[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float q = mx[r];
      q = fmaxf(q, __shfl_xor_sync(0xffffffffu, q, 1));
      q = fmaxf(q, __shfl_xor_sync(0xffffffffu, q, 2));
      mn[r] = fmaxf(m[r], q);
    }
#pragma unroll
    for (int n = 0; n < BV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e >> 1] += __expf(acc[n][e] - mn[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float q = sum[r];
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      s[r] = s[r] * __expf(m[r] - mn[r]) + q;
      m[r] = mn[r];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float q = gold[r];  // held by the one lane of the quad owning the label
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    const int row = t0 + r0 + 8 * r;
    if (t == 0 && row < T) {
      const size_t i = (size_t)split * T + row;
      const size_t plane = (size_t)gridDim.y * T;
      part[i] = m[r];
      part[plane + i] = s[r];
      part[2 * plane + i] = q;
    }
  }
}

// ----------------------------------------------------------------- f32
constexpr int kF32Threads = 256;
constexpr int FB = 64, FK = 16;  // 64 x 64 tile, 16-deep chunks

// grid (ceil(T / FB), nsplit); vocabulary tiles are FB wide here
template <bool VH>
__global__ void __launch_bounds__(kF32Threads)
    lce_f32(const float* __restrict__ x, const float* __restrict__ w,
            const int* __restrict__ labels, float* __restrict__ part, int T,
            int H, int V, int ldw, int tps) {
  __shared__ float As[FK][FB + 4];  // x chunk, transposed
  __shared__ float Bs[FK][FB + 4];  // w chunk as [k][v]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int t0 = blockIdx.x * FB, split = blockIdx.y;
  const int n_vt = (V + FB - 1) / FB;
  const int vt0 = split * tps, vt1 = min(n_vt, vt0 + tps);
  int lab[4];
  float m[4], s[4], gold[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = t0 + ty + 16 * i;
    lab[i] = row < T ? labels[row] : -1;
    m[i] = kNeg;
    s[i] = gold[i] = 0.f;
  }
  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * FB;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < H; k0 += FK) {
#pragma unroll
      for (int i = 0; i < FK * FB / kF32Threads; ++i) {
        const int e = tid + i * kF32Threads;
        {  // x: row e / FK, column e % FK
          const int r = e / FK, kk = e % FK, row = t0 + r, k = k0 + kk;
          As[kk][r] = (row < T && k < H) ? x[(size_t)row * H + k] : 0.f;
        }
        if constexpr (VH) {  // w [V, H]: vocabulary row e / FK
          const int c = e / FK, kk = e % FK, v = v0 + c, k = k0 + kk;
          Bs[kk][c] = (v < V && k < H) ? w[(size_t)v * H + k] : 0.f;
        } else {  // w [H, V]: row e / FB, vocabulary column e % FB
          const int kk = e / FB, c = e % FB, v = v0 + c, k = k0 + kk;
          Bs[kk][c] = (v < V && k < H) ? w[(size_t)k * ldw + v] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx + 16 * j;
        float z = acc[i][j];
        if (col >= V) z = kNeg;
        if (col == lab[i]) gold[i] += z;
        acc[i][j] = z;
        mx = fmaxf(mx, z);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)  // the 16 lanes sharing row i
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(acc[i][j] - mn);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      s[i] = s[i] * expf(m[i] - mn) + sum;
      m[i] = mn;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float q = gold[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const int row = t0 + ty + 16 * i;
    if (tx == 0 && row < T) {
      const size_t idx = (size_t)split * T + row;
      const size_t plane = (size_t)gridDim.y * T;
      part[idx] = m[i];
      part[plane + idx] = s[i];
      part[2 * plane + idx] = q;
    }
  }
}

// merge the nsplit partial (max, sum-exp, gold) triples of every token
__global__ void lce_merge(const float* __restrict__ part, float* __restrict__ loss,
                          float* __restrict__ lse, int T, int nsplit) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= T) return;
  const size_t plane = (size_t)nsplit * T;
  float mx = kNeg;
  for (int i = 0; i < nsplit; ++i) mx = fmaxf(mx, part[(size_t)i * T + row]);
  float s = 0.f, g = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const size_t j = (size_t)i * T + row;
    s += part[plane + j] * expf(part[j] - mx);
    g += part[2 * plane + j];
  }
  const float l = mx + logf(s);
  lse[row] = l;
  loss[row] = l - g;
}

}  // namespace

extern "C" {

// layout: 0 = "hv" (w [H, V]), 1 = "vh" (w [V, H]); dtype: 0 = float32,
// 1 = bfloat16; ldw: the row stride of an [H, V] head (>= V; ignored for
// "vh"); tps vocabulary tiles (128 wide for bf16, 64 for f32) per split;
// part: [3, nsplit, T] f32 scratch the partial triples go to
int pt_linear_ce_partial(const void* x, const void* w, const int* labels,
                         float* part, int T, int H, int V, int ldw,
                         int layout, int dtype, int nsplit, int tps,
                         void* stream) {
  // an error an earlier runtime call left pending is returned (and so
  // cleared), never dropped: the wrapper raises it
  if (cudaError_t pending = cudaGetLastError()) return pending;
  if (T < 1 || H < 1 || V < 1 || nsplit < 1 || nsplit > 65535 || tps < 1 ||
      (layout != 0 && layout != 1) || (layout == 0 && ldw < V))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (H % 8 || (layout == 0 && ldw % 8)) return cudaErrorInvalidValue;
    const dim3 grid((T + BT - 1) / BT, nsplit);
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    if (layout == 1)
      lce_bf16<true><<<grid, kThreads, 0, st>>>(xb, wb, labels, part, T, H, V,
                                                ldw, tps);
    else
      lce_bf16<false><<<grid, kThreads, 0, st>>>(xb, wb, labels, part, T, H,
                                                 V, ldw, tps);
  } else if (dtype == 0) {
    const dim3 grid((T + FB - 1) / FB, nsplit);
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    if (layout == 1)
      lce_f32<true><<<grid, kF32Threads, 0, st>>>(xf, wf, labels, part, T, H,
                                                  V, ldw, tps);
    else
      lce_f32<false><<<grid, kF32Threads, 0, st>>>(xf, wf, labels, part, T, H,
                                                   V, ldw, tps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// loss and lse [T] f32 from the [3, nsplit, T] partial triples
int pt_linear_ce_merge(const float* part, float* loss, float* lse, int T,
                       int nsplit, void* stream) {
  // an error an earlier runtime call left pending is returned (and so
  // cleared), never dropped: the wrapper raises it
  if (cudaError_t pending = cudaGetLastError()) return pending;
  if (T < 1 || nsplit < 1) return cudaErrorInvalidValue;
  lce_merge<<<(T + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      part, loss, lse, T, nsplit);
  return cudaGetLastError();
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
