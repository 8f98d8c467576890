// Fused LM head + softmax cross-entropy, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/linear_ce.py
// `linear_cross_entropy` (its forward `_fwd_kernel`; the backward is plain
// matmuls in the JAX package and in the port). Same function, not the same
// tiling: the TPU kernel walks the vocabulary sequentially for one token
// block, carrying the running max, sum-exp and gold logit in VMEM scratch;
// here the (token tile, vocabulary tile) pairs are spread over the SMs,
// each tile's (max, sum-exp, gold) triple of every token goes to a
// [3, nsplit, T] f32 scratch, and a second small kernel merges the nsplit
// partial triples of each token in a fixed order (no atomics: two launches
// agree bitwise).
//
//   x       [T, H] bf16 or f32, row-major, contiguous
//   w       [V, H] ("vh", the tied embedding) or [H, V] ("hv", an untied
//           head; rows ldw >= V apart), x's dtype
//   labels  [T] int32
//   loss    [T] f32 = lse - logit[label];  lse [T] f32
//
// The [T, V] logits never reach device memory: each tile lives in the
// accumulator registers of the warps that computed it. Columns past V (the
// ragged tail: bert's V = 30522 is not a multiple of the tile) are masked
// to -1e30; a label matches exactly one column; a label outside [0, V) adds
// nothing to the gold logit, as in the TPU kernel.
//
// Bound: 2 T H V tensor-core operations (1.27e12 at T = 6144, H = 2048,
// V = 50304: 1.28 ms at 989 TFLOP/s). Design against that, bf16 "vh" (the
// main path; kernel lce_wg):
//   * a 128-token x 256-vocabulary tile per step, on warpgroup MMAs:
//     wgmma m64n256k16 bf16 x bf16 -> f32 with both operands K-major in
//     shared memory; two consumer warpgroups each own 64 token rows and
//     hold their 64 x 256 f32 logits in registers (128 a thread);
//   * one producer warp issues TMA loads of 64-deep chunks of x (16 KB)
//     and w (32 KB) along H into a ring of 4 stages (full / empty
//     mbarriers, 128-byte swizzle); the producer warpgroup gives its
//     registers to the consumers (setmaxnreg 24 / 240). Rows past T or V
//     and columns past H arrive as TMA zero fill;
//   * a persistent grid, one CTA per SM, walks the tiles in the order
//     tile = token tile + n_tt * vocabulary tile, CTA c taking tiles c,
//     c + grid, ...: the CTAs resident at one time work on two or three
//     vocabulary tiles of every token tile, so each 1 MB w tile comes from
//     device memory about once and is then read from L2 by every token
//     tile, while x (25 MB at gpt3-1.3b) stays resident in L2. A tile
//     moves 128 x H + 256 x H bf16 (1.5 MB at H = 2048) from L2 into
//     shared memory: 85 operations per byte, against 42.7 for the 64 x
//     128 tiles of the kernel it replaced;
//   * the producer runs ahead across tile boundaries, so the next tile's
//     first chunks load while the consumers run this tile's epilogue: the
//     triple of the tile's 256 columns in f32 (row statistics reduce inside
//     a quad of lanes, exponentials in base 2 on MUFU.EX2), written once
//     per (token, vocabulary tile): nsplit = ceil(V / 256);
//   * no wgmma is issued under a branch (ptxas would serialise them).
// The other forms serve no main path: bf16 "hv" (kernel lce_bf16_hv)
// runs a 64 x 128 tile on 4 warps of mma.sync, the H contraction in 32-wide
// chunks of x and w double-buffered with cp.async and w read transposed
// from shared memory, each CTA walking a share of the vocabulary; f32
// (parity runs only) runs plain FMAs on the CUDA cores (never TF32), a 64 x
// 64 tile per 256-thread CTA, each thread a 4 x 4 register tile.
//
// Plain C interface (loaded with ctypes): two entry points, the tile kernel
// and the merge, each launching on the given stream without synchronising
// and returning cudaGetLastError(). The caller provides the [3, nsplit, T]
// f32 scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tiles::cp_async16;
using tiles::cp_async_commit;
using tiles::cp_async_wait;
using tiles::ld32;
using tiles::mma;
using tiles::pack2;
constexpr float kNeg = -1e30f;

// --------------------------------------------------------- bf16 "hv"
constexpr int kThreads = 128;
constexpr int BT = 64, BV = 128, BK = 32;
constexpr int XLD = BK + 8;    // x chunk [BT][XLD]
constexpr int HLD = BV + 8;    // w chunk [BK][HLD]

// grid (ceil(T / BT), nsplit): CTA (i, s) takes token rows i*BT.. and the
// vocabulary tiles [s * tps, min((s + 1) * tps, n_vt))
__global__ void __launch_bounds__(kThreads)
    lce_bf16_hv(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const int* __restrict__ labels, float* __restrict__ part, int T,
             int H, int V, int ldw, int tps) {
  __shared__ __align__(16) bf16 Xs[2][BT * XLD];
  __shared__ __align__(16) bf16 Ws[2][BK * HLD];
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
    lab[r] = row < T && labels[row] < V ? labels[row] : -1;
  }

  auto stage = [&](int buf, int v0, int k0) {
    // x: BT rows x BK columns, 4 chunks of 16 bytes a row
    for (int c = tid; c < BT * (BK / 8); c += kThreads) {
      const int r = c / (BK / 8), k = k0 + (c % (BK / 8)) * 8;
      const bool ok = t0 + r < T && k < H;
      cp_async16(&Xs[buf][r * XLD + (c % (BK / 8)) * 8],
                 ok ? x + (size_t)(t0 + r) * H + k : x, ok);
    }
    for (int c = tid; c < BK * (BV / 8); c += kThreads) {  // BK rows of w
      const int r = c / (BV / 8), v = v0 + (c % (BV / 8)) * 8;
      const bool ok = k0 + r < H && v < V;
      cp_async16(&Ws[buf][r * HLD + (c % (BV / 8)) * 8],
                 ok ? w + (size_t)(k0 + r) * ldw + v : w, ok);
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
          const bf16* b = W + (kk + 2 * t) * HLD + n * 8 + g;
          mma(acc[n], a, pack2(b, b + HLD), pack2(b + 8 * HLD, b + 9 * HLD));
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

// ------------------------------------------ bf16 "vh": wgmma and TMA
constexpr int kWgThreads = 384;   // warpgroup 0 the producer, 1-2 consumers
constexpr int WBM = 128, WBN = 256, WBK = 64, WST = 4;
constexpr uint32_t XB = WBM * WBK * 2;  // bytes of an x chunk (16 KB)
constexpr uint32_t WB = WBN * WBK * 2;  // bytes of a w chunk (32 KB)
constexpr int kEmptyArrivals = 8;       // lane 0 of each consumer warp
constexpr float kLog2e = 1.4426950408889634f;

// issue acc (+)= x chunk rows [64 cw, 64 cw + 64) . w chunk^T over the 64
// columns of one stage (not committed); acc_in = 0 starts the sum
__device__ __forceinline__ void chunk_mma(float (&acc)[128], const bf16* Xs,
                                          const bf16* Ws, int cw,
                                          int acc_in) {
#pragma unroll
  for (int kk = 0; kk < WBK / 16; ++kk)
    hopper::mma_ss(acc, hopper::kdesc(Xs, WBM, 64 * cw, kk),
                   hopper::kdesc(Ws, WBN, 0, kk), acc_in | (kk > 0));
}

// grid: min(SMs, tiles) CTAs, each walking tiles blockIdx.x + k gridDim.x;
// tile = token tile + n_tt * vocabulary tile. part: [3, n_vt, T].
__global__ void __launch_bounds__(kWgThreads, 1)
    lce_wg(const __grid_constant__ CUtensorMap tx,
           const __grid_constant__ CUtensorMap tw,
           const int* __restrict__ labels, float* __restrict__ part, int T,
           int H, int V) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align1k(smem_raw);  // [WST] stages: x, w
  __shared__ __align__(8) uint64_t full[WST], empty[WST];
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int n_tt = (T + WBM - 1) / WBM, n_vt = (V + WBN - 1) / WBN;
  const int n_tiles = n_tt * n_vt, nk = (H + WBK - 1) / WBK;
  if (tid == 0) {
    for (int s = 0; s < WST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kEmptyArrivals);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ---------------------------------------------- producer
    hopper::reg_dealloc<24>();
    if (tid == 0) {
      int it = 0;  // chunks issued, over every tile of this CTA
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int t0 = tile % n_tt * WBM, v0 = tile / n_tt * WBN;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % WST;
          hopper::mbar_wait(&empty[s], ((it / WST) & 1) ^ 1);
          hopper::mbar_expect_tx(&full[s], XB + WB);
          unsigned char* st = sm + s * (XB + WB);
          hopper::tma_load2(st, &tx, &full[s], kc * WBK, t0);
          hopper::tma_load2(st + XB, &tw, &full[s], kc * WBK, v0);
        }
      }
    }
  } else {  // -------------------------------------------------- consumers
    hopper::reg_alloc<240>();
    const int cw = wg - 1, g = lane / 4, t = lane % 4;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int it = 0;  // chunks consumed, over every tile of this CTA
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int tt = tile % n_tt, vt = tile / n_tt;
      const int r0 = tt * WBM + 64 * cw + 16 * warp + g;  // rows r0, r0 + 8
      const int v0 = vt * WBN;
      // chunk 0 starts the sum; each later chunk is issued before the
      // previous one is waited for, then the previous stage is released
      {
        const int s = it % WST;
        hopper::mbar_wait(&full[s], (it / WST) & 1);
        const bf16* st = reinterpret_cast<const bf16*>(sm + s * (XB + WB));
        hopper::fence_regs(acc);
        hopper::wg_fence();
        chunk_mma(acc, st, st + XB / 2, cw, 0);
        hopper::wg_commit();
      }
      for (int kc = 1; kc < nk; ++kc) {
        const int i = it + kc, s = i % WST;
        hopper::mbar_wait(&full[s], (i / WST) & 1);
        const bf16* st = reinterpret_cast<const bf16*>(sm + s * (XB + WB));
        hopper::wg_fence();
        chunk_mma(acc, st, st + XB / 2, cw, 1);
        hopper::wg_commit();
        hopper::wg_wait1();
        hopper::fence_regs(acc);
        hopper::release(&empty[(i - 1) % WST], lane);
      }
      hopper::wg_wait0();
      hopper::fence_regs(acc);
      hopper::release(&empty[(it + nk - 1) % WST], lane);
      it += nk;

      // epilogue: this tile's (max, sum-exp, gold) of rows r0 and r0 + 8;
      // acc[4 j + e] is row r0 + 8 (e >> 1), column v0 + 8 j + 2 t + (e & 1)
      if (v0 + WBN > V) {  // uniform: only the last vocabulary tile
#pragma unroll
        for (int j = 0; j < WBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (v0 + 8 * j + 2 * t + (e & 1) >= V) acc[4 * j + e] = kNeg;
      }
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < WBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], acc[4 * j + e]);
      float ml[2], sum[2] = {0.f, 0.f}, gold[2] = {0.f, 0.f};
      int rel[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = tiles::quad_max(mx[r]);
        ml[r] = mx[r] * kLog2e;
        const int row = r0 + 8 * r;
        const int lab = row < T ? labels[row] : -1;
        // the label's column in this tile, or -1 (a label outside [0, V)
        // matches no column)
        rel[r] = lab >= v0 && lab < V && lab < v0 + WBN ? lab - v0 : -1;
      }
#pragma unroll
      for (int j = 0; j < WBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sum[e >> 1] += hopper::ex2(fmaf(acc[4 * j + e], kLog2e,
                                          -ml[e >> 1]));
      // rare: a label among this lane's columns (8 j + 2 t, 8 j + 2 t + 1)
      if ((rel[0] >= 0 && (rel[0] >> 1 & 3) == t) ||
          (rel[1] >= 0 && (rel[1] >> 1 & 3) == t)) {
#pragma unroll
        for (int j = 0; j < WBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * t + (e & 1) == rel[e >> 1])
              gold[e >> 1] = acc[4 * j + e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sr = tiles::quad_sum(sum[r]);
        const float gr = tiles::quad_sum(gold[r]);  // one lane holds it
        const int row = r0 + 8 * r;
        if (t == 0 && row < T) {
          const size_t i = (size_t)vt * T + row;
          const size_t plane = (size_t)n_vt * T;
          part[i] = mx[r];
          part[plane + i] = sr;
          part[2 * plane + i] = gr;
        }
      }
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
    lab[i] = row < T && labels[row] < V ? labels[row] : -1;
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

// the persistent wgmma kernel; nsplit must be its ceil(V / 256) tiles
cudaError_t launch_wg(const bf16* x, const bf16* w, const int* labels,
                      float* part, int T, int H, int V, int nsplit,
                      cudaStream_t st) {
  const int n_vt = (V + WBN - 1) / WBN;
  if (nsplit != n_vt) return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!hopper::tensor_map_2d(&tx, x, T, H, H, WBM) ||
      !hopper::tensor_map_2d(&tw, w, V, H, H, WBN))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)((T + WBM - 1) / WBM) * n_vt;
  if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  const size_t smem = 1024 + WST * (XB + WB);
  e = cudaFuncSetAttribute(lce_wg, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  lce_wg<<<grid, kWgThreads, smem, st>>>(tx, tw, labels, part, T, H, V);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// layout: 0 = "hv" (w [H, V]), 1 = "vh" (w [V, H]); dtype: 0 = float32,
// 1 = bfloat16; ldw: the row stride of an [H, V] head (>= V; ignored for
// "vh"); part: [3, nsplit, T] f32 scratch the partial triples go to.
// bf16 "vh" (lce_wg): nsplit = ceil(V / 256), one triple per vocabulary
// tile, tps = 1, a persistent grid of one CTA per SM; the other forms:
// tps vocabulary tiles (128 wide for bf16, 64 for f32) per split
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
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    if (layout == 1) {
      if (tps != 1) return cudaErrorInvalidValue;
      return launch_wg(xb, wb, labels, part, T, H, V, nsplit, st);
    }
    const dim3 grid((T + BT - 1) / BT, nsplit);
    lce_bf16_hv<<<grid, kThreads, 0, st>>>(xb, wb, labels, part, T, H, V,
                                           ldw, tps);
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
