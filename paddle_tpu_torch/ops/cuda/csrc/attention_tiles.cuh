// Device helpers shared by the attention kernels (flash_attention.cu,
// fused_mha.cu, fused_mha_bias.cu, paged_prefix_attention.cu) and the
// mma.sync kernel of linear_ce.cu, each built into a library of its own:
// cp.async staging of bf16 tiles into shared memory, mma.sync m16n8k16
// products of such tiles with f32 accumulators, quad and warp reductions,
// and the f32 path's tile loads. Every kernel that uses them runs kThreads
// threads (4 warps).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace tiles {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // 4 warps in every kernel

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 bytes are zeroed
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

// Stage rows [row0, row0 + ROWS) x [0, DM) of a strided bf16 matrix whose
// row r starts at base + r * rs into dst [ROWS][ld]; rows >= nrows and
// columns >= D are zero-filled.
template <int ROWS, int DM>
__device__ __forceinline__ void stage(bf16* dst, int ld, const bf16* base,
                                      long long rs, int row0, int nrows,
                                      int D, int tid) {
  constexpr int CPR = DM / 8;  // 16-byte chunks per row
#pragma unroll 4
  for (int c = tid; c < ROWS * CPR; c += kThreads) {
    const int r = c / CPR, d = (c % CPR) * 8;
    const bool ok = (row0 + r < nrows) && (d < D);
    const bf16* src = ok ? base + (long long)(row0 + r) * rs + d : base;
    cp_async16(dst + r * ld + d, src, ok);
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// two bf16 at different rows of shared memory as one operand register
__device__ __forceinline__ uint32_t pack2(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}
__device__ __forceinline__ uint32_t packf(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A operand of rows r, r + 8 and columns kk.. kk + 16 of a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld,
                                       int r, int kk, int t) {
  a[0] = ld32(s + r * ld + kk + 2 * t);
  a[1] = ld32(s + (r + 8) * ld + kk + 2 * t);
  a[2] = ld32(s + r * ld + kk + 2 * t + 8);
  a[3] = ld32(s + (r + 8) * ld + kk + 2 * t + 8);
}

// acc[j] += A (16 x DM, shared, rows r..) * B^T where B is NT*8 rows of a
// shared [rows][ld] tile starting at row 0
template <int NT, int DM>
__device__ __forceinline__ void mm_abt(float (&acc)[NT][4], const bf16* As,
                                       const bf16* Bs, int ld, int r, int g,
                                       int t) {
#pragma unroll
  for (int kk = 0; kk < DM; kk += 16) {
    uint32_t a[4];
    load_a(a, As, ld, r, kk, t);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* b = Bs + (j * 8 + g) * ld + kk + 2 * t;
      mma(acc[j], a, ld32(b), ld32(b + 8));
    }
  }
}

// acc[n] += P (16 x KT*16, from the f32 accumulator tiles p, rounded to
// bf16) * Bs (KT*16 rows x DM, shared, row-major)
template <int KT, int DM>
__device__ __forceinline__ void mm_pb(float (&acc)[DM / 8][4],
                                      const float (&p)[2 * KT][4],
                                      const bf16* Bs, int ld, int g, int t) {
#pragma unroll
  for (int c = 0; c < KT; ++c) {
    uint32_t a[4];
    a[0] = packf(p[2 * c][0], p[2 * c][1]);
    a[1] = packf(p[2 * c][2], p[2 * c][3]);
    a[2] = packf(p[2 * c + 1][0], p[2 * c + 1][1]);
    a[3] = packf(p[2 * c + 1][2], p[2 * c + 1][3]);
    const bf16* b = Bs + (c * 16 + 2 * t) * ld + g;
#pragma unroll
    for (int n = 0; n < DM / 8; ++n)
      mma(acc[n], a, pack2(b + n * 8, b + ld + n * 8),
          pack2(b + 8 * ld + n * 8, b + 9 * ld + n * 8));
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Staging of the other sequence's next tile into the free buffer while
// the current one is used; returns the current buffer's index.
template <int BK, int DM>
__device__ __forceinline__ int next_tiles(bf16* As, bf16* Bs, int LD,
                                          const bf16* ab, const bf16* bb,
                                          long long ars, long long brs,
                                          int it, int n, int S, int D,
                                          int tid) {
  const int buf = it & 1;
  if (it + 1 < n) {
    const int nb = buf ^ 1;
    stage<BK, DM>(As + nb * BK * LD, LD, ab, ars, (it + 1) * BK, S, D, tid);
    stage<BK, DM>(Bs + nb * BK * LD, LD, bb, brs, (it + 1) * BK, S, D, tid);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  return buf;
}

// load rows [row0, row0 + ROWS) x [0, DM) of a strided f32 matrix into
// dst [ROWS][ld], zero-filling rows >= nrows and columns >= D
template <int ROWS, int DM>
__device__ __forceinline__ void load_f32(float* dst, int ld, const float* base,
                                         long long rs, int row0, int nrows,
                                         int D, int tid) {
  for (int i = tid; i < ROWS * DM; i += kThreads) {
    const int r = i / DM, d = i % DM;
    dst[r * ld + d] = (row0 + r < nrows && d < D)
                          ? base[(long long)(row0 + r) * rs + d]
                          : 0.f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace tiles
