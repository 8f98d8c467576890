// Fused whole-sequence multi-head attention for short sequences on the
// packed projection output, for Hopper (sm_90a): the forward and the
// backward (three passes behind one entry point).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/fused_mha.py
// `fused_mha` (its forward `_fwd_kernel` and its backward `_bwd_kernel`).
// Same function, not the same plan: a TPU program holds the whole [S, S]
// score matrix of a group of heads in VMEM and the backward emits dq, dk
// and dv in one program. Here a score row does not fit: at S = 512 a
// 64-row tile of f32 scores is 128 KiB and one head's K and V another 128
// KiB, against 227 KiB of shared memory. So:
//   * forward: one CTA per (64 query rows, head, batch row) streams the
//     key tiles with an online softmax (the same function);
//   * backward: pass 1 recomputes each query row's max m, 1/sum and the
//     exact in-row term r = sum_j dsigma_j sigma_j (online, from the
//     scores and dP = dO V^T, never from the rounded output); pass 2 (one
//     CTA per 64 query rows) forms dQ; pass 3 (one CTA per 64 key rows,
//     the products transposed) forms dK and dV: FA-2's split, no atomics.
//     The row statistics are the only scratch, f32 [3, B, nh, S].
//
//   qkv  [B, S, 3F] (F = nh * D), [q heads | k heads | v heads], read in
//        place: q of head h at column h * D, k at F + h * D, v at 2F + h * D
//   out  [B, S, F]; dout [B, S, F]; dqkv [B, S, 3F] in the packed layout
//   s = (q . k) * scale; s = -1e30 where col >= lim (lim = kv_len, or
//   lens[b] per batch row) or, under causal, where row < col; sigma =
//   softmax(s) in f32; with dropout p = sigma * keep * 1/(1-p); out = p v
//   with p rounded to the input type before the product (bf16).
//   backward: dsigma = (dO . v) * keep/(1-p); ds = sigma (dsigma - r);
//   dq = scale ds k, dk = scale ds^T q (ds rounded before its products),
//   dv = (sigma * keep/(1-p))^T dO (rounded before its product).
//   A row whose every key is masked (lens[b] <= 0) averages all S keys,
//   as the TPU kernel's -1e30 scores do. Query rows past lens[b] attend
//   the row's valid keys like any other row.
//
// Dropout: a stateless counter-based generator, the same in the plain
// PyTorch version (ops/fused_mha.py): bits(b, h, row, col) =
// fmix32(fmix32(fmix32(seed + b * nh + h) + row) + col) (murmur3's
// finaliser, uint32 arithmetic); keep iff bits >= thresh = floor(p *
// 2^32). The seed is read from device memory (one int32), so the caller
// never syncs. Every pass regenerates the same mask.
//
// Bound: at bert-base (B=32, S=512, nh=12, D=64) the forward's two
// [S, S] x D products are ~26 GFLOP against ~100 MB of qkv and output:
// about the same time at the tensor-core peak as at the memory rate; the
// backward's five products make it operation-bound. Design against that,
// simple first (the design of #6, flash_attention.cu):
//   * bf16: mma.sync m16n8k16 bf16 x bf16 -> f32, each warp owning 16 rows
//     of the CTA's block so the row statistics reduce inside a quad of
//     lanes; P and dS go from the accumulators to the next product's A
//     operand in registers;
//   * the other sequence's tiles are double-buffered in shared memory with
//     cp.async; rows past S (S = 197 is ragged) and columns past D are
//     zero-filled as they are staged, and the tail columns past S score
//     -inf, so they never enter the max or the sum;
//   * tiles past the key limit, and under causal tiles above the diagonal,
//     are skipped (their probabilities are exactly zero) unless every key
//     of the row is masked;
//   * f32: plain FMAs on the CUDA cores (never TF32), one warp per row and
//     one lane per column of a 32-wide tile of the other sequence; this
//     path serves parity runs, not speed.
// `wgmma`, TMA and warp specialisation are later work. Head dims: any
// multiple of 8 up to 256, built for D buckets of 64, 128 and 256.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;  // 4 warps in every kernel

struct Params {
  const void* qkv;   // [B, S, 3F]
  const void* dout;  // [B, S, F] (backward)
  void* out;         // forward: [B, S, F]; backward: dqkv [B, S, 3F]
  float* m;          // backward row statistics [B, nh, S]: the max,
  float* il;         //   1 / sum of exp(s - max),
  float* r;          //   and the in-row term
  const int* lens;   // [B] valid keys per batch row, or null
  const int* seed;   // one int32, or null without dropout
  int B, S, nh, D, F, kv_len, causal, drop;
  float scale;
  unsigned thresh;   // keep iff bits >= thresh
  float inv;         // 1 / (1 - p), the kept entries' scale
};

// ------------------------------------------------------------ helpers
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  return h ^ (h >> 16);
}
__device__ __forceinline__ uint32_t head_key(const Params& p, int b, int h) {
  if (!p.drop) return 0u;
  return fmix32(static_cast<uint32_t>(*p.seed) +
                static_cast<uint32_t>(b * p.nh + h));
}
__device__ __forceinline__ uint32_t row_hash(uint32_t k1, int row) {
  return fmix32(k1 + static_cast<uint32_t>(row));
}
// the keep-scale of (row, col): 1/(1-p) or 0; 1 without dropout
__device__ __forceinline__ float keep(const Params& p, uint32_t rh, int col) {
  if (!p.drop) return 1.f;
  return fmix32(rh + static_cast<uint32_t>(col)) >= p.thresh ? p.inv : 0.f;
}

// keys >= the limit are masked; 0 when every key of the batch row is
__device__ __forceinline__ int key_limit(const Params& p, int b) {
  const int lim = p.lens ? p.lens[b] : p.kv_len;
  return lim < p.S ? (lim > 0 ? lim : 0) : p.S;
}
// the scaled score x of (row, col): -inf past the sequence (a tile's
// tail, outside the softmax), -1e30 where masked
__device__ __forceinline__ float masked(float x, int row, int col, int S,
                                        int lim, int causal) {
  if (col >= S) return -INFINITY;
  if (col >= lim || (causal && row < col)) return kNeg;
  return x;
}
// key tiles of width BK a block of query rows [q0, q0 + BQ) must visit
__device__ __forceinline__ int key_tiles(int q0, int BQ, int BK, int S,
                                         int lim, int causal) {
  if (lim == 0) return (S + BK - 1) / BK;  // every key masked: all of them
  int n = (lim + BK - 1) / BK;
  if (causal) n = min(n, (q0 + BQ + BK - 1) / BK);
  return n;
}

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

// ------------------------------------------------------------ bf16 forward
// grid (ceil(S / 64), nh, B); 4 warps x 16 query rows; key tiles of BK
template <int DM, int BK>
__global__ void __launch_bounds__(kThreads) fwd_bf16(Params p) {
  constexpr int BQ = 64, LD = DM + 8, NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;       // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;   // [2][BK][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long rs = 3LL * p.F;
  const bf16* qb = static_cast<const bf16*>(p.qkv) + (long long)b * p.S * rs +
                   (long long)h * p.D;
  const bf16* kb = qb + p.F;
  const bf16* vb = qb + 2 * p.F;
  const int lim = key_limit(p, b);
  const int n_kb = key_tiles(q0, BQ, BK, p.S, lim, p.causal);
  const uint32_t k1 = head_key(p, b, h);

  stage<BQ, DM>(Qs, LD, qb, rs, q0, p.S, p.D, tid);
  stage<BK, DM>(Ks, LD, kb, rs, 0, p.S, p.D, tid);
  stage<BK, DM>(Vs, LD, vb, rs, 0, p.S, p.D, tid);
  cp_async_commit();

  float o[DM / 8][4];
#pragma unroll
  for (int n = 0; n < DM / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int r0 = warp * 16 + g;  // this lane's rows r0 and r0 + 8
  const uint32_t rh[2] = {row_hash(k1, q0 + r0), row_hash(k1, q0 + r0 + 8)};

  for (int it = 0; it < n_kb; ++it) {
    const int buf = next_tiles<BK, DM>(Ks, Vs, LD, kb, vb, rs, rs, it, n_kb,
                                       p.S, p.D, tid);
    const bf16* K = Ks + buf * BK * LD;
    const bf16* V = Vs + buf * BK * LD;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mm_abt<NT, DM>(s, Qs, K, LD, r0, g, t);

    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + (e >> 1) * 8;
        const int col = it * BK + j * 8 + 2 * t + (e & 1);
        const float x = masked(s[j][e] * p.scale, row, col, p.S, lim,
                               p.causal);
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = __expf(m[r] - mn);
      m[r] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = __expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += x;
        s[j][e] = x * keep(p, rh[e >> 1], it * BK + j * 8 + 2 * t + (e & 1));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = corr[r] * l[r] + quad_sum(sum[r]);
#pragma unroll
    for (int n = 0; n < DM / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    mm_pb<BK / 16, DM>(o, s, V, LD, g, t);
    __syncthreads();  // the next iteration overwrites this buffer
  }

  bf16* ob = static_cast<bf16*>(p.out) + (long long)b * p.S * p.F +
             (long long)h * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= p.S) continue;
    const float inv = 1.f / l[r];
    bf16* orow = ob + (long long)row * p.F;
#pragma unroll
    for (int n = 0; n < DM / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

// --------------------------------------------- bf16 backward, row stats
// grid (ceil(S / 64), nh, B); 4 warps x 16 query rows; key tiles of BK.
// Online over the key tiles: the max m, the sum l of exp(s - m) and
// rr = sum exp(s - m) * dsigma, rescaled together; stores m, 1/l, rr/l.
template <int DM, int BK>
__global__ void __launch_bounds__(kThreads) stats_bf16(Params p) {
  constexpr int BQ = 64, LD = DM + 8, NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + BQ * LD;        // dout rows
  bf16* Ks = Os + BQ * LD;        // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;    // [2][BK][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long rs = 3LL * p.F;
  const bf16* qb = static_cast<const bf16*>(p.qkv) + (long long)b * p.S * rs +
                   (long long)h * p.D;
  const bf16* kb = qb + p.F;
  const bf16* vb = qb + 2 * p.F;
  const bf16* dob = static_cast<const bf16*>(p.dout) +
                    (long long)b * p.S * p.F + (long long)h * p.D;
  const int lim = key_limit(p, b);
  const int n_kb = key_tiles(q0, BQ, BK, p.S, lim, p.causal);
  const uint32_t k1 = head_key(p, b, h);

  stage<BQ, DM>(Qs, LD, qb, rs, q0, p.S, p.D, tid);
  stage<BQ, DM>(Os, LD, dob, p.F, q0, p.S, p.D, tid);
  stage<BK, DM>(Ks, LD, kb, rs, 0, p.S, p.D, tid);
  stage<BK, DM>(Vs, LD, vb, rs, 0, p.S, p.D, tid);
  cp_async_commit();

  const int r0 = warp * 16 + g;
  const uint32_t rh[2] = {row_hash(k1, q0 + r0), row_hash(k1, q0 + r0 + 8)};
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, rr[2] = {0.f, 0.f};

  for (int it = 0; it < n_kb; ++it) {
    const int buf = next_tiles<BK, DM>(Ks, Vs, LD, kb, vb, rs, rs, it, n_kb,
                                       p.S, p.D, tid);
    const bf16* K = Ks + buf * BK * LD;
    const bf16* V = Vs + buf * BK * LD;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mm_abt<NT, DM>(s, Qs, K, LD, r0, g, t);
    mm_abt<NT, DM>(dp, Os, V, LD, r0, g, t);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + (e >> 1) * 8;
        const int col = it * BK + j * 8 + 2 * t + (e & 1);
        const float x = masked(s[j][e] * p.scale, row, col, p.S, lim,
                               p.causal);
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = __expf(m[r] - mn);
      m[r] = mn;
    }
    float sum[2] = {0.f, 0.f}, sr[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = it * BK + j * 8 + 2 * t + (e & 1);
        const float x = __expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += x;
        sr[e >> 1] += x * (dp[j][e] * keep(p, rh[e >> 1], col));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = corr[r] * l[r] + quad_sum(sum[r]);
      rr[r] = corr[r] * rr[r] + quad_sum(sr[r]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= p.S || t != 0) continue;
    const long long i = ((long long)b * p.nh + h) * p.S + row;
    p.m[i] = m[r];
    p.il[i] = 1.f / l[r];
    p.r[i] = rr[r] / l[r];
  }
}

// --------------------------------------------------------------- bf16 dQ
// grid (ceil(S / 64), nh, B); 4 warps x 16 query rows; key tiles of BK
template <int DM, int BK>
__global__ void __launch_bounds__(kThreads) dq_bf16(Params p) {
  constexpr int BQ = 64, LD = DM + 8, NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + BQ * LD;        // dout rows
  bf16* Ks = Os + BQ * LD;        // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;    // [2][BK][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long rs = 3LL * p.F;
  const bf16* qb = static_cast<const bf16*>(p.qkv) + (long long)b * p.S * rs +
                   (long long)h * p.D;
  const bf16* kb = qb + p.F;
  const bf16* vb = qb + 2 * p.F;
  const bf16* dob = static_cast<const bf16*>(p.dout) +
                    (long long)b * p.S * p.F + (long long)h * p.D;
  const int lim = key_limit(p, b);
  const int n_kb = key_tiles(q0, BQ, BK, p.S, lim, p.causal);
  const uint32_t k1 = head_key(p, b, h);

  stage<BQ, DM>(Qs, LD, qb, rs, q0, p.S, p.D, tid);
  stage<BQ, DM>(Os, LD, dob, p.F, q0, p.S, p.D, tid);
  stage<BK, DM>(Ks, LD, kb, rs, 0, p.S, p.D, tid);
  stage<BK, DM>(Vs, LD, vb, rs, 0, p.S, p.D, tid);
  cp_async_commit();

  const int r0 = warp * 16 + g;
  const uint32_t rh[2] = {row_hash(k1, q0 + r0), row_hash(k1, q0 + r0 + 8)};
  float mr[2], il[2], rr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    const long long i = ((long long)b * p.nh + h) * p.S + row;
    mr[r] = row < p.S ? p.m[i] : 0.f;
    il[r] = row < p.S ? p.il[i] : 0.f;
    rr[r] = row < p.S ? p.r[i] : 0.f;
  }
  float dq[DM / 8][4];
#pragma unroll
  for (int n = 0; n < DM / 8; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int it = 0; it < n_kb; ++it) {
    const int buf = next_tiles<BK, DM>(Ks, Vs, LD, kb, vb, rs, rs, it, n_kb,
                                       p.S, p.D, tid);
    const bf16* K = Ks + buf * BK * LD;
    const bf16* V = Vs + buf * BK * LD;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mm_abt<NT, DM>(s, Qs, K, LD, r0, g, t);
    mm_abt<NT, DM>(dp, Os, V, LD, r0, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int row = q0 + r0 + r * 8;
        const int col = it * BK + j * 8 + 2 * t + (e & 1);
        const float x = masked(s[j][e] * p.scale, row, col, p.S, lim,
                               p.causal);
        const float sg = __expf(x - mr[r]) * il[r];
        const float dsig = dp[j][e] * keep(p, rh[r], col);
        s[j][e] = sg * (dsig - rr[r]);  // dS, rounded below
      }
    mm_pb<BK / 16, DM>(dq, s, K, LD, g, t);
    __syncthreads();
  }

  bf16* dqb = static_cast<bf16*>(p.out) + (long long)b * p.S * rs +
              (long long)h * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= p.S) continue;
    bf16* drow = dqb + (long long)row * rs;
#pragma unroll
    for (int n = 0; n < DM / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(drow + col) = __floats2bfloat162_rn(
            dq[n][2 * r] * p.scale, dq[n][2 * r + 1] * p.scale);
    }
  }
}

// ------------------------------------------------------------ bf16 dK/dV
// grid (ceil(S / 64), nh, B); 4 warps x 16 key rows; query tiles of BQ.
// The products run transposed: S^T = K Q^T, dP^T = V dout^T, so each
// warp's rows are keys and the query index runs along the accumulator's
// columns.
template <int DM, int BQ>
__global__ void __launch_bounds__(kThreads) dkv_bf16(Params p) {
  constexpr int BKR = 64, LD = DM + 8, NT = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BKR * LD;
  bf16* Qs = Vs + BKR * LD;      // [2][BQ][LD]
  bf16* Os = Qs + 2 * BQ * LD;   // [2][BQ][LD] dout rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BKR, h = blockIdx.y, b = blockIdx.z;
  const long long rs = 3LL * p.F;
  const bf16* qb = static_cast<const bf16*>(p.qkv) + (long long)b * p.S * rs +
                   (long long)h * p.D;
  const bf16* kb = qb + p.F;
  const bf16* vb = qb + 2 * p.F;
  const bf16* dob = static_cast<const bf16*>(p.dout) +
                    (long long)b * p.S * p.F + (long long)h * p.D;
  const long long st = ((long long)b * p.nh + h) * p.S;
  const float *mb = p.m + st, *ilb = p.il + st, *rb = p.r + st;
  const int lim = key_limit(p, b);
  const uint32_t k1 = head_key(p, b, h);

  // query tiles that see this key block: under causal (q >= k) from the
  // tile holding q = k0; none when the block is past the key limit (its
  // probabilities are zero), all when every key is masked
  const int qt0 = (p.causal && lim > 0) ? k0 / BQ : 0;
  const int n_qt = (lim == 0 || k0 < lim) ? (p.S + BQ - 1) / BQ : 0;

  stage<BKR, DM>(Ks, LD, kb, rs, k0, p.S, p.D, tid);
  stage<BKR, DM>(Vs, LD, vb, rs, k0, p.S, p.D, tid);
  if (qt0 < n_qt) {
    stage<BQ, DM>(Qs + (qt0 & 1) * BQ * LD, LD, qb, rs, qt0 * BQ, p.S, p.D,
                  tid);
    stage<BQ, DM>(Os + (qt0 & 1) * BQ * LD, LD, dob, p.F, qt0 * BQ, p.S, p.D,
                  tid);
  }
  cp_async_commit();

  const int r0 = warp * 16 + g;
  float dk[DM / 8][4], dv[DM / 8][4];
#pragma unroll
  for (int n = 0; n < DM / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int buf = next_tiles<BQ, DM>(Qs, Os, LD, qb, dob, rs, p.F, qt, n_qt,
                                       p.S, p.D, tid);
    const bf16* Q = Qs + buf * BQ * LD;
    const bf16* O = Os + buf * BQ * LD;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mm_abt<NT, DM>(s, Ks, Q, LD, r0, g, t);   // S^T  [keys x queries]
    mm_abt<NT, DM>(dp, Vs, O, LD, r0, g, t);  // dP^T
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = qt * BQ + j * 8 + 2 * t + e;
        const bool qok = qi < p.S;
        const float mq = qok ? mb[qi] : 0.f, iq = qok ? ilb[qi] : 0.f;
        const float rq = qok ? rb[qi] : 0.f;
        const uint32_t qh = p.drop ? row_hash(k1, qi) : 0u;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = k0 + r0 + r * 8;
          const float x = qok ? masked(s[j][2 * r + e] * p.scale, qi, key,
                                       p.S, lim, p.causal)
                              : -INFINITY;
          const float sg = __expf(x - mq) * iq;
          const float kp = keep(p, qh, key);
          s[j][2 * r + e] = sg * kp;                              // P^T
          dp[j][2 * r + e] = sg * (dp[j][2 * r + e] * kp - rq);   // dS^T
        }
      }
    mm_pb<BQ / 16, DM>(dv, s, O, LD, g, t);   // dV += P^T dout
    mm_pb<BQ / 16, DM>(dk, dp, Q, LD, g, t);  // dK += dS^T q
    __syncthreads();
  }
  cp_async_wait<0>();  // a block no query sees still staged K and V

  bf16* dkb = static_cast<bf16*>(p.out) + (long long)b * p.S * rs + p.F +
              (long long)h * p.D;
  bf16* dvb = dkb + p.F;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + r * 8;
    if (key >= p.S) continue;
    const long long off = (long long)key * rs;
#pragma unroll
    for (int n = 0; n < DM / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + off + col) =
            __floats2bfloat162_rn(dk[n][2 * r] * p.scale,
                                  dk[n][2 * r + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + off + col) =
            __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------- f32 path
// One warp per row of the CTA's block (RW rows per warp), one lane per
// column of a 32-wide tile of the other sequence; lane L owns the output
// columns d = L + 32 i.
constexpr int RW = 4;                    // rows per warp
constexpr int FROWS = 4 * RW;            // rows per CTA
constexpr int FT = 32;                   // tile of the other sequence

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

// the f32 kernels' views of one (batch row, head)
struct F32Head {
  const float *q, *k, *v, *dout;
  long long rs;  // qkv row stride (3F)
  int lim;
  uint32_t k1;
};
__device__ __forceinline__ F32Head f32_head(const Params& p, int b, int h) {
  F32Head v;
  v.rs = 3LL * p.F;
  v.q = static_cast<const float*>(p.qkv) + (long long)b * p.S * v.rs +
        (long long)h * p.D;
  v.k = v.q + p.F;
  v.v = v.q + 2 * p.F;
  v.dout = p.dout ? static_cast<const float*>(p.dout) +
                        (long long)b * p.S * p.F + (long long)h * p.D
                  : nullptr;
  v.lim = key_limit(p, b);
  v.k1 = head_key(p, b, h);
  return v;
}

// grid (ceil(S / 16), nh, B)
template <int DM>
__global__ void __launch_bounds__(kThreads) fwd_f32(Params p) {
  constexpr int LD = DM + 1, ND = DM / 32;
  extern __shared__ float fsm[];
  float* Qs = fsm;                 // [FROWS][DM]
  float* Ks = Qs + FROWS * DM;     // [FT][LD]
  float* Vs = Ks + FT * LD;        // [FT][DM]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * FROWS, h = blockIdx.y, b = blockIdx.z;
  const F32Head hd = f32_head(p, b, h);
  const int n_kt = key_tiles(q0, FROWS, FT, p.S, hd.lim, p.causal);
  load_f32<FROWS, DM>(Qs, DM, hd.q, hd.rs, q0, p.S, p.D, tid);

  float m[RW], l[RW], acc[RW][ND];
  uint32_t rh[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
    rh[r] = row_hash(hd.k1, q0 + warp * RW + r);
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[r][i] = 0.f;
  }
  for (int it = 0; it < n_kt; ++it) {
    __syncthreads();
    load_f32<FT, DM>(Ks, LD, hd.k, hd.rs, it * FT, p.S, p.D, tid);
    load_f32<FT, DM>(Vs, DM, hd.v, hd.rs, it * FT, p.S, p.D, tid);
    __syncthreads();
    const int col = it * FT + lane;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = warp * RW + r, row = q0 + lr;
      float x = 0.f;
      for (int d = 0; d < DM; ++d) x = fmaf(Qs[lr * DM + d], Ks[lane * LD + d], x);
      x = masked(x * p.scale, row, col, p.S, hd.lim, p.causal);
      const float mn = fmaxf(m[r], warp_max(x));
      const float corr = expf(m[r] - mn);
      const float e = expf(x - mn);
      l[r] = corr * l[r] + warp_sum(e);
      m[r] = mn;
      const float pr = e * keep(p, rh[r], col);
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[r][i] *= corr;
      for (int j = 0; j < FT; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
        for (int i = 0; i < ND; ++i)
          acc[r][i] = fmaf(pj, Vs[j * DM + lane + 32 * i], acc[r][i]);
      }
    }
  }
  float* ob = static_cast<float*>(p.out) + (long long)b * p.S * p.F +
              (long long)h * p.D;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    if (row >= p.S) continue;
    float* orow = ob + (long long)row * p.F;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      if (lane + 32 * i < p.D) orow[lane + 32 * i] = acc[r][i] / l[r];
  }
}

// grid (ceil(S / 16), nh, B): the row statistics m, 1/l, r
template <int DM>
__global__ void __launch_bounds__(kThreads) stats_f32(Params p) {
  constexpr int LD = DM + 1;
  extern __shared__ float fsm[];
  float* Qs = fsm;                 // [FROWS][DM]
  float* Os = Qs + FROWS * DM;     // [FROWS][DM] dout
  float* Ks = Os + FROWS * DM;     // [FT][LD]
  float* Vs = Ks + FT * LD;        // [FT][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * FROWS, h = blockIdx.y, b = blockIdx.z;
  const F32Head hd = f32_head(p, b, h);
  const int n_kt = key_tiles(q0, FROWS, FT, p.S, hd.lim, p.causal);
  load_f32<FROWS, DM>(Qs, DM, hd.q, hd.rs, q0, p.S, p.D, tid);
  load_f32<FROWS, DM>(Os, DM, hd.dout, p.F, q0, p.S, p.D, tid);
  float m[RW], l[RW], rr[RW];
  uint32_t rh[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = kNeg;
    l[r] = rr[r] = 0.f;
    rh[r] = row_hash(hd.k1, q0 + warp * RW + r);
  }
  for (int it = 0; it < n_kt; ++it) {
    __syncthreads();
    load_f32<FT, DM>(Ks, LD, hd.k, hd.rs, it * FT, p.S, p.D, tid);
    load_f32<FT, DM>(Vs, LD, hd.v, hd.rs, it * FT, p.S, p.D, tid);
    __syncthreads();
    const int col = it * FT + lane;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = warp * RW + r, row = q0 + lr;
      float x = 0.f, dp = 0.f;
      for (int d = 0; d < DM; ++d) {
        x = fmaf(Qs[lr * DM + d], Ks[lane * LD + d], x);
        dp = fmaf(Os[lr * DM + d], Vs[lane * LD + d], dp);
      }
      x = masked(x * p.scale, row, col, p.S, hd.lim, p.causal);
      const float mn = fmaxf(m[r], warp_max(x));
      const float corr = expf(m[r] - mn);
      const float e = expf(x - mn);
      l[r] = corr * l[r] + warp_sum(e);
      rr[r] = corr * rr[r] + warp_sum(e * (dp * keep(p, rh[r], col)));
      m[r] = mn;
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    if (row >= p.S || lane != 0) continue;
    const long long i = ((long long)b * p.nh + h) * p.S + row;
    p.m[i] = m[r];
    p.il[i] = 1.f / l[r];
    p.r[i] = rr[r] / l[r];
  }
}

// grid (ceil(S / 16), nh, B)
template <int DM>
__global__ void __launch_bounds__(kThreads) dq_f32(Params p) {
  constexpr int LD = DM + 1, ND = DM / 32;
  extern __shared__ float fsm[];
  float* Qs = fsm;                 // [FROWS][DM]
  float* Os = Qs + FROWS * DM;     // [FROWS][DM] dout
  float* Ks = Os + FROWS * DM;     // [FT][LD]
  float* Vs = Ks + FT * LD;        // [FT][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * FROWS, h = blockIdx.y, b = blockIdx.z;
  const F32Head hd = f32_head(p, b, h);
  const int n_kt = key_tiles(q0, FROWS, FT, p.S, hd.lim, p.causal);
  load_f32<FROWS, DM>(Qs, DM, hd.q, hd.rs, q0, p.S, p.D, tid);
  load_f32<FROWS, DM>(Os, DM, hd.dout, p.F, q0, p.S, p.D, tid);

  float mr[RW], il[RW], rr[RW], acc[RW][ND];
  uint32_t rh[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    const long long i = ((long long)b * p.nh + h) * p.S + row;
    mr[r] = row < p.S ? p.m[i] : 0.f;
    il[r] = row < p.S ? p.il[i] : 0.f;
    rr[r] = row < p.S ? p.r[i] : 0.f;
    rh[r] = row_hash(hd.k1, row);
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[r][j] = 0.f;
  }
  for (int it = 0; it < n_kt; ++it) {
    __syncthreads();
    load_f32<FT, DM>(Ks, LD, hd.k, hd.rs, it * FT, p.S, p.D, tid);
    load_f32<FT, DM>(Vs, LD, hd.v, hd.rs, it * FT, p.S, p.D, tid);
    __syncthreads();
    const int col = it * FT + lane;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = warp * RW + r, row = q0 + lr;
      float x = 0.f, dp = 0.f;
      for (int d = 0; d < DM; ++d) {
        x = fmaf(Qs[lr * DM + d], Ks[lane * LD + d], x);
        dp = fmaf(Os[lr * DM + d], Vs[lane * LD + d], dp);
      }
      x = masked(x * p.scale, row, col, p.S, hd.lim, p.causal);
      const float sg = expf(x - mr[r]) * il[r];
      const float ds = sg * (dp * keep(p, rh[r], col) - rr[r]);
      for (int j = 0; j < FT; ++j) {
        const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int i = 0; i < ND; ++i)
          acc[r][i] = fmaf(dj, Ks[j * LD + lane + 32 * i], acc[r][i]);
      }
    }
  }
  float* dqb = static_cast<float*>(p.out) + (long long)b * p.S * hd.rs +
               (long long)h * p.D;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    if (row >= p.S) continue;
    float* drow = dqb + (long long)row * hd.rs;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      if (lane + 32 * i < p.D) drow[lane + 32 * i] = acc[r][i] * p.scale;
  }
}

// grid (ceil(S / 16), nh, B): one warp per key row, one lane per query of
// a 32-wide query tile
template <int DM>
__global__ void __launch_bounds__(kThreads) dkv_f32(Params p) {
  constexpr int LD = DM + 1, ND = DM / 32;
  extern __shared__ float fsm[];
  float* Ks = fsm;                 // [FROWS][DM]
  float* Vs = Ks + FROWS * DM;     // [FROWS][DM]
  float* Qs = Vs + FROWS * DM;     // [FT][LD]
  float* Os = Qs + FT * LD;        // [FT][LD] dout
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * FROWS, h = blockIdx.y, b = blockIdx.z;
  const F32Head hd = f32_head(p, b, h);
  const long long st = ((long long)b * p.nh + h) * p.S;
  const int qt0 = (p.causal && hd.lim > 0) ? k0 / FT : 0;
  const int n_qt = (hd.lim == 0 || k0 < hd.lim) ? (p.S + FT - 1) / FT : 0;
  load_f32<FROWS, DM>(Ks, DM, hd.k, hd.rs, k0, p.S, p.D, tid);
  load_f32<FROWS, DM>(Vs, DM, hd.v, hd.rs, k0, p.S, p.D, tid);

  float dk[RW][ND], dv[RW][ND];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < ND; ++i) dk[r][i] = dv[r][i] = 0.f;
  for (int qt = qt0; qt < n_qt; ++qt) {
    __syncthreads();
    load_f32<FT, DM>(Qs, LD, hd.q, hd.rs, qt * FT, p.S, p.D, tid);
    load_f32<FT, DM>(Os, LD, hd.dout, p.F, qt * FT, p.S, p.D, tid);
    __syncthreads();
    const int qi = qt * FT + lane;
    const bool qok = qi < p.S;
    const float mq = qok ? p.m[st + qi] : 0.f, iq = qok ? p.il[st + qi] : 0.f;
    const float rq = qok ? p.r[st + qi] : 0.f;
    const uint32_t qh = row_hash(hd.k1, qi);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = warp * RW + r, key = k0 + lr;
      float x = 0.f, dp = 0.f;
      for (int d = 0; d < DM; ++d) {
        x = fmaf(Qs[lane * LD + d], Ks[lr * DM + d], x);
        dp = fmaf(Os[lane * LD + d], Vs[lr * DM + d], dp);
      }
      x = qok ? masked(x * p.scale, qi, key, p.S, hd.lim, p.causal)
              : -INFINITY;
      const float sg = expf(x - mq) * iq;
      const float kp = keep(p, qh, key);
      const float pd = sg * kp;
      const float ds = sg * (dp * kp - rq);
      for (int j = 0; j < FT; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pd, j);
        const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          dv[r][i] = fmaf(pj, Os[j * LD + lane + 32 * i], dv[r][i]);
          dk[r][i] = fmaf(dj, Qs[j * LD + lane + 32 * i], dk[r][i]);
        }
      }
    }
  }
  float* dkb = static_cast<float*>(p.out) + (long long)b * p.S * hd.rs + p.F +
               (long long)h * p.D;
  float* dvb = dkb + p.F;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int key = k0 + warp * RW + r;
    if (key >= p.S) continue;
    const long long off = (long long)key * hd.rs;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      if (lane + 32 * i < p.D) {
        dkb[off + lane + 32 * i] = dk[r][i] * p.scale;
        dvb[off + lane + 32 * i] = dv[r][i];
      }
  }
}

// ------------------------------------------------------------- launchers
enum Kind { kFwd = 0, kStats = 1, kDq = 2, kDkv = 3 };

template <typename Kern>
cudaError_t launch(Kern kern, dim3 grid, size_t smem, const Params& p,
                   cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int DM>
cudaError_t launch_bf16(int kind, const Params& p, cudaStream_t st) {
  constexpr int LD = DM + 8;
  // key tiles of the forward: 64 wide, 32 at the widest head dim
  constexpr int FBK = DM > 128 ? 32 : 64;
  constexpr size_t E = sizeof(bf16);
  const dim3 grid((p.S + 63) / 64, p.nh, p.B);
  if (kind == kFwd)
    return launch(fwd_bf16<DM, FBK>, grid, (64 + 4 * FBK) * LD * E, p, st);
  if (kind == kStats)
    return launch(stats_bf16<DM, 32>, grid, (2 * 64 + 4 * 32) * LD * E, p,
                  st);
  if (kind == kDq)
    return launch(dq_bf16<DM, 32>, grid, (2 * 64 + 4 * 32) * LD * E, p, st);
  return launch(dkv_bf16<DM, 32>, grid, (2 * 64 + 4 * 32) * LD * E, p, st);
}

template <int DM>
cudaError_t launch_f32(int kind, const Params& p, cudaStream_t st) {
  constexpr int LD = DM + 1;
  constexpr size_t F = sizeof(float);
  const dim3 grid((p.S + FROWS - 1) / FROWS, p.nh, p.B);
  if (kind == kFwd)
    return launch(fwd_f32<DM>, grid, (FROWS * DM + FT * LD + FT * DM) * F, p,
                  st);
  const size_t sm = (2 * FROWS * DM + 2 * FT * LD) * F;
  if (kind == kStats) return launch(stats_f32<DM>, grid, sm, p, st);
  if (kind == kDq) return launch(dq_f32<DM>, grid, sm, p, st);
  return launch(dkv_f32<DM>, grid, sm, p, st);
}

cudaError_t run(int kind, const Params& p, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    if (p.D <= 64) return launch_bf16<64>(kind, p, st);
    if (p.D <= 128) return launch_bf16<128>(kind, p, st);
    return launch_bf16<256>(kind, p, st);
  }
  if (dtype == 0) {
    if (p.D <= 64) return launch_f32<64>(kind, p, st);
    if (p.D <= 128) return launch_f32<128>(kind, p, st);
    return launch_f32<256>(kind, p, st);
  }
  return cudaErrorInvalidValue;
}

bool fill(Params& p, int B, int S, int nh, int D, int kv_len, int causal,
          float scale, unsigned thresh, float inv) {
  if (B < 1 || B > 65535 || S < 1 || nh < 1 || nh > 65535 || D < 8 ||
      D > 256 || D % 8 || (nh * D) % 128 || kv_len < 1)
    return false;
  p.B = B; p.S = S; p.nh = nh; p.D = D; p.F = nh * D;
  p.kv_len = kv_len < S ? kv_len : S;
  p.causal = causal;
  p.scale = scale;
  p.thresh = thresh;
  p.inv = inv;
  p.drop = p.seed != nullptr && thresh > 0u;
  return true;
}

}  // namespace

extern "C" {

// qkv [B, S, 3F] -> out [B, S, F]; lens [B] int32 or null (then kv_len
// masks, kv_len >= S: none); seed one int32 or null (no dropout); dtype:
// 0 = float32, 1 = bfloat16
int pt_fused_mha_fwd(const void* qkv, void* out, const int* lens,
                     const int* seed, int B, int S, int nh, int D, int kv_len,
                     int causal, float scale, unsigned thresh, float inv,
                     int dtype, void* stream) {
  // an error an earlier runtime call left pending is returned (and so
  // cleared), never dropped: the wrapper raises it
  if (cudaError_t pending = cudaGetLastError()) return pending;
  Params p{};
  p.qkv = qkv; p.out = out; p.lens = lens; p.seed = seed;
  if (!fill(p, B, S, nh, D, kv_len, causal, scale, thresh, inv))
    return cudaErrorInvalidValue;
  return run(kFwd, p, dtype, static_cast<cudaStream_t>(stream));
}

// dqkv [B, S, 3F] from qkv and dout [B, S, F]; stats: f32 scratch
// [3, B, nh, S] for the row max, 1/sum and in-row term. Three launches
// in order on the stream: the row statistics, dQ, dK/dV.
int pt_fused_mha_bwd(const void* qkv, const void* dout, void* dqkv,
                     float* stats, const int* lens, const int* seed, int B,
                     int S, int nh, int D, int kv_len, int causal, float scale,
                     unsigned thresh, float inv, int dtype, void* stream) {
  if (cudaError_t pending = cudaGetLastError()) return pending;
  Params p{};
  p.qkv = qkv; p.dout = dout; p.out = dqkv; p.lens = lens; p.seed = seed;
  if (!fill(p, B, S, nh, D, kv_len, causal, scale, thresh, inv))
    return cudaErrorInvalidValue;
  const long long n = (long long)B * nh * S;
  p.m = stats;
  p.il = stats + n;
  p.r = stats + 2 * n;
  auto st = static_cast<cudaStream_t>(stream);
  const int kinds[3] = {kStats, kDq, kDkv};
  for (int kind : kinds)
    if (cudaError_t e = run(kind, p, dtype, st)) return e;
  return cudaSuccess;
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
