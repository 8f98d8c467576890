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
// (head, batch row, tile of query rows).
//
// Bound: device-memory bytes at the serving shapes (a window of S <= 128
// rows over <= 256 cached columns does ~2*S flops per K/V element it reads,
// far below the ~295 flop/byte where the tensor cores would become the
// limit). So what a design must buy is reading each K/V byte as few times
// as it can and keeping the arithmetic off the critical path.
//
// bf16 q (kernel prefix_tc, the main path's form) over bf16 pools (#3) or
// int8 codes (#4), one template with the pool form as its parameter:
//   * a CTA owns 64 query rows, one warp per 16, so each K/V byte is read
//     from device memory once per 64 rows (in a window shorter than 64
//     rows the warps without rows still stage tiles);
//   * K and V are staged 64 pool columns at a time (four 16-row pool
//     blocks) with 16-byte cp.async, double-buffered: bf16 rows straight
//     into the padded tiles the products read (a row of D bf16 values, D a
//     multiple of 8, is a whole number of 16-byte pieces; there is no
//     widening pass); int8 codes (8-byte pieces where a row of D codes is
//     not a multiple of 16 bytes) into buffers of their own, their scales
//     beside them, widened once per tile to bf16 in shared memory (exact:
//     |code| <= 127);
//   * Q K^T and P V run on the tensor cores, mma.sync m16n8k16 bf16 -> f32
//     with ldmatrix operands (.trans for V); each column's score is
//     multiplied by scale (times k_scale for codes) in f32, and the online
//     softmax stays in f32 in the accumulator layout (row statistics reduce
//     inside a quad of lanes);
//   * P (P * v_scale for codes) is formed in f32 and rounded to bf16 once,
//     as the A operand of its product with V. For codes the JAX kernel
//     forms p * vs in f32 before its dot and the plain version rounds it to
//     q's dtype too; for bf16 pools the JAX kernel keeps p in f32 and the
//     plain version rounds the normalised probabilities, so this one
//     rounding is the tile kernel's own (sized in
//     tests/test_torch_prefix_tiles.py);
//   * the CTA stops at its largest frontier, min(start + last row,
//     MB*bs - 1), and a warp skips tiles past its own; head dims D that are
//     not a multiple of 16 (the mma depth) are zero-padded in shared memory.
// f32 q (kernel paged_prefix_kernel, the parity route of both forms): one
// warp per query row, kRows rows per CTA, kCols pool columns staged at a
// time in their storage type and widened in registers; each warp scores
// kGroup columns together (lanes spread over D, one warp-wide sum per
// column) on the CUDA cores and keeps its row's online softmax in f32
// registers; the q8 form keeps the TPU kernel's factored scales. Head
// dims: any multiple of 8 up to 256. In the warp-per-row kernel each lane
// owns NV = ceil(D / 32) elements; where D is not a multiple of 32
// (gpt3-2.7b's 80) it is instantiated at 32 * NV, stages its tiles element
// by element with the columns d >= D zero-filled, and masks q's loads and
// the output's stores at d >= D, so the pools are read in place, never
// padded.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attention_tiles.cuh"
#include "hopper.cuh"

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
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// ------------------------------------------- bf16 q: tensor-core tiles
constexpr int kTcRows = 64;  // query rows per CTA, 16 per warp
constexpr int kTcCols = 64;  // pool columns per staged K/V tile
constexpr int kTcThreads = 128;

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   hopper::smem_u32(smem)),
               "l"(gmem), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// eight int8 codes as eight bf16 (exact)
__device__ __forceinline__ uint4 widen8(uint2 raw) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
  uint4 w;
  w.x = tiles::packf(static_cast<float>(e[0]), static_cast<float>(e[1]));
  w.y = tiles::packf(static_cast<float>(e[2]), static_cast<float>(e[3]));
  w.z = tiles::packf(static_cast<float>(e[4]), static_cast<float>(e[5]));
  w.w = tiles::packf(static_cast<float>(e[6]), static_cast<float>(e[7]));
  return w;
}

// shared memory of prefix_tc<DP, Q8>, tiles' bf16 rows padded by 16 bytes
// against ldmatrix bank conflicts: q, then for bf16 pools two buffers of
// K and V tiles; for codes the widened K and V tiles, two buffers of K and
// V codes and two of their scales
constexpr size_t tc_smem(int DP, bool q8) {
  return q8 ? 3 * kTcCols * (DP + 8) * 2 + 4 * kTcCols * DP + 4 * kTcCols * 4
            : 5 * kTcCols * (DP + 8) * 2;
}

// grid (H, B, ceil(S / 64)); block kTcThreads. DP: D rounded up to the
// mma depth (16). Q8 = false: k_pool and v_pool are bf16 [NB, bs, H, D],
// the scales unused; Q8 = true: int8 codes and their f32 scales.
template <int DP, bool Q8>
__global__ void __launch_bounds__(kTcThreads)
    prefix_tc(const __nv_bfloat16* __restrict__ q,
              const void* __restrict__ k_pool,
              const float* __restrict__ k_scale,
              const void* __restrict__ v_pool,
              const float* __restrict__ v_scale,
              const int* __restrict__ tables, const int* __restrict__ start,
              __nv_bfloat16* __restrict__ out, int S, int H, int NB, int bs,
              int MB, int D, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = DP + 8;  // bf16 row pitch of the staged tiles
  constexpr int TILE = kTcCols * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [64][LD]
  // bf16 pools: [2 buffers][K, V][64][LD]; codes: the widened K and V
  // tiles [64][LD] each, then [2 buffers][K, V][64][DP] codes, then
  // [2][K, V][64] scales
  bf16* tiles_s = Qs + kTcRows * LD;
  int8_t* codes = reinterpret_cast<int8_t*>(tiles_s + 2 * TILE);
  float* scales = reinterpret_cast<float*>(codes + 4 * kTcCols * DP);
  const int h = blockIdx.x, b = blockIdx.y, row0 = blockIdx.z * kTcRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = row0 + 16 * warp;  // this warp's first query row

  // frontiers (last attended column, inclusive) in 64 bits: start + row
  // may pass the table's extent, which the wrapper keeps below 2^31
  const int64_t width = static_cast<int64_t>(MB) * bs;
  const int64_t st = start[b];
  const int F = static_cast<int>(
      min64(st + min(row0 + kTcRows, S) - 1, width - 1));  // the CTA's
  const int fw = wr < S ? static_cast<int>(min64(
                              st + min(wr + 15, S - 1), width - 1))
                        : -1;                                 // the warp's
  int fr[2];                                                  // the rows'
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wr + g + 8 * r;
    fr[r] = i < S ? static_cast<int>(min64(st + i, width - 1)) : -1;
  }
  const int* trow = tables + static_cast<int64_t>(b) * MB;
  const int n_tiles = F / kTcCols + 1;
  // the pool row of column c (c <= F); a table entry outside [0, NB) would
  // read outside the pool, so it is clamped into it (the engine never
  // emits one)
  auto pool_row = [&](int c) {
    const int blk = min(max(trow[c / bs], 0), NB - 1);
    return (static_cast<int64_t>(blk) * bs + c % bs) * H + h;
  };

  // q rows (zero past S), columns D..DP zero
  for (int x = tid; x < kTcRows * (DP / 8); x += kTcThreads) {
    const int r = x / (DP / 8), d = (x % (DP / 8)) * 8, i = row0 + r;
    bf16* dst = Qs + r * LD + d;
    if (d < D)
      tiles::cp_async16(
          dst, q + ((static_cast<int64_t>(b) * S + (i < S ? i : 0)) * H + h) *
                       D + d,
          i < S);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  // pool columns [64 tile, 64 tile + 64) into buffer buf; columns past F
  // (and a bf16 tile's columns D..DP) are zero-filled
  auto stage = [&](int tile, int buf) {
    const int c0 = tile * kTcCols;
    if constexpr (Q8) {
      int8_t* kd = codes + buf * 2 * kTcCols * DP;
      int8_t* vd = kd + kTcCols * DP;
      float* ksd = scales + buf * 2 * kTcCols;
      float* vsd = ksd + kTcCols;
      const int8_t* kp = static_cast<const int8_t*>(k_pool);
      const int8_t* vp = static_cast<const int8_t*>(v_pool);
      const int vec = D % 16 == 0 ? 16 : 8, pieces = D / vec;
      for (int x = tid; x < kTcCols * pieces; x += kTcThreads) {
        const int cc = x / pieces, pc = x - cc * pieces, c = c0 + cc;
        const bool ok = c <= F;
        const int64_t off = ok ? pool_row(c) * D + pc * vec : 0;
        if (vec == 16) {
          tiles::cp_async16(kd + cc * DP + pc * 16, kp + off, ok);
          tiles::cp_async16(vd + cc * DP + pc * 16, vp + off, ok);
        } else {
          cp_async8(kd + cc * DP + pc * 8, kp + off, ok);
          cp_async8(vd + cc * DP + pc * 8, vp + off, ok);
        }
      }
      for (int cc = tid; cc < kTcCols; cc += kTcThreads) {
        const int c = c0 + cc;
        const bool ok = c <= F;
        const int64_t idx = ok ? pool_row(c) : 0;
        cp_async4(ksd + cc, k_scale + idx, ok);
        cp_async4(vsd + cc, v_scale + idx, ok);
      }
    } else {
      bf16* kd = tiles_s + buf * 2 * TILE;
      bf16* vd = kd + TILE;
      const bf16* kp = static_cast<const bf16*>(k_pool);
      const bf16* vp = static_cast<const bf16*>(v_pool);
      for (int x = tid; x < kTcCols * (DP / 8); x += kTcThreads) {
        const int cc = x / (DP / 8), d = (x % (DP / 8)) * 8, c = c0 + cc;
        const bool ok = c <= F && d < D;
        const int64_t off = ok ? pool_row(c) * D + d : 0;
        tiles::cp_async16(kd + cc * LD + d, kp + off, ok);
        tiles::cp_async16(vd + cc * LD + d, vp + off, ok);
      }
    }
  };

  stage(0, 0);
  tiles::cp_async_commit();
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1, c0 = tile * kTcCols;
    if (tile + 1 < n_tiles) {
      stage(tile + 1, buf ^ 1);
      tiles::cp_async_commit();
      tiles::cp_async_wait<1>();
    } else {
      tiles::cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and q) has landed
    const bf16* Kb = Q8 ? tiles_s : tiles_s + buf * 2 * TILE;
    const bf16* Vb = Kb + TILE;
    if constexpr (Q8) {
      const int8_t* kd = codes + buf * 2 * kTcCols * DP;
      const int8_t* vd = kd + kTcCols * DP;
      for (int x = tid; x < kTcCols * (DP / 8); x += kTcThreads) {
        const int cc = x / (DP / 8), d = (x % (DP / 8)) * 8;
        uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
        if (d < D) {
          kw = widen8(*reinterpret_cast<const uint2*>(kd + cc * DP + d));
          vw = widen8(*reinterpret_cast<const uint2*>(vd + cc * DP + d));
        }
        *reinterpret_cast<uint4*>(tiles_s + cc * LD + d) = kw;
        *reinterpret_cast<uint4*>(tiles_s + TILE + cc * LD + d) = vw;
      }
      __syncthreads();  // the widened tiles are complete
    }
    if (c0 <= fw) {   // warp-uniform
      const float* ksd = scales + buf * 2 * kTcCols;
      const float* vsd = ksd + kTcCols;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        hopper::ldsm_x4(a, Qs + (16 * warp + lane % 16) * LD + kk * 16 +
                               (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          hopper::ldsm_x4(bb, Kb + (16 * np + (lane / 16) * 8 + lane % 8) * LD +
                                  kk * 16 + ((lane / 8) & 1) * 8);
          tiles::mma(s[2 * np], a, bb[0], bb[1]);
          tiles::mma(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = j * 8 + 2 * t + (e & 1);
          float x = s[j][e] * (Q8 ? ksd[cc] * scale : scale);
          if (c0 + cc > fr[e >> 1]) x = kNeg;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], tiles::quad_max(mx[r]));
        corr[r] = expf(m[r] - mn);
        m[r] = mn;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = j * 8 + 2 * t + (e & 1);
          const float p =
              c0 + cc > fr[e >> 1] ? 0.f : expf(s[j][e] - m[e >> 1]);
          sum[e >> 1] += p;
          // P (P * v_scale for codes), rounded to bf16 below
          s[j][e] = Q8 ? p * vsd[cc] : p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = corr[r] * l[r] + tiles::quad_sum(sum[r]);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t a[4];
        a[0] = tiles::packf(s[2 * c][0], s[2 * c][1]);
        a[1] = tiles::packf(s[2 * c][2], s[2 * c][3]);
        a[2] = tiles::packf(s[2 * c + 1][0], s[2 * c + 1][1]);
        a[3] = tiles::packf(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
        for (int np = 0; np < DP / 16; ++np) {
          uint32_t bb[4];
          hopper::ldsm_x4_t(bb, Vb + (16 * c + ((lane / 8) & 1) * 8 +
                                      lane % 8) * LD +
                                    np * 16 + (lane / 16) * 8);
          tiles::mma(acc[2 * np], a, bb[0], bb[1]);
          tiles::mma(acc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // readers of this tile's buffers are done
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wr + g + 8 * r;
    if (i >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = out + ((static_cast<int64_t>(b) * S + i) * H + h) * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  }
}

template <int DP, bool Q8>
cudaError_t launch_tc(const void* q, const void* k, const float* ks,
                      const void* v, const float* vs, const int* tables,
                      const int* start, void* out, int B, int S, int H, int D,
                      int NB, int bs, int MB, float scale,
                      cudaStream_t stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(prefix_tc<DP, Q8>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(tc_smem(DP, Q8)));
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B, (S + kTcRows - 1) / kTcRows);
  prefix_tc<DP, Q8><<<grid, kTcThreads, tc_smem(DP, Q8), stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, ks, v, vs, tables, start,
      static_cast<__nv_bfloat16*>(out), S, H, NB, bs, MB, D, scale);
  return cudaGetLastError();
}

// bf16 q over bf16 pools (Q8 = false) or int8 codes (Q8 = true)
template <bool Q8>
cudaError_t launch_tc_d(const void* q, const void* k, const float* ks,
                        const void* v, const float* vs, const int* tables,
                        const int* start, void* out, int B, int S, int H,
                        int D, int NB, int bs, int MB, float scale,
                        cudaStream_t stream) {
#define PT_TC(DP)                                                        \
  case DP:                                                               \
    return launch_tc<DP, Q8>(q, k, ks, v, vs, tables, start, out, B, S, \
                             H, D, NB, bs, MB, scale, stream);
  switch ((D + 15) / 16 * 16) {
    PT_TC(16) PT_TC(32) PT_TC(48) PT_TC(64) PT_TC(80) PT_TC(96) PT_TC(112)
    PT_TC(128) PT_TC(144) PT_TC(160) PT_TC(176) PT_TC(192) PT_TC(208)
    PT_TC(224) PT_TC(240) PT_TC(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_TC
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
    return launch_tc_d<false>(q, k_pool, nullptr, v_pool, nullptr, tables,
                              start, out, B, S, H, D, NB, bs, MB, scale, s);
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
    return launch_tc_d<true>(q, k_codes, k_scale, v_codes, v_scale, tables,
                             start, out, B, S, H, D, NB, bs, MB, scale, s);
  return cudaErrorInvalidValue;
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
