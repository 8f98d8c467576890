// Flash attention for Hopper (sm_90a): the forward, and the two passes of
// the FlashAttention-2 backward (dQ; dK and dV).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// `flash_attention` (its forward `_fwd_kernel`, and `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` of the custom VJP). Same function, not the same
// tiling: the TPU kernels walk a sequential 3-D grid and carry m, l and the
// accumulators in VMEM scratch from one grid step to the next; here one CTA
// owns a block of query rows (forward, dQ) or of key rows (dK/dV) and loops
// over the other sequence in a loop inside the block.
//
//   q  [B, Sq, H, D], k and v [B, Sk, H, D], any strides with the last dim
//      contiguous (the q/k/v views of the fused qkv projection are taken as
//      they are, without a copy to head-major)
//   out, dout [B, Sq, H, D] contiguous; dq [B, Sq, H, D] and dk, dv
//      [B, Sk, H, D] at the element strides (batch, seq, head) the caller
//      gives, last dim contiguous (contiguous on the default route; the
//      column slices of one packed [B, S, 3 H D] gradient on the packed
//      route, so dq, dk and dv land in the projection's layout)
//   lse, delta [B, H, Sq] f32
//
//   s = (q . k) * scale; s = -1e30 where k_idx >= kv_len or, under causal,
//   where q_idx < k_idx (the mask is aligned top-left, as the TPU kernel's
//   is, also when Sq != Sk); out = softmax(s) v with the online softmax in
//   f32, l clamped at 1e-30, lse = m + log(l).
//   backward: p = exp(s - lse), dp = dout . v, ds = p * (dp - delta) with
//   delta = rowsum(dout * out) (one elementwise pass before the kernels);
//   dq = scale * ds k, dk = scale * ds^T q, dv = p^T dout. P and dS are
//   rounded to the input type before their products, as in the TPU kernel.
//   Two deterministic passes, no atomics: every output element is summed
//   by one CTA in a fixed order, so two launches agree bitwise.
//
// Bound: at training shapes (S = 1024..2048, D = 64..128) tensor-core
// operations (4 B H S^2 D forward, halved under causal). Design against
// that, bf16 (kernels fwd_wg, dq_wg, dkv_wg):
//   * warpgroup MMA: wgmma m64nNk16 bf16 x bf16 -> f32, the only way to the
//     card's full tensor-core rate. Products of two staged tiles read both
//     from shared memory (K-major, 128-byte swizzle); P and dS go from the
//     accumulator layout to the next product's A operand in registers (one
//     bf16 rounding each), against V, K, dout or q read MN-major;
//   * warp specialisation: a CTA is three warpgroups. One producer warp
//     keeps TMA loads of the other sequence's tiles in flight into rings
//     of stages (full / empty mbarriers: the forward's K and V tiles on
//     rings of 2 of their own, the backward's on one ring of 3); the
//     producer warpgroup gives its registers to the two consumer
//     warpgroups (setmaxnreg 24 / 240), each of which owns 64 rows of the
//     CTA's 128. The threads that do the math compute no copy addresses;
//   * software pipelining inside each consumer: the forward issues the next
//     tile's Q K^T and this tile's P V, then runs the next softmax while
//     P V is on the tensor cores; dQ leaves a tile's dS K in flight over
//     the next tile's S and dP; dK/dV forms P^T while dP^T runs. No wgmma
//     is issued under a branch (ptxas would serialise them);
//   * TMA tensor maps carry the views' strides (built per call on the
//     host), so the packed q/k/v views and the padded head dims need no
//     copy: rows past S and columns past D arrive as zeros;
//   * the online softmax stays in registers in the accumulator layout (a
//     row's statistics reduce inside a quad of lanes), in base 2: one FFMA
//     (s * scale * log2 e - m) and one MUFU.EX2 per score; masks are
//     applied only on tiles that cross the diagonal, kv_len or Sq, behind
//     one uniform branch per tile; under causal, tiles wholly above the
//     diagonal are neither loaded nor computed, and a consumer warpgroup
//     passes over a staged tile none of its rows sees;
//   * f32: plain FMAs on the CUDA cores (never TF32), one warp per row and
//     one lane per column of a 32-wide tile of the other sequence; this path
//     serves parity runs, not speed.
// Head dims: any multiple of 16 up to 256 (the wrapper pads others); the
// kernels are built for D buckets of 64, 128 and 256 (gpt3-2.7b's 80 runs
// in the 128 bucket: its columns 80..127 arrive as TMA zero fill, so they
// cost tensor-core work but no memory traffic). At 256 the dK/dV pass
// splits the output columns over two CTAs, each recomputing S and dP.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError(); a
// view TMA cannot take (a stride or base not 16-byte aligned) returns
// cudaErrorInvalidValue, which the wrapper checks for first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace tiles;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;  // backward only, contiguous like out
  void* out;         // forward output, or dq / dk
  void* out2;        // dv (dK/dV pass)
  float* lse;
  const float* delta;
  long long q_sb, q_ss, q_sh;  // element strides of q, k, v (last dim 1)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // element strides of dq, or of dk and dv
  int B, H, Sq, Sk, D, kv_lim, causal;
  float scale;
};

// ------------------------------------------------- bf16: wgmma and TMA
// Every bf16 kernel: 384 threads, warpgroup 0 the producer (one thread
// issues the TMA loads; the lse / delta tiles of the dK/dV pass are
// written by its first warp), warpgroups 1 and 2 the consumers, each
// owning 64 rows of the CTA's 128.
constexpr int kWgThreads = 384;
constexpr int kStages = 2;     // forward: K and V rings of their own
constexpr int kBwdStages = 3;  // backward: one ring, a tile held over
constexpr int kEmptyArrivals = 8;  // lane 0 of each consumer warp

using hopper::align1k;
using hopper::fence_regs;
using hopper::kdesc;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_wait;
using hopper::mma_rs;
using hopper::mma_ss;
using hopper::mndesc;
using hopper::release;
using hopper::tma_load4;
using hopper::wg_commit;
using hopper::wg_fence;
using hopper::wg_wait0;

// the DM / 64 boxes of one [R x DM] tile, rows row0.. of (head h, batch b)
template <int DM, int R>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int h,
                                          int b) {
#pragma unroll
  for (int a = 0; a < DM / 64; ++a)
    tma_load4(dst + a * R * 64, map, bar, a * 64, row0, h, b);
}

// accumulator tiles (64 x 16 c.. of an m64nN f32 accumulator) as the
// bf16 A operand of the next product, rounded once
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&s)[N / 2]) {
#pragma unroll
  for (int c = 0; c < N / 16; ++c) {
    a[c][0] = packf(s[8 * c], s[8 * c + 1]);
    a[c][1] = packf(s[8 * c + 2], s[8 * c + 3]);
    a[c][2] = packf(s[8 * c + 4], s[8 * c + 5]);
    a[c][3] = packf(s[8 * c + 6], s[8 * c + 7]);
  }
}

// issue S = Q K^T for consumer warpgroup cw's 64 rows of a BM-row Q tile
// against a BN-row K tile (not committed)
template <int DM, int BN, int BM>
__device__ __forceinline__ void scores(float (&sc)[BN / 2], const bf16* Qs,
                                       const bf16* K, int cw) {
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk)
    mma_ss(sc, kdesc(Qs, BM, 64 * cw, kk), kdesc(K, BN, 0, kk), kk > 0);
}

// o (the forward's 64 x DM accumulator) times this lane's rows' factors
template <int DM>
__device__ __forceinline__ void rescale(float (&o)[DM / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < DM / 8; ++n) {
    o[4 * n] *= corr[0];
    o[4 * n + 1] *= corr[0];
    o[4 * n + 2] *= corr[1];
    o[4 * n + 3] *= corr[1];
  }
}

// issue o += P V over a BN-row V tile, P the bf16 A operand (not committed)
template <int DM, int BN>
__device__ __forceinline__ void pv(float (&o)[DM / 2],
                                   const uint32_t (&pa)[BN / 16][4],
                                   const bf16* V) {
#pragma unroll
  for (int c = 0; c < BN / 16; ++c) mma_rs(o, pa[c], mndesc(V, BN, c, 0));
}

// the forward's online-softmax step on the raw scores of the key tile at
// c0, in base 2 (sl2 = scale * log2(e); m in those units): in place, sc
// becomes p = 2^(s sl2 - m_new) = exp(s scale - m_new / log2 e),
// unrounded; updates this lane's rows' m and l and gives the factor corr
// for the accumulator. Masks (kv_len, the causal diagonal) only on tiles
// that cross one, behind one warpgroup-uniform branch.
template <int BN>
__device__ __forceinline__ void fwd_softmax(float (&sc)[BN / 2], float (&m)[2],
                                            float (&l)[2], float (&corr)[2],
                                            const Params& p, float sl2,
                                            int c0, int r0, int rw, int t) {
  if (c0 + BN > p.kv_lim || (p.causal && c0 + BN - 1 > rw)) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8;
        const int col = c0 + j * 8 + 2 * t + (e & 1);
        const bool out = col >= p.kv_lim || (p.causal && row < col);
        sc[4 * j + e] = out ? kNeg : sc[4 * j + e];
      }
  }
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]) * sl2);
    corr[r] = hopper::ex2(m[r] - mn);
    m[r] = mn;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = hopper::ex2(fmaf(sc[4 * j + e], sl2, -m[e >> 1]));
      sc[4 * j + e] = x;
      sum[e >> 1] += x;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = corr[r] * l[r] + quad_sum(sum[r]);
}

// grid (ceil(Sq / 128), H, B), the last query block first (under causal
// it has the most key tiles); key tiles of BN. K and V tiles have rings of
// their own: a K tile is released once S = Q K^T is done, a V tile once
// P V is, so the producer loads ahead of a consumer that holds the next
// tile's K and this tile's V at once.
template <int DM, int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
    fwd_wg(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int BM = 128;
  constexpr uint32_t QB = DM / 64 * BM * 128, KB = DM / 64 * BN * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1k(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  bf16* Ks = reinterpret_cast<bf16*>(sm + QB);                 // [kStages]
  bf16* Vs = reinterpret_cast<bf16*>(sm + QB + kStages * KB);  // [kStages]
  __shared__ __align__(8) uint64_t q_full, k_full[kStages], k_empty[kStages],
      v_full[kStages], v_empty[kStages];
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM, h = blockIdx.y,
            b = blockIdx.z;
  int n_kb = (p.kv_lim + BN - 1) / BN;
  if (p.causal) n_kb = min(n_kb, (q0 + BM + BN - 1) / BN);
  if (tid == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&k_empty[s], kEmptyArrivals);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&v_empty[s], kEmptyArrivals);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ---------------------------------------------- producer
    hopper::reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(&q_full, QB);
      load_tile<DM, BM>(Qs, &tq, &q_full, q0, h, b);
      // in the order the consumers need them: K 0, then K it+1 and V it
      for (int j = 0; j <= n_kb; ++j) {
        for (int kv = 0; kv < 2; ++kv) {
          const int it = kv ? j - 1 : j;  // K of tile j, V of tile j - 1
          if (it < 0 || it >= n_kb) continue;
          const int s = it % kStages, ph = ((it / kStages) & 1) ^ 1;
          uint64_t* fb = kv ? &v_full[s] : &k_full[s];
          mbar_wait(kv ? &v_empty[s] : &k_empty[s], ph);
          mbar_expect_tx(fb, KB);
          load_tile<DM, BN>((kv ? Vs : Ks) + s * (KB / 2), kv ? &tv : &tk, fb,
                            it * BN, h, b);
        }
      }
    }
  } else {  // -------------------------------------------------- consumers
    hopper::reg_alloc<240>();
    const int cw = wg - 1, rw = q0 + 64 * cw;  // this warpgroup's rows
    const int g = lane / 4, t = lane % 4;
    const int r0 = rw + 16 * warp + g;         // this lane's rows r0, r0 + 8
    // the tiles some row of ours sees (under causal the block's last tile
    // may lie wholly above this warpgroup's part of the diagonal)
    const int n_my = p.causal ? min(n_kb, (rw + 63) / BN + 1) : n_kb;
    float o[DM / 2], sc[BN / 2], corr[2];
#pragma unroll
    for (int i = 0; i < DM / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    const float sl2 = p.scale * kLog2e;
    mbar_wait(&q_full, 0);
    // S of tile 0; then per tile: issue S of the next tile and P V of this
    // one, and run the next tile's softmax while P V is on the tensor cores
    mbar_wait(&k_full[0], 0);
    fence_regs(sc);
    wg_fence();
    scores<DM, BN, BM>(sc, Qs, Ks, cw);
    wg_commit();
    wg_wait0();
    fence_regs(sc);
    release(&k_empty[0], lane);
    fwd_softmax<BN>(sc, m, l, corr, p, sl2, 0, r0, rw, t);
    // (the last tile is peeled off, so no wgmma is issued under a branch:
    // ptxas serialises wgmmas on a divergent path)
    for (int it = 0; it + 1 < n_my; ++it) {
      const int s = it % kStages, sn = (it + 1) % kStages;
      uint32_t pa[BN / 16][4];
      to_a<BN>(pa, sc);
      rescale<DM>(o, corr);
      mbar_wait(&k_full[sn], ((it + 1) / kStages) & 1);
      mbar_wait(&v_full[s], (it / kStages) & 1);
      fence_regs(o);
      fence_regs(sc);
      wg_fence();
      scores<DM, BN, BM>(sc, Qs, Ks + sn * (KB / 2), cw);
      wg_commit();
      pv<DM, BN>(o, pa, Vs + s * (KB / 2));
      wg_commit();
      hopper::wg_wait1();  // the next tile's S, not this tile's P V
      fence_regs(sc);
      release(&k_empty[sn], lane);
      fwd_softmax<BN>(sc, m, l, corr, p, sl2, (it + 1) * BN, r0, rw, t);
      wg_wait0();
      fence_regs(o);
      fence_regs(pa);
      release(&v_empty[s], lane);
    }
    {
      const int it = n_my - 1, s = it % kStages;
      uint32_t pa[BN / 16][4];
      to_a<BN>(pa, sc);
      rescale<DM>(o, corr);
      mbar_wait(&v_full[s], (it / kStages) & 1);
      fence_regs(o);
      wg_fence();
      pv<DM, BN>(o, pa, Vs + s * (KB / 2));
      wg_commit();
      wg_wait0();
      fence_regs(o);
      fence_regs(pa);
      release(&v_empty[s], lane);
    }
    for (int it = n_my; it < n_kb; ++it) {  // tiles none of our rows sees
      const int s = it % kStages, ph = (it / kStages) & 1;
      mbar_wait(&k_full[s], ph);
      release(&k_empty[s], lane);
      mbar_wait(&v_full[s], ph);
      release(&v_empty[s], lane);
    }

    bf16* ob = static_cast<bf16*>(p.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + r * 8;
      if (row >= p.Sq) continue;
      const float lc = fmaxf(l[r], 1e-30f), inv = 1.f / lc;
      bf16* orow = ob + (((long long)b * p.Sq + row) * p.H + h) * p.D;
#pragma unroll
      for (int n = 0; n < DM / 8; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < p.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[4 * n + 2 * r] * inv,
                                    o[4 * n + 2 * r + 1] * inv);
      }
      if (t == 0)  // m is in base-2 units
        p.lse[((long long)b * p.H + h) * p.Sq + row] = m[r] * kLn2 + logf(lc);
    }
  }
}

// grid (ceil(Sq / 128), H, B), the last query block first; key tiles of BN
// on a ring of ST stages. Pipelined: a tile's dQ += dS K stays in flight
// while the next tile's S and dP run, and its stage is released at the
// next tile's first wait.
template <int DM, int BN, int ST>
__global__ void __launch_bounds__(kWgThreads, 1)
    dq_wg(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo, const Params p) {
  constexpr int BM = 128;
  constexpr uint32_t QB = DM / 64 * BM * 128, KB = DM / 64 * BN * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1k(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  bf16* Os = reinterpret_cast<bf16*>(sm + QB);  // dout rows
  bf16* Ks = reinterpret_cast<bf16*>(sm + 2 * QB);
  bf16* Vs = reinterpret_cast<bf16*>(sm + 2 * QB + ST * KB);
  __shared__ __align__(8) uint64_t q_full, full[ST], empty[ST];
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM, h = blockIdx.y,
            b = blockIdx.z;
  int n_kb = (p.kv_lim + BN - 1) / BN;
  if (p.causal) n_kb = min(n_kb, (q0 + BM + BN - 1) / BN);
  if (tid == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kEmptyArrivals);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ---------------------------------------------- producer
    hopper::reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(&q_full, 2 * QB);
      load_tile<DM, BM>(Qs, &tq, &q_full, q0, h, b);
      load_tile<DM, BM>(Os, &tdo, &q_full, q0, h, b);
      for (int it = 0; it < n_kb; ++it) {
        const int s = it % ST;
        mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * KB);
        load_tile<DM, BN>(Ks + s * (KB / 2), &tk, &full[s], it * BN, h, b);
        load_tile<DM, BN>(Vs + s * (KB / 2), &tv, &full[s], it * BN, h, b);
      }
    }
  } else {  // -------------------------------------------------- consumers
    hopper::reg_alloc<240>();
    const int cw = wg - 1, rw = q0 + 64 * cw;
    const int g = lane / 4, t = lane % 4;
    const int r0 = rw + 16 * warp + g;
    const int n_my = p.causal ? min(n_kb, (rw + 63) / BN + 1) : n_kb;
    const float sl2 = p.scale * kLog2e;
    float lse2[2], dl[2];  // lse in base-2 units
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + r * 8;
      const long long i = ((long long)b * p.H + h) * p.Sq + row;
      lse2[r] = row < p.Sq ? p.lse[i] * kLog2e : 0.f;
      dl[r] = row < p.Sq ? p.delta[i] : 0.f;
    }
    float dq[DM / 2], sc[BN / 2], dp[BN / 2];
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int i = 0; i < DM / 2; ++i) dq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
    for (int c = 0; c < BN / 16; ++c)
      da[c][0] = da[c][1] = da[c][2] = da[c][3] = 0u;
    mbar_wait(&q_full, 0);
    for (int it = 0; it < n_my; ++it) {
      const int s = it % ST, c0 = it * BN;
      const bf16* K = Ks + s * (KB / 2);
      const bf16* V = Vs + s * (KB / 2);
      mbar_wait(&full[s], (it / ST) & 1);
      fence_regs(sc);
      fence_regs(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk)
        mma_ss(sc, kdesc(Qs, BM, 64 * cw, kk), kdesc(K, BN, 0, kk), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk)
        mma_ss(dp, kdesc(Os, BM, 64 * cw, kk), kdesc(V, BN, 0, kk), kk > 0);
      wg_commit();
      hopper::wg_wait1();  // this tile's S and the previous tile's dQ
      fence_regs(sc);
      fence_regs(dq);
      fence_regs(da);
      if (it > 0) release(&empty[(it - 1) % ST], lane);
      // p = exp(s scale - lse) = 2^(s sl2 - lse2), 0 where masked
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = hopper::ex2(fmaf(sc[4 * j + e], sl2, -lse2[e >> 1]));
      if (c0 + BN > p.kv_lim || (p.causal && c0 + BN - 1 > rw)) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + (e >> 1) * 8;
            const int col = c0 + j * 8 + 2 * t + (e & 1);
            const bool out = col >= p.kv_lim || (p.causal && row < col);
            sc[4 * j + e] = out ? 0.f : sc[4 * j + e];
          }
      }
      wg_wait0();  // dP
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] *= dp[4 * j + e] - dl[e >> 1];  // dS
      to_a<BN>(da, sc);
      wg_fence();
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) mma_rs(dq, da[c], mndesc(K, BN, c, 0));
      wg_commit();
    }
    wg_wait0();
    fence_regs(dq);
    fence_regs(da);
    if (n_my > 0) release(&empty[(n_my - 1) % ST], lane);
    for (int it = n_my; it < n_kb; ++it) {  // tiles none of our rows sees
      mbar_wait(&full[it % ST], (it / ST) & 1);
      release(&empty[it % ST], lane);
    }

    bf16* dqb = static_cast<bf16*>(p.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + r * 8;
      if (row >= p.Sq) continue;
      bf16* drow = dqb + b * p.o_sb + row * p.o_ss + h * p.o_sh;
#pragma unroll
      for (int n = 0; n < DM / 8; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < p.D)
          *reinterpret_cast<__nv_bfloat162*>(drow + col) =
              __floats2bfloat162_rn(dq[4 * n + 2 * r] * p.scale,
                                    dq[4 * n + 2 * r + 1] * p.scale);
      }
    }
  }
}

// grid (ceil(Sk / 128) * DM / DC, H, B): 128 key rows and DC of the DM
// output columns per CTA; query tiles of BQ. The products run transposed:
// S^T = K Q^T, dP^T = V dout^T, so each consumer's rows are keys and the
// query index runs along the accumulator's columns; its lse and delta come
// from shared memory, staged beside each query tile by the producer warp.
// Query tiles on a ring of ST stages. P^T is formed while dP^T is still
// on the tensor cores. (Holding a tile's dV and dK products in flight over
// the next tile's S^T and dP^T needs more than a consumer's 240
// registers: ptxas then serialises the wgmmas.)
template <int DM, int DC, int BQ, int ST>
__global__ void __launch_bounds__(kWgThreads, 1)
    dkv_wg(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap tdo, const Params p) {
  constexpr int BKR = 128, NCH = DM / DC;
  constexpr uint32_t KB = DM / 64 * BKR * 128, QB = DM / 64 * BQ * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1k(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(sm);
  bf16* Vs = reinterpret_cast<bf16*>(sm + KB);
  bf16* Qs = reinterpret_cast<bf16*>(sm + 2 * KB);            // [ST]
  bf16* Os = reinterpret_cast<bf16*>(sm + 2 * KB + ST * QB);  // [ST] dout
  __shared__ __align__(8) uint64_t kv_full, full[ST], empty[ST];
  __shared__ float lse_s[ST][BQ], dl_s[ST][BQ];
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int k0 = blockIdx.x / NCH * BKR, chunk = blockIdx.x % NCH;
  const int h = blockIdx.y, b = blockIdx.z;
  // query tiles that see this key block: under causal (q >= k, top-left)
  // from the tile holding q = k0; none when the block is past kv_len
  const int qt0 = p.causal ? k0 / BQ : 0;
  const int n_qt = k0 < p.kv_lim ? (p.Sq + BQ - 1) / BQ : 0;
  if (tid == 0) {
    hopper::mbar_init(&kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes
      hopper::mbar_init(&empty[s], kEmptyArrivals);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ---------------------------------------------- producer
    hopper::reg_dealloc<24>();
    if (warp == 0) {
      if (lane == 0 && qt0 < n_qt) {
        mbar_expect_tx(&kv_full, 2 * KB);
        load_tile<DM, BKR>(Ks, &tk, &kv_full, k0, h, b);
        load_tile<DM, BKR>(Vs, &tv, &kv_full, k0, h, b);
      }
      const float* lseb = p.lse + ((long long)b * p.H + h) * p.Sq;
      const float* dlb = p.delta + ((long long)b * p.H + h) * p.Sq;
      for (int qt = qt0; qt < n_qt; ++qt) {
        const int i = qt - qt0, s = i % ST;
        mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        for (int j = lane; j < BQ; j += 32) {
          const int qi = qt * BQ + j;
          lse_s[s][j] = qi < p.Sq ? lseb[qi] * kLog2e : 0.f;  // base 2
          dl_s[s][j] = qi < p.Sq ? dlb[qi] : 0.f;
        }
        // each lane's arrival releases its own stores; lane 0's also
        // announces the two tiles' bytes
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * QB);
          load_tile<DM, BQ>(Qs + s * (QB / 2), &tq, &full[s], qt * BQ, h, b);
          load_tile<DM, BQ>(Os + s * (QB / 2), &tdo, &full[s], qt * BQ, h,
                            b);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {  // -------------------------------------------------- consumers
    hopper::reg_alloc<240>();
    const int cw = wg - 1, kr = k0 + 64 * cw;  // this warpgroup's keys
    const int g = lane / 4, t = lane % 4;
    const int r0 = kr + 16 * warp + g;         // this lane's keys r0, r0 + 8
    const int a0 = chunk * DC / 64;            // first atom of the columns
    const float sl2 = p.scale * kLog2e;
    // the query tiles where some of our keys are seen: under causal from
    // the tile holding q = kr (the block's earlier tiles see only the other
    // warpgroup's keys); none when all our keys are past kv_len
    const int qa = kr >= p.kv_lim ? n_qt
                   : p.causal     ? max(qt0, min(n_qt, kr / BQ))
                                  : qt0;
    float dk[DC / 2], dv[DC / 2], st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
    for (int qt = qt0; qt < qa; ++qt) {  // tiles none of our keys sees
      const int i = qt - qt0;
      mbar_wait(&full[i % ST], (i / ST) & 1);
      release(&empty[i % ST], lane);
    }
    if (qa < n_qt) mbar_wait(&kv_full, 0);
    for (int qt = qa; qt < n_qt; ++qt) {
      const int i = qt - qt0, s = i % ST;
      const bf16* Q = Qs + s * (QB / 2);
      const bf16* O = Os + s * (QB / 2);
      mbar_wait(&full[s], (i / ST) & 1);
      fence_regs(st);
      fence_regs(dpt);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk)
        mma_ss(st, kdesc(Ks, BKR, 64 * cw, kk), kdesc(Q, BQ, 0, kk), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk)
        mma_ss(dpt, kdesc(Vs, BKR, 64 * cw, kk), kdesc(O, BQ, 0, kk), kk > 0);
      wg_commit();
      hopper::wg_wait1();  // S^T (dP^T may still run)
      fence_regs(st);
      // P^T = 2^(s sl2 - lse2), 0 where masked: the masks only on tiles
      // that cross the diagonal, kv_len or Sq
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + 2 * t + (e & 1);
          st[4 * j + e] = hopper::ex2(fmaf(st[4 * j + e], sl2, -lse_s[s][qc]));
        }
      if (qt * BQ + BQ > p.Sq || kr + 64 > p.kv_lim ||
          (p.causal && qt * BQ < kr + 63)) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qt * BQ + j * 8 + 2 * t + (e & 1);
            const int key = r0 + (e >> 1) * 8;
            const bool out =
                qi >= p.Sq || key >= p.kv_lim || (p.causal && qi < key);
            st[4 * j + e] = out ? 0.f : st[4 * j + e];
          }
      }
      wg_wait0();  // dP^T
      fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + 2 * t + (e & 1);
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dl_s[s][qc]);
        }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      to_a<BQ>(pa, st);   // P^T
      to_a<BQ>(da, dpt);  // dS^T
      fence_regs(dv);
      fence_regs(dk);
      wg_fence();
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c) {
        mma_rs(dv, pa[c], mndesc(O, BQ, c, a0));  // dV += P^T dout
        mma_rs(dk, da[c], mndesc(Q, BQ, c, a0));  // dK += dS^T q
      }
      wg_commit();
      wg_wait0();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      release(&empty[s], lane);
    }

    bf16* dkb = static_cast<bf16*>(p.out);
    bf16* dvb = static_cast<bf16*>(p.out2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = r0 + r * 8;
      if (key >= p.Sk) continue;
      const long long off = b * p.o_sb + key * p.o_ss + h * p.o_sh;
#pragma unroll
      for (int n = 0; n < DC / 8; ++n) {
        const int col = chunk * DC + n * 8 + 2 * t;
        if (col < p.D) {
          *reinterpret_cast<__nv_bfloat162*>(dkb + off + col) =
              __floats2bfloat162_rn(dk[4 * n + 2 * r] * p.scale,
                                    dk[4 * n + 2 * r + 1] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(dvb + off + col) =
              __floats2bfloat162_rn(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
        }
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

// grid (ceil(Sq / 16), H, B)
template <int DM>
__global__ void __launch_bounds__(kThreads) fwd_f32(Params p) {
  constexpr int LD = DM + 1, ND = DM / 32;
  extern __shared__ float fsm[];
  float* Qs = fsm;                 // [FROWS][DM]
  float* Ks = Qs + FROWS * DM;     // [FT][LD]
  float* Vs = Ks + FT * LD;        // [FT][DM]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * FROWS, h = blockIdx.y, b = blockIdx.z;
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  int n_kt = (p.kv_lim + FT - 1) / FT;
  if (p.causal) n_kt = min(n_kt, (q0 + FROWS + FT - 1) / FT);
  load_f32<FROWS, DM>(Qs, DM, qb, p.q_ss, q0, p.Sq, p.D, tid);

  float m[RW], l[RW], acc[RW][ND];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[r][i] = 0.f;
  }
  for (int it = 0; it < n_kt; ++it) {
    __syncthreads();
    load_f32<FT, DM>(Ks, LD, kb, p.k_ss, it * FT, p.Sk, p.D, tid);
    load_f32<FT, DM>(Vs, DM, vb, p.v_ss, it * FT, p.Sk, p.D, tid);
    __syncthreads();
    const int col = it * FT + lane;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = warp * RW + r, row = q0 + lr;
      float x = 0.f;
      for (int d = 0; d < DM; ++d) x = fmaf(Qs[lr * DM + d], Ks[lane * LD + d], x);
      x *= p.scale;
      if (col >= p.kv_lim || (p.causal && row < col)) x = kNeg;
      const float mn = fmaxf(m[r], warp_max(x));
      const float corr = expf(m[r] - mn);
      const float pr = expf(x - mn);
      l[r] = corr * l[r] + warp_sum(pr);
      m[r] = mn;
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
  float* ob = static_cast<float*>(p.out);
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    if (row >= p.Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    float* orow = ob + (((long long)b * p.Sq + row) * p.H + h) * p.D;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      if (lane + 32 * i < p.D) orow[lane + 32 * i] = acc[r][i] / lc;
    if (lane == 0) p.lse[((long long)b * p.H + h) * p.Sq + row] = m[r] + logf(lc);
  }
}

// grid (ceil(Sq / 16), H, B)
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
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const long long o_ss = (long long)p.H * p.D;
  const float* dob = static_cast<const float*>(p.dout) +
                     (long long)b * p.Sq * o_ss + (long long)h * p.D;
  int n_kt = (p.kv_lim + FT - 1) / FT;
  if (p.causal) n_kt = min(n_kt, (q0 + FROWS + FT - 1) / FT);
  load_f32<FROWS, DM>(Qs, DM, qb, p.q_ss, q0, p.Sq, p.D, tid);
  load_f32<FROWS, DM>(Os, DM, dob, o_ss, q0, p.Sq, p.D, tid);

  float lse[RW], dl[RW], acc[RW][ND];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    const long long i = ((long long)b * p.H + h) * p.Sq + row;
    lse[r] = row < p.Sq ? p.lse[i] : 0.f;
    dl[r] = row < p.Sq ? p.delta[i] : 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[r][j] = 0.f;
  }
  for (int it = 0; it < n_kt; ++it) {
    __syncthreads();
    load_f32<FT, DM>(Ks, LD, kb, p.k_ss, it * FT, p.Sk, p.D, tid);
    load_f32<FT, DM>(Vs, LD, vb, p.v_ss, it * FT, p.Sk, p.D, tid);
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
      x *= p.scale;
      if (col >= p.kv_lim || (p.causal && row < col)) x = kNeg;
      const float ds = expf(x - lse[r]) * (dp - dl[r]);
      for (int j = 0; j < FT; ++j) {
        const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int i = 0; i < ND; ++i)
          acc[r][i] = fmaf(dj, Ks[j * LD + lane + 32 * i], acc[r][i]);
      }
    }
  }
  float* dqb = static_cast<float*>(p.out);
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    if (row >= p.Sq) continue;
    float* drow = dqb + b * p.o_sb + row * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      if (lane + 32 * i < p.D) drow[lane + 32 * i] = acc[r][i] * p.scale;
  }
}

// grid (ceil(Sk / 16), H, B): one warp per key row, one lane per query of
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
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const long long o_ss = (long long)p.H * p.D;
  const float* dob = static_cast<const float*>(p.dout) +
                     (long long)b * p.Sq * o_ss + (long long)h * p.D;
  const float* lseb = p.lse + ((long long)b * p.H + h) * p.Sq;
  const float* dlb = p.delta + ((long long)b * p.H + h) * p.Sq;
  const int qt0 = p.causal ? k0 / FT : 0;
  const int n_qt = k0 < p.kv_lim ? (p.Sq + FT - 1) / FT : 0;
  load_f32<FROWS, DM>(Ks, DM, kb, p.k_ss, k0, p.Sk, p.D, tid);
  load_f32<FROWS, DM>(Vs, DM, vb, p.v_ss, k0, p.Sk, p.D, tid);

  float dk[RW][ND], dv[RW][ND];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < ND; ++i) dk[r][i] = dv[r][i] = 0.f;
  for (int qt = qt0; qt < n_qt; ++qt) {
    __syncthreads();
    load_f32<FT, DM>(Qs, LD, qb, p.q_ss, qt * FT, p.Sq, p.D, tid);
    load_f32<FT, DM>(Os, LD, dob, o_ss, qt * FT, p.Sq, p.D, tid);
    __syncthreads();
    const int qi = qt * FT + lane;
    const bool qok = qi < p.Sq;
    const float lq = qok ? lseb[qi] : 0.f, dq = qok ? dlb[qi] : 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = warp * RW + r, key = k0 + lr;
      float x = 0.f, dp = 0.f;
      for (int d = 0; d < DM; ++d) {
        x = fmaf(Qs[lane * LD + d], Ks[lr * DM + d], x);
        dp = fmaf(Os[lane * LD + d], Vs[lr * DM + d], dp);
      }
      x *= p.scale;
      if (!qok || key >= p.kv_lim || (p.causal && qi < key)) x = kNeg;
      const float pr = expf(x - lq);
      const float ds = pr * (dp - dq);
      for (int j = 0; j < FT; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
        const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          dv[r][i] = fmaf(pj, Os[j * LD + lane + 32 * i], dv[r][i]);
          dk[r][i] = fmaf(dj, Qs[j * LD + lane + 32 * i], dk[r][i]);
        }
      }
    }
  }
  float* dkb = static_cast<float*>(p.out);
  float* dvb = static_cast<float*>(p.out2);
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int key = k0 + warp * RW + r;
    if (key >= p.Sk) continue;
    const long long off = b * p.o_sb + key * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      if (lane + 32 * i < p.D) {
        dkb[off + lane + 32 * i] = dk[r][i] * p.scale;
        dvb[off + lane + 32 * i] = dv[r][i];
      }
  }
}

// ------------------------------------------------------------- launchers
enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename Kern, typename... Args>
cudaError_t launch(Kern kern, dim3 grid, int threads, size_t smem,
                   cudaStream_t st, const Args&... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// bf16 tiles per head-dim bucket: the forward's key tile FBN, the dQ
// pass's key tile QBN, the dK/dV pass's query tile BQ and output columns
// per CTA DC; 128 rows of the CTA's own sequence throughout. Shared memory:
// a 1 KB alignment margin plus the tiles (at most 161 KB for DM <= 128,
// 225 KB at 256).
template <int DM>
cudaError_t launch_bf16(int kind, const Params& p, cudaStream_t st) {
  constexpr int FBN = DM > 128 ? 64 : 128;
  constexpr int QBN = DM > 128 ? 32 : 64;
  constexpr int BQ = DM > 128 ? 32 : 64;
  constexpr int DC = DM > 128 ? 128 : DM;
  constexpr size_t A = DM / 64 * 128;  // bytes per tile row, all atoms
  using hopper::tensor_map;
  const int qrows = kind == kDkv ? BQ : 128;
  const int krows = kind == kFwd ? FBN : kind == kDq ? QBN : 128;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, p.q, p.B, p.Sq, p.H, p.D, p.q_sb, p.q_ss, p.q_sh,
                  qrows) ||
      !tensor_map(&tk, p.k, p.B, p.Sk, p.H, p.D, p.k_sb, p.k_ss, p.k_sh,
                  krows) ||
      !tensor_map(&tv, p.v, p.B, p.Sk, p.H, p.D, p.v_sb, p.v_ss, p.v_sh,
                  krows))
    return cudaErrorInvalidValue;
  const dim3 qgrid((p.Sq + 127) / 128, p.H, p.B);
  if (kind == kFwd)
    return launch(fwd_wg<DM, FBN>, qgrid, kWgThreads,
                  1024 + A * (128 + 2 * kStages * FBN), st, tq, tk, tv, p);
  // dout: contiguous [B, Sq, H, D]
  const long long o_ss = (long long)p.H * p.D;
  if (!tensor_map(&tdo, p.dout, p.B, p.Sq, p.H, p.D, p.Sq * o_ss, o_ss, p.D,
                  qrows))
    return cudaErrorInvalidValue;
  if (kind == kDq)
    return launch(dq_wg<DM, QBN, kBwdStages>, qgrid, kWgThreads,
                  1024 + A * (2 * 128 + 2 * kBwdStages * QBN), st, tq, tk, tv,
                  tdo, p);
  return launch(dkv_wg<DM, DC, BQ, kBwdStages>,
                dim3((p.Sk + 127) / 128 * (DM / DC), p.H, p.B), kWgThreads,
                1024 + A * (2 * 128 + 2 * kBwdStages * BQ), st, tq, tk, tv,
                tdo, p);
}

template <int DM>
cudaError_t launch_f32(int kind, const Params& p, cudaStream_t st) {
  constexpr int LD = DM + 1;
  constexpr size_t F = sizeof(float);
  if (kind == kFwd)
    return launch(fwd_f32<DM>, dim3((p.Sq + FROWS - 1) / FROWS, p.H, p.B),
                  kThreads, (FROWS * DM + FT * LD + FT * DM) * F, st, p);
  if (kind == kDq)
    return launch(dq_f32<DM>, dim3((p.Sq + FROWS - 1) / FROWS, p.H, p.B),
                  kThreads, (2 * FROWS * DM + 2 * FT * LD) * F, st, p);
  return launch(dkv_f32<DM>, dim3((p.Sk + FROWS - 1) / FROWS, p.H, p.B),
                kThreads, (2 * FROWS * DM + 2 * FT * LD) * F, st, p);
}

cudaError_t run(int kind, Params& p, const long long* strides,
                const long long* ostrides, int B, int H, int Sq, int Sk,
                int D, int kv_len, int causal, float scale, int dtype,
                void* stream) {
  // an error an earlier runtime call left pending is returned (and so
  // cleared), never dropped: the wrapper raises it
  if (cudaError_t pending = cudaGetLastError()) return pending;
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 16 || D > 256 || D % 16 ||
      B > 65535 || H > 65535 || kv_len < 1)
    return cudaErrorInvalidValue;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  if (kind != kFwd) {
    if (!ostrides) return cudaErrorInvalidValue;
    p.o_sb = ostrides[0]; p.o_ss = ostrides[1]; p.o_sh = ostrides[2];
  }
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.D = D;
  p.kv_lim = kv_len < Sk ? kv_len : Sk;
  p.causal = causal;
  p.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D <= 64) return launch_bf16<64>(kind, p, st);
    if (D <= 128) return launch_bf16<128>(kind, p, st);
    return launch_bf16<256>(kind, p, st);
  }
  if (dtype == 0) {
    if (D <= 64) return launch_f32<64>(kind, p, st);
    if (D <= 128) return launch_f32<128>(kind, p, st);
    return launch_f32<256>(kind, p, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// strides: the element strides (batch, seq, head) of q, k and v, in that
// order; dq_strides / dkv_strides: those of dq, or of dk and dv (which
// share them); dtype: 0 = float32, 1 = bfloat16 (all tensors share it)
int pt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                 float* lse, const long long* strides, int B, int H, int Sq,
                 int Sk, int D, int kv_len, int causal, float scale, int dtype,
                 void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.out = out; p.lse = lse;
  return run(kFwd, p, strides, nullptr, B, H, Sq, Sk, D, kv_len, causal,
             scale, dtype, stream);
}

int pt_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, const long long* strides,
                    const long long* dq_strides, int B, int H, int Sq,
                    int Sk, int D, int kv_len, int causal, float scale,
                    int dtype, void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.out = dq;
  p.lse = const_cast<float*>(lse); p.delta = delta;
  return run(kDq, p, strides, dq_strides, B, H, Sq, Sk, D, kv_len, causal,
             scale, dtype, stream);
}

int pt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, const long long* strides,
                     const long long* dkv_strides, int B, int H, int Sq,
                     int Sk, int D, int kv_len, int causal, float scale,
                     int dtype, void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.out = dk; p.out2 = dv;
  p.lse = const_cast<float*>(lse); p.delta = delta;
  return run(kDkv, p, strides, dkv_strides, B, H, Sq, Sk, D, kv_len, causal,
             scale, dtype, stream);
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
