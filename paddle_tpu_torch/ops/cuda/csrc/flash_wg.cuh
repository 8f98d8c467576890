// The bf16 warpgroup kernels of flash attention for Hopper (sm_90a): the
// forward fwd_wg and the FlashAttention-2 backward's dq_wg and dkv_wg, one
// copy for two libraries. flash_attention.cu (kernel #6, and #7 on the
// packed views) instantiates them with MHA = false; fused_mha.cu (kernel
// #9, the fused short-sequence MHA on the packed projection output) with
// MHA = true, which compiles in #9's features:
//   * a key limit per batch row, lens[b], read once per CTA: tiles past it
//     are skipped, the tile that crosses it is masked behind the same
//     uniform branch as kv_len. A batch row whose every key is masked
//     (lens[b] <= 0) averages all Sk keys, as the TPU kernel's all -1e30
//     scores do: its raw scores are forced to 0 (uniform softmax), with no
//     causal mask; tail columns past Sk still score -1e30, outside the max
//     and the sum;
//   * attention-probability dropout from a stateless counter-based
//     generator: bits(b, h, row, col) = fmix32(fmix32(fmix32(seed + b * H +
//     h) + row) + col) (murmur3's finaliser), keep iff bits >= thresh, kept
//     entries scaled by inv = 1 / (1 - p). The head key and each row's hash
//     are formed once per CTA (per query tile in dK/dV, by the producer
//     warp into shared memory beside lse), so a score costs one fmix32, a
//     compare and a select, in the accumulator layout. The 0/1 mask
//     multiplies P before P V (forward), dP in the r and dQ passes and
//     P^T and dP^T in dK/dV; inv, common to every kept entry, is left out
//     of P, dP and r and applied once to out, dq, dk and dv (a multiply
//     less per score and pass); the seed is one int32 in device memory,
//     read by the kernel;
//   * the row term of the backward, r = rowsum(dsigma * sigma) with dsigma
//     = dP * keep (over inv), formed in f32 as the TPU kernel forms it, by a pass of
//     its own ahead of dQ and dK/dV (dq_wg with RP: S and dP of every key
//     tile, from the forward's lse) into [B, H, Sq], which both read as
//     #6's passes read delta. FA-2's delta, rowsum(dout * out) from the
//     bf16 output, equals it in real arithmetic but not here: where a
//     row's softmax sits on few keys its rounding is all that is left of
//     dS (tests/test_torch_fused_mha_wg.py), so the backward pays the two
//     extra [S, S] x D products.
// With MHA = false each of those is compiled out (`if constexpr`), so #6's
// and #7's instantiations are the code they were before #9 shared them.
//
// See flash_attention.cu for the function, the bound and the design
// (warp specialisation, TMA rings, the software pipeline, the masks).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace {
namespace wg {

using tiles::bf16;
using tiles::packf;
using tiles::quad_max;
using tiles::quad_sum;
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
  // MHA (kernel #9) only
  const int* lens;   // [B] valid keys per batch row, or null
  const int* seed;   // one int32, or null without dropout
  float* r;          // the r pass's output [B, H, Sq] (then read as delta)
  unsigned thresh;   // keep iff bits >= thresh
  float inv;         // 1 / (1 - p), the kept entries' scale
  int drop;          // dropout on
};

// Every bf16 kernel: NCW + 1 warpgroups, warpgroup 0 the producer (one
// thread issues the TMA loads; the lse / delta tiles of the dK/dV pass are
// written by its first warp), warpgroups 1..NCW the consumers, each
// owning 64 rows of the CTA's 64 NCW. Two consumers (#6, #7: 384 threads,
// one CTA an SM) give their registers 240 each; one (#9 at bucket 64:
// 256 threads, two CTAs an SM) 232, the most two CTAs' 65536 allow. A
// ring stage is released by lane 0 of each consumer warp (4 NCW
// arrivals).
constexpr int kStages = 2;     // forward: K and V rings of their own
constexpr int kBwdStages = 3;  // backward: one ring, a tile held over

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

// -------------------------------------------------- keys and dropout
// The keys a CTA of batch row b sees: columns >= lim are masked, causal
// (top-left) or not; zero: every key of the row is masked (lens[b] <= 0),
// so its raw scores are forced to 0 and lim is Sk.
struct Keys {
  int lim, causal;
  bool zero;
};
template <bool MHA>
__device__ __forceinline__ Keys keys_of(const Params& p, int b) {
  if constexpr (MHA) {
    if (p.lens) {
      const int n = p.lens[b];
      if (n <= 0) return {p.Sk, 0, true};
      return {n < p.Sk ? n : p.Sk, p.causal, false};
    }
  }
  return {p.kv_lim, p.causal, false};
}

// the key limit and the causal flag where they are used: #6/#7 read them
// from the kernel's parameters there, as before MHA shared the kernels
// (kept out of registers, which the dK/dV pass at 240 has none to spare
// for: 4% slower at gpt3-1.3b otherwise), MHA from the batch row's Keys
template <bool MHA>
__device__ __forceinline__ int lim_of(const Keys& ks, const Params& p) {
  if constexpr (MHA) return ks.lim;
  else return p.kv_lim;
}
template <bool MHA>
__device__ __forceinline__ int causal_of(const Keys& ks, const Params& p) {
  if constexpr (MHA) return ks.causal;
  else return p.causal;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  return h ^ (h >> 16);
}
// the head key fmix32(seed + b * H + h); 0 without dropout
__device__ __forceinline__ uint32_t head_key(const Params& p, int b, int h) {
  return p.drop ? fmix32(static_cast<uint32_t>(*p.seed) +
                         static_cast<uint32_t>(b * p.H + h))
                : 0u;
}
// bit i of kb: element i = 4 j + e of this lane's accumulator fragment
// (row r0 + 8 (e >> 1), column c0 + 8 j + 2 t + (e & 1)) is kept; rh: the
// hashes of the lane's two rows (forward, dQ and r passes; the dK/dV pass
// draws its bits from the query columns' hashes itself)
template <int N>
__device__ __forceinline__ void keep_bits(uint32_t (&kb)[(N + 31) / 32],
                                          const Params& p,
                                          const uint32_t (&rh)[2], int c0,
                                          int t) {
#pragma unroll
  for (int w = 0; w < (N + 31) / 32; ++w) kb[w] = 0u;
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const uint32_t col = static_cast<uint32_t>(c0 + j * 8 + 2 * t + (e & 1));
      kb[i / 32] |= static_cast<uint32_t>(fmix32(rh[e >> 1] + col) >=
                                          p.thresh)
                    << (i % 32);
    }
}
__device__ __forceinline__ float kept(const uint32_t* kb, int i, float x) {
  return (kb[i / 32] >> (i % 32)) & 1u ? x : 0.f;
}

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
// for the accumulator. Masks (the key limit, the causal diagonal) only on
// tiles that cross one, behind one warpgroup-uniform branch. MHA: a row
// with every key masked scores 0; under dropout p leaves multiplied by
// its keep-scale (l sums the undropped p).
template <int BN, bool MHA>
__device__ __forceinline__ void fwd_softmax(float (&sc)[BN / 2], float (&m)[2],
                                            float (&l)[2], float (&corr)[2],
                                            const Params& p, const Keys& ks,
                                            float sl2, int c0, int r0, int rw,
                                            int t, const uint32_t (&rh)[2]) {
  if constexpr (MHA) {
    if (ks.zero) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    }
  }
  if (c0 + BN > lim_of<MHA>(ks, p) ||
      (causal_of<MHA>(ks, p) && c0 + BN - 1 > rw)) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8;
        const int col = c0 + j * 8 + 2 * t + (e & 1);
        const bool out = col >= lim_of<MHA>(ks, p) ||
                         (causal_of<MHA>(ks, p) && row < col);
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
  if constexpr (MHA) {
    if (p.drop) {
      uint32_t kb[(BN / 2 + 31) / 32];
      keep_bits<BN / 2>(kb, p, rh, c0, t);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = kept(kb, i, sc[i]);
    }
  }
}

// grid (ceil(Sq / 128), H, B), the last query block first (under causal
// it has the most key tiles); key tiles of BN. K and V tiles have rings of
// their own: a K tile is released once S = Q K^T is done, a V tile once
// P V is, so the producer loads ahead of a consumer that holds the next
// tile's K and this tile's V at once.
template <int DM, int BN, bool MHA, int NCW = 2>
__global__ void __launch_bounds__(128 * (NCW + 1), NCW == 1 ? 2 : 1)
    fwd_wg(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int BM = 64 * NCW;
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
  const Keys ks = keys_of<MHA>(p, b);
  int n_kb = (lim_of<MHA>(ks, p) + BN - 1) / BN;
  if (causal_of<MHA>(ks, p)) n_kb = min(n_kb, (q0 + BM + BN - 1) / BN);
  if (tid == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&k_empty[s], 4 * NCW);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&v_empty[s], 4 * NCW);
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
    hopper::reg_alloc<NCW == 1 ? 232 : 240>();
    const int cw = wg - 1, rw = q0 + 64 * cw;  // this warpgroup's rows
    const int g = lane / 4, t = lane % 4;
    const int r0 = rw + 16 * warp + g;         // this lane's rows r0, r0 + 8
    // the tiles some row of ours sees (under causal the block's last tile
    // may lie wholly above this warpgroup's part of the diagonal)
    const int n_my =
        causal_of<MHA>(ks, p) ? min(n_kb, (rw + 63) / BN + 1) : n_kb;
    uint32_t rh[2] = {0u, 0u};  // the rows' hashes (dropout)
    if constexpr (MHA) {
      if (p.drop) {
        const uint32_t k1 = head_key(p, b, h);
        rh[0] = fmix32(k1 + static_cast<uint32_t>(r0));
        rh[1] = fmix32(k1 + static_cast<uint32_t>(r0 + 8));
      }
    }
    float o[DM / 2], sc[BN / 2], corr[2];
#pragma unroll
    for (int i = 0; i < DM / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    const float sl2 = p.scale * kLog2e;
    const float dsc = MHA && p.drop ? p.inv : 1.f;  // kept entries' scale
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
    fwd_softmax<BN, MHA>(sc, m, l, corr, p, ks, sl2, 0, r0, rw, t, rh);
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
      fwd_softmax<BN, MHA>(sc, m, l, corr, p, ks, sl2, (it + 1) * BN, r0, rw,
                           t, rh);
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
      const float lc = fmaxf(l[r], 1e-30f), inv = dsc / lc;
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
// next tile's first wait. MHA: the keep bits of a tile are drawn while its
// dP is on the tensor cores. RP (MHA only): the r pass, which runs S and
// dP of every tile, sums p * dP * keep over the row and writes r instead
// of dQ.
template <int DM, int BN, int ST, bool MHA, bool RP = false, int NCW = 2>
__global__ void __launch_bounds__(128 * (NCW + 1), NCW == 1 ? 2 : 1)
    dq_wg(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo, const Params p) {
  constexpr int BM = 64 * NCW;
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
  const Keys ks = keys_of<MHA>(p, b);
  int n_kb = (lim_of<MHA>(ks, p) + BN - 1) / BN;
  if (causal_of<MHA>(ks, p)) n_kb = min(n_kb, (q0 + BM + BN - 1) / BN);
  if (tid == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * NCW);
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
    hopper::reg_alloc<NCW == 1 ? 232 : 240>();
    const int cw = wg - 1, rw = q0 + 64 * cw;
    const int g = lane / 4, t = lane % 4;
    const int r0 = rw + 16 * warp + g;
    const int n_my =
        causal_of<MHA>(ks, p) ? min(n_kb, (rw + 63) / BN + 1) : n_kb;
    const float sl2 = p.scale * kLog2e;
    float lse2[2], dl[2];  // lse in base-2 units
    uint32_t rh[2] = {0u, 0u};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + r * 8;
      const long long i = ((long long)b * p.H + h) * p.Sq + row;
      lse2[r] = row < p.Sq ? p.lse[i] * kLog2e : 0.f;
      dl[r] = (!RP && row < p.Sq) ? p.delta[i] : 0.f;  // RP: r's sums
    }
    if constexpr (MHA) {
      if (p.drop) {
        const uint32_t k1 = head_key(p, b, h);
        rh[0] = fmix32(k1 + static_cast<uint32_t>(r0));
        rh[1] = fmix32(k1 + static_cast<uint32_t>(r0 + 8));
      }
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
      if constexpr (!RP) {
        fence_regs(dq);
        fence_regs(da);
        if (it > 0) release(&empty[(it - 1) % ST], lane);
      }
      if constexpr (MHA) {
        if (ks.zero) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
        }
      }
      // p = exp(s scale - lse) = 2^(s sl2 - lse2), 0 where masked
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = hopper::ex2(fmaf(sc[4 * j + e], sl2, -lse2[e >> 1]));
      if (c0 + BN > lim_of<MHA>(ks, p) ||
          (causal_of<MHA>(ks, p) && c0 + BN - 1 > rw)) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + (e >> 1) * 8;
            const int col = c0 + j * 8 + 2 * t + (e & 1);
            const bool out = col >= lim_of<MHA>(ks, p) ||
                             (causal_of<MHA>(ks, p) && row < col);
            sc[4 * j + e] = out ? 0.f : sc[4 * j + e];
          }
      }
      uint32_t kb[(BN / 2 + 31) / 32];
      if constexpr (MHA) {
        if (p.drop) keep_bits<BN / 2>(kb, p, rh, c0, t);
      }
      wg_wait0();  // dP
      fence_regs(dp);
      if constexpr (MHA) {
        if (p.drop) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) dp[i] = kept(kb, i, dp[i]);
        }
      }
      if constexpr (RP) {  // r += p * dP * keep; the stage is free
        release(&empty[s], lane);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dl[e >> 1] = fmaf(sc[4 * j + e], dp[4 * j + e], dl[e >> 1]);
        continue;
      }
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
    if constexpr (!RP) {
      wg_wait0();
      fence_regs(dq);
      fence_regs(da);
      if (n_my > 0) release(&empty[(n_my - 1) % ST], lane);
    }
    for (int it = n_my; it < n_kb; ++it) {  // tiles none of our rows sees
      mbar_wait(&full[it % ST], (it / ST) & 1);
      release(&empty[it % ST], lane);
    }
    if constexpr (RP) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + r * 8;
        const float rr = quad_sum(dl[r]);
        if (row < p.Sq && t == 0)
          p.r[((long long)b * p.H + h) * p.Sq + row] = rr;
      }
      return;
    }

    // dropout's 1 / (1 - p), left out of dP and r, is applied here
    const float qs = MHA && p.drop ? p.scale * p.inv : p.scale;
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
              __floats2bfloat162_rn(dq[4 * n + 2 * r] * qs,
                                    dq[4 * n + 2 * r + 1] * qs);
      }
    }
  }
}

// grid (ceil(Sk / 128) * DM / DC, H, B): 128 key rows and DC of the DM
// output columns per CTA; query tiles of BQ. The products run transposed:
// S^T = K Q^T, dP^T = V dout^T, so each consumer's rows are keys and the
// query index runs along the accumulator's columns; its lse and delta come
// from shared memory, staged beside each query tile by the producer warp
// (MHA under dropout: also the query rows' hashes). Query tiles on a ring
// of ST stages. P^T is formed while dP^T is still on the tensor cores.
// (Holding a tile's dV and dK products in flight over the next tile's S^T
// and dP^T needs more than a consumer's 240 registers: ptxas then
// serialises the wgmmas.)
template <int DM, int DC, int BQ, int ST, bool MHA, int NCW = 2>
__global__ void __launch_bounds__(128 * (NCW + 1), NCW == 1 ? 2 : 1)
    dkv_wg(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap tdo, const Params p) {
  constexpr int BKR = 64 * NCW, NCH = DM / DC;
  constexpr uint32_t KB = DM / 64 * BKR * 128, QB = DM / 64 * BQ * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1k(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(sm);
  bf16* Vs = reinterpret_cast<bf16*>(sm + KB);
  bf16* Qs = reinterpret_cast<bf16*>(sm + 2 * KB);            // [ST]
  bf16* Os = reinterpret_cast<bf16*>(sm + 2 * KB + ST * QB);  // [ST] dout
  __shared__ __align__(8) uint64_t kv_full, full[ST], empty[ST];
  __shared__ float lse_s[ST][BQ], dl_s[ST][BQ];
  __shared__ uint32_t rh_s[MHA ? ST : 1][MHA ? BQ : 1];  // query row hashes
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int k0 = blockIdx.x / NCH * BKR, chunk = blockIdx.x % NCH;
  const int h = blockIdx.y, b = blockIdx.z;
  const Keys ks = keys_of<MHA>(p, b);
  // query tiles that see this key block: under causal (q >= k, top-left)
  // from the tile holding q = k0; none when the block is past the key limit
  const int qt0 = causal_of<MHA>(ks, p) ? k0 / BQ : 0;
  const int n_qt = k0 < lim_of<MHA>(ks, p) ? (p.Sq + BQ - 1) / BQ : 0;
  if (tid == 0) {
    hopper::mbar_init(&kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes
      hopper::mbar_init(&empty[s], 4 * NCW);
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
      uint32_t k1 = 0u;
      if constexpr (MHA) k1 = head_key(p, b, h);
      for (int qt = qt0; qt < n_qt; ++qt) {
        const int i = qt - qt0, s = i % ST;
        mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        for (int j = lane; j < BQ; j += 32) {
          const int qi = qt * BQ + j;
          lse_s[s][j] = qi < p.Sq ? lseb[qi] * kLog2e : 0.f;  // base 2
          dl_s[s][j] = qi < p.Sq ? dlb[qi] : 0.f;
          if constexpr (MHA) {
            if (p.drop) rh_s[s][j] = fmix32(k1 + static_cast<uint32_t>(qi));
          }
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
    hopper::reg_alloc<NCW == 1 ? 232 : 240>();
    const int cw = wg - 1, kr = k0 + 64 * cw;  // this warpgroup's keys
    const int g = lane / 4, t = lane % 4;
    const int r0 = kr + 16 * warp + g;         // this lane's keys r0, r0 + 8
    const int a0 = chunk * DC / 64;            // first atom of the columns
    const float sl2 = p.scale * kLog2e;
    // the query tiles where some of our keys are seen: under causal from
    // the tile holding q = kr (the block's earlier tiles see only the other
    // warpgroup's keys); none when all our keys are past the key limit
    const int qa = kr >= lim_of<MHA>(ks, p)   ? n_qt
                   : causal_of<MHA>(ks, p) ? max(qt0, min(n_qt, kr / BQ))
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
      if constexpr (MHA) {
        if (ks.zero) {
#pragma unroll
          for (int j = 0; j < BQ / 2; ++j) st[j] = 0.f;
        }
      }
      // P^T = 2^(s sl2 - lse2), 0 where masked: the masks only on tiles
      // that cross the diagonal, the key limit or Sq
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + 2 * t + (e & 1);
          st[4 * j + e] = hopper::ex2(fmaf(st[4 * j + e], sl2, -lse_s[s][qc]));
        }
      if (qt * BQ + BQ > p.Sq || kr + 64 > lim_of<MHA>(ks, p) ||
          (causal_of<MHA>(ks, p) && qt * BQ < kr + 63)) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qt * BQ + j * 8 + 2 * t + (e & 1);
            const int key = r0 + (e >> 1) * 8;
            const bool out = qi >= p.Sq || key >= lim_of<MHA>(ks, p) ||
                             (causal_of<MHA>(ks, p) && qi < key);
            st[4 * j + e] = out ? 0.f : st[4 * j + e];
          }
      }
      // the keep bits of (query qc, key): the query's hash from shared
      // memory, the key along the rows
      uint32_t kb[(BQ / 2 + 31) / 32];
      if constexpr (MHA) {
        if (p.drop) {
#pragma unroll
          for (int w = 0; w < (BQ / 2 + 31) / 32; ++w) kb[w] = 0u;
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i2 = 4 * j + e, qc = j * 8 + 2 * t + (e & 1);
              const uint32_t key = static_cast<uint32_t>(r0 + (e >> 1) * 8);
              kb[i2 / 32] |= static_cast<uint32_t>(fmix32(rh_s[s][qc] + key) >=
                                                   p.thresh)
                             << (i2 % 32);
            }
        }
      }
      wg_wait0();  // dP^T
      fence_regs(dpt);
      if constexpr (MHA) {
        if (p.drop) {
#pragma unroll
          for (int i2 = 0; i2 < BQ / 2; ++i2)
            dpt[i2] = kept(kb, i2, dpt[i2]);
        }
      }
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + 2 * t + (e & 1);
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dl_s[s][qc]);
        }
      if constexpr (MHA) {
        if (p.drop) {
#pragma unroll
          for (int i2 = 0; i2 < BQ / 2; ++i2)
            st[i2] = kept(kb, i2, st[i2]);
        }
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

    // dropout's 1 / (1 - p), left out of P^T, dP^T and r, is applied here
    const float kscale = MHA && p.drop ? p.scale * p.inv : p.scale;
    const float vscale = MHA && p.drop ? p.inv : 1.f;
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
              __floats2bfloat162_rn(dk[4 * n + 2 * r] * kscale,
                                    dk[4 * n + 2 * r + 1] * kscale);
          *reinterpret_cast<__nv_bfloat162*>(dvb + off + col) =
              __floats2bfloat162_rn(dv[4 * n + 2 * r] * vscale,
                                    dv[4 * n + 2 * r + 1] * vscale);
        }
      }
    }
  }
}

// ------------------------------------------------------------- launchers
enum Kind { kFwd = 0, kDq = 1, kDkv = 2, kR = 3 };  // kR: MHA's r pass

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
// per CTA DC; BM = 64 NCW rows of the CTA's own sequence throughout.
// Shared memory: a 1 KB alignment margin plus the tiles (at most 161 KB for
// DM <= 128, 225 KB at 256; at most 73 KB with one consumer). MHA's dK/dV at bucket 128 splits its columns over two
// CTAs (each recomputing S^T and dP^T), as bucket 256 does: the keep bits
// leave no room beside 128 dK and dV columns in a consumer's 240 registers
// (60 bytes spilled); no main path runs #9 at that bucket.
template <int DM, bool MHA>
cudaError_t launch_bf16(int kind, const Params& p, cudaStream_t st) {
  constexpr int FBN = DM > 128 ? 64 : 128;
  constexpr int QBN = DM > 128 ? 32 : 64;
  constexpr int BQ = DM > 128 ? 32 : 64;
  constexpr int DC = DM > 128 ? 128 : (MHA && DM == 128) ? 64 : DM;
  constexpr size_t A = DM / 64 * 128;  // bytes per tile row, all atoms
  using hopper::tensor_map;
  // consumer warpgroups of 64 rows a CTA: MHA at bucket 64 runs one, two
  // CTAs an SM (its rows are short: a CTA sees a few tiles, and a second
  // CTA hides one's prologue and epilogue), #6/#7 two
  constexpr int NCW = MHA && DM == 64 ? 1 : 2, BM = 64 * NCW;
  const int qrows = kind == kDkv ? BQ : BM;
  const int krows = kind == kFwd ? FBN : kind == kDkv ? BM : QBN;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, p.q, p.B, p.Sq, p.H, p.D, p.q_sb, p.q_ss, p.q_sh,
                  qrows) ||
      !tensor_map(&tk, p.k, p.B, p.Sk, p.H, p.D, p.k_sb, p.k_ss, p.k_sh,
                  krows) ||
      !tensor_map(&tv, p.v, p.B, p.Sk, p.H, p.D, p.v_sb, p.v_ss, p.v_sh,
                  krows))
    return cudaErrorInvalidValue;
  const dim3 qgrid((p.Sq + BM - 1) / BM, p.H, p.B);
  constexpr int T = 128 * (NCW + 1);
  if (kind == kFwd)
    return launch(fwd_wg<DM, FBN, MHA, NCW>, qgrid, T,
                  1024 + A * (BM + 2 * kStages * FBN), st, tq, tk, tv, p);
  // dout: contiguous [B, Sq, H, D]
  const long long o_ss = (long long)p.H * p.D;
  if (!tensor_map(&tdo, p.dout, p.B, p.Sq, p.H, p.D, p.Sq * o_ss, o_ss, p.D,
                  qrows))
    return cudaErrorInvalidValue;
  constexpr size_t QSMEM = 1024 + A * (2 * BM + 2 * kBwdStages * QBN);
  if (kind == kDq)
    return launch(dq_wg<DM, QBN, kBwdStages, MHA, false, NCW>, qgrid, T,
                  QSMEM, st, tq, tk, tv, tdo, p);
  if constexpr (MHA) {
    if (kind == kR)
      return launch(dq_wg<DM, QBN, kBwdStages, true, true, NCW>, qgrid, T,
                    QSMEM, st, tq, tk, tv, tdo, p);
  }
  return launch(dkv_wg<DM, DC, BQ, kBwdStages, MHA, NCW>,
                dim3((p.Sk + BM - 1) / BM * (DM / DC), p.H, p.B), T,
                1024 + A * (2 * BM + 2 * kBwdStages * BQ), st, tq, tk, tv,
                tdo, p);
}

// by head-dim bucket: 64, 128 (gpt3-2.7b's and vit-h14's 80 run here, their
// columns 80..127 TMA zero fill) or 256
template <bool MHA>
cudaError_t run_bf16(int kind, const Params& p, cudaStream_t st) {
  if (p.D <= 64) return launch_bf16<64, MHA>(kind, p, st);
  if (p.D <= 128) return launch_bf16<128, MHA>(kind, p, st);
  return launch_bf16<256, MHA>(kind, p, st);
}

}  // namespace wg
}  // namespace
