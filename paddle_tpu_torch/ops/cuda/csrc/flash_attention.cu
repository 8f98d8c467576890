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
// that, bf16 (kernels fwd_wg, dq_wg, dkv_wg, in flash_wg.cuh, which #9's
// fused_mha.cu instantiates with its own features):
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
#include "flash_wg.cuh"  // the bf16 kernels fwd_wg, dq_wg, dkv_wg

namespace {

using namespace tiles;
using wg::kNeg;
using wg::Params;

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
using wg::kDkv;
using wg::kDq;
using wg::kFwd;
using wg::launch;

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
  if (dtype == 1) return wg::run_bf16<false>(kind, p, st);
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
