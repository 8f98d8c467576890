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
//   Two deterministic passes, no atomics.
//
// Bound: at training shapes (S = 1024..2048, D = 64..128) tensor-core
// operations (4 B H S^2 D forward, halved under causal). Design against
// that:
//   * bf16: mma.sync m16n8k16 bf16 x bf16 -> f32 on the tensor cores; each
//     warp owns 16 rows of the CTA's block, so the row statistics of the
//     online softmax reduce inside a quad of lanes; P and dS go from the
//     accumulator layout to the next product's A operand in registers;
//   * the tiles of the other sequence are double-buffered in shared memory
//     with cp.async, the next tile in flight while the current one is used;
//     out-of-range rows and columns are zero-filled as they are staged;
//   * under causal, tiles wholly above the diagonal are skipped, and so are
//     tiles wholly past kv_len (they contribute exactly zero);
//   * f32: plain FMAs on the CUDA cores (never TF32), one warp per row and
//     one lane per column of a 32-wide tile of the other sequence; this path
//     serves parity runs, not speed.
// Head dims: any multiple of 16 up to 256 (the wrapper pads others); the
// kernels are built for D buckets of 64, 128 and 256, and columns past D
// are zero-filled when staged and never stored.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_tiles.cuh"

namespace {

using namespace tiles;
constexpr float kNeg = -1e30f;

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

// ------------------------------------------------------------ bf16 forward
// grid (ceil(Sq / 64), H, B); 4 warps x 16 query rows; key tiles of BK
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
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  int n_kb = (p.kv_lim + BK - 1) / BK;
  if (p.causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);

  stage<BQ, DM>(Qs, LD, qb, p.q_ss, q0, p.Sq, p.D, tid);
  stage<BK, DM>(Ks, LD, kb, p.k_ss, 0, p.Sk, p.D, tid);
  stage<BK, DM>(Vs, LD, vb, p.v_ss, 0, p.Sk, p.D, tid);
  cp_async_commit();

  float o[DM / 8][4];
#pragma unroll
  for (int n = 0; n < DM / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int r0 = warp * 16 + g;  // this lane's rows r0 and r0 + 8

  for (int it = 0; it < n_kb; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_kb) {
      const int nb = buf ^ 1;
      stage<BK, DM>(Ks + nb * BK * LD, LD, kb, p.k_ss, (it + 1) * BK, p.Sk,
                    p.D, tid);
      stage<BK, DM>(Vs + nb * BK * LD, LD, vb, p.v_ss, (it + 1) * BK, p.Sk,
                    p.D, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
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
        float x = s[j][e] * p.scale;
        if (col >= p.kv_lim || (p.causal && row < col)) x = kNeg;
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
        s[j][e] = x;
        sum[e >> 1] += x;
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

  bf16* ob = static_cast<bf16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= p.Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f), inv = 1.f / lc;
    bf16* orow = ob + (((long long)b * p.Sq + row) * p.H + h) * p.D;
#pragma unroll
    for (int n = 0; n < DM / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
    if (t == 0) p.lse[((long long)b * p.H + h) * p.Sq + row] = m[r] + logf(lc);
  }
}

// --------------------------------------------------------------- bf16 dQ
// grid (ceil(Sq / 64), H, B); 4 warps x 16 query rows; key tiles of BK
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
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const long long o_ss = (long long)p.H * p.D;
  const bf16* dob = static_cast<const bf16*>(p.dout) +
                    (long long)b * p.Sq * o_ss + (long long)h * p.D;

  int n_kb = (p.kv_lim + BK - 1) / BK;
  if (p.causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);

  stage<BQ, DM>(Qs, LD, qb, p.q_ss, q0, p.Sq, p.D, tid);
  stage<BQ, DM>(Os, LD, dob, o_ss, q0, p.Sq, p.D, tid);
  stage<BK, DM>(Ks, LD, kb, p.k_ss, 0, p.Sk, p.D, tid);
  stage<BK, DM>(Vs, LD, vb, p.v_ss, 0, p.Sk, p.D, tid);
  cp_async_commit();

  const int r0 = warp * 16 + g;
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    const long long i = ((long long)b * p.H + h) * p.Sq + row;
    lse[r] = row < p.Sq ? p.lse[i] : 0.f;
    dl[r] = row < p.Sq ? p.delta[i] : 0.f;
  }
  float dq[DM / 8][4];
#pragma unroll
  for (int n = 0; n < DM / 8; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int it = 0; it < n_kb; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_kb) {
      const int nb = buf ^ 1;
      stage<BK, DM>(Ks + nb * BK * LD, LD, kb, p.k_ss, (it + 1) * BK, p.Sk,
                    p.D, tid);
      stage<BK, DM>(Vs + nb * BK * LD, LD, vb, p.v_ss, (it + 1) * BK, p.Sk,
                    p.D, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
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
        const int row = q0 + r0 + (e >> 1) * 8;
        const int col = it * BK + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * p.scale;
        if (col >= p.kv_lim || (p.causal && row < col)) x = kNeg;
        const float pr = __expf(x - lse[e >> 1]);
        s[j][e] = pr * (dp[j][e] - dl[e >> 1]);  // dS, rounded below
      }
    mm_pb<BK / 16, DM>(dq, s, K, LD, g, t);
    __syncthreads();
  }

  bf16* dqb = static_cast<bf16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= p.Sq) continue;
    bf16* drow = dqb + b * p.o_sb + row * p.o_ss + h * p.o_sh;
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
// grid (ceil(Sk / 64), H, B); 4 warps x 16 key rows; query tiles of BQ.
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
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const long long o_ss = (long long)p.H * p.D;
  const bf16* dob = static_cast<const bf16*>(p.dout) +
                    (long long)b * p.Sq * o_ss + (long long)h * p.D;
  const float* lseb = p.lse + ((long long)b * p.H + h) * p.Sq;
  const float* dlb = p.delta + ((long long)b * p.H + h) * p.Sq;

  // query tiles that see this key block: under causal (q >= k, top-left)
  // from the tile holding q = k0; none when the block is past kv_len
  const int qt0 = p.causal ? k0 / BQ : 0;
  const int n_qt = k0 < p.kv_lim ? (p.Sq + BQ - 1) / BQ : 0;

  stage<BKR, DM>(Ks, LD, kb, p.k_ss, k0, p.Sk, p.D, tid);
  stage<BKR, DM>(Vs, LD, vb, p.v_ss, k0, p.Sk, p.D, tid);
  if (qt0 < n_qt) {
    stage<BQ, DM>(Qs + (qt0 & 1) * BQ * LD, LD, qb, p.q_ss, qt0 * BQ, p.Sq,
                  p.D, tid);
    stage<BQ, DM>(Os + (qt0 & 1) * BQ * LD, LD, dob, o_ss, qt0 * BQ, p.Sq,
                  p.D, tid);
  }
  cp_async_commit();

  const int r0 = warp * 16 + g;
  float dk[DM / 8][4], dv[DM / 8][4];
#pragma unroll
  for (int n = 0; n < DM / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int buf = qt & 1;
    if (qt + 1 < n_qt) {
      const int nb = buf ^ 1;
      stage<BQ, DM>(Qs + nb * BQ * LD, LD, qb, p.q_ss, (qt + 1) * BQ, p.Sq,
                    p.D, tid);
      stage<BQ, DM>(Os + nb * BQ * LD, LD, dob, o_ss, (qt + 1) * BQ, p.Sq,
                    p.D, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
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
        const bool qok = qi < p.Sq;
        const float lq = qok ? lseb[qi] : 0.f, dq = qok ? dlb[qi] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = k0 + r0 + r * 8;
          float x = s[j][2 * r + e] * p.scale;
          if (!qok || key >= p.kv_lim || (p.causal && qi < key)) x = kNeg;
          const float pr = __expf(x - lq);
          s[j][2 * r + e] = pr;                                // P^T
          dp[j][2 * r + e] = pr * (dp[j][2 * r + e] - dq);     // dS^T
        }
      }
    mm_pb<BQ / 16, DM>(dv, s, O, LD, g, t);   // dV += P^T dout
    mm_pb<BQ / 16, DM>(dk, dp, Q, LD, g, t);  // dK += dS^T q
    __syncthreads();
  }
  cp_async_wait<0>();  // a block no query sees still staged K and V

  bf16* dkb = static_cast<bf16*>(p.out);
  bf16* dvb = static_cast<bf16*>(p.out2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + r * 8;
    if (key >= p.Sk) continue;
    const long long off = b * p.o_sb + key * p.o_ss + h * p.o_sh;
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
  if (kind == kFwd)
    return launch(fwd_bf16<DM, FBK>, dim3((p.Sq + 63) / 64, p.H, p.B),
                  (64 + 4 * FBK) * LD * E, p, st);
  if (kind == kDq)
    return launch(dq_bf16<DM, 32>, dim3((p.Sq + 63) / 64, p.H, p.B),
                  (2 * 64 + 4 * 32) * LD * E, p, st);
  return launch(dkv_bf16<DM, 32>, dim3((p.Sk + 63) / 64, p.H, p.B),
                (2 * 64 + 4 * 32) * LD * E, p, st);
}

template <int DM>
cudaError_t launch_f32(int kind, const Params& p, cudaStream_t st) {
  constexpr int LD = DM + 1;
  constexpr size_t F = sizeof(float);
  if (kind == kFwd)
    return launch(fwd_f32<DM>, dim3((p.Sq + FROWS - 1) / FROWS, p.H, p.B),
                  (FROWS * DM + FT * LD + FT * DM) * F, p, st);
  if (kind == kDq)
    return launch(dq_f32<DM>, dim3((p.Sq + FROWS - 1) / FROWS, p.H, p.B),
                  (2 * FROWS * DM + 2 * FT * LD) * F, p, st);
  return launch(dkv_f32<DM>, dim3((p.Sk + FROWS - 1) / FROWS, p.H, p.B),
                (2 * FROWS * DM + 2 * FT * LD) * F, p, st);
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
