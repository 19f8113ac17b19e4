// Backward of the RWKV6 WKV recurrence.  The forward (wkv.cu):
//
//   out_t[j] = sum_i r_t[i] * (S_t[i][j] + u[i] * k_t[i] * v_t[j])
//   S_{t+1}[i][j] = w_t[i] * S_t[i][j] + k_t[i] * v_t[j]
//
// Given dout (B, S, H, hd) and dstateT (B, H, hd, hd) or null for zeros, all
// float32, with dS_{t+1} the gradient of the state after step t (dS_S =
// dstateT), it gives, in float32:
//
//   dr_t[i] = sum_j dout_t[j] * (S_t[i][j] + u[i] * k_t[i] * v_t[j])
//   dk_t[i] = r_t[i] * u[i] * (dout_t . v_t) + sum_j dS_{t+1}[i][j] * v_t[j]
//   dv_t[j] = (sum_i r_t[i] u[i] k_t[i]) * dout_t[j] + sum_i dS_{t+1}[i][j] * k_t[i]
//   dw_t[i] = sum_j dS_{t+1}[i][j] * S_t[i][j]
//   du[i]   = sum over b and t of r_t[i] * k_t[i] * (dout_t . v_t)
//   dS_t    = w_t (.)rows dS_{t+1} + r_t dout_t^T,    dstate0 = dS_0
//
// The reference has no WKV backward kernel: it differentiates the
// jax.checkpoint-ed two-level lax.scan of rwkv_time_mix
// (src/repro/models/ssm.py:303) with JAX's autodiff; the TPU kernel
// src/repro/kernels/wkv/wkv.py:53 (ported in wkv.cu) is forward only.
// r, k, v are float32 or bfloat16 (exact in TF32, so they need no lo part).
//
// What bounds it on an H100: at the rates this kernel runs on (below), the
// bytes (r, k, v, w, dout read, four gradients written), not the
// arithmetic.  Stepped one step at a time it is a chain of dependent steps
// over few states (B * H = 128 at rwkv6's batch 4), bound by latency; dw needs S_t beside dS_{t+1} at every step, and
// dividing by w is ruled out (fast decays underflow w's products to 0, see
// wkv.cu).  So the chunk form of gated linear attention, in sub-blocks of
// kT = 16 steps [b, e) with start state S_b and state gradient dS_e at the
// end: A_t = prod_{b<=m<t} w_m, Z_t = prod_{t<m<e} w_m, D = A_e, P(s, t) =
// prod_{s<m<t} w_m, all running products formed by multiplying, never by
// dividing; X = S_b dout^T, Y = dS_e V^T, M = V dout^T (M[s, t] = v_s .
// dout_t), each row i of the state on its own:
//
//   dr_t = A_t X_t + sum_{s<t} P(s,t) k_s M[s,t] + u k_t M[t,t]
//   dk_t = Z_t Y_t + sum_{s>t} P(t,s) r_s M[t,s] + u r_t M[t,t]
//   dw_t = A_t Z_t rowsum(S_b * dS_e) + A_t sum_{s>t} P(t,s) r_s X_s
//          + Z_t sum_{s<t} P(s,t) k_s Y_s + sum_{s<t<s'} P(s,t) P(t,s') k_s r_s' M[s,s']
//   dv_t = dS_e^T (Z_t k_t) + sum_{s>=t} C[t,s] dout_s,  C[t,s] = sum_i k_t P(t,s) r_s
//          (s > t), C[t,t] = sum_i r_t u k_t
//   dS_b = D dS_e + (A R)^T dout,   S_e = D S_b + (Z K)^T V
//
// (kernels/wkv/ref.py::wkv_bwd_chunked_ref writes it out).  The products
// over a head dim or a sub-block (X, Y, M, (Z K)^T dS_e, (A R)^T dout,
// (Z K)^T V) run on the tensor cores, mma.sync m16n8k8 TF32 with float32
// sums, as 3xTF32: every float32 operand split into hi = rna(x) and lo =
// rna(x - hi), summed lo hi + hi lo + hi hi, which keeps float32's accuracy
// (one pass of TF32 would not: ~5e-4 of max|g|).  The pair terms (T x T per
// row) run on the CUDA cores.
//
// Design: the sequence is cut into the forward's chunks of C steps (a
// multiple of kT, at most kMaxChunk), whose start states the forward's
// chunked route keeps (the caller passes them, or state0 as the one chunk
// of a short sequence).  A block of NW = hd / 16 warps takes a chunk of one
// (b, h); warp wp owns the state rows 16 wp .. 16 wp + 15, held as mma
// accumulator fragments (thread (g, q) of a warp: rows g and g + 8, columns
// 8 n + 2 q and + 1 of every n-tile), so X, Y, the dS update and the state
// advance are row-local and dr, dk, dw are written once each.  Each
// sub-block's r, k, v, w, dout are staged into shared memory by cp.async,
// one sub-block ahead (two buffers; past S, r = k = v = dout = 0 and w = 1,
// which change neither the state nor its gradient).  An operand whose
// fragment holds a row's columns in the accumulator's order reaches the
// mma with its k index permuted (k = q <-> column 2 q, q + 4 <-> 2 q + 1),
// and so does the other operand, read from shared memory.  Four kernels:
//   1. wkv_bwd_chunk_tc: the chunk's share of the state gradient at its
//      start, G_c = the dS_b rule from dS = 0 over its sub-blocks (last
//      first), and its decay D_c = prod of the sub-blocks' D;
//   2. wkv_bwd_scan: per (b, h) and slice of the state, dS at the chunk's
//      start = D_c * dS at its end + G_c, from dstateT back to dstate0,
//      overwriting G_c with the gradient at the chunk's end;
//   3. wkv_bwd_grad_tc: the chunk's sub-block start states, stepped forward
//      from its start state (S_e rule) into a global scratch (each thread
//      its own fragments) that the same block reads back (8 states of 16 KB
//      at hd 64 in shared memory would leave room for one block an SM;
//      whether the scratch stays in L2 is not measured); then the sub-blocks last first, carrying dS:
//      per sub-block M by warps 0 and 1, X and Y
//      by each warp, the pair terms by lane (row rho, half hf): half 0
//      walks the steps forward and writes dr, half 1 walks them backward
//      (the mirror image of the same terms: k <-> r, X <-> Y, M <-> M^T, A
//      <-> Z) and writes dk, each running L_{t+1} = w_t L_t + k_t M[t, :]
//      (and its mirror); the last term of dw and C's rows are split between
//      the halves (half 0 the steps t < 8, half 1 t >= 8), C reduced over a
//      warp's rows by a shuffle reduce-scatter, then dv summed over the
//      warps in order through shared memory; du's share of the chunk goes
//      to a workspace;
//   4. wkv_bwd_du: du summed over batch rows, then chunks, in order.
// No atomics: every sum has one fixed order, so two launches give the same
// bits.  As written the time goes to latency more than to either bound: 12
// warps an SM at hd 64 (168 registers a thread, 73 KB of shared memory a
// block), three block barriers a sub-block, and the pair terms' serial walk
// over the sub-block's 16 steps (PERF.md section 6 has the times).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 16;                   // steps per sub-block (the mma's m)
constexpr int kMaxChunk = 128;           // longest chunk (kernels/wkv/wkv.py CHUNK)
constexpr int kSubs = kMaxChunk / kT;    // sub-blocks of the longest chunk
constexpr int kHalf = kT / 2;
constexpr int kScanThreads = 256;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes, of which the first `bytes` are copied and the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// x rounded to TF32, to nearest, ties away from zero.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}
// d += a b: A 16 x 8 (row g: a0, a2 at columns q, q + 4; row g + 8: a1,
// a3), B 8 x 8 (b0, b1 at rows q, q + 4 of column g), D 16 x 8 (rows g,
// g + 8, columns 2 q, 2 q + 1), g = lane / 4, q = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand fragment as TF32 hi and lo parts; LO false for values exact in
// TF32 (bfloat16 r, k, v), whose lo part is 0.
template <int N>
struct Frag {
  unsigned h[N], l[N];
};
template <bool LO, int N>
__device__ __forceinline__ void split(Frag<N>& f, int e, float x) {
  if (LO) {
    f.h[e] = tf32_rna(x);
    f.l[e] = tf32_rna(x - __uint_as_float(f.h[e]));
  } else {
    f.h[e] = __float_as_uint(x);
  }
}
// d += a b as 3xTF32 (the small terms first).
template <bool ALO, bool BLO>
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  if (ALO) mma_tf32(d, a.l, b.h);
  if (BLO) mma_tf32(d, a.h, b.l);
  mma_tf32(d, a.h, b.h);
}

template <typename T>
struct ExactTf32 {
  static constexpr bool value = false;
};
template <>
struct ExactTf32<__nv_bfloat16> {
  static constexpr bool value = true;
};

__device__ __forceinline__ float elem(const float* p) { return *p; }
__device__ __forceinline__ float elem(const __nv_bfloat16* p) { return __bfloat162float(*p); }
// Two consecutive elements (8-byte aligned for float, 4 for bfloat16).
__device__ __forceinline__ float2 elem2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 elem2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The block's shared memory, in floats: two stage buffers (each r, k, v in
// TI then w, dout in float, rows of RS elements), A r and Z k of the
// sub-block ([t][i]), its decay D and rowsum(S_b * dS_e) ([i]), each warp's
// X and Y tiles ([row][t]), M and M^T, each warp's share of C ([t][s]), and
// each warp's copy of dS_e ([row][j]), reused for its share of dv ([t][j]).
// Row strides padded so that the mma operand reads are free of bank
// conflicts.
template <int HD, typename TI>
struct Bwd {
  static constexpr int NW = HD / 16;        // warps: 16 state rows each
  static constexpr int NT = 32 * NW;
  static constexpr int NT8 = HD / 8;        // n-tiles of a state row
  static constexpr int RS = HD + 8;         // staged rows
  static constexpr int RA = HD + 8;         // A r, Z k rows
  static constexpr int RX = kT + 1;         // X, Y, M rows
  static constexpr int RD = HD + 4;         // dS_e copy, dv share rows
  static constexpr int kTiArr = kT * RS * static_cast<int>(sizeof(TI));   // bytes
  static constexpr int kF32Arr = kT * RS * 4;                             // bytes
  static constexpr int kStage = (3 * kTiArr + 2 * kF32Arr) / 4;           // floats
  static constexpr int oAR = 2 * kStage, oZK = oAR + kT * RA, oD = oZK + kT * RA,
                       oDiag = oD + HD, oX = oDiag + HD, oY = oX + NW * 16 * RX,
                       oM = oY + NW * 16 * RX, oMT = oM + kT * RX, oC = oMT + kT * RX,
                       oDS = oC + NW * kT * kT, kEnd = oDS + NW * 16 * RD;
  static constexpr int SMEM_CHUNK = oX * 4;   // kernel 1: stages, A r, Z k, D
  static constexpr int SMEM = kEnd * 4;
  static constexpr int MINB = HD <= 64 ? 3 : 1;
  static_assert(HD % 16 == 0 && (3 * kTiArr + 2 * kF32Arr) % 16 == 0, "wkv_bwd shape");
};

// Rows [0, kT) of a staged array: row t < valid from src + row0 + t * rstride
// by cp.async, the rest filled with `fill`.
template <int NT, int HD, int RS, typename T>
__device__ __forceinline__ void stage_rows(char* dst, const T* src, long long row0,
                                           long long rstride, int valid, float fill) {
  constexpr int CPR = HD * static_cast<int>(sizeof(T)) / 16;   // 16-byte pieces a row
  for (int e = threadIdx.x; e < kT * CPR; e += NT) {
    const int t = e / CPR, c = e - t * CPR;
    float* d = reinterpret_cast<float*>(dst + t * RS * static_cast<int>(sizeof(T)) + c * 16);
    if (t < valid)
      cp_async16(d, reinterpret_cast<const float*>(src + row0 + t * rstride) + 4 * c, 16);
    else
      *reinterpret_cast<float4*>(d) = make_float4(fill, fill, fill, fill);
  }
}

enum { kR = 1, kK = 2, kV = 4, kW = 8, kDO = 16, kAll = 31 };

// Stage the arrays of `mask` for one sub-block into buffer `buf` and commit
// the group.
template <int HD, typename TI>
__device__ __forceinline__ void stage(char* buf, const TI* r, const TI* k, const TI* v,
                                      const float* w, const float* dout, long long row0,
                                      long long rstride, int valid, int mask) {
  using Cfg = Bwd<HD, TI>;
  constexpr int NT = Cfg::NT, RS = Cfg::RS;
  if (mask & kR) stage_rows<NT, HD, RS>(buf, r, row0, rstride, valid, 0.f);
  if (mask & kK) stage_rows<NT, HD, RS>(buf + Cfg::kTiArr, k, row0, rstride, valid, 0.f);
  if (mask & kV) stage_rows<NT, HD, RS>(buf + 2 * Cfg::kTiArr, v, row0, rstride, valid, 0.f);
  if (mask & kW) stage_rows<NT, HD, RS>(buf + 3 * Cfg::kTiArr, w, row0, rstride, valid, 1.f);
  if (mask & kDO)
    stage_rows<NT, HD, RS>(buf + 3 * Cfg::kTiArr + Cfg::kF32Arr, dout, row0, rstride, valid,
                           0.f);
  cp_async_commit();
}

template <int HD, typename TI>
struct Staged {
  const TI *r, *k, *v;
  const float *w, *dout;
  __device__ explicit Staged(const char* buf)
      : r(reinterpret_cast<const TI*>(buf)),
        k(reinterpret_cast<const TI*>(buf + Bwd<HD, TI>::kTiArr)),
        v(reinterpret_cast<const TI*>(buf + 2 * Bwd<HD, TI>::kTiArr)),
        w(reinterpret_cast<const float*>(buf + 3 * Bwd<HD, TI>::kTiArr)),
        dout(reinterpret_cast<const float*>(buf + 3 * Bwd<HD, TI>::kTiArr +
                                            Bwd<HD, TI>::kF32Arr)) {}
};

// The sub-block's running products for row i, by lane half hf walking its
// frame (step t = f, or kT - 1 - f for hf = 1): half 0 writes A_t r_t (if
// `ar`) and D, half 1 Z_t k_t (if `zk`).
template <int HD, typename TI>
__device__ __forceinline__ void decays(const Staged<HD, TI>& st, float* smem, int i, int hf,
                                       bool ar, bool zk) {
  using Cfg = Bwd<HD, TI>;
  const TI* rf = hf ? st.k : st.r;
  float* dst = smem + (hf ? Cfg::oZK : Cfg::oAR);
  const int t0 = hf ? kT - 1 : 0, dt = hf ? -1 : 1;
  float a = 1.f;
#pragma unroll
  for (int f = 0; f < kT; ++f) {
    const int t = t0 + dt * f;
    if (hf ? zk : ar) dst[t * Cfg::RA + i] = a * elem(rf + t * Cfg::RS + i);
    a *= st.w[t * Cfg::RS + i];
  }
  if (hf == 0) smem[Cfg::oD + i] = a;
}

// acc (the warp's 16 rows i0.. of a state, fragments) = D (.)rows acc +
// (src)^T b over the sub-block's steps: D [i] and src [t][i] (A r or Z k) in
// shared memory, b [t][j] a staged array.
template <int HD, bool BLO, typename TB>
__device__ __forceinline__ void rows_update(float (&acc)[HD / 8][4], const float* D,
                                            const float* src, const TB* b, int i0, int lane) {
  constexpr int RA = HD + 8, RS = HD + 8;
  const int g = lane >> 2, q = lane & 3;
  const float d0 = D[i0 + g], d1 = D[i0 + g + 8];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    acc[n][0] *= d0;
    acc[n][1] *= d0;
    acc[n][2] *= d1;
    acc[n][3] *= d1;
  }
#pragma unroll
  for (int kt = 0; kt < kT / 8; ++kt) {
    Frag<4> a;
    const float* s = src + (8 * kt + q) * RA + i0 + g;
    split<true>(a, 0, s[0]);
    split<true>(a, 1, s[8]);
    split<true>(a, 2, s[4 * RA]);
    split<true>(a, 3, s[4 * RA + 8]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      Frag<2> fb;
      const TB* p = b + (8 * kt + q) * RS + 8 * n + g;
      split<BLO>(fb, 0, elem(p));
      split<BLO>(fb, 1, elem(p + 4 * RS));
      mma3<true, BLO>(acc[n], a, fb);
    }
  }
}

// out (16 x kT: the warp's rows x the sub-block's steps) = acc-held rows
// times b^T, b [t][j] staged: the row fragment's columns give the k index,
// permuted alike in both operands.
template <int HD, bool BLO, typename TB>
__device__ __forceinline__ void rows_times(float (&out)[2][4], const float (&rows)[HD / 8][4],
                                           const TB* b, int lane) {
  constexpr int RS = HD + 8;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < HD / 8; ++kt) {
    Frag<4> a;
    split<true>(a, 0, rows[kt][0]);
    split<true>(a, 1, rows[kt][2]);
    split<true>(a, 2, rows[kt][1]);
    split<true>(a, 3, rows[kt][3]);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      Frag<2> fb;
      const float2 x = elem2(b + (8 * n + g) * RS + 8 * kt + 2 * q);
      split<BLO>(fb, 0, x.x);
      split<BLO>(fb, 1, x.y);
      mma3<true, BLO>(out[n], a, fb);
    }
  }
}

// The warp's 16 state rows i0.. (fragments) from / to a row-major array
// of row stride ld.
template <int HD>
__device__ __forceinline__ void load_rows(float (&acc)[HD / 8][4], const float* src, int ld,
                                          int i0, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const float2 x = *reinterpret_cast<const float2*>(src + (i0 + g) * ld + 8 * n + 2 * q);
    const float2 y = *reinterpret_cast<const float2*>(src + (i0 + g + 8) * ld + 8 * n + 2 * q);
    acc[n][0] = x.x;
    acc[n][1] = x.y;
    acc[n][2] = y.x;
    acc[n][3] = y.y;
  }
}
template <int HD>
__device__ __forceinline__ void store_rows(float* dst, int ld, const float (&acc)[HD / 8][4],
                                           int i0, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<float2*>(dst + (i0 + g) * ld + 8 * n + 2 * q) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(dst + (i0 + g + 8) * ld + 8 * n + 2 * q) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

__device__ __forceinline__ long long step_base(int b, int t, int h, int S, int H, int HD) {
  return ((static_cast<long long>(b) * S + t) * H + h) * HD;
}

// Kernel 1.  Grid (chunks, H, B), 2 HD threads (warp wp: rows 16 wp..).
// wsd (B, H, chunks, HD, HD) row-major, wd (B, H, chunks, HD).
template <int HD, typename TI>
__global__ void __launch_bounds__(Bwd<HD, TI>::NT)
wkv_bwd_chunk_tc(const TI* __restrict__ r, const float* __restrict__ w,
                 const float* __restrict__ dout, float* __restrict__ wsd,
                 float* __restrict__ wd, int S, int H, int C) {
  using Cfg = Bwd<HD, TI>;
  extern __shared__ __align__(16) float smem[];
  char* bufs = reinterpret_cast<char*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5, i0 = 16 * wp;
  const int rho = lane & 15, hf = lane >> 4, i = i0 + rho;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nchunks = gridDim.x;
  const int t0c = c * C, len = min(C, S - t0c), nsub = (len + kT - 1) / kT;
  const long long bh = static_cast<long long>(b) * H + h, rstride = static_cast<long long>(H) * HD;
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float decay = 1.f;
  int cur = 0;
  stage<HD, TI>(bufs, r, r, r, w, dout, step_base(b, t0c + (nsub - 1) * kT, h, S, H, HD),
                rstride, len - (nsub - 1) * kT, kR | kW | kDO);
  for (int sb = nsub - 1; sb >= 0; --sb) {
    cp_async_wait<0>();
    __syncthreads();
    if (sb > 0)
      stage<HD, TI>(bufs + (cur ^ 1) * Cfg::kStage * 4, r, r, r, w, dout,
                    step_base(b, t0c + (sb - 1) * kT, h, S, H, HD), rstride, kT,
                    kR | kW | kDO);
    const Staged<HD, TI> st(bufs + cur * Cfg::kStage * 4);
    decays<HD, TI>(st, smem, i, hf, true, false);
    __syncwarp();
    if (hf == 0) decay *= smem[Cfg::oD + i];
    rows_update<HD, true>(acc, smem + Cfg::oD, smem + Cfg::oAR, st.dout, i0, lane);
    cur ^= 1;
  }
  store_rows<HD>(wsd + (bh * nchunks + c) * HD * HD, HD, acc, i0, lane);
  if (hf == 0) wd[(bh * nchunks + c) * HD + i] = decay;
}

// Kernel 2.  Grid (slices, H, B): each thread carries 4 entries of row i of
// the state gradient back through the chunks: wsd[c] <- dS at the end of
// chunk c (overwriting G_c), then dS at its start = D_c[i] * that + G_c; the
// last is dstate0.
template <int HD>
__global__ void __launch_bounds__(kScanThreads)
wkv_bwd_scan(float* __restrict__ wsd, const float* __restrict__ wd,
             const float* __restrict__ dstateT, float* __restrict__ dstate0,
             int H, int nchunks) {
  const int e = 4 * (blockIdx.x * kScanThreads + threadIdx.x);
  if (e >= HD * HD) return;
  const int i = e / HD;
  const long long bh = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (dstateT != nullptr)
    g = *reinterpret_cast<const float4*>(dstateT + bh * HD * HD + e);
  for (int c = nchunks - 1; c >= 0; --c) {
    const long long cc = bh * nchunks + c;
    float4* p = reinterpret_cast<float4*>(wsd + cc * HD * HD + e);
    const float4 G = *p;
    const float d = wd[cc * HD + i];
    *p = g;
    g.x = fmaf(d, g.x, G.x);
    g.y = fmaf(d, g.y, G.y);
    g.z = fmaf(d, g.z, G.z);
    g.w = fmaf(d, g.w, G.w);
  }
  *reinterpret_cast<float4*>(dstate0 + bh * HD * HD + e) = g;
}

// Sum v[c] over the 16 lanes of a half warp (lane bits 0-3), scattered:
// lane rho ends with the total of c = rho in v[0].  Each partial sum has one
// lane that forms it, so the order is fixed.
__device__ __forceinline__ void reduce_scatter16(float (&v)[kT], int rho) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) {
    const bool hi = (rho & off) != 0;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      if (x < off) {
        const float send = hi ? v[x] : v[x + off];
        const float keep = hi ? v[x + off] : v[x];
        v[x] = keep + __shfl_xor_sync(kFull, send, off);
      }
    }
  }
}

// The pair terms of the sub-block for row i (lane rho of warp wp, half hf):
// half 0 walks the steps forward and writes dr, half 1 walks them backward
// (frame f is step t = kT - 1 - f: the same terms with k <-> r, X <-> Y,
// M <-> M^T, A <-> Z) and writes dk; each writes dw for its frame's first
// kHalf steps and its part of C (half 0 C's rows t < 8, half 1 the columns
// t >= 8 of rows >= 8).  Returns the row's share of du.
template <int HD, typename TI>
__device__ __forceinline__ float pair_terms(const Staged<HD, TI>& st, float* smem, float ui,
                                            int i, int rho, int hf, int wp, float* __restrict__ dr,
                                            float* __restrict__ dk, float* __restrict__ dw,
                                            long long row0, long long rstride, int valid) {
  using Cfg = Bwd<HD, TI>;
  constexpr int RS = Cfg::RS, RX = Cfg::RX;
  const TI* kb = hf ? st.r : st.k;
  const TI* rb = hf ? st.k : st.r;
  const int t0 = hf ? kT - 1 : 0, dt = hf ? -1 : 1;
  float wf[kT], kf[kT], rf[kT], zf[kT];
#pragma unroll
  for (int f = 0; f < kT; ++f) {
    const int t = t0 + dt * f;
    wf[f] = st.w[t * RS + i];
    kf[f] = elem(kb + t * RS + i);
    rf[f] = elem(rb + t * RS + i);
  }
  {
    float z = 1.f;
#pragma unroll
    for (int f = kT - 1; f >= 0; --f) {
      zf[f] = z;
      z *= wf[f];
    }
  }
  const float* mm = smem + (hf ? Cfg::oMT : Cfg::oM);          // Mf(f, c) = mm[t(f)][t(c)]
  const float* xt = smem + (hf ? Cfg::oY : Cfg::oX) + (wp * 16 + rho) * RX;
  const float* yt = smem + (hf ? Cfg::oX : Cfg::oY) + (wp * 16 + rho) * RX;
  float* cw = smem + Cfg::oC + wp * kT * kT;
  float* out = hf ? dk : dr;
  const float diag = smem[Cfg::oDiag + i];
  float L[kT], G[kHalf], T4[kHalf], AZ[kHalf];
#pragma unroll
  for (int c = 0; c < kT; ++c) L[c] = 0.f;
  float F = 0.f, a = 1.f, du = 0.f;
#pragma unroll
  for (int f = 0; f < kT; ++f) {
    const int t = t0 + dt * f;
    const float mff = mm[t * RX + t];
    // dr (half 0) or dk (half 1)
    const float o = fmaf(a, xt[t], L[f]) + ui * kf[f] * mff;
    if (t < valid) out[row0 + t * rstride + i] = o;
    const float gf = zf[f] * F;   // dw's Y term (half 0) or X term (half 1)
    if (f < kHalf) {
      G[f] = gf;
      AZ[f] = a * zf[f];
      du = fmaf(kf[f] * rf[f], mff, du);
      // dw's last term and C's row: beta_c = P(t, c) r_c for the frame's c > f
      float cv[kT];
#pragma unroll
      for (int c = 0; c < f; ++c) cv[c] = 0.f;
      cv[f] = kf[f] * rf[f] * ui;
      float p = 1.f, t4 = 0.f;
#pragma unroll
      for (int c = f + 1; c < kT; ++c) {
        const float beta = p * rf[c];
        t4 = fmaf(beta, L[c], t4);
        cv[c] = (hf == 0 || c < kHalf) ? kf[f] * beta : 0.f;
        p *= wf[c];
      }
      T4[f] = t4;
      reduce_scatter16(cv, rho);
      if (hf == 0)
        cw[f * kT + rho] = cv[0];
      else if (rho < kHalf)
        cw[(kT - 1 - rho) * kT + kT - 1 - f] = cv[0];
    } else {
      // the partner half holds the same step at frame kT - 1 - f < kHalf:
      // its dw gets this term, this lane's dw at frame kT - 1 - f the other
      const float pg = __shfl_xor_sync(kFull, gf, 16);
      const int fb = kT - 1 - f, tb = t0 + dt * fb;
      const float dwv = AZ[fb] * diag + G[fb] + pg + T4[fb];
      if (tb < valid) dw[row0 + tb * rstride + i] = dwv;
    }
#pragma unroll
    for (int c = f + 1; c < kT; ++c)
      L[c] = fmaf(wf[f], L[c], kf[f] * mm[t * RX + t0 + dt * c]);
    F = fmaf(wf[f], F, kf[f] * yt[t]);
    a *= wf[f];
  }
  return du + __shfl_xor_sync(kFull, du, 16);
}

// Kernel 3.  Grid (chunks, H, B), 2 HD threads (warp wp: state rows
// 16 wp..).  starts (B, H, chunks, HD, HD) the chunk-start states, wsd the
// state gradient at each chunk's end, wss (B, H, chunks, kSubs, HD, HD)
// the scratch for sub-block start states (each thread's fragments, so that
// no fragment lives across the backward loop); du_part (B, H, chunks, HD).
template <int HD, typename TI>
__global__ void __launch_bounds__(Bwd<HD, TI>::NT, Bwd<HD, TI>::MINB)
wkv_bwd_grad_tc(const TI* __restrict__ r, const TI* __restrict__ k,
                const TI* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ dout,
                const float* __restrict__ starts, const float* __restrict__ wsd,
                float* __restrict__ wss, float* __restrict__ dr, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ dw,
                float* __restrict__ du_part, int S, int H, int C) {
  using Cfg = Bwd<HD, TI>;
  constexpr int NW = Cfg::NW, RX = Cfg::RX, RD = Cfg::RD, RS = Cfg::RS, RA = Cfg::RA;
  constexpr bool VLO = !ExactTf32<TI>::value;
  extern __shared__ __align__(16) float smem[];
  char* bufs = reinterpret_cast<char*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5, i0 = 16 * wp;
  const int g = lane >> 2, q = lane & 3, rho = lane & 15, hf = lane >> 4, i = i0 + rho;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nchunks = gridDim.x;
  const int t0c = c * C, len = min(C, S - t0c), nsub = (len + kT - 1) / kT;
  const long long bh = static_cast<long long>(b) * H + h, cc = bh * nchunks + c;
  const long long rstride = static_cast<long long>(H) * HD;
  const float ui = u[h * HD + i];
  float4* slots = reinterpret_cast<float4*>(wss + cc * kSubs * HD * HD) +
                  wp * (HD / 8) * 32 + lane;   // slot sb, n-tile n: [sb * HD * HD / 4 + n * 32]
  auto base = [&](int sb) { return step_base(b, t0c + sb * kT, h, S, H, HD); };
  auto valid = [&](int sb) { return min(kT, len - sb * kT); };

  // forward: the sub-blocks' start states, from the chunk's start state
  float sf[HD / 8][4];
  load_rows<HD>(sf, starts + cc * HD * HD, HD, i0, lane);
  int cur = 0;
  stage<HD, TI>(bufs, r, k, v, w, dout, base(0), rstride, valid(0),
                nsub == 1 ? kAll : kK | kV | kW);
  for (int sb = 0; sb + 1 < nsub; ++sb) {
    cp_async_wait<0>();
    __syncthreads();
    stage<HD, TI>(bufs + (cur ^ 1) * Cfg::kStage * 4, r, k, v, w, dout, base(sb + 1), rstride,
                  valid(sb + 1), sb + 2 == nsub ? kAll : kK | kV | kW);
    const Staged<HD, TI> st(bufs + cur * Cfg::kStage * 4);
    decays<HD, TI>(st, smem, i, hf, false, true);
    __syncwarp();
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      slots[sb * (HD * HD / 4) + n * 32] = make_float4(sf[n][0], sf[n][1], sf[n][2], sf[n][3]);
    rows_update<HD, VLO>(sf, smem + Cfg::oD, smem + Cfg::oZK, st.v, i0, lane);
    cur ^= 1;
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    slots[(nsub - 1) * (HD * HD / 4) + n * 32] =
        make_float4(sf[n][0], sf[n][1], sf[n][2], sf[n][3]);

  // backward: the sub-blocks last first, carrying dS
  float ds[HD / 8][4];
  load_rows<HD>(ds, wsd + cc * HD * HD, HD, i0, lane);
  float du_acc = 0.f;
  float* dsc = smem + Cfg::oDS + wp * 16 * RD;   // the warp's dS_e, then its share of dv
  for (int sb = nsub - 1; sb >= 0; --sb) {
    cp_async_wait<0>();
    __syncthreads();
    if (sb > 0)
      stage<HD, TI>(bufs + (cur ^ 1) * Cfg::kStage * 4, r, k, v, w, dout, base(sb - 1),
                    rstride, kT, kAll);
    const Staged<HD, TI> st(bufs + cur * Cfg::kStage * 4);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float4 x = slots[sb * (HD * HD / 4) + n * 32];
      sf[n][0] = x.x;
      sf[n][1] = x.y;
      sf[n][2] = x.z;
      sf[n][3] = x.w;
    }
    decays<HD, TI>(st, smem, i, hf, true, true);
    // M = V dout^T: warp wp the n-tiles wp, wp + NW, ... of its two
    for (int n = wp; n < 2; n += NW) {
      float m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kt = 0; kt < HD / 8; ++kt) {
        Frag<4> fa;
        Frag<2> fb;
        const float2 a0 = elem2(st.v + g * RS + 8 * kt + 2 * q);
        const float2 a1 = elem2(st.v + (g + 8) * RS + 8 * kt + 2 * q);
        const float2 bb = elem2(st.dout + (8 * n + g) * RS + 8 * kt + 2 * q);
        split<VLO>(fa, 0, a0.x);
        split<VLO>(fa, 1, a1.x);
        split<VLO>(fa, 2, a0.y);
        split<VLO>(fa, 3, a1.y);
        split<true>(fb, 0, bb.x);
        split<true>(fb, 1, bb.y);
        mma3<VLO, true>(m, fa, fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = g + 8 * (e >> 1), s2 = 8 * n + 2 * q + (e & 1);
        smem[Cfg::oM + s * RX + s2] = m[e];
        smem[Cfg::oMT + s2 * RX + s] = m[e];
      }
    }
    // X = S_b dout^T, Y = dS_e V^T, rowsum(S_b * dS_e); the warp's dS_e copy
    {
      float x[2][4], y[2][4];
      rows_times<HD, true>(x, sf, st.dout, lane);
      rows_times<HD, VLO>(y, ds, st.v, lane);
      float* xw = smem + Cfg::oX + wp * 16 * RX;
      float* yw = smem + Cfg::oY + wp * 16 * RX;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = g + 8 * (e >> 1), t = 8 * n + 2 * q + (e & 1);
          xw[row * RX + t] = x[n][e];
          yw[row * RX + t] = y[n][e];
        }
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        d0 = fmaf(sf[n][0], ds[n][0], d0);
        d0 = fmaf(sf[n][1], ds[n][1], d0);
        d1 = fmaf(sf[n][2], ds[n][2], d1);
        d1 = fmaf(sf[n][3], ds[n][3], d1);
        *reinterpret_cast<float2*>(dsc + g * RD + 8 * n + 2 * q) = make_float2(ds[n][0], ds[n][1]);
        *reinterpret_cast<float2*>(dsc + (g + 8) * RD + 8 * n + 2 * q) =
            make_float2(ds[n][2], ds[n][3]);
      }
      d0 += __shfl_xor_sync(kFull, d0, 1);
      d1 += __shfl_xor_sync(kFull, d1, 1);
      d0 += __shfl_xor_sync(kFull, d0, 2);
      d1 += __shfl_xor_sync(kFull, d1, 2);
      if (q == 0) {
        smem[Cfg::oDiag + i0 + g] = d0;
        smem[Cfg::oDiag + i0 + g + 8] = d1;
      }
    }
    __syncthreads();
    const long long row0 = base(sb);
    const int vs = valid(sb);
    du_acc += pair_terms<HD, TI>(st, smem, ui, i, rho, hf, wp, dr, dk, dw, row0, rstride, vs);
    __syncwarp();
    // the warp's share of dv: (Z K)^T dS_e over its rows, k = its rows
    // permuted as the fragments hold them
    float pv[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      Frag<4> fa;
      const float2 a0 =
          *reinterpret_cast<const float2*>(smem + Cfg::oZK + g * RA + i0 + 8 * kt + 2 * q);
      const float2 a1 =
          *reinterpret_cast<const float2*>(smem + Cfg::oZK + (g + 8) * RA + i0 + 8 * kt + 2 * q);
      split<true>(fa, 0, a0.x);
      split<true>(fa, 1, a1.x);
      split<true>(fa, 2, a0.y);
      split<true>(fa, 3, a1.y);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        Frag<2> fb;
        split<true>(fb, 0, dsc[(8 * kt + 2 * q) * RD + 8 * n + g]);
        split<true>(fb, 1, dsc[(8 * kt + 2 * q + 1) * RD + 8 * n + g]);
        mma3<true, true>(pv[n], fa, fb);
      }
    }
    // dS_b = D dS_e + (A R)^T dout
    load_rows<HD>(ds, dsc, RD, 0, lane);
    rows_update<HD, true>(ds, smem + Cfg::oD, smem + Cfg::oAR, st.dout, i0, lane);
    __syncwarp();
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<float2*>(dsc + g * RD + 8 * n + 2 * q) = make_float2(pv[n][0], pv[n][1]);
      *reinterpret_cast<float2*>(dsc + (g + 8) * RD + 8 * n + 2 * q) =
          make_float2(pv[n][2], pv[n][3]);
    }
    __syncthreads();
    // dv_t[j] = the warps' shares in order + sum_{s>=t} C[t][s] dout_s[j]
    {
      constexpr int TPT = HD / 8;   // threads a step, 8 columns each
      const int t = tid / TPT, jg = tid - t * TPT;
      if (t < vs) {
        float acc[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int j = jg + TPT * x;
          float sum = smem[Cfg::oDS + t * RD + j];
#pragma unroll
          for (int w2 = 1; w2 < NW; ++w2) sum += smem[Cfg::oDS + w2 * 16 * RD + t * RD + j];
          acc[x] = sum;
        }
#pragma unroll
        for (int s = 0; s < kT; ++s) {
          if (s >= t) {
            float cs = smem[Cfg::oC + t * kT + s];
#pragma unroll
            for (int w2 = 1; w2 < NW; ++w2) cs += smem[Cfg::oC + w2 * kT * kT + t * kT + s];
#pragma unroll
            for (int x = 0; x < 8; ++x) acc[x] = fmaf(cs, st.dout[s * RS + jg + TPT * x], acc[x]);
          }
        }
#pragma unroll
        for (int x = 0; x < 8; ++x) dv[row0 + t * rstride + jg + TPT * x] = acc[x];
      }
    }
    cur ^= 1;
  }
  if (hf == 0) du_part[cc * HD + i] = du_acc;
}

// Kernel 4.  Grid H, HD threads: du[h][i] = sum_b sum_c du_part[b][h][c][i].
template <int HD>
__global__ void __launch_bounds__(HD)
wkv_bwd_du(const float* __restrict__ du_part, float* __restrict__ du, int B, int H,
           int nchunks) {
  const int i = threadIdx.x, h = blockIdx.x;
  float sum = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nchunks; ++c)
      sum += du_part[((static_cast<long long>(b) * H + h) * nchunks + c) * HD + i];
  du[h * HD + i] = sum;
}

// cudaFuncSetAttribute for kernels 1 and 3's dynamic shared memory, once
// per device and instantiation.
template <int HD, typename TI>
int smem_attribute() {
  static int done[kMaxDevices];  // 0 unset, 1 set, else -(error)
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev] == 0) {
    rc = static_cast<int>(cudaFuncSetAttribute(wkv_bwd_chunk_tc<HD, TI>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Bwd<HD, TI>::SMEM_CHUNK));
    if (rc == 0)
      rc = static_cast<int>(cudaFuncSetAttribute(wkv_bwd_grad_tc<HD, TI>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 Bwd<HD, TI>::SMEM));
    done[dev] = rc == 0 ? 1 : -rc;
  }
  return done[dev] == 1 ? 0 : -done[dev];
}

template <int HD, typename TI>
int launch(const TI* r, const TI* k, const TI* v, const float* w, const float* u,
           const float* dout, const float* starts, const float* dstateT, float* dr,
           float* dk, float* dv, float* dw, float* du, float* dstate0, float* wsd,
           float* wd, float* du_part, float* wss, int B, int S, int H, int C,
           cudaStream_t stream) {
  using Cfg = Bwd<HD, TI>;
  if (C <= 0 || C > kMaxChunk || C % kT != 0) return cudaErrorInvalidValue;
  int rc = smem_attribute<HD, TI>();
  if (rc != 0) return rc;
  const int nchunks = (S + C - 1) / C;
  const dim3 grid(nchunks, H, B);
  wkv_bwd_chunk_tc<HD, TI><<<grid, Cfg::NT, Cfg::SMEM_CHUNK, stream>>>(r, w, dout, wsd, wd, S,
                                                                      H, C);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int slices = (HD * HD / 4 + kScanThreads - 1) / kScanThreads;
  wkv_bwd_scan<HD><<<dim3(slices, H, B), kScanThreads, 0, stream>>>(wsd, wd, dstateT, dstate0,
                                                                     H, nchunks);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  wkv_bwd_grad_tc<HD, TI><<<grid, Cfg::NT, Cfg::SMEM, stream>>>(
      r, k, v, w, u, dout, starts, wsd, wss, dr, dk, dv, dw, du_part, S, H, C);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  wkv_bwd_du<HD><<<H, HD, 0, stream>>>(du_part, du, B, H, nchunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI>
int dispatch(int hd, const TI* r, const TI* k, const TI* v, const float* w, const float* u,
             const float* dout, const float* starts, const float* dstateT, float* dr,
             float* dk, float* dv, float* dw, float* du, float* dstate0, float* wsd,
             float* wd, float* du_part, float* wss, int B, int S, int H, int C,
             cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<16, TI>(r, k, v, w, u, dout, starts, dstateT, dr, dk, dv, dw, du, dstate0,
                            wsd, wd, du_part, wss, B, S, H, C, stream);
    case 32:
      return launch<32, TI>(r, k, v, w, u, dout, starts, dstateT, dr, dk, dv, dw, du, dstate0,
                            wsd, wd, du_part, wss, B, S, H, C, stream);
    case 64:
      return launch<64, TI>(r, k, v, w, u, dout, starts, dstateT, dr, dk, dv, dw, du, dstate0,
                            wsd, wd, du_part, wss, B, S, H, C, stream);
    case 128:
      return launch<128, TI>(r, k, v, w, u, dout, starts, dstateT, dr, dk, dv, dw, du,
                             dstate0, wsd, wd, du_part, wss, B, S, H, C, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// All operands contiguous and 16-byte aligned: r, k, v (B, S, H, hd) of
// dtype 0 float32 or 1 bfloat16; w, dout, dr, dk, dv, dw (B, S, H, hd), u
// and du (H, hd), dstateT (or null for zeros) and dstate0 (B, H, hd, hd),
// starts and the workspace wsd (B, H, chunks, hd, hd), the workspaces wd
// and du_part (B, H, chunks, hd) and wss (B, H, chunks, 8, hd, hd), all
// float32; chunks = ceil(S / chunk), chunk a multiple of 16 up to 128.  hd
// in {16, 32, 64, 128}.  Returns cudaGetLastError() after the launches.
int wkv_bwd(int dtype, const void* r, const void* k, const void* v, const float* w,
            const float* u, const float* dout, const float* starts, const float* dstateT,
            float* dr, float* dk, float* dv, float* dw, float* du, float* dstate0,
            float* wsd, float* wd, float* du_part, float* wss, int B, int S, int H, int hd,
            int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(hd, static_cast<const float*>(r), static_cast<const float*>(k),
                           static_cast<const float*>(v), w, u, dout, starts, dstateT, dr, dk,
                           dv, dw, du, dstate0, wsd, wd, du_part, wss, B, S, H, chunk, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(
        hd, static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), w, u, dout, starts, dstateT, dr, dk, dv, dw, du,
        dstate0, wsd, wd, du_part, wss, B, S, H, chunk, st);
  return cudaErrorInvalidValue;
}

const char* wkv_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
