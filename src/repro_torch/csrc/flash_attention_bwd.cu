// Flash attention backward: dq, dk, dv of grouped-query attention with a
// causal mask, an optional sliding window and a query offset, from the
// forward's output o and its per-row log-sum-exp, float32 or bfloat16 in and
// the same type out, float32 accumulators.
//
// Replaces the reference's custom VJP, src/repro/models/attention.py:98
// (_flash_bwd), which is plain JAX, not a Pallas kernel: the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:100 is forward only,
// and the reference differentiates its chunked scan.  The function is the
// same: with s = scale * q . k, p = exp(s - lse) on valid (query, key)
// pairs and 0 elsewhere (the reference's where(valid, exp(s - lse), 0)),
// delta = rowsum(dO * O), dp = dO . v, ds = p (dp - delta):
//   dv = sum over queries of p dO,  dk = scale * sum of ds q,
//   dq = scale * sum over keys of ds k.
// Query i sits at position q_offset + i and key j at j; a pair is valid when
// j <= pos (causal) and j > pos - window (window > 0).  Rows are the
// flattened (position, query head of the group) index of one KV head,
// row = i * G + g, as in the forward kernel, so one block's dk and dv sum
// over the G query heads that share its KV head; nothing is added across
// blocks, no atomics: two launches give the same bits.
//
// What bounds it on an H100: 10 hd flops per valid (query head, key) pair
// (the least work: s, dp, dv, dk and dq, 2 hd each) at 989 TFLOP/s in bf16,
// against reading q, k, v, o, dO and lse and writing dq, dk, dv once at
// 3.35 TB/s; at training shapes the flops (0.17 ms at tinyllama's (4, 2048,
// 32 / 4, 64)).  The first version ran every product as FP32 FMAs
// on the CUDA cores, 14.87 ms there (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// The dtype picks the kernels, explicitly, in flash_attention_bwd below.
// float32 keeps the first version's CUDA-core kernels in full FP32
// (flash_bwd_dkdv / flash_bwd_dq): TF32 keeps ~3 decimal digits and would
// use up the 1e-3 by which whole-model float32 gradients are held to the
// CPU's (chip_smoke.py phase 10b).  bfloat16 (training's compute type)
// runs flash_bwd_dkdv_tc / flash_bwd_dq_tc, FlashAttention-2's backward
// adapted to GQA; against each of the first version's four costs:
//
// 1. FP32 FMAs on the CUDA cores -> all five products (S = Q K^T, dP =
//    dO V^T, dV += P^T dO, dK += dS^T Q, dQ += dS K) on the tensor cores,
//    mma.sync.m16n8k16 with bf16 operands and fp32 accumulators.  P and dS
//    are rounded to bf16 as the A operands of the second products, straight
//    from the accumulator registers of the first (no shared memory), as
//    FlashAttention-2 does; the softmax arithmetic stays fp32.
// 2. Operands widened to float32 and stored twice -> bf16 tiles stored once,
//    rows padded by 16 bytes so ldmatrix is free of bank conflicts;
//    ldmatrix.trans gives the transposed fragments (Q and dO as B of dK and
//    dV, K as B of dQ).  dkdv at hd 64 takes 75 KB of shared memory where
//    it took 137 KB; its registers (247 a thread) now let two blocks share
//    an SM, where one 8-warp block did.
// 3. S and dP computed twice -> kept: a dkdv kernel by key tile and a dq
//    kernel by row tile, each recomputing S and dP, 14 hd flops a pair for
//    the least work's 10, the price of needing neither atomics nor O(S^2)
//    scratch.
// 4. Causal imbalance -> one-dimensional grids with the tile index
//    outermost and heaviest first (dkdv: key tile 0, the longest column of
//    rows; dq: the last row tile), so every head's longest tiles start in
//    the first wave.  Only tiles that cross the causal or window edge or a
//    ragged end evaluate the mask.
//
// Q, dO, lse and delta row tiles reach dkdv through a 3-stage cp.async ring
// while the previous tile computes; K and V key tiles reach dq the same way.
// Tiles (TcBwdCfg): dkdv 64 keys (16 a warp) x BR rows, BR = 64 at hd <= 64
// and 32 above; dq 64 rows (16 a warp) x BK keys, BK = 64 / 32 likewise.
// hd 256 cannot hold its 16 keys' float32 dK and dV over 256 columns in
// registers (256 a thread), so its dkdv splits the columns over two blocks,
// each recomputing S and dP (12 hd flops a pair there instead of 8).  hd
// 112 is seven k16 chunks of S and seven n8 pairs of dK, dV, dQ; its
// 240-byte padded rows keep ldmatrix free of bank conflicts.  G = 1 fills
// the tiles as any G does: the rows are positions.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py --time-kernels,
// parent and change in turns in one call; PERF.md): 1.14 ms at tinyllama's
// shape (the first version 14.8-14.9; SDPA's backward 0.60), 1.72 / 2.19
// ms on gemma3's local / global layer (24.6 / 32.6).  What sets the pace
// now, by a count of the instructions (not profiled): each warp reads
// every B fragment it uses from shared memory through ldmatrix for its own
// 16 keys or rows, one ldmatrix.x4 for every two mma, and dkdv holds 247
// registers a thread at hd 64.  wgmma, which reads its shared operand once
// per warpgroup, is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// ---------------------------------------------------------------------------
// float32: the first version's CUDA-core kernels, FP32 FMAs with operands
// widened in shared memory and 4 x 4 register micro-tiles.
// * flash_bwd_delta (both types): delta (B, Hq, Sq) = rowsum(dO * O) in
//   float32, a warp a row, lanes summed by a fixed shuffle tree.
// * flash_bwd_dkdv: one block per (key tile, KV head, batch), walking the
//   row tiles that can see its keys: S = Q K^T and dP = dO V^T again, P and
//   dS in shared memory, dV += P^T dO, dK += dS^T Q.
// * flash_bwd_dq: one block per (row tile, KV head, batch), walking the key
//   tiles its rows can see: dQ += dS K.
// Tiles: 64 rows x 64 keys at hd <= 64; 32 x 64 at hd 112 and 128; 16 x 32
// at hd 256.  Shared memory rows are padded by 4 floats.
// ---------------------------------------------------------------------------

template <int HD>
struct BwdCfg {
  static constexpr int BR = HD <= 64 ? 64 : (HD <= 128 ? 32 : 16);  // rows a tile
  static constexpr int BK = HD <= 128 ? 64 : 32;                    // keys a tile
  // S / dP micro-tile of a thread: SR rows x SC keys, (BR / SR) (BK / SC)
  // = 256 threads
  static constexpr int SR = HD <= 64 ? 4 : (HD <= 128 ? 2 : 1);
  static constexpr int SC = HD <= 128 ? 4 : 2;
  static constexpr int LDR = BR + 4, LDK = BK + 4, LDH = HD + 4;
  // dK / dV (kernel dkdv) and dQ (kernel dq) outputs: groups of 4 x 4
  static constexpr int NG_KV = (BK / 4) * (HD / 4);
  static constexpr int NG_Q = (BR / 4) * (HD / 4);
  static constexpr int PER_KV = (NG_KV + kThreads - 1) / kThreads;
  static constexpr int PER_Q = (NG_Q + kThreads - 1) / kThreads;
  static constexpr int SMEM_KV =
      (2 * HD * LDK + 2 * BR * LDH + 2 * HD * LDR + 2 * BR * LDK + 2 * BR) * 4;
  static constexpr int SMEM_Q =
      (2 * HD * LDR + 2 * HD * LDK + BK * LDH + BK * LDR + 2 * BR) * 4;
  static_assert((BR / SR) * (BK / SC) == kThreads, "one S micro-tile a thread");
  static_assert(HD % 4 == 0, "hd in groups of 4");
};

// Offset of row `row` (= i * G + g) of (batch b, KV head hk) in q, o, dO, dq.
__device__ __forceinline__ long long row_offset(int b, int hk, int row, int G,
                                                int Sq, int Hq, int hd) {
  const int qi = row / G, g = row - qi * G;
  return ((static_cast<long long>(b) * Sq + qi) * Hq + hk * G + g) * hd;
}

// Index of row `row` in lse and delta, laid out (B, Hq, Sq).
__device__ __forceinline__ long long row_stat(int b, int hk, int row, int G,
                                              int Sq, int Hq) {
  const int qi = row / G, g = row - qi * G;
  return (static_cast<long long>(b) * Hq + hk * G + g) * Sq + qi;
}

__device__ __forceinline__ bool pair_valid(int key, int pos, int causal,
                                           int window) {
  return (!causal || key <= pos) && (window <= 0 || key > pos - window);
}

// delta[(b, h, i)] = sum_d dO * O over q's layout (B, Sq, Hq, hd): a warp
// a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, long long rows, int Sq, int Hq,
                int hd) {
  const long long n = blockIdx.x * static_cast<long long>(kThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (n >= rows) return;
  const T* po = o + n * hd;
  const T* pd = dout + n * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f(pd[d]), to_f(po[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long bi = n / Hq;  // b * Sq + i
    const int h = static_cast<int>(n - bi * Hq);
    const long long b = bi / Sq;
    const int i = static_cast<int>(bi - b * Sq);
    delta[(b * Hq + h) * Sq + i] = acc;
  }
}

// S = Q K^T and dP = dO V^T for this thread's micro-tile, from the
// transposed tiles sQT / sdOT (HD x LDR) and sKT / sVT (HD x LDK); then P
// and dS.  Writes dS (and P when sP is given) at [r][c] (ld LDK), or dS
// transposed at [c][r] (ld LDR) when `transposed`.
template <int HD, bool transposed>
__device__ __forceinline__ void scores_tile(
    const float* sQT, const float* sdOT, const float* sKT, const float* sVT,
    const float* sLse, const float* sDelta, float* sP, float* sdS, int r0,
    int row_end, int k0, int key_end, int G, int q_offset, int causal,
    int window, float scale) {
  using C = BwdCfg<HD>;
  constexpr int SR = C::SR, SC = C::SC, LDR = C::LDR, LDK = C::LDK;
  const int tid = threadIdx.x;
  const int sc = tid % (C::BK / SC), sr = tid / (C::BK / SC);
  const int rr = sr * SR, cc = sc * SC;
  float s[SR][SC], dp[SR][SC];
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int j = 0; j < SC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[SR], oa[SR], kb[SC], vb[SC];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      qa[i] = sQT[d * LDR + rr + i];
      oa[i] = sdOT[d * LDR + rr + i];
    }
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      kb[j] = sKT[d * LDK + cc + j];
      vb[j] = sVT[d * LDK + cc + j];
    }
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int r = rr + i, row = r0 + r;
    const int pos = q_offset + row / G;
    const float lse = sLse[r], dl = sDelta[r];
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int c = cc + j, key = k0 + c;
      const bool ok = row < row_end && key < key_end &&
                      pair_valid(key, pos, causal, window);
      const float p = ok ? expf(s[i][j] * scale - lse) : 0.f;
      const float ds = p * (dp[i][j] - dl);
      if (transposed) {
        sdS[c * LDR + r] = ds;
      } else {
        sP[r * LDK + c] = p;
        sdS[r * LDK + c] = ds;
      }
    }
  }
}

// One block per (key tile, KV head, batch): dk and dv of its keys.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv,
               int Hq, int Hkv, int G, int causal, int window, int q_offset,
               float scale) {
  using C = BwdCfg<HD>;
  constexpr int BR = C::BR, BK = C::BK, LDR = C::LDR, LDK = C::LDK,
                LDH = C::LDH, PER = C::PER_KV, NG = C::NG_KV;
  extern __shared__ __align__(16) float smem[];
  float* sKT = smem;                 // HD x LDK
  float* sVT = sKT + HD * LDK;       // HD x LDK
  float* sQ = sVT + HD * LDK;        // BR x LDH
  float* sdO = sQ + BR * LDH;        // BR x LDH
  float* sQT = sdO + BR * LDH;       // HD x LDR
  float* sdOT = sQT + HD * LDR;      // HD x LDR
  float* sP = sdOT + HD * LDR;       // BR x LDK
  float* sdS = sP + BR * LDK;        // BR x LDK
  float* sLse = sdS + BR * LDK;      // BR
  float* sDelta = sLse + BR;         // BR

  const int tid = threadIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const int key_end = min(Skv, k0 + BK);
  const long long kv_row = static_cast<long long>(Hkv) * HD;
  const T* kb = k + static_cast<long long>(b) * Skv * kv_row + hk * HD;
  const T* vb = v + static_cast<long long>(b) * Skv * kv_row + hk * HD;

  for (int e = tid; e < BK * HD; e += kThreads) {
    const int c = e / HD, d = e - c * HD;
    float kx = 0.f, vx = 0.f;
    if (k0 + c < key_end) {
      kx = to_f(kb[(k0 + c) * kv_row + d]);
      vx = to_f(vb[(k0 + c) * kv_row + d]);
    }
    sKT[d * LDK + c] = kx;
    sVT[d * LDK + c] = vx;
  }

  // Query positions that can see some key of [k0, key_end).
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  int i_hi = Sq;
  if (window > 0) i_hi = min(Sq, max(0, key_end - 1 + window - q_offset));
  const int row_lo = i_lo * G, row_end = max(i_hi, i_lo) * G;

  float accK[PER][4][4], accV[PER][4][4];
#pragma unroll
  for (int u = 0; u < PER; ++u)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) accK[u][a][c] = accV[u][a][c] = 0.f;

  for (int r0 = row_lo; r0 < row_end; r0 += BR) {
    __syncthreads();  // the previous tile's P, dS, Q and dO are read
    for (int e = tid; e < BR * HD; e += kThreads) {
      const int r = e / HD, d = e - r * HD;
      const int row = r0 + r;
      float qx = 0.f, dx = 0.f;
      if (row < row_end) {
        const long long off = row_offset(b, hk, row, G, Sq, Hq, HD) + d;
        qx = to_f(q[off]);
        dx = to_f(dout[off]);
      }
      sQ[r * LDH + d] = qx;
      sdO[r * LDH + d] = dx;
      sQT[d * LDR + r] = qx;
      sdOT[d * LDR + r] = dx;
    }
    for (int r = tid; r < BR; r += kThreads) {
      const int row = r0 + r;
      const bool in = row < row_end;
      sLse[r] = in ? lse[row_stat(b, hk, row, G, Sq, Hq)] : 0.f;
      sDelta[r] = in ? delta[row_stat(b, hk, row, G, Sq, Hq)] : 0.f;
    }
    __syncthreads();
    scores_tile<HD, false>(sQT, sdOT, sKT, sVT, sLse, sDelta, sP, sdS, r0,
                           row_end, k0, key_end, G, q_offset, causal, window,
                           scale);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int gi = tid + u * kThreads;
      if (gi >= NG) break;
      const int c0 = (gi / (HD / 4)) * 4, d0 = (gi % (HD / 4)) * 4;
      for (int r = 0; r < BR; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(sP + r * LDK + c0);
        const float4 ds = *reinterpret_cast<const float4*>(sdS + r * LDK + c0);
        const float4 o4 = *reinterpret_cast<const float4*>(sdO + r * LDH + d0);
        const float4 q4 = *reinterpret_cast<const float4*>(sQ + r * LDH + d0);
        const float pa[4] = {p.x, p.y, p.z, p.w};
        const float sa[4] = {ds.x, ds.y, ds.z, ds.w};
        const float ob[4] = {o4.x, o4.y, o4.z, o4.w};
        const float qb[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            accV[u][a][c] = fmaf(pa[a], ob[c], accV[u][a][c]);
            accK[u][a][c] = fmaf(sa[a], qb[c], accK[u][a][c]);
          }
      }
    }
  }

  // Every key of the tile is written, zeros where no query sees it.
  T* dkb = dk + static_cast<long long>(b) * Skv * kv_row + hk * HD;
  T* dvb = dv + static_cast<long long>(b) * Skv * kv_row + hk * HD;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int gi = tid + u * kThreads;
    if (gi >= NG) break;
    const int c0 = (gi / (HD / 4)) * 4, d0 = (gi % (HD / 4)) * 4;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int key = k0 + c0 + a;
      if (key >= key_end) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dkb[key * kv_row + d0 + c] = from_f<T>(accK[u][a][c] * scale);
        dvb[key * kv_row + d0 + c] = from_f<T>(accV[u][a][c]);
      }
    }
  }
}

// One block per (query tile, KV head, batch): dq of its rows.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int G,
             int causal, int window, int q_offset, float scale) {
  using C = BwdCfg<HD>;
  constexpr int BR = C::BR, BK = C::BK, LDR = C::LDR, LDK = C::LDK,
                LDH = C::LDH, PER = C::PER_Q, NG = C::NG_Q;
  extern __shared__ __align__(16) float smem[];
  float* sQT = smem;                 // HD x LDR
  float* sdOT = sQT + HD * LDR;      // HD x LDR
  float* sKT = sdOT + HD * LDR;      // HD x LDK
  float* sVT = sKT + HD * LDK;       // HD x LDK
  float* sK = sVT + HD * LDK;        // BK x LDH
  float* sdST = sK + BK * LDH;       // BK x LDR
  float* sLse = sdST + BK * LDR;     // BR
  float* sDelta = sLse + BR;         // BR

  const int tid = threadIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int R = Sq * G;
  const int r0 = blockIdx.x * BR;
  const int row_end = min(R, r0 + BR);
  for (int e = tid; e < BR * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    const int row = r0 + r;
    float qx = 0.f, dx = 0.f;
    if (row < row_end) {
      const long long off = row_offset(b, hk, row, G, Sq, Hq, HD) + d;
      qx = to_f(q[off]);
      dx = to_f(dout[off]);
    }
    sQT[d * LDR + r] = qx;
    sdOT[d * LDR + r] = dx;
  }
  for (int r = tid; r < BR; r += kThreads) {
    const int row = r0 + r;
    const bool in = row < row_end;
    sLse[r] = in ? lse[row_stat(b, hk, row, G, Sq, Hq)] : 0.f;
    sDelta[r] = in ? delta[row_stat(b, hk, row, G, Sq, Hq)] : 0.f;
  }

  // Keys any row of the tile can see.
  const int qa = q_offset + r0 / G, qb = q_offset + (row_end - 1) / G;
  const int kv_lo = window > 0 ? max(0, qa - window + 1) : 0;
  const int kv_hi = causal ? min(Skv, qb + 1) : Skv;
  const long long kv_row = static_cast<long long>(Hkv) * HD;
  const T* kb = k + static_cast<long long>(b) * Skv * kv_row + hk * HD;
  const T* vb = v + static_cast<long long>(b) * Skv * kv_row + hk * HD;

  float acc[PER][4][4];
#pragma unroll
  for (int u = 0; u < PER; ++u)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][a][c] = 0.f;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += BK) {
    __syncthreads();  // the previous tile's K and dS are read
    const int key_end = min(kv_hi, t0 + BK);
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int c = e / HD, d = e - c * HD;
      float kx = 0.f, vx = 0.f;
      if (t0 + c < key_end) {
        kx = to_f(kb[(t0 + c) * kv_row + d]);
        vx = to_f(vb[(t0 + c) * kv_row + d]);
      }
      sKT[d * LDK + c] = kx;
      sVT[d * LDK + c] = vx;
      sK[c * LDH + d] = kx;
    }
    __syncthreads();
    scores_tile<HD, true>(sQT, sdOT, sKT, sVT, sLse, sDelta, nullptr, sdST,
                          r0, row_end, t0, key_end, G, q_offset, causal,
                          window, scale);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int gi = tid + u * kThreads;
      if (gi >= NG) break;
      const int rr = (gi / (HD / 4)) * 4, d0 = (gi % (HD / 4)) * 4;
      for (int c = 0; c < BK; ++c) {
        const float4 s4 = *reinterpret_cast<const float4*>(sdST + c * LDR + rr);
        const float4 k4 = *reinterpret_cast<const float4*>(sK + c * LDH + d0);
        const float sa[4] = {s4.x, s4.y, s4.z, s4.w};
        const float kc[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[u][a][j] = fmaf(sa[a], kc[j], acc[u][a][j]);
      }
    }
  }

#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int gi = tid + u * kThreads;
    if (gi >= NG) break;
    const int rr = (gi / (HD / 4)) * 4, d0 = (gi % (HD / 4)) * 4;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = r0 + rr + a;
      if (row >= row_end) continue;
      T* dst = dq + row_offset(b, hk, row, G, Sq, Hq, HD) + d0;
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = from_f<T>(acc[u][a][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, ldmatrix, cp.async rings).
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTcThreads = 128;  // 4 warps
constexpr int kTcStages = 3;     // cp.async ring depth of both kernels

// Tiles of the tensor-core kernels by head dim.  flash_bwd_dkdv_tc: a warp
// owns 16 keys (KEYS = 64 a block) and walks the rows in tiles of BR;
// its float32 dK and dV accumulators cover DACC of the HD columns, so hd
// 256 splits its columns over NSPLIT = 2 blocks, each recomputing S and dP
// (dK and dV over all 256 columns would take 256 registers a thread).
// flash_bwd_dq_tc: a warp owns 16 rows (ROWS = 64 a block) and walks the
// keys in tiles of BK.  REG: the warp's A fragments (K and V in dkdv, Q and
// dO in dq) stay in registers for the whole walk; above hd 64 they are
// re-read from shared memory by ldmatrix where they are used.
// kernels/flash_attention/flash_attention_bwd.py::bwd_tiles mirrors this.
template <int HD>
struct TcBwdCfg {
  static constexpr int KEYS = 64;
  static constexpr int BR = HD <= 64 ? 64 : 32;
  static constexpr int DACC = HD <= 128 ? HD : 128;
  static constexpr int NSPLIT = HD / DACC;
  static constexpr int ROWS = 64;
  static constexpr int BK = HD <= 64 ? 64 : 32;
  static constexpr bool REG = HD <= 64;
  static constexpr int LD = HD + 8;  // bf16 a shared row: 16-byte pad
  // one ring stage of dkdv: Q and dO tiles, then lse and delta
  static constexpr int ROW_STAGE = 2 * BR * LD * 2 + 2 * BR * 4;
  static constexpr int SMEM_KV = 2 * KEYS * LD * 2 + kTcStages * ROW_STAGE;
  static constexpr int KEY_STAGE = 2 * BK * LD * 2;  // K and V tiles
  static constexpr int SMEM_Q = 2 * ROWS * LD * 2 + kTcStages * KEY_STAGE;
  static_assert(HD % 16 == 0 && DACC % 16 == 0, "whole k16 chunks and n8 pairs");
  static_assert(SMEM_KV <= 232448 && SMEM_Q <= 232448, "shared memory a block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; bytes < 16 copies that many and zero-fills the rest.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4-byte async copy; bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A fragment (16 x 16, row-major) of rows r0 .. r0 + 15, columns
// 16 kc .. 16 kc + 15 of a shared tile with row length LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* tile,
                                       int r0, int kc, int lane) {
  ldmatrix_x4(r, smem_u32(tile + (r0 + (lane & 15)) * LD + kc * 16 +
                          (lane >> 4) * 8));
}

// B fragments of two n8 tiles (rows n0 .. n0 + 15 of the shared tile are
// B's columns, its columns 16 kc .. the k16 chunk): b[0], b[1] for rows
// n0 .. n0 + 7, b[2], b[3] for n0 + 8 .. n0 + 15.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* tile,
                                       int n0, int kc, int lane) {
  ldmatrix_x4(r, smem_u32(tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kc * 16 + ((lane >> 3) & 1) * 8));
}

// B fragments of the transposed tile: k16 chunk = rows 16 kc .., two n8
// tiles = columns c0 .. c0 + 15 (ldmatrix.trans, no second copy).
template <int LD>
__device__ __forceinline__ void load_bt(uint32_t (&r)[4], const bf16* tile,
                                        int kc, int c0, int lane) {
  ldmatrix_x4_trans(r, smem_u32(tile + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                c0 + (lane >> 4) * 8));
}

// The A fragment of a k16 chunk from the fp32 accumulators of two n8 tiles
// (FlashAttention-2's register reuse), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// dK and dV of one (key tile, column split, KV head, batch).  Blocks run key
// tile outermost, so every head's first key tile (causal: the longest
// column of rows) starts first.  Warp w owns keys k0 + 16 w .. + 15 and
// computes S^T = K Q^T and dP^T = V dO^T for them against each row tile,
// P^T and dS^T in its registers, then dV += P^T dO and dK += dS^T Q from
// the same registers: nothing but Q, dO, lse and delta passes through
// shared memory.
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int Sq,
                  int Skv, int Hq, int Hkv, int G, int causal, int window,
                  int q_offset, float scale) {
  using C = TcBwdCfg<HD>;
  constexpr int LD = C::LD, BR = C::BR, KEYS = C::KEYS, DACC = C::DACC;
  constexpr int KC = HD / 16;   // k16 chunks of S^T, dP^T
  constexpr int NT = BR / 8;    // n8 tiles of rows
  constexpr int DT = DACC / 8;  // n8 tiles of dK, dV columns
  constexpr int CPR = HD / 8;   // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + KEYS * LD;
  unsigned char* ring = smem_raw + 2 * KEYS * LD * 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nbh = B * Hkv * C::NSPLIT;
  const int kt = blockIdx.x / nbh;
  int rest = blockIdx.x - kt * nbh;
  const int split = rest % C::NSPLIT;
  rest /= C::NSPLIT;
  const int hk = rest % Hkv, b = rest / Hkv;
  const int k0 = kt * KEYS, key_end = min(Skv, k0 + KEYS);
  const int d_lo = split * DACC;
  const long long kv_row = static_cast<long long>(Hkv) * HD;
  const bf16* kb = k + static_cast<long long>(b) * Skv * kv_row + hk * HD;
  const bf16* vb = v + static_cast<long long>(b) * Skv * kv_row + hk * HD;

  for (int e = tid; e < KEYS * CPR; e += kTcThreads) {
    const int j = e / CPR, c = (e - j * CPR) * 8;
    const bool in = k0 + j < key_end;
    const long long off = in ? (k0 + j) * kv_row + c : 0;
    cp_async16(smem_u32(sK + j * LD + c), kb + off, in ? 16 : 0);
    cp_async16(smem_u32(sV + j * LD + c), vb + off, in ? 16 : 0);
  }
  cp_async_commit();

  // Rows (position, head of the group) whose positions can see a key of
  // [k0, key_end).
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  int i_hi = Sq;
  if (window > 0) i_hi = min(Sq, max(0, key_end - 1 + window - q_offset));
  const int row_lo = i_lo * G, row_end = max(i_hi, i_lo) * G;
  const int ntiles = (row_end - row_lo + BR - 1) / BR;

  auto load_rows = [&](int t, int slot) {
    bf16* sQ = reinterpret_cast<bf16*>(ring + slot * C::ROW_STAGE);
    bf16* sdO = sQ + BR * LD;
    float* sL = reinterpret_cast<float*>(sdO + BR * LD);
    const int r0 = row_lo + t * BR;
    for (int e = tid; e < BR * CPR; e += kTcThreads) {
      const int r = e / CPR, c = (e - r * CPR) * 8;
      const int row = r0 + r;
      const bool in = row < row_end;
      const long long off = in ? row_offset(b, hk, row, G, Sq, Hq, HD) + c : 0;
      cp_async16(smem_u32(sQ + r * LD + c), q + off, in ? 16 : 0);
      cp_async16(smem_u32(sdO + r * LD + c), dout + off, in ? 16 : 0);
    }
    for (int r = tid; r < BR; r += kTcThreads) {
      const int row = r0 + r;
      const bool in = row < row_end;
      const long long i = in ? row_stat(b, hk, row, G, Sq, Hq) : 0;
      cp_async4(smem_u32(sL + r), lse + i, in ? 4 : 0);
      cp_async4(smem_u32(sL + BR + r), delta + i, in ? 4 : 0);
    }
  };
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < ntiles) load_rows(s, s);
    cp_async_commit();
  }
  cp_async_wait<kTcStages - 1>();  // K and V have landed
  __syncthreads();

  const int wkey = warp * 16;
  const bool warp_live = k0 + wkey < key_end;
  constexpr int RK = C::REG ? KC : 1;
  uint32_t kf[RK][4], vf[RK][4];
  if constexpr (C::REG) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      load_a<LD>(kf[kc], sK, wkey, kc, lane);
      load_a<LD>(vf[kc], sV, wkey, kc, lane);
    }
  }
  const int gq = lane >> 2, tig = lane & 3;
  const int key0 = k0 + wkey + gq;  // the thread's keys: key0 and key0 + 8
  const float sl2 = scale * kLog2e;
  float acc_k[DT][4], acc_v[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kTcStages - 2>();  // row tile t has landed
    __syncthreads();                 // and every warp is done with t - 1
    {
      const int nt = t + kTcStages - 1;
      if (nt < ntiles) load_rows(nt, nt % kTcStages);
      cp_async_commit();
    }
    if (!warp_live) continue;
    const bf16* sQ = reinterpret_cast<const bf16*>(ring + (t % kTcStages) * C::ROW_STAGE);
    const bf16* sdO = sQ + BR * LD;
    const float* sL = reinterpret_cast<const float*>(sdO + BR * LD);
    const float* sD = sL + BR;
    const int r0 = row_lo + t * BR;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4], va[4];
      if constexpr (C::REG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = kf[kc][i];
          va[i] = vf[kc][i];
        }
      } else {
        load_a<LD>(ka, sK, wkey, kc, lane);
        load_a<LD>(va, sV, wkey, kc, lane);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t qb[4], ob[4];
        load_b<LD>(qb, sQ, np * 16, kc, lane);
        load_b<LD>(ob, sdO, np * 16, kc, lane);
        mma_bf16(s[2 * np], ka, qb[0], qb[1]);
        mma_bf16(s[2 * np + 1], ka, qb[2], qb[3]);
        mma_bf16(dp[2 * np], va, ob[0], ob[1]);
        mma_bf16(dp[2 * np + 1], va, ob[2], ob[3]);
      }
    }

    // P^T and dS^T: element e of n tile n is key key0 + 8 (e >> 1), row
    // r0 + 8 n + 2 tig + (e & 1).  Masks only on tiles that cross the
    // causal or window edge or a ragged end.
    const int last = min(r0 + BR, row_end) - 1;
    const int pa = q_offset + r0 / G, pb = q_offset + last / G;
    const bool need_mask = r0 + BR > row_end || k0 + KEYS > key_end ||
                           (causal && k0 + KEYS - 1 > pa) ||
                           (window > 0 && k0 <= pb - window);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int rl = n * 8 + 2 * tig + c;
        const float l2 = sL[rl] * kLog2e, dl = sD[rl];
        int pos = 0;
        if (need_mask) pos = q_offset + (r0 + rl) / G;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + c;
          float p = exp2_approx(fmaf(s[n][e], sl2, -l2));
          if (need_mask) {
            const int key = key0 + 8 * h;
            if (r0 + rl >= row_end || key >= key_end ||
                !pair_valid(key, pos, causal, window))
              p = 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dl);
        }
      }

    // dV += P^T dO and dK += dS^T Q: the rows are the k dimension.
#pragma unroll
    for (int kc = 0; kc < BR / 16; ++kc) {
      uint32_t pa4[4], da4[4];
      acc_to_a(pa4, s[2 * kc], s[2 * kc + 1]);
      acc_to_a(da4, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int dpr = 0; dpr < DT / 2; ++dpr) {
        uint32_t ob[4], qb[4];
        load_bt<LD>(ob, sdO, kc, d_lo + dpr * 16, lane);
        load_bt<LD>(qb, sQ, kc, d_lo + dpr * 16, lane);
        mma_bf16(acc_v[2 * dpr], pa4, ob[0], ob[1]);
        mma_bf16(acc_v[2 * dpr + 1], pa4, ob[2], ob[3]);
        mma_bf16(acc_k[2 * dpr], da4, qb[0], qb[1]);
        mma_bf16(acc_k[2 * dpr + 1], da4, qb[2], qb[3]);
      }
    }
  }
  cp_async_wait<0>();
  if (!warp_live) return;

  // Every key of the tile is written, zeros where no query sees it.
  bf16* dkb = dk + static_cast<long long>(b) * Skv * kv_row + hk * HD + d_lo + 2 * tig;
  bf16* dvb = dv + static_cast<long long>(b) * Skv * kv_row + hk * HD + d_lo + 2 * tig;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= key_end) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key * kv_row + n * 8) =
          __floats2bfloat162_rn(acc_k[n][2 * h] * scale, acc_k[n][2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key * kv_row + n * 8) =
          __floats2bfloat162_rn(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
    }
  }
}

// dQ of one (row tile, KV head, batch).  Blocks run row tile outermost,
// causal heaviest (last) first.  Warp w owns rows r0 + 16 w .. + 15 and
// walks the key tiles its block's rows can see through a cp.async ring of
// K and V tiles: S = Q K^T, dP = dO V^T, P and dS in registers, dQ += dS K
// (K's B fragments by ldmatrix.trans from the same tile).
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int B, int Sq, int Skv, int Hq, int Hkv,
                int G, int causal, int window, int q_offset, float scale) {
  using C = TcBwdCfg<HD>;
  constexpr int LD = C::LD, ROWS = C::ROWS, BK = C::BK;
  constexpr int KC = HD / 16;  // k16 chunks of S, dP
  constexpr int NT = BK / 8;   // n8 tiles of keys
  constexpr int DT = HD / 8;   // n8 tiles of dQ columns
  constexpr int CPR = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + ROWS * LD;
  bf16* ring = sdO + ROWS * LD;  // stage s: K, then V

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nbh = B * Hkv;
  const int t_rank = blockIdx.x / nbh;
  const int bh = blockIdx.x - t_rank * nbh;
  const int hk = bh % Hkv, b = bh / Hkv;
  const int R = Sq * G;
  const int nqt = (R + ROWS - 1) / ROWS;
  const int qt = causal ? nqt - 1 - t_rank : t_rank;
  const int r0 = qt * ROWS, row_end = min(R, r0 + ROWS);
  const int qa = q_offset + r0 / G, qb = q_offset + (row_end - 1) / G;
  const int kv_lo = window > 0 ? max(0, qa - window + 1) : 0;
  const int kv_hi = causal ? min(Skv, qb + 1) : Skv;
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;
  const long long kv_row = static_cast<long long>(Hkv) * HD;
  const bf16* kbase = k + static_cast<long long>(b) * Skv * kv_row + hk * HD;
  const bf16* vbase = v + static_cast<long long>(b) * Skv * kv_row + hk * HD;

  for (int e = tid; e < ROWS * CPR; e += kTcThreads) {
    const int r = e / CPR, c = (e - r * CPR) * 8;
    const int row = r0 + r;
    const bool in = row < row_end;
    const long long off = in ? row_offset(b, hk, row, G, Sq, Hq, HD) + c : 0;
    cp_async16(smem_u32(sQ + r * LD + c), q + off, in ? 16 : 0);
    cp_async16(smem_u32(sdO + r * LD + c), dout + off, in ? 16 : 0);
  }
  cp_async_commit();
  auto load_keys = [&](int t, int slot) {
    bf16* sK = ring + slot * (2 * BK * LD);
    bf16* sV = sK + BK * LD;
    const int t0 = kv_lo + t * BK;
    for (int e = tid; e < BK * CPR; e += kTcThreads) {
      const int j = e / CPR, c = (e - j * CPR) * 8;
      const bool in = t0 + j < kv_hi;
      const long long off = in ? (t0 + j) * kv_row + c : 0;
      cp_async16(smem_u32(sK + j * LD + c), kbase + off, in ? 16 : 0);
      cp_async16(smem_u32(sV + j * LD + c), vbase + off, in ? 16 : 0);
    }
  };
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < ntiles) load_keys(s, s);
    cp_async_commit();
  }

  // The thread's rows: wrow + gq and wrow + gq + 8.
  const int gq = lane >> 2, tig = lane & 3;
  const int wrow = warp * 16;
  const bool warp_live = r0 + wrow < row_end;
  float l2[2], dl[2];
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + wrow + gq + 8 * h;
    const bool in = row < row_end;
    const long long i = in ? row_stat(b, hk, row, G, Sq, Hq) : 0;
    l2[h] = in ? lse[i] * kLog2e : 0.f;
    dl[h] = in ? delta[i] : 0.f;
    pos[h] = q_offset + row / G;
  }
  cp_async_wait<kTcStages - 1>();  // Q and dO have landed
  __syncthreads();
  constexpr int RQ = C::REG ? KC : 1;
  uint32_t qf[RQ][4], of[RQ][4];
  if constexpr (C::REG) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      load_a<LD>(qf[kc], sQ, wrow, kc, lane);
      load_a<LD>(of[kc], sdO, wrow, kc, lane);
    }
  }
  const float sl2 = scale * kLog2e;
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kTcStages - 2>();  // key tile t has landed
    __syncthreads();                 // and every warp is done with t - 1
    {
      const int nt = t + kTcStages - 1;
      if (nt < ntiles) load_keys(nt, nt % kTcStages);
      cp_async_commit();
    }
    if (!warp_live) continue;
    const bf16* sK = ring + (t % kTcStages) * (2 * BK * LD);
    const bf16* sV = sK + BK * LD;
    const int t0 = kv_lo + t * BK;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa4[4], oa4[4];
      if constexpr (C::REG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa4[i] = qf[kc][i];
          oa4[i] = of[kc][i];
        }
      } else {
        load_a<LD>(qa4, sQ, wrow, kc, lane);
        load_a<LD>(oa4, sdO, wrow, kc, lane);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb4[4], vb4[4];
        load_b<LD>(kb4, sK, np * 16, kc, lane);
        load_b<LD>(vb4, sV, np * 16, kc, lane);
        mma_bf16(s[2 * np], qa4, kb4[0], kb4[1]);
        mma_bf16(s[2 * np + 1], qa4, kb4[2], kb4[3]);
        mma_bf16(dp[2 * np], oa4, vb4[0], vb4[1]);
        mma_bf16(dp[2 * np + 1], oa4, vb4[2], vb4[3]);
      }
    }

    // P and dS: element e of n tile n is row wrow + gq + 8 (e >> 1), key
    // t0 + 8 n + 2 tig + (e & 1).
    const bool need_mask = t0 + BK > kv_hi || r0 + ROWS > row_end ||
                           (causal && t0 + BK - 1 > qa) ||
                           (window > 0 && t0 <= qb - window);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = exp2_approx(fmaf(s[n][e], sl2, -l2[h]));
        if (need_mask) {
          const int key = t0 + n * 8 + 2 * tig + (e & 1);
          if (r0 + wrow + gq + 8 * h >= row_end || key >= kv_hi ||
              !pair_valid(key, pos[h], causal, window))
            p = 0.f;
        }
        dp[n][e] = p * (dp[n][e] - dl[h]);
      }

    // dQ += dS K: the keys are the k dimension.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t da4[4];
      acc_to_a(da4, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int dpr = 0; dpr < DT / 2; ++dpr) {
        uint32_t kb4[4];
        load_bt<LD>(kb4, sK, kc, dpr * 16, lane);
        mma_bf16(acc[2 * dpr], da4, kb4[0], kb4[1]);
        mma_bf16(acc[2 * dpr + 1], da4, kb4[2], kb4[3]);
      }
    }
  }
  cp_async_wait<0>();
  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + wrow + gq + 8 * h;
    if (row >= row_end) continue;
    bf16* dst = dq + row_offset(b, hk, row, G, Sq, Hq, HD) + 2 * tig;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// cudaFuncSetAttribute for the dynamic shared memory, once per device.
template <typename K>
int smem_attribute(K kernel, int bytes, int* done) {
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev] == 0) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    done[dev] = rc == 0 ? 1 : -rc;
  }
  return done[dev] == 1 ? 0 : -done[dev];
}

// float32: the CUDA-core kernels.
template <int HD>
int launch_f32(const float* q, const float* k, const float* v, const float* o,
               const float* dout, const float* lse, float* delta, float* dq,
               float* dk, float* dv, int B, int Sq, int Skv, int Hq, int Hkv,
               int causal, int window, int q_offset, float scale,
               cudaStream_t stream) {
  using C = BwdCfg<HD>;
  static int done_kv[kMaxDevices], done_q[kMaxDevices];
  int rc = smem_attribute(flash_bwd_dkdv<float, HD>, C::SMEM_KV, done_kv);
  if (rc != 0) return rc;
  rc = smem_attribute(flash_bwd_dq<float, HD>, C::SMEM_Q, done_q);
  if (rc != 0) return rc;
  const int G = Hq / Hkv;
  const long long rows = static_cast<long long>(B) * Sq * Hq;
  const long long R = static_cast<long long>(Sq) * G;
  const long long gd = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const long long gkv = (Skv + C::BK - 1) / C::BK;
  const long long gq = (R + C::BR - 1) / C::BR;
  if (gd > 2147483647LL || gq > 2147483647LL || R > 2147483647LL ||
      Hkv > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  flash_bwd_delta<float><<<static_cast<unsigned>(gd), kThreads, 0, stream>>>(
      o, dout, delta, rows, Sq, Hq, HD);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_bwd_dkdv<float, HD><<<dim3(static_cast<unsigned>(gkv), Hkv, B), kThreads,
                              C::SMEM_KV, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Skv, Hq, Hkv, G, causal, window,
      q_offset, scale);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_bwd_dq<float, HD><<<dim3(static_cast<unsigned>(gq), Hkv, B), kThreads,
                            C::SMEM_Q, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Skv, Hq, Hkv, G, causal, window,
      q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16: the tensor-core kernels.  Grids are one dimension, the tile
// index outermost (kernels/flash_attention/flash_attention_bwd.py::dkdv_order,
// dq_order).
template <int HD>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
              const bf16* dout, const float* lse, float* delta, bf16* dq,
              bf16* dk, bf16* dv, int B, int Sq, int Skv, int Hq, int Hkv,
              int causal, int window, int q_offset, float scale,
              cudaStream_t stream) {
  using C = TcBwdCfg<HD>;
  static int done_kv[kMaxDevices], done_q[kMaxDevices];
  int rc = smem_attribute(flash_bwd_dkdv_tc<HD>, C::SMEM_KV, done_kv);
  if (rc != 0) return rc;
  rc = smem_attribute(flash_bwd_dq_tc<HD>, C::SMEM_Q, done_q);
  if (rc != 0) return rc;
  const int G = Hq / Hkv;
  const long long rows = static_cast<long long>(B) * Sq * Hq;
  const long long R = static_cast<long long>(Sq) * G;
  const long long gd = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const long long bh = static_cast<long long>(B) * Hkv;
  const long long gkv = (Skv + C::KEYS - 1) / C::KEYS * bh * C::NSPLIT;
  const long long gq = (R + C::ROWS - 1) / C::ROWS * bh;
  if (gd > 2147483647LL || gq > 2147483647LL || gkv > 2147483647LL ||
      R > 2147483647LL)
    return cudaErrorInvalidValue;
  flash_bwd_delta<bf16><<<static_cast<unsigned>(gd), kThreads, 0, stream>>>(
      o, dout, delta, rows, Sq, Hq, HD);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_bwd_dkdv_tc<HD><<<static_cast<unsigned>(gkv), kTcThreads, C::SMEM_KV,
                          stream>>>(q, k, v, dout, lse, delta, dk, dv, B, Sq,
                                    Skv, Hq, Hkv, G, causal, window, q_offset,
                                    scale);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_bwd_dq_tc<HD><<<static_cast<unsigned>(gq), kTcThreads, C::SMEM_Q,
                        stream>>>(q, k, v, dout, lse, delta, dq, B, Sq, Skv,
                                  Hq, Hkv, G, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, float* delta,
              void* dq, void* dk, void* dv, int B, int Sq, int Skv, int Hq,
              int Hkv, int causal, int window, int q_offset, float scale,
              cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<HD>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), B, Sq, Skv, Hq, Hkv,
        causal, window, q_offset, scale, stream);
  if (dtype == 1)
    return launch_tc<HD>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sq, Skv, Hq, Hkv,
        causal, window, q_offset, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, o, dout, dq (B, Sq, Hq, hd); k, v, dk, dv (B, Skv, Hkv, hd); all
// contiguous and of one type: dtype 0 float32 (CUDA-core kernels), 1
// bfloat16 (tensor-core kernels).  lse (B, Hq, Sq) float32 from the forward
// (natural log of the row's softmax denominator of scale * q . k); delta
// float32 scratch of the same shape.  hd in {16, 32, 64, 112, 128, 256}; Hq
// a multiple of Hkv with Hq / Hkv <= 128; window <= 0 means none;
// q_offset >= 0.  Returns cudaGetLastError() after the launches.
int flash_attention_bwd(int dtype, const void* q, const void* k,
                        const void* v, const void* o, const void* dout,
                        const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
                        int hd, int causal, int window, int q_offset,
                        float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > 128 || q_offset < 0 || lse == nullptr || delta == nullptr ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
#define FLASH_BWD_HD(D)                                                       \
  case D:                                                                     \
    return launch_hd<D>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, B,   \
                        Sq, Skv, Hq, Hkv, causal, window, q_offset, scale, st);
  switch (hd) {
    FLASH_BWD_HD(16) FLASH_BWD_HD(32) FLASH_BWD_HD(64) FLASH_BWD_HD(112)
    FLASH_BWD_HD(128) FLASH_BWD_HD(256)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_HD
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
