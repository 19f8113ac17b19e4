// Flash attention backward: dq, dk, dv of grouped-query attention with a
// causal mask, an optional sliding window and a query offset, from the
// forward's output o and its per-row log-sum-exp, float32 or bfloat16 in and
// the same type out, float32 inside.
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
// blocks.
//
// What bounds it on an H100: 10 hd flops per valid (query head, key) pair
// (the least work: s, dp, dv, dk and dq, 2 hd each) at 989 TFLOP/s in bf16,
// against reading q, k, v, o, dO and lse and writing dq, dk, dv once at
// 3.35 TB/s; at training shapes the flops.
//
// The design is the simple one, right first: every product runs as FP32
// FMAs on the CUDA cores, operands widened to float32 in shared memory, with
// register micro-tiles (4 x 4 outputs a thread where the tile allows).  Three
// kernels under one call, in a fixed order and without atomics, so two
// launches give the same bits:
//
// * flash_bwd_delta: delta (B, Hq, Sq) = rowsum(dO * O) in float32, a warp
//   a row, lanes summed by a fixed shuffle tree.
// * flash_bwd_dkdv: one block per (key tile, KV head, batch).  It keeps its
//   BK keys' K and V (transposed) and the dK, dV accumulators in registers,
//   and walks the query tiles that can see its keys (causal: from the
//   tile's first key on; window: up to its last key + window): per tile it
//   recomputes S = Q K^T and dP = dO V^T, forms P and dS in shared memory,
//   and adds dV += P^T dO, dK += dS^T Q.
// * flash_bwd_dq: one block per (query tile, KV head, batch), walking the
//   key tiles its rows can see and adding dQ += dS K.
//
// Tiles: 64 rows x 64 keys at hd <= 64; 32 x 64 at hd 112 and 128; 16 x 32
// at hd 256, where a 64-key tile's float32 dK and dV accumulators alone
// would take 128 KB.  Shared memory rows are padded by 4 floats.  Making it
// fast (mma.sync or wgmma on bf16 operands, TMA) is later work.
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
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

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

template <typename T, int HD>
int launch_hd(const T* q, const T* k, const T* v, const T* o, const T* dout,
              const float* lse, float* delta, T* dq, T* dk, T* dv, int B,
              int Sq, int Skv, int Hq, int Hkv, int causal, int window,
              int q_offset, float scale, cudaStream_t stream) {
  using C = BwdCfg<HD>;
  static int done_kv[kMaxDevices], done_q[kMaxDevices];
  int rc = smem_attribute(flash_bwd_dkdv<T, HD>, C::SMEM_KV, done_kv);
  if (rc != 0) return rc;
  rc = smem_attribute(flash_bwd_dq<T, HD>, C::SMEM_Q, done_q);
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
  flash_bwd_delta<T><<<static_cast<unsigned>(gd), kThreads, 0, stream>>>(
      o, dout, delta, rows, Sq, Hq, HD);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_bwd_dkdv<T, HD><<<dim3(static_cast<unsigned>(gkv), Hkv, B), kThreads,
                          C::SMEM_KV, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Skv, Hq, Hkv, G, causal, window,
      q_offset, scale);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_bwd_dq<T, HD><<<dim3(static_cast<unsigned>(gq), Hkv, B), kThreads,
                        C::SMEM_Q, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Skv, Hq, Hkv, G, causal, window,
      q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
           int hd, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
#define FLASH_BWD_HD(D)                                                       \
  case D:                                                                     \
    return launch_hd<T, D>(                                                   \
        static_cast<const T*>(q), static_cast<const T*>(k),                   \
        static_cast<const T*>(v), static_cast<const T*>(o),                   \
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),         \
        static_cast<T*>(dk), static_cast<T*>(dv), B, Sq, Skv, Hq, Hkv,        \
        causal, window, q_offset, scale, stream);
  switch (hd) {
    FLASH_BWD_HD(16) FLASH_BWD_HD(32) FLASH_BWD_HD(64) FLASH_BWD_HD(112)
    FLASH_BWD_HD(128) FLASH_BWD_HD(256)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_HD
}

}  // namespace

extern "C" {

// q, o, dout, dq (B, Sq, Hq, hd); k, v, dk, dv (B, Skv, Hkv, hd); all
// contiguous and of one type: dtype 0 float32, 1 bfloat16.  lse (B, Hq, Sq)
// float32 from the forward (natural log of the row's softmax denominator
// of scale * q . k); delta float32 scratch of the same shape.  hd in {16,
// 32, 64, 112, 128, 256}; Hq a multiple of Hkv with Hq / Hkv <= 128;
// window <= 0 means none; q_offset >= 0.  Returns cudaGetLastError() after
// the launches.
int flash_attention_bwd(int dtype, const void* q, const void* k,
                        const void* v, const void* o, const void* dout,
                        const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
                        int hd, int causal, int window, int q_offset,
                        float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > 128 || q_offset < 0 || lse == nullptr || delta == nullptr)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv,
                         Hq, Hkv, hd, causal, window, q_offset, scale, st);
  if (dtype == 1)
    return launch<bf16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv,
                        Hq, Hkv, hd, causal, window, q_offset, scale, st);
  return cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
