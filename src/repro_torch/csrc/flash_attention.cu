// Flash attention forward: grouped-query attention with a causal mask, an
// optional sliding window and a query offset, q (B, Sq, Hq, hd) against
// k, v (B, Skv, Hkv, hd), float32 or bfloat16 in, the same type out.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py (_flash_kernel /
// flash_attention_pallas) and computes the same function: scores
// (q * 1/sqrt(hd)) . k, query head h reading KV head h / (Hq / Hkv), masked
// scores set to -1e30, an online softmax with a running max m, denominator l
// and float32 accumulator, and the output acc / max(l, 1e-30).  Query i sits
// at absolute position q_offset + i and key j at j; a key is valid when
// j <= pos (causal) and j > pos - window (window > 0).  A row with no valid
// key gets the uniform average over all Skv keys, as the reference's
// all -1e30 softmax does.  Unlike the TPU kernel, ragged Sq and Skv are
// masked at the edge rather than asserted away.
//
// What bounds it on an H100: at prefill, arithmetic (4 * B * Hq * Sq * Skv
// * hd flops, halved by causality); at decode (Sq = 1), reading K and V once.
// This first version computes on the CUDA cores in FP32 (no tensor cores, so
// no TF32 either: float32 operands meet the reference's 2e-5), far from the
// bf16 tensor-core bound; wgmma and TMA are later work.
//
// Design: one block per (query tile, KV head, batch) with 128 threads.  The
// tile packs BQ query positions x the G query heads that share the KV head
// into rows, so each K/V tile staged in shared memory (converted to float32)
// serves all G heads: K and V are read once per group.  Each row is owned by
// NS threads (NS a power of two, NS * rows <= 128), each taking every NS-th
// key of a tile with its own (m, l, acc); the splits merge through warp
// shuffles at the end.  At prefill (G = 8, BQ = 16) NS = 1; at decode (one
// position, 8 rows) NS = 16 spreads the cache walk over the block.  A thread
// keeps its query row and accumulator in registers and updates the softmax
// once per chunk of kChunk keys.  Blocks skip key tiles that causality or
// the window masks for all their rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 8;
constexpr float kMasked = -1e30f;  // the reference's NEG_INF

template <int HD>
struct Tile {
  static constexpr int BK = HD <= 64 ? 64 : 32;  // keys per staged tile
  static constexpr int LD = HD + 4;  // row pad: 16-byte rows, no conflicts
};

__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float2 f0 = __bfloat1622float2(h[0]);
  float2 f1 = __bfloat1622float2(h[1]);
  float2 f2 = __bfloat1622float2(h[2]);
  float2 f3 = __bfloat1622float2(h[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(f0.x, f0.y, f1.x, f1.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f2.x, f2.y, f3.x, f3.y);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv, int Hq,
          int Hkv, int G, int BQ, int NS, int causal, int window,
          int q_offset, float scale) {
  constexpr int BK = Tile<HD>::BK, LD = Tile<HD>::LD;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  __shared__ __align__(16) float sK[BK][LD];
  __shared__ __align__(16) float sV[BK][LD];

  const int tid = threadIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int rows = BQ * G;
  const int row = tid / NS, split = tid - (tid / NS) * NS;
  const int qi = row / G, g = row - (row / G) * G;
  const bool live = row < rows && q0 + qi < Sq;
  const int qpos = q_offset + q0 + qi;
  const long long qoff =
      ((static_cast<long long>(b) * Sq + q0 + qi) * Hq + hk * G + g) * HD;

  float qr[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = live ? to_f32(q[qoff + d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = kMasked, l = 0.f;

  // Keys any row of this block can see.  A window can leave a row with no
  // valid key (pos >= Skv + window - 1); such a row averages all keys, so
  // the block then walks them all with every score masked.
  const int qa = q_offset + q0;
  const int qb = q_offset + min(q0 + BQ, Sq) - 1;
  int kv_lo = window > 0 ? max(0, qa - window + 1) : 0;
  int kv_hi = causal ? min(Skv, qb + 1) : Skv;
  if (window > 0 && qb >= Skv + window - 1) {
    kv_lo = 0;
    kv_hi = Skv;
  }

  for (int t0 = kv_lo; t0 < kv_hi; t0 += BK) {
    const int nt = min(BK, kv_hi - t0);
    __syncthreads();
    for (int e = tid; e < nt * PER_ROW; e += kThreads) {
      const int j = e / PER_ROW, c = (e - j * PER_ROW) * VEC;
      const long long off =
          ((static_cast<long long>(b) * Skv + t0 + j) * Hkv + hk) * HD + c;
      load16(k + off, &sK[j][c]);
      load16(v + off, &sV[j][c]);
    }
    __syncthreads();
    if (!live) continue;
    for (int c0 = split; c0 < nt; c0 += NS * kChunk) {
      float s[kChunk];
      float mx = m;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int key = c0 + NS * j;
        if (key < nt) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < HD; d += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(&sK[key][d]);
            dot = fmaf(qr[d], kk.x, dot);
            dot = fmaf(qr[d + 1], kk.y, dot);
            dot = fmaf(qr[d + 2], kk.z, dot);
            dot = fmaf(qr[d + 3], kk.w, dot);
          }
          const int kpos = t0 + key;
          const bool ok = (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          s[j] = ok ? dot : kMasked;
        } else {
          s[j] = -__int_as_float(0x7f800000);  // -inf: no key, weight 0
        }
        mx = fmaxf(mx, s[j]);
      }
      const float corr = expf(m - mx);
      l *= corr;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int key = c0 + NS * j;
        if (key < nt) {
          const float p = expf(s[j] - mx);
          l += p;
#pragma unroll
          for (int d = 0; d < HD; d += 4) {
            const float4 vv = *reinterpret_cast<const float4*>(&sV[key][d]);
            acc[d] = fmaf(p, vv.x, acc[d]);
            acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
            acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
            acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
          }
        }
      }
      m = mx;
    }
  }

  // Merge the NS splits of a row: they are NS consecutive lanes of one warp.
  if (NS > 1) {
    float mall = m;
    for (int off = NS >> 1; off > 0; off >>= 1)
      mall = fmaxf(mall, __shfl_xor_sync(0xffffffffu, mall, off));
    const float w = expf(m - mall);
    l *= w;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= w;
    for (int off = NS >> 1; off > 0; off >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
      for (int d = 0; d < HD; ++d)
        acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
    }
  }
  if (live && split == 0) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD; ++d) store(o + qoff + d, acc[d] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int Hq, int Hkv, int hd, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  int BQ = kThreads / G;
  BQ = BQ < 1 ? 1 : (BQ > Sq ? Sq : BQ);
  const int rows = BQ * G;
  int NS = 1;
  while (NS < 32 && rows * NS * 2 <= kThreads) NS *= 2;
  const long long gx = (Sq + BQ - 1) / BQ;
  if (gx > 2147483647LL || Hkv > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(gx), Hkv, B);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
#define FLASH_HD(D)                                                          \
  case D:                                                                    \
    flash_fwd<D, T><<<grid, kThreads, 0, stream>>>(                          \
        qq, kk, vv, oo, Sq, Skv, Hq, Hkv, G, BQ, NS, causal, window,         \
        q_offset, scale);                                                    \
    break;
  switch (hd) {
    FLASH_HD(16) FLASH_HD(32) FLASH_HD(64) FLASH_HD(128)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_HD
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd), o like q, all contiguous and
// 16-byte aligned, of one type: dtype 0 float32, 1 bfloat16.  hd in
// {16, 32, 64, 128}; Hq a multiple of Hkv with Hq / Hkv <= 128; window <= 0
// means none; q_offset >= 0.  Returns cudaGetLastError() after the launch.
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, int B, int Sq, int Skv,
                        int Hq, int Hkv, int hd, int causal, int window,
                        int q_offset, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > kThreads || q_offset < 0)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, hd, causal, window,
                         q_offset, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, hd, causal,
                                 window, q_offset, scale, st);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
