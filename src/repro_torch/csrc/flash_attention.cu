// Flash attention forward: grouped-query attention with a causal mask, an
// optional sliding window and a query offset, q (B, Sq, Hq, hd) against
// k, v (B, Skv, Hkv, hd), float32 or bfloat16 in, the same type out.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:100 (_flash_kernel /
// flash_attention_pallas) and computes the same function: scores
// (q * 1/sqrt(hd)) . k, query head h reading KV head h / (Hq / Hkv), masked
// scores set to -1e30, an online softmax with a running max m, denominator l
// and float32 accumulator, and the output acc / max(l, 1e-30).  Query i sits
// at absolute position q_offset + i and key j at j; a key is valid when
// j <= pos (causal) and j > pos - window (window > 0).  Keys past the end of
// the range a block walks (the ragged edge) score -inf, so they weigh 0.  A
// row with no valid key gets the uniform average over all Skv keys, as the
// reference's all -1e30 softmax does.  Unlike the TPU kernel, ragged Sq and
// Skv are masked at the edge rather than asserted away.  Given an lse
// pointer, each kernel (or, when the keys are split, the merge) also writes
// each row's log-sum-exp, m + log l in natural-log units, which the backward
// (flash_attention_bwd.cu) reads; the serving path passes null.
//
// The dtype picks the kernel, explicitly, in flash_attention_fwd below:
//
// * bfloat16 (the serving path) runs on the tensor cores (flash_fwd_tc).
// * float32 keeps the first, CUDA-core kernel (flash_fwd_f32): FP32 FMAs
//   without TF32.  TF32 tensor cores keep ~3 decimal digits and cannot meet
//   the reference's 2e-5; the float32 operands are the comparison cases and
//   the whole-model float32 check.  This is a choice by type, not a fallback:
//   a bfloat16 operand always goes to the tensor-core kernel, and a build or
//   launch that fails raises in the wrapper.
//
// What bounds it on an H100: at prefill, arithmetic (4 * B * Hq * Sq * Skv
// * hd flops, halved by causality, at 989 TFLOP/s in bf16); at decode
// (Sq = 1), reading K and V once (3.35 TB/s).  The first version ran every
// product as FP32 FMAs with one query row per thread, widened K/V to float32
// in shared memory, staged synchronously and, at decode, ran only B x Hkv =
// 16 blocks: 1.213 ms at tinyllama's prefill against SDPA's 0.085 ms, 0.043
// ms at decode against 0.0071 ms (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// The bfloat16 design (FlashAttention-2, adapted to GQA):
//
// * Rows.  A block of 4 warps owns 128 query rows, each warp two m16 tiles
//   (M of mma.sync.m16n8k16: bf16 in, fp32 accumulate, inline PTX), so a
//   K or V fragment read from shared memory feeds two products and each
//   warp has twice the independent work.  hd = 128 (registers) and calls
//   with at most 64 rows (decode) take one m16 tile a warp, 64 rows a
//   block.  Rows are the flattened (position, query head of the group)
//   index of one KV head, row = i * G + g, so one staged K/V tile serves
//   all G heads that share it (K and V are read once per group, not G
//   times) and any G fits; L2 would serve G re-reads otherwise.
// * Q.  Loaded once through shared memory into ldmatrix A fragments and
//   kept in registers for the whole walk over keys.  The 1/sqrt(hd) scale
//   is applied to S in fp32 (times log2 e, for exp2), not folded into the
//   bf16 Q, so it adds no bf16 rounding: the only roundings are the inputs'
//   and P's.
// * K/V.  Tiles of 64 keys x hd stay bf16 in shared memory, each row
//   padded by 16 bytes so ldmatrix (K) and ldmatrix.trans (V) are free of
//   bank conflicts.  A 3-stage cp.async ring (16-byte cp.async.cg,
//   commit_group / wait_group) keeps two tiles in flight while one is
//   computed; Q is staged in the last slot before the ring reaches it.
//   hd = 128 takes 104 KB of dynamic shared memory (attribute set once).
// * Softmax.  S accumulates in fp32 registers; the online softmax runs on
//   them, with row max across the 4 lanes of a quad by __shfl_xor_sync and
//   the row sum kept per lane until the end.  P is rounded to bf16 in
//   registers and used directly as the A fragment of P.V.
// * Masks only on tiles that straddle the causal or window edge or the
//   ragged end; tiles masked for every row are never walked.  Causal q
//   tiles launch heaviest first (blockIdx.x reversed).
// * Head dims 16, 32, 64, 112, 128 and 256.  hd 112 (zamba2) is seven k16
//   chunks of Q . K^T, an odd count, which no loop pairs; O's 14 n8 tiles
//   pair into 7 ldmatrix.x4.trans loads of V; its 240-byte padded rows
//   keep ldmatrix free of bank conflicts (rows fall 112 bytes apart mod 128).
//   hd 256 (gemma3) keeps Q in shared memory (TcCfg), and the float32
//   kernel splits its rows' columns over two lanes.
// * K and V may be views of the first Skv slots of a longer cache (whisper's
//   cross-attention cache, padded to 1536 slots, read over its 1500): rows
//   are contiguous within a batch row, batch rows kv_bstride elements apart,
//   so no copy of the view is made.
// * Split-KV.  When the grid would not fill the card (decode: one position
//   x G heads per (batch, KV head)), the wrapper's plan cuts the keys into
//   nsplit ranges of split_len (a multiple of the tile): grid (q tiles x
//   nsplit, Hkv, B).  Each split writes its partial (m, l, acc) in fp32 to
//   scratch the wrapper allocates; a second kernel in this entry point
//   merges the splits in a fixed order (no atomics).  A split with no
//   keys writes l = 0, m = -inf and weighs 0; a split whose keys are all
//   masked writes m = -1e30 and weighs exp(-1e30 - M) = 0 beside a valid
//   key, 1 when no split has one (the uniform average again).
//
// Measured (NVIDIA H100 80GB HBM3, power limit 700 W; chip_smoke.py phase 7
// and benchmarks/torch_kernel_ab.py, CUDA events behind a device sleep):
// prefill (4, 1024, 32/4, 64) causal 0.096 ms against SDPA's 0.063 ms and
// the first version's 1.097 ms by the same timer (~180 TFLOP/s of the 17.2
// GFLOP); llama3.2-3b's heads (hd 128) 0.153 ms against 0.068 ms; decode
// against a 1056-slot cache 0.0080 ms replayed from a CUDA graph against
// 0.0068 ms (first version: 0.0431 ms).  What sets the pace now, by a
// count of the bytes (not profiled): every warp reads each K/V fragment
// from shared memory through ldmatrix, 16 KB a 64-key tile at hd 64 for
// two m16 tiles and twice that per product at hd 128, where two tiles
// spill registers.  wgmma, which reads its shared-memory operand once per
// warpgroup, is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// Keys [lo, hi) that some row of a block with query positions [qa, qb] can
// see.  A window can leave a row with no valid key (pos >= Skv + window -
// 1); such a row averages all keys, so the block then walks them all with
// every score masked (walk_all).
struct KeyRange {
  int lo, hi;
  bool walk_all;
};

__device__ __forceinline__ KeyRange block_keys(int qa, int qb, int Skv,
                                               int causal, int window) {
  KeyRange r;
  r.walk_all = window > 0 && qb >= Skv + window - 1;
  r.lo = r.walk_all || window <= 0 ? 0 : max(0, qa - window + 1);
  r.hi = r.walk_all || !causal ? Skv : min(Skv, qb + 1);
  return r;
}

// ---------------------------------------------------------------------------
// float32: FP32 FMAs on the CUDA cores (the first version's kernel).
//
// One block per (query tile, KV head, batch) with 128 threads packs BQ
// positions x the G query heads of a KV head into rows; each row is owned by
// NS threads that take every NS-th key and merge by warp shuffles.
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 128;  // threads per block for each column split
constexpr int kChunk = 8;

template <int HD>
struct F32Tile {
  // hd 256 splits a row's columns over two lanes (DS), so no thread holds
  // more than 128 query and 128 accumulator values; its key tile is 16 keys
  // so the two static tiles stay under the 48 KB static limit.
  static constexpr int DS = HD > 128 ? 2 : 1;    // column split of a row
  static constexpr int HP = HD / DS;             // columns a thread holds
  static constexpr int BK = HD <= 64 ? 64 : (HD <= 128 ? 32 : 16);  // keys a tile
  static constexpr int LD = HD + 4;  // row pad: 16-byte rows, no conflicts
};

template <int HD>
__global__ void __launch_bounds__(kF32Threads * F32Tile<HD>::DS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv, int G,
              int BQ, int NS, int causal, int window, int q_offset, float scale,
              long long kv_bstride) {
  constexpr int BK = F32Tile<HD>::BK, LD = F32Tile<HD>::LD;
  constexpr int DS = F32Tile<HD>::DS, HP = F32Tile<HD>::HP;
  constexpr int PER_ROW = HD / 4;
  constexpr int NTHREADS = kF32Threads * DS;
  __shared__ __align__(16) float sK[BK][LD];
  __shared__ __align__(16) float sV[BK][LD];

  const int tid = threadIdx.x;
  // thread = (row * NS + split) * DS + half: a row's NS * DS threads are
  // consecutive lanes of one warp, the two halves of a column split adjacent.
  const int half = tid % DS, t2 = tid / DS;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int rows = BQ * G;
  const int row = t2 / NS, split = t2 - (t2 / NS) * NS;
  const int qi = row / G, g = row - (row / G) * G;
  const bool live = row < rows && q0 + qi < Sq;
  const int qpos = q_offset + q0 + qi;
  const long long qoff =
      ((static_cast<long long>(b) * Sq + q0 + qi) * Hq + hk * G + g) * HD +
      half * HP;
  const unsigned pair = DS == 2 ? 3u << ((tid & 31) & ~1) : 0u;

  float qr[HP], acc[HP];
#pragma unroll
  for (int d = 0; d < HP; ++d) {
    qr[d] = live ? q[qoff + d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = kMasked, l = 0.f;

  const KeyRange keys = block_keys(q_offset + q0, q_offset + min(q0 + BQ, Sq) - 1,
                                   Skv, causal, window);
  const int kv_lo = keys.lo, kv_hi = keys.hi;
  const float* kb = k + static_cast<long long>(b) * kv_bstride;
  const float* vb = v + static_cast<long long>(b) * kv_bstride;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += BK) {
    const int nt = min(BK, kv_hi - t0);
    __syncthreads();
    for (int e = tid; e < nt * PER_ROW; e += NTHREADS) {
      const int j = e / PER_ROW, c = (e - j * PER_ROW) * 4;
      const long long off = (static_cast<long long>(t0 + j) * Hkv + hk) * HD + c;
      *reinterpret_cast<float4*>(&sK[j][c]) =
          *reinterpret_cast<const float4*>(kb + off);
      *reinterpret_cast<float4*>(&sV[j][c]) =
          *reinterpret_cast<const float4*>(vb + off);
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
          for (int d = 0; d < HP; d += 4) {
            const float4 kk =
                *reinterpret_cast<const float4*>(&sK[key][half * HP + d]);
            dot = fmaf(qr[d], kk.x, dot);
            dot = fmaf(qr[d + 1], kk.y, dot);
            dot = fmaf(qr[d + 2], kk.z, dot);
            dot = fmaf(qr[d + 3], kk.w, dot);
          }
          // both halves of a split row take the same key: a + b == b + a,
          // so they hold the same score bits
          if (DS == 2) dot += __shfl_xor_sync(pair, dot, 1);
          const int kpos = t0 + key;
          const bool ok = (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          s[j] = ok ? dot : kMasked;
        } else {
          s[j] = neg_inf();  // no key: weight 0
        }
        mx = fmaxf(mx, s[j]);
      }
      const float corr = expf(m - mx);
      l *= corr;
#pragma unroll
      for (int d = 0; d < HP; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int key = c0 + NS * j;
        if (key < nt) {
          const float p = expf(s[j] - mx);
          l += p;
#pragma unroll
          for (int d = 0; d < HP; d += 4) {
            const float4 vv =
                *reinterpret_cast<const float4*>(&sV[key][half * HP + d]);
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

  // Merge the NS splits of a row: lanes DS apart in one warp.
  float mrow = m;
  if (NS > 1) {
    float mall = m;
    for (int off = NS >> 1; off > 0; off >>= 1)
      mall = fmaxf(mall, __shfl_xor_sync(0xffffffffu, mall, off * DS));
    const float w = expf(m - mall);
    mrow = mall;
    l *= w;
#pragma unroll
    for (int d = 0; d < HP; ++d) acc[d] *= w;
    for (int off = NS >> 1; off > 0; off >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off * DS);
#pragma unroll
      for (int d = 0; d < HP; ++d)
        acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off * DS);
    }
  }
  if (live && split == 0) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < HP; ++d) o[qoff + d] = acc[d] * inv;
    // the row's log-sum-exp (B, Hq, Sq), for the backward
    if (lse != nullptr && half == 0)
      lse[(static_cast<long long>(b) * Hq + hk * G + g) * Sq + q0 + qi] =
          mrow + logf(fmaxf(l, 1e-30f));
  }
}

template <int HD>
int launch_f32_hd(const float* q, const float* k, const float* v, float* o,
                  float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                  int window, int q_offset, float scale, long long kv_bstride,
                  cudaStream_t stream) {
  constexpr int DS = F32Tile<HD>::DS;
  const int G = Hq / Hkv;
  int BQ = kF32Threads / G;
  BQ = BQ < 1 ? 1 : (BQ > Sq ? Sq : BQ);
  const int rows = BQ * G;
  int NS = 1;
  while (NS < 32 / DS && rows * NS * 2 <= kF32Threads) NS *= 2;
  const long long gx = (Sq + BQ - 1) / BQ;
  if (gx > 2147483647LL || Hkv > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  flash_fwd_f32<HD><<<dim3(static_cast<unsigned>(gx), Hkv, B),
                      kF32Threads * DS, 0, stream>>>(
      q, k, v, o, lse, Sq, Skv, Hq, Hkv, G, BQ, NS, causal, window, q_offset,
      scale, kv_bstride);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const float* q, const float* k, const float* v, float* o,
               float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
               int window, int q_offset, float scale, long long kv_bstride,
               cudaStream_t stream) {
#define FLASH_F32_HD(D)                                                      \
  case D:                                                                    \
    return launch_f32_hd<D>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, causal, window, \
                            q_offset, scale, kv_bstride, stream);
  switch (hd) {
    FLASH_F32_HD(16) FLASH_F32_HD(32) FLASH_F32_HD(64) FLASH_F32_HD(112)
    FLASH_F32_HD(128) FLASH_F32_HD(256)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_F32_HD
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async K/V ring, split-KV.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // 4 warps
constexpr int kBK = 64;          // keys per tile

// hd <= 128 keeps Q in registers and stages it in the last slot of a
// 3-stage K/V ring.  hd 256 cannot: O's accumulator alone is 128 registers
// a lane, and Q's fragments would add 64.  So Q stays in shared memory in
// a slot of its own and each k16 chunk's fragment is re-read by ldmatrix
// before its products; three stages of K + V (202,752 bytes) leave no room
// for that slot, so the ring has two (169 KB with Q).
template <int HD, int MT>
struct TcCfg {
  static constexpr bool QS = HD > 128;           // Q read from shared memory
  static constexpr int STAGES = QS ? 2 : 3;      // cp.async ring depth
  static constexpr int LD = HD + 8;              // bf16 per row: 16-byte pad
  static constexpr int TILE = kBK * LD;          // bf16 per K (or V) tile
  static constexpr int QROWS = QS ? 4 * 16 * MT : 0;  // Q's own slot
  static constexpr int SMEM = (STAGES * 2 * TILE + QROWS * LD) * 2;  // bytes
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

// Output row r of (batch b, KV head hk) is query position r / G, head
// hk * G + r % G.
__device__ __forceinline__ long long out_offset(int b, int hk, int row, int G,
                                                int Sq, int Hq, int hd) {
  const int qi = row / G, g = row - qi * G;
  return ((static_cast<long long>(b) * Sq + qi) * Hq + hk * G + g) * hd;
}

// Index of row r's log-sum-exp in lse (B, Hq, Sq).
__device__ __forceinline__ long long row_stat(int b, int hk, int row, int G,
                                              int Sq, int Hq) {
  const int qi = row / G, g = row - qi * G;
  return (static_cast<long long>(b) * Hq + hk * G + g) * Sq + qi;
}

template <int HD, int MT>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, float* __restrict__ part_m,
             float* __restrict__ part_l,
             float* __restrict__ part_acc, int Sq, int Skv, int Hq, int Hkv,
             int G, int causal, int window, int q_offset, float scale,
             int nsplit, int split_len, long long kv_bstride) {
  using Cfg = TcCfg<HD, MT>;
  constexpr int LD = Cfg::LD, TILE = Cfg::TILE, kStages = Cfg::STAGES;
  constexpr bool QS = Cfg::QS;
  constexpr int ROWS = 4 * 16 * MT;  // rows per block: MT m16 tiles per warp
  constexpr int KC = HD / 16;   // 16-wide hd chunks of Q . K^T (7 at hd 112)
  constexpr int NT = kBK / 8;   // 8-key n-tiles of S
  constexpr int DT = HD / 8;    // 8-wide hd n-tiles of O (even: 14 at hd 112)
  constexpr int CPR = HD / 8;   // 16-byte chunks per row
  constexpr int QKC = QS ? 1 : KC;  // Q fragments held in registers
  static_assert(HD % 16 == 0 && DT % 2 == 0, "hd: whole k16 chunks, n8 pairs");
  static_assert(QS || ROWS <= 2 * kBK, "Q must fit one ring slot");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);  // slot s: K, then V

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int R = Sq * G;
  const int nqt = (R + ROWS - 1) / ROWS;
  const int tile_idx = blockIdx.x / nsplit;
  const int split = blockIdx.x - tile_idx * nsplit;
  const int qt = causal ? nqt - 1 - tile_idx : tile_idx;  // heaviest first
  const int r0 = qt * ROWS;
  const int qa = q_offset + r0 / G;
  const int qb = q_offset + (min(r0 + ROWS, R) - 1) / G;

  // Keys any row of this block can see, cut to this block's split.
  const KeyRange keys = block_keys(qa, qb, Skv, causal, window);
  const bool walk_all = keys.walk_all;
  int kv_lo = keys.lo, kv_hi = keys.hi;
  if (nsplit > 1) {
    kv_lo = max(kv_lo, split * split_len);
    kv_hi = min(kv_hi, split * split_len + split_len);
  }
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kBK - 1) / kBK : 0;

  const long long kv_row = static_cast<long long>(Hkv) * HD;
  const bf16* kbase = k + static_cast<long long>(b) * kv_bstride + hk * HD;
  const bf16* vbase = v + static_cast<long long>(b) * kv_bstride + hk * HD;

  // Q goes to the last ring slot, which the ring first fills with tile
  // kStages - 1, after Q is in registers; at hd 256 to its own slot.
  bf16* sQ = smem + (QS ? 2 * kStages : 2 * (kStages - 1)) * TILE;
  for (int e = tid; e < ROWS * CPR; e += kTcThreads) {
    const int r = e / CPR, c = (e - r * CPR) * 8;
    const int row = r0 + r;
    const bf16* src = q;
    int bytes = 0;
    if (row < R) {
      src = q + out_offset(b, hk, row, G, Sq, Hq, HD) + c;
      bytes = 16;
    }
    cp_async16(smem_u32(sQ + r * LD + c), src, bytes);
  }
  cp_async_commit();
  auto load_tile = [&](int t, int slot) {
    const int t0 = kv_lo + t * kBK;
    bf16* sK = smem + (2 * slot) * TILE;
    bf16* sV = sK + TILE;
    for (int e = tid; e < kBK * CPR; e += kTcThreads) {
      const int j = e / CPR, c = (e - j * CPR) * 8;
      const int key = t0 + j;
      const bool in = key < kv_hi;
      const long long off = in ? key * kv_row + c : 0;
      cp_async16(smem_u32(sK + j * LD + c), kbase + off, in ? 16 : 0);
      cp_async16(smem_u32(sV + j * LD + c), vbase + off, in ? 16 : 0);
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }

  cp_async_wait<kStages - 1>();  // Q has landed
  __syncthreads();
  const int wrow = warp * 16 * MT;
  const bool warp_live = r0 + wrow < R;
  uint32_t qf[MT][QKC][4];
  auto load_q = [&](int mt, int kc, uint32_t (&r)[4]) {
    ldmatrix_x4(r, smem_u32(sQ + (wrow + mt * 16 + (lane & 15)) * LD +
                            kc * 16 + (lane >> 4) * 8));
  };
  if constexpr (!QS) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) load_q(mt, kc, qf[mt][kc]);
  }

  // Thread rows: m tile mt, half h -> row wrow + 16 mt + 8 h + lane / 4.
  const int gq = lane >> 2, tig = lane & 3;
  int pos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pos[mt][h] = q_offset + (r0 + wrow + mt * 16 + h * 8 + gq) / G;
  const float sl2 = scale * kLog2e;  // scores in log2 units
  float m[MT][2], l[MT][2], oacc[MT][DT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = kMasked;
      l[mt][h] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mt][d][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // and every warp is done with tile t - 1
    {
      const int nt = t + kStages - 1;
      if (nt < ntiles) load_tile(nt, nt % kStages);
      cp_async_commit();
    }
    if (!warp_live) continue;
    const bf16* sK = smem + (2 * (t % kStages)) * TILE;
    const bf16* sV = sK + TILE;
    const int t0 = kv_lo + t * kBK;

    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if constexpr (QS) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) load_q(mt, kc, qf[mt][0]);
      }
      const int qk = QS ? 0 : kc;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_u32(sK + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                                 kc * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qf[mt][qk], kf[0], kf[1]);
          mma_bf16(s[mt][2 * np + 1], qf[mt][qk], kf[2], kf[3]);
        }
      }
    }

    const bool need_mask = walk_all || t0 + kBK > kv_hi ||
                           (causal && t0 + kBK - 1 > qa) ||
                           (window > 0 && t0 <= qb - window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][n][e] * sl2;
          if (need_mask) {
            const int key = t0 + n * 8 + tig * 2 + (e & 1);
            const int p = pos[mt][e >> 1];
            if (key >= kv_hi)
              x = neg_inf();
            else if ((causal && key > p) || (window > 0 && key <= p - window))
              x = kMasked;
          }
          s[mt][n][e] = x;
        }

    // Online softmax on the registers: half h of m tile mt holds row
    // 16 mt + 8 h + lane / 4 in elements 2h, 2h + 1; a row's 64 scores sit
    // in the 4 lanes of a quad.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[mt][h];
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mx = fmaxf(mx, fmaxf(s[mt][n][2 * h], s[mt][n][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // Differences first: -1e30 - -1e30 is 0 exactly; a fused
        // s * log2e - m * log2e would not be.
        const float corr = exp2_approx(m[mt][h] - mx);
        m[mt][h] = mx;
        l[mt][h] *= corr;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          oacc[mt][d][2 * h] *= corr;
          oacc[mt][d][2 * h + 1] *= corr;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float p0 = exp2_approx(s[mt][n][2 * h] - mx);
          const float p1 = exp2_approx(s[mt][n][2 * h + 1] - mx);
          s[mt][n][2 * h] = p0;
          s[mt][n][2 * h + 1] = p1;
          l[mt][h] += p0 + p1;
        }
      }

    // O += P . V: P's accumulator fragments are the A fragments of P . V.
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kc][0], s[mt][2 * kc][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kc][2], s[mt][2 * kc][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kc + 1][0], s[mt][2 * kc + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kc + 1][2], s[mt][2 * kc + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_u32(sV + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                       dp * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(oacc[mt][2 * dp], pa[mt], vf[0], vf[1]);
          mma_bf16(oacc[mt][2 * dp + 1], pa[mt], vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!warp_live) return;

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lr = l[mt][h];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = r0 + wrow + mt * 16 + h * 8 + gq;
      if (row >= R) continue;
      if (nsplit == 1) {
        const float inv = 1.f / fmaxf(lr, 1e-30f);
        bf16* dst = o + out_offset(b, hk, row, G, Sq, Hq, HD) + tig * 2;
#pragma unroll
        for (int d = 0; d < DT; ++d)
          *reinterpret_cast<__nv_bfloat162*>(dst + d * 8) = __floats2bfloat162_rn(
              oacc[mt][d][2 * h] * inv, oacc[mt][d][2 * h + 1] * inv);
        // the row's log-sum-exp in natural-log units, for the backward
        if (lse != nullptr && tig == 0) {
          const float mm = m[mt][h] == kMasked ? kMasked : m[mt][h] * kLn2;
          lse[row_stat(b, hk, row, G, Sq, Hq)] = mm + logf(fmaxf(lr, 1e-30f));
        }
      } else {
        // Partial in natural-log units; l = 0 (no keys) carries m = -inf.
        const long long pr =
            ((static_cast<long long>(b) * Hkv + hk) * nsplit + split) * R + row;
        if (tig == 0) {
          const float mm = m[mt][h] == kMasked ? kMasked : m[mt][h] * kLn2;
          part_m[pr] = lr > 0.f ? mm : neg_inf();
          part_l[pr] = lr;
        }
        float* dst = part_acc + pr * HD + tig * 2;
#pragma unroll
        for (int d = 0; d < DT; ++d)
          *reinterpret_cast<float2*>(dst + d * 8) =
              make_float2(oacc[mt][d][2 * h], oacc[mt][d][2 * h + 1]);
      }
    }
}

// Merge the splits of each row: M = max of m over splits with keys,
// weights w = exp(m_s - M) (0 for a split with no keys), out = sum w acc /
// max(sum w l, 1e-30).  A block takes kCombineRows rows of one (batch, KV
// head).  Every split's (m, l) is loaded at once into shared memory and
// turned into weights in parallel; then kCombineGroups groups of
// min(hd / 4, 32) threads a row each sum the accumulators of every
// kCombineGroups-th split (4 hd values a thread and column pass, independent
// loads; hd 256 takes two passes of 32 threads), and the groups' sums are
// added in group order.  The order is fixed: no atomics, the same bits each
// run.
constexpr int kCombineRows = 4;
constexpr int kCombineGroups = 4;
constexpr int kCombineLanes = 32;  // threads a row and group, at most
constexpr int kMaxSplits = 256;
constexpr int kMaxHd = 256;

int combine_threads(int hd) {
  return kCombineRows * kCombineGroups * (hd / 4 < kCombineLanes ? hd / 4 : kCombineLanes);
}

__global__ void __launch_bounds__(kCombineRows * kCombineGroups * kCombineLanes)
flash_combine(const float* __restrict__ part_m,
              const float* __restrict__ part_l,
              const float* __restrict__ part_acc, bf16* __restrict__ o,
              float* __restrict__ lse, int Sq, int Hq, int Hkv, int G, int hd,
              int nsplit) {
  __shared__ float sw[kCombineRows][kMaxSplits];  // m, then the weight
  __shared__ float sl[kCombineRows][kMaxSplits];
  __shared__ float sM[kCombineRows], sinv[kCombineRows];
  __shared__ float4 sacc[kCombineGroups][kCombineRows][kMaxHd / 4];
  const int tid = threadIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int R = Sq * G, per_row = hd / 4;
  const int lanes = min(per_row, kCombineLanes);
  const int row0 = blockIdx.x * kCombineRows;
  const int rows = min(kCombineRows, R - row0);
  const long long base = (static_cast<long long>(b) * Hkv + hk) * nsplit * R;
  for (int e = tid; e < rows * nsplit; e += blockDim.x) {
    const int r = e / nsplit, s = e - r * nsplit;
    const long long i = base + static_cast<long long>(s) * R + row0 + r;
    sw[r][s] = part_m[i];
    sl[r][s] = part_l[i];
  }
  __syncthreads();
  if (tid < rows) {
    float M = neg_inf();
    for (int s = 0; s < nsplit; ++s)
      if (sl[tid][s] > 0.f) M = fmaxf(M, sw[tid][s]);
    sM[tid] = M;
  }
  __syncthreads();
  for (int e = tid; e < rows * nsplit; e += blockDim.x) {
    const int r = e / nsplit, s = e - r * nsplit;
    // an empty split never reaches exp(-inf - -inf)
    sw[r][s] = sl[r][s] > 0.f ? expf(sw[r][s] - sM[r]) : 0.f;
  }
  __syncthreads();
  if (tid < rows) {
    float L = 0.f;
    for (int s = 0; s < nsplit; ++s) L = fmaf(sw[tid][s], sl[tid][s], L);
    sinv[tid] = 1.f / fmaxf(L, 1e-30f);
    if (lse != nullptr)
      lse[row_stat(b, hk, row0 + tid, G, Sq, Hq)] = sM[tid] + logf(fmaxf(L, 1e-30f));
  }
  const int per_group = kCombineRows * lanes;
  const int grp = tid / per_group, rem = tid - grp * per_group;
  const int r = rem / lanes, dq0 = rem - r * lanes;
  const long long step = static_cast<long long>(R) * hd;
  for (int dq = dq0; dq < per_row; dq += lanes) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      const float* src = part_acc + (base + row0 + r) * hd + dq * 4;
#pragma unroll 8
      for (int s = grp; s < nsplit; s += kCombineGroups) {
        const float w = sw[r][s];
        const float4 a = *reinterpret_cast<const float4*>(src + s * step);
        acc.x = fmaf(w, a.x, acc.x);
        acc.y = fmaf(w, a.y, acc.y);
        acc.z = fmaf(w, a.z, acc.z);
        acc.w = fmaf(w, a.w, acc.w);
      }
    }
    sacc[grp][r][dq] = acc;
  }
  __syncthreads();
  if (grp != 0 || r >= rows) return;
  const float inv = sinv[r];
  bf16* dst = o + out_offset(b, hk, row0 + r, G, Sq, Hq, hd);
  for (int dq = dq0; dq < per_row; dq += lanes) {
    float4 acc = sacc[0][r][dq];
    for (int g = 1; g < kCombineGroups; ++g) {
      const float4 a = sacc[g][r][dq];
      acc.x += a.x;
      acc.y += a.y;
      acc.z += a.z;
      acc.w += a.w;
    }
    reinterpret_cast<__nv_bfloat162*>(dst + dq * 4)[0] =
        __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    reinterpret_cast<__nv_bfloat162*>(dst + dq * 4)[1] =
        __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  }
}

// cudaFuncSetAttribute for the dynamic shared memory, once per device.
template <int HD, int MT>
int smem_attribute() {
  static int done[kMaxDevices];  // 0 unset, 1 set, else -(error)
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev] == 0) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        flash_fwd_tc<HD, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TcCfg<HD, MT>::SMEM));
    done[dev] = rc == 0 ? 1 : -rc;
  }
  return done[dev] == 1 ? 0 : -done[dev];
}

template <int HD, int MT>
int launch_tc_mt(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                 float* lse, float* part_m, float* part_l, float* part_acc, int nsplit,
                 int split_len, int B, int Sq, int Skv, int Hq, int Hkv,
                 int causal, int window, int q_offset, float scale,
                 long long kv_bstride, cudaStream_t stream) {
  int rc = smem_attribute<HD, MT>();
  if (rc != 0) return rc;
  const int G = Hq / Hkv;
  const long long R = static_cast<long long>(Sq) * G;
  const long long rows = 4 * 16 * MT;
  const long long gx = (R + rows - 1) / rows * nsplit;
  if (R > 2147483647LL || gx > 2147483647LL || Hkv > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  constexpr int smem = TcCfg<HD, MT>::SMEM;
  flash_fwd_tc<HD, MT><<<dim3(static_cast<unsigned>(gx), Hkv, B), kTcThreads,
                         smem, stream>>>(
      q, k, v, o, lse, part_m, part_l, part_acc, Sq, Skv, Hq, Hkv, G, causal,
      window, q_offset, scale, nsplit, split_len, kv_bstride);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || nsplit == 1) return rc;
  flash_combine<<<dim3(static_cast<unsigned>((R + kCombineRows - 1) / kCombineRows),
                       Hkv, B),
                  combine_threads(HD), 0, stream>>>(
      part_m, part_l, part_acc, o, lse, Sq, Hq, Hkv, G, HD, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_tc_hd(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                 float* lse, float* part_m, float* part_l, float* part_acc, int nsplit,
                 int split_len, int B, int Sq, int Skv, int Hq, int Hkv,
                 int causal, int window, int q_offset, float scale,
                 long long kv_bstride, cudaStream_t stream) {
  // Two m16 tiles per warp (128 rows a block) for hd <= 64 and more than
  // 64 rows; hd >= 112 (registers: two tiles spill) and decode-sized row
  // counts take one (64 rows).  kernels/flash_attention mirrors this rule
  // in tc_rows_per_block.
  if constexpr (HD <= 64) {
    if (static_cast<long long>(Sq) * (Hq / Hkv) > 64)
      return launch_tc_mt<HD, 2>(
          q, k, v, o, lse, part_m, part_l, part_acc, nsplit, split_len, B, Sq,
          Skv, Hq, Hkv, causal, window, q_offset, scale, kv_bstride, stream);
  }
  return launch_tc_mt<HD, 1>(q, k, v, o, lse, part_m, part_l, part_acc, nsplit,
                             split_len, B, Sq, Skv, Hq, Hkv, causal, window,
                             q_offset, scale, kv_bstride, stream);
}

int launch_tc(const bf16* q, const bf16* k, const bf16* v, bf16* o,
              float* lse, float* part_m, float* part_l, float* part_acc, int nsplit,
              int split_len, int B, int Sq, int Skv, int Hq, int Hkv, int hd,
              int causal, int window, int q_offset, float scale,
              long long kv_bstride, cudaStream_t stream) {
  if (nsplit < 1 || nsplit > kMaxSplits) return cudaErrorInvalidValue;
  if (nsplit > 1 &&
      (part_m == nullptr || part_l == nullptr || part_acc == nullptr ||
       split_len <= 0 || static_cast<long long>(nsplit) * split_len < Skv))
    return cudaErrorInvalidValue;
#define FLASH_TC_HD(D)                                                       \
  case D:                                                                    \
    return launch_tc_hd<D>(q, k, v, o, lse, part_m, part_l, part_acc, nsplit,\
                           split_len, B, Sq, Skv, Hq, Hkv, causal, window,   \
                           q_offset, scale, kv_bstride, stream);
  switch (hd) {
    FLASH_TC_HD(16) FLASH_TC_HD(32) FLASH_TC_HD(64) FLASH_TC_HD(112)
    FLASH_TC_HD(128) FLASH_TC_HD(256)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_TC_HD
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, hd) and o like q, contiguous; k and v (B, Skv, Hkv, hd),
// contiguous within a batch row, batch row b at b * kv_bstride elements (a
// view of the first Skv slots of a longer cache keeps its stride); all
// 16-byte aligned, of one type: dtype 0 float32 (CUDA-core kernel), 1
// bfloat16 (tensor-core kernel).  hd in {16, 32, 64, 112, 128, 256}; Hq a
// multiple of Hkv with Hq / Hkv <= 128; window <= 0 means none;
// q_offset >= 0.
//
// Split-KV (bfloat16 only): nsplit > 1 cuts the keys into ranges
// [s * split_len, (s + 1) * split_len) with nsplit * split_len >= Skv, and
// needs float32 scratch part_m, part_l (B, Hkv, nsplit, Sq * Hq / Hkv) and
// part_acc (..., hd); nsplit = 1 ignores the scratch.  Returns
// cudaGetLastError() after the launch(es).  lse, when not null, takes each
// row's log-sum-exp (B, Hq, Sq) in float32: m + log(l) of scale * q . k in
// natural-log units, the state the backward (flash_attention_bwd.cu) needs.
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, float* lse, float* part_m,
                        float* part_l,
                        float* part_acc, int nsplit, int split_len, int B,
                        int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
                        int window, int q_offset, float scale,
                        long long kv_bstride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > kF32Threads || q_offset < 0 ||
      kv_bstride < static_cast<long long>(Skv) * Hkv * hd)
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (nsplit != 1) return cudaErrorInvalidValue;
    return launch_f32(static_cast<const float*>(q),
                      static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(o), lse, B,
                      Sq, Skv, Hq, Hkv, hd, causal, window, q_offset, scale,
                      kv_bstride, st);
  }
  if (dtype == 1)
    return launch_tc(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<bf16*>(o), lse,
                     part_m, part_l, part_acc, nsplit, split_len, B, Sq, Skv,
                     Hq, Hkv, hd, causal, window, q_offset, scale, kv_bstride,
                     st);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
