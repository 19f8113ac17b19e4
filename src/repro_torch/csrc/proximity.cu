// Cross proximity kernel: principal-angle distances between two stacks of
// client signatures, (Ka, n, p) x (Kb, n, q) -> (Ka, Kb) float32 degrees.
//
// Replaces the Pallas TPU kernel src/repro/kernels/proximity/proximity.py
// (_proximity_kernel / proximity_pallas, math in
// src/repro/core/measures.py::measure_tile).  The TPU kernel is square-only
// and zero-pads K to its tile edge; this one takes two stacks, so the square
// matrix (Ua is Ub, then hygiene in torch), the PME cross block and the
// serving scores all run through it, and it masks the ragged edge itself.
//
//   eq3: C[a, b] = sum_r deg(acos(clip(|G_rr|, 0, 1))),  needs p == q
//   eq2: C[a, b] = deg(acos(sqrt(lambda_max(G^T G)))),  G = Ua[a]^T Ub[b]
//
// What bounds it on an H100: arithmetic.  The Gram sums are K^2 * n * p
// (eq3) or K^2 * n * p * q (eq2) fused multiply-adds, while the inputs are
// K * n * p floats that stay resident in the 50 MB L2.  Never TF32: near
// G ~ 1 the arccos amplifies TF32's ~1e-3 relative error far beyond the 1e-3
// degree parity tolerance, and at n = 3072 even a plain sequential FP32 sum
// carries ~1e-6 of rounding in G, which arccos turns into >1e-3 degrees for
// angles of a few degrees (the within-cluster regime).
//
// Eq. 3 (eq3_tc): the Gram diagonal is p independent K x K Grams, one per
// column r, G_r = Ua[:, :, r] Ub[:, :, r]^T.  Each runs on the FP64 tensor
// cores (mma.sync m16n8k16 .f64, sm_90; m8n8k4 ran several times slower):
// float32 inputs are converted to FP64 when a fragment is loaded, so every
// product is exact and every sum FP64, at the FP64 tensor-core rate (67
// TFLOP/s, the float32 CUDA-core rate).  A block tile of client pairs stages
// each client's (NC x p) rows once per n-chunk, client-major as they lie in
// memory, through a 3-stage ring of 16-byte cp.async copies (4-byte copies
// for other strides; per-element staging cost more instructions than the
// math), and serves all p columns from it.  When
// Ua and Ub are one stack (same pointer, strides and K) the grid walks only
// the upper-triangle tiles (triangle_tile) and writes each value to C[a, b]
// and C[b, a]: half the work, and the result exactly symmetric.  The
// epilogue is the reference's in-order clipped arccos sum over r.
//
// Eq. 2 (eq2_tc): p * q times the Gram work of eq3's one column, and a
// q x q Jacobi per pair.  What bounds it on this card: the FP64 tensor cores
// at large K (at K = 1024, p = q = 3: 4.7e5 pairs x 9 x 3072 x 2 flops,
// 0.43 ms at 67 TFLOP/s), and at the FL path's K = 97 the grid: 4 x 4
// client tiles of 32 would leave 116 of 132 SMs idle while each block walked
// all of n alone.  The design: the p x q Grams G_rs = Ua[:, :, r]
// Ub[:, :, s]^T run on the FP64 tensor cores as eq3's do (the same 3-stage
// cp.async ring, f32 -> f64 at fragment load, so the Gram is exact products
// with FP64 sums; each operand its own padded stage row, q may differ from
// p).  Per k16 step a warp loads q B-fragments, then per row r one
// A-fragment and q mmas (9 mmas per 6 fragment loads at p = q = 3); each
// lane then holds all p * q entries of its 4 pairs, and the reference's
// fixed-sweep packed Jacobi on G^T G (same plane order, sweep count,
// cancellation-free tangent, 1e-30 denominator guard and rsqrt as
// measures.py::_jacobi_rotate) runs in registers.  When Ua and Ub are one
// stack the grid walks only the upper-triangle tiles and each unordered
// pair's Gram runs the Jacobi twice, on G^T G for C[a, b] and on G G^T for
// C[b, a]: each entry is what the full rectangle gives (the reference
// averages the two in its hygiene; one mirrored value would differ from it
// by ~0.02 degrees near 0).  A 256-thread block holds ~180 registers a
// thread at p = q = 3, so one block runs on an SM at a time; where the
// tiles cannot fill a wave of the card, a host plan
// (kernels/proximity/proximity.py::eq2_plan) splits n so that tiles x splits
// comes as close to the SM count as whole k16 steps allow (K = 97: 10 x
// 13).  Each split writes its FP64 partial Grams to a workspace, and
// eq2_reduce_ws adds them in split order (coalesced, 32 pairs a block) and
// runs the epilogue, with no atomics, so the result is bitwise the same
// from run to run.  Ranks whose accumulators and fragments would not fit
// kEq2Doubles (p = q = 4, p = 3 with q = 5, ...) take the Gram rows r in
// groups, one grid layer each, through the same workspace.  Clients and
// rows past the edge are staged as zeros and never written.
//
// Ranks above kMaxRank take a runtime-rank path (proximity_any_rank): one
// warp per pair, the pair's NC-row chunks staged in the warp's slice of
// dynamic shared memory, each lane summing its Gram entries over a chunk in
// a fresh FP32 register and adding the chunk sums into FP64 totals kept in
// shared memory.  The reduction is the same arithmetic with loops in place
// of the unroll: eq3's in-order clipped arccos sum on lane 0, eq2's packed
// G^T G and cyclic Jacobi (same plane order and sweep count) with the
// off-plane updates of each rotation spread over the lanes.  It has no
// pair-tile reuse, so it is far slower than the other paths per pair.
#include <cuda_runtime.h>

namespace {

constexpr float kTiny = 1e-30f;
constexpr float kDegPerRad = 57.295779513082320876798f;
constexpr int kMaxRank = 8;  // largest rank the templates unroll
constexpr int kMaxDevices = 64;

template <int P>
__device__ __forceinline__ float eq3_reduce(const double (&gd)[P]) {
  float g[P];
#pragma unroll
  for (int r = 0; r < P; ++r) g[r] = static_cast<float>(gd[r]);
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    float d = fabsf(g[r]);
    d = d > 1.f ? 1.f : d;
    const float ang = acosf(d) * kDegPerRad;
    total = r == 0 ? ang : total + ang;
  }
  return total;
}

// One plane rotation zeroing b[i][j]; only the upper triangle is live.
template <int Q, int I, int J>
__device__ __forceinline__ void rotate(float (&b)[Q][Q]) {
  const float bii = b[I][I], bjj = b[J][J], bij = b[I][J];
  const float d = bjj - bii;
  const float e = bij + bij;
  const float den = fabsf(d) + sqrtf(d * d + e * e) + kTiny;
  const float sgn = d >= 0.f ? 1.f : -1.f;
  const float t = sgn * e / den;
  const float c = rsqrtf(1.f + t * t);
  const float s = t * c;
  const float tb = t * bij;
  b[I][I] = bii - tb;
  b[J][J] = bjj + tb;
  b[I][J] = 0.f;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    if (k == I || k == J) continue;
    float& bik = k < I ? b[k][I] : b[I][k];
    float& bjk = k < J ? b[k][J] : b[J][k];
    const float x = bik, y = bjk;
    bik = c * x - s * y;
    bjk = s * x + c * y;
  }
}

template <int Q, int I, int J>
__device__ __forceinline__ void sweep_from(float (&b)[Q][Q]) {
  if constexpr (I < Q - 1) {
    rotate<Q, I, J>(b);
    if constexpr (J + 1 < Q) {
      sweep_from<Q, I, J + 1>(b);
    } else {
      sweep_from<Q, I + 1, I + 2>(b);
    }
  }
}

template <int P, int Q>
__device__ __forceinline__ float eq2_reduce(const double (&gd)[P * Q]) {
  float g[P * Q];
#pragma unroll
  for (int x = 0; x < P * Q; ++x) g[x] = static_cast<float>(gd[x]);
  float b[Q][Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int r = q; r < Q; ++r) {
      float acc = g[q] * g[r];
#pragma unroll
      for (int k = 1; k < P; ++k) acc = acc + g[k * Q + q] * g[k * Q + r];
      b[q][r] = acc;
    }
  }
  float lam;
  if constexpr (Q == 1) {
    lam = b[0][0];
  } else {
    constexpr int kSweeps = Q <= 5 ? 4 : 6;
#pragma unroll
    for (int it = 0; it < kSweeps; ++it) sweep_from<Q, 0, 1>(b);
    lam = b[0][0];
#pragma unroll
    for (int i = 1; i < Q; ++i) lam = b[i][i] > lam ? b[i][i] : lam;
  }
  lam = lam < 0.f ? 0.f : lam;
  float smax = sqrtf(lam);
  smax = smax > 1.f ? 1.f : smax;
  return acosf(smax) * kDegPerRad;
}

// ---------------------------------------------------------------------------
// Shared by the tensor-core kernels (eq3_tc, eq2_tc)
// ---------------------------------------------------------------------------

constexpr int kStageRows = 16;   // rows of n per stage: one k16 mma step
constexpr int kStages = 3;       // stages in the cp.async ring

// A stage holds each client's kStageRows rows x R columns as one row of LS
// floats (client-major, as they lie in device memory).  LS: a multiple of 4
// (16-byte copies) at least kStageRows * R such that a fragment load (8
// clients x 4 k-rows, word g * LS + k * R) hits 32 distinct banks, where one
// exists.
constexpr bool stage_conflict_free(int ls, int rank) {
  for (int x = 0; x < 32; ++x)
    for (int y = x + 1; y < 32; ++y)
      if (((x >> 2) * ls + (x & 3) * rank) % 32 == ((y >> 2) * ls + (y & 3) * rank) % 32)
        return false;
  return true;
}
constexpr int stage_row(int rank) {
  for (int ls = kStageRows * rank; ls < kStageRows * rank + 32; ls += 4)
    if (stage_conflict_free(ls, rank)) return ls;
  return kStageRows * rank + 4;
}

// ---------------------------------------------------------------------------
// eq3 on the FP64 tensor cores: p independent K x K Grams.
// ---------------------------------------------------------------------------

// Block tile: WA x WB warps, each MA x MB mma tiles of 16 x 8 pairs per
// Gram column r, so a block covers TA = 16 * WA * MA clients of Ua by
// TB = 8 * WB * MB of Ub, with P * MA * MB * 4 FP64 accumulators a lane.
// Square tiles (TA == TB), so the symmetric grid can mirror them.
template <int P> struct Eq3Tile {
  // 32 x 32 pairs, 4 warps: at K = 1024 the triangle is 528 tiles, four
  // resident on each of the 132 SMs (64 x 64 tiles would make 136: a
  // second wave for 4 SMs)
  static constexpr int WA = 2, WB = 2, MA = 1, MB = 2;
  static constexpr int TA = 16 * WA * MA, TB = 8 * WB * MB;
  static constexpr int THREADS = 32 * WA * WB;
  static constexpr int NC = kStageRows, NS = kStages;
  static constexpr int LS = stage_row(P);
  static constexpr int STAGE = TA * LS;   // floats per operand per stage
  static constexpr int SMEM = 2 * NS * STAGE * 4;
  static_assert(TA == TB, "the symmetric grid mirrors square tiles");
  static_assert(NC * P % 4 == 0, "a client's stage row is whole 16-byte chunks");
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
// 16 bytes, of which the first `bytes` are copied and the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D (16 x 8) += A (16 x 16, row) * B (16 x 8, col), FP64 (sm_90).  Lane
// l = 4 g + t holds A[g + 8 (i % 2)][t + 4 (i / 2)] in a[i], B[t + 4 i][g] in
// b[i] and D[g + 8 (i / 2)][2 t + i % 2] in d[i].
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[8],
                                        const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// The tile (bi, bj), bi <= bj, of upper-triangle tile index x: x enumerates
// the pairs column by column, (0,0), (0,1), (1,1), (0,2), ...  Mirrored on
// the host by kernels/proximity/proximity.py::triangle_tile.
__device__ __forceinline__ void triangle_tile(long long x, int& bi, int& bj) {
  long long j = static_cast<long long>((sqrt(8.0 * x + 1.0) - 1.0) / 2.0);
  while (j * (j + 1) / 2 > x) --j;
  while ((j + 1) * (j + 2) / 2 <= x) ++j;
  bj = static_cast<int>(j);
  bi = static_cast<int>(x - j * (j + 1) / 2);
}

// Stage rows [t0, t0 + NC) of T clients from k0 into s[i * LS + t * P + r].
// vec: the client's rows are contiguous and 16-byte aligned (sn == P,
// sp == 1), so each thread copies 16-byte chunks, the ragged edge
// zero-filled; else one 4-byte copy per element.  Clients and rows past the
// edge are zeros.
template <int P, int T, int LS, int NC, int THREADS>
__device__ __forceinline__ void stage_async(float* s, const float* __restrict__ U,
                                            long long sk, long long sn,
                                            long long sp, int K, int n, int k0,
                                            int t0, int tid, bool vec) {
  constexpr int kRow = NC * P;
  if (vec) {
    constexpr int kChunks = kRow / 4;
    const long long left = static_cast<long long>(n - t0) * P;  // floats
    for (int e = tid; e < T * kChunks; e += THREADS) {
      const int i = e / kChunks, part = e - (e / kChunks) * kChunks;
      const int k = k0 + i;
      const long long f = 4LL * part;
      long long bytes = k < K ? 4 * (left - f) : 0;
      bytes = bytes < 0 ? 0 : (bytes > 16 ? 16 : bytes);
      cp_async16(&s[i * LS + 4 * part],
                 bytes > 0 ? U + k * sk + static_cast<long long>(t0) * P + f : U,
                 static_cast<int>(bytes));
    }
  } else {
    for (int e = tid; e < T * kRow; e += THREADS) {
      const int i = e / kRow, rem = e - (e / kRow) * kRow;
      const int t = rem / P, r = rem - (rem / P) * P;
      const int k = k0 + i;
      const bool valid = k < K && t0 + t < n;
      cp_async4(&s[i * LS + rem], valid ? U + k * sk + (t0 + t) * sn + r * sp : U,
                valid);
    }
  }
}

// C[a, b] = sum_r deg(acos(clip(|G_r[a, b]|, 0, 1))), G_r = Ua[:, :, r] Ub[:, :, r]^T
// with float32 inputs, exact FP64 products and FP64 sums.  sym != 0: Ua is
// Ub, the grid walks the upper-triangle tiles only and each value is written
// to C[a, b] and C[b, a] (in the diagonal tiles only a <= b is computed).
template <int P>
__global__ void __launch_bounds__(Eq3Tile<P>::THREADS)
eq3_tc(const float* __restrict__ Ua, long long sak, long long san,
       long long sap, int Ka, const float* __restrict__ Ub, long long sbk,
       long long sbn, long long sbq, int Kb, int n, float* __restrict__ C,
       long long ldc, int sym, int vec_a, int vec_b) {
  using T = Eq3Tile<P>;
  constexpr int NC = T::NC, NS = T::NS, LS = T::LS, MA = T::MA, MB = T::MB;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                     // [NS][TA][LS]
  float* sB = smem + NS * T::STAGE;     // [NS][TB][LS]

  int bi, bj;
  if (sym) {
    triangle_tile(blockIdx.x, bi, bj);
  } else {
    bi = blockIdx.y;
    bj = blockIdx.x;
  }
  const int a0 = bi * T::TA, b0 = bj * T::TB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wa = warp / T::WB, wb = warp - (warp / T::WB) * T::WB;
  const int g = lane >> 2, t4 = lane & 3;
  const int fa = wa * MA * 16 + g;   // A fragment client; + 8, + 16 ma
  const int fb = wb * MB * 8 + g;    // B fragment client; + 8 mb

  double acc[P][MA][MB][4];
#pragma unroll
  for (int r = 0; r < P; ++r)
#pragma unroll
    for (int i = 0; i < MA; ++i)
#pragma unroll
      for (int j = 0; j < MB; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[r][i][j][x] = 0.0;

  const int nchunks = (n + NC - 1) / NC;
#pragma unroll
  for (int c = 0; c < NS - 1; ++c) {
    if (c < nchunks) {
      stage_async<P, T::TA, LS, NC, T::THREADS>(sA + c * T::STAGE, Ua, sak,
                                                san, sap, Ka, n, a0, c * NC,
                                                tid, vec_a);
      stage_async<P, T::TB, LS, NC, T::THREADS>(sB + c * T::STAGE, Ub, sbk,
                                                sbn, sbq, Kb, n, b0, c * NC,
                                                tid, vec_b);
    }
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    {
      const int cn = c + NS - 1;
      if (cn < nchunks) {
        const int slot = cn % NS;
        stage_async<P, T::TA, LS, NC, T::THREADS>(sA + slot * T::STAGE, Ua,
                                                  sak, san, sap, Ka, n, a0,
                                                  cn * NC, tid, vec_a);
        stage_async<P, T::TB, LS, NC, T::THREADS>(sB + slot * T::STAGE, Ub,
                                                  sbk, sbn, sbq, Kb, n, b0,
                                                  cn * NC, tid, vec_b);
      }
      cp_async_commit();
    }
    const float* xa = sA + (c % NS) * T::STAGE;
    const float* xb = sB + (c % NS) * T::STAGE;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      double fa_[MA][8], fb_[MB][4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = (t4 + 4 * x) * P + r;
#pragma unroll
        for (int i = 0; i < MA; ++i) {
          fa_[i][2 * x] = static_cast<double>(xa[(fa + 16 * i) * LS + col]);
          fa_[i][2 * x + 1] =
              static_cast<double>(xa[(fa + 16 * i + 8) * LS + col]);
        }
#pragma unroll
        for (int j = 0; j < MB; ++j)
          fb_[j][x] = static_cast<double>(xb[(fb + 8 * j) * LS + col]);
      }
#pragma unroll
      for (int i = 0; i < MA; ++i)
#pragma unroll
        for (int j = 0; j < MB; ++j) mma_f64(acc[r][i][j], fa_[i], fb_[j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MA; ++i) {
#pragma unroll
    for (int j = 0; j < MB; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int a = a0 + fa + 16 * i + 8 * (x >> 1);
        const int b = b0 + wb * MB * 8 + 8 * j + 2 * t4 + (x & 1);
        if (a >= Ka || b >= Kb || (sym && bi == bj && a > b)) continue;
        double gd[P];
#pragma unroll
        for (int r = 0; r < P; ++r) gd[r] = acc[r][i][j][x];
        const float out = eq3_reduce<P>(gd);
        C[a * ldc + b] = out;
        if (sym && a != b) C[b * ldc + a] = out;
      }
    }
  }
}

// 1 where a stack's client rows are contiguous and 16-byte aligned, so the
// kernels stage them in 16-byte copies (stage_async's vec path).
int stage_vec(const float* U, long long sk, long long sn, long long sp, int rank) {
  return sn == rank && sp == 1 && sk % 4 == 0 &&
         reinterpret_cast<unsigned long long>(U) % 16 == 0;
}

template <int P>
int launch_eq3_tc(const float* Ua, long long sak, long long san, long long sap,
                  int Ka, const float* Ub, long long sbk, long long sbn,
                  long long sbq, int Kb, int n, float* C, long long ldc,
                  cudaStream_t stream) {
  using T = Eq3Tile<P>;
  static int done[kMaxDevices];  // smem attribute: 0 unset, 1 set, else -(error)
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev] == 0) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        eq3_tc<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM));
    done[dev] = rc == 0 ? 1 : -rc;
  }
  if (done[dev] != 1) return -done[dev];
  // the same stack on both sides: upper-triangle tiles only
  const bool sym = Ua == Ub && Ka == Kb && sak == sbk && san == sbn &&
                   sap == sbq && T::TA == T::TB;
  dim3 grid;
  if (sym) {
    const long long nt = (Ka + T::TA - 1) / T::TA;
    const long long tiles = nt * (nt + 1) / 2;
    if (tiles > 2147483647LL) return cudaErrorInvalidValue;
    grid = dim3(static_cast<unsigned>(tiles));
  } else {
    const long long gx = (Kb + T::TB - 1) / T::TB;
    const long long gy = (Ka + T::TA - 1) / T::TA;
    if (gy > 65535 || gx > 2147483647LL) return cudaErrorInvalidValue;
    grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  }
  eq3_tc<P><<<grid, T::THREADS, T::SMEM, stream>>>(
      Ua, sak, san, sap, Ka, Ub, sbk, sbn, sbq, Kb, n, C, ldc, sym ? 1 : 0,
      stage_vec(Ua, sak, san, sap, P), stage_vec(Ub, sbk, sbn, sbq, P));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// eq2 on the FP64 tensor cores: the p x q Gram of every pair.
// ---------------------------------------------------------------------------

// FP64 registers a lane may give to the Gram phase: its accumulators (RG
// rows x q entries for each of its 4 pairs) and one k16 step's fragments
// (q B-fragments of 4 and one A-fragment of 8), 160 of its 255 registers.
constexpr int kEq2Doubles = 80;

// Rows r of the Gram a block accumulates: all p where they fit in
// kEq2Doubles, else the largest divisor of p that fits (the other rows are
// other blocks, the grid's z dimension).  Mirrored by
// kernels/proximity/proximity.py::eq2_row_group.
constexpr int eq2_row_group(int p, int q) {
  for (int d = p; d > 1; --d)
    if (p % d == 0 && 4 * d * q + 4 * q + 8 <= kEq2Doubles) return d;
  return 1;
}

// Block tile: 32 x 32 client pairs, 8 warps (2 along a, 4 along b), each
// warp one 16 x 8 mma tile of pairs holding RG x Q Gram entries a pair: 4
// pairs a lane, RG * Q * 4 FP64 accumulators.
template <int P, int Q> struct Eq2Tile {
  static constexpr int WA = 2, WB = 4;
  static constexpr int TA = 16 * WA, TB = 8 * WB;
  static constexpr int PAIRS = TA * TB;
  static constexpr int THREADS = 32 * WA * WB;
  static constexpr int NC = kStageRows, NS = kStages;
  static constexpr int RG = eq2_row_group(P, Q);
  static constexpr int GROUPS = P / RG;
  static constexpr int LSA = stage_row(P), LSB = stage_row(Q);
  static constexpr int STA = TA * LSA, STB = TB * LSB;   // floats per stage
  static constexpr int SMEM = NS * (STA + STB) * 4;
  static_assert(TA == TB, "the symmetric grid walks square tiles");
};

// C[a, b] from the pair's Gram G (p x q, FP64 sums): the Jacobi of G^T G.
// On the symmetric grid (Ua is Ub, so p == q) the pair also gives C[b, a],
// the Jacobi of G G^T, as the full rectangle would from its own Gram of
// (b, a), which is G^T; the diagonal tiles compute only a <= b.
template <int P, int Q>
__device__ __forceinline__ void eq2_store(const double (&gd)[P * Q], int a, int b,
                                          int Ka, int Kb, bool sym, bool diag,
                                          float* __restrict__ C, long long ldc) {
  if (a >= Ka || b >= Kb || (sym && diag && a > b)) return;
  C[a * ldc + b] = eq2_reduce<P, Q>(gd);
  if constexpr (P == Q) {
    if (sym && a != b) {
      double gt[P * Q];
#pragma unroll
      for (int r = 0; r < P; ++r)
#pragma unroll
        for (int s = 0; s < Q; ++s) gt[s * P + r] = gd[r * Q + s];
      C[b * ldc + a] = eq2_reduce<Q, P>(gt);
    }
  }
}

// The tile (bi, bj) of block tile index x: the upper triangle on the
// symmetric grid, else row-major over ceil(Kb / TB) tile columns.
__device__ __forceinline__ void eq2_tile(long long x, int sym, int Kb, int tb,
                                         int& bi, int& bj) {
  if (sym) {
    triangle_tile(x, bi, bj);
  } else {
    const long long ntb = (Kb + tb - 1) / tb;
    bi = static_cast<int>(x / ntb);
    bj = static_cast<int>(x - bi * ntb);
  }
}

// Block (tile, split, group): the FP64 Gram entries of rows r in
// [group * RG, (group + 1) * RG) of the tile's pairs, summed over the
// split's rows [split * split_rows, ...) of n (a multiple of 16).  ws null
// (one split, one group): the Jacobi epilogue in registers, into C.  Else
// the partial Grams go to ws[split][tile][r * Q + s][pair], pair = 32 *
// (a - a0) + (b - b0), for eq2_reduce_ws.
template <int P, int Q>
__global__ void __launch_bounds__(Eq2Tile<P, Q>::THREADS)
eq2_tc(const float* __restrict__ Ua, long long sak, long long san,
       long long sap, int Ka, const float* __restrict__ Ub, long long sbk,
       long long sbn, long long sbq, int Kb, int n, float* __restrict__ C,
       long long ldc, int sym, int vec_a, int vec_b, int split_rows,
       double* __restrict__ ws) {
  using T = Eq2Tile<P, Q>;
  constexpr int NC = T::NC, NS = T::NS, RG = T::RG;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                  // [NS][TA][LSA]
  float* sB = smem + NS * T::STA;    // [NS][TB][LSB]

  const long long tile = blockIdx.x;
  const int split = blockIdx.y;
  const int r0 = blockIdx.z * RG;
  int bi, bj;
  eq2_tile(tile, sym, Kb, T::TB, bi, bj);
  const int a0 = bi * T::TA, b0 = bj * T::TB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wa = warp / T::WB, wb = warp - (warp / T::WB) * T::WB;
  const int g = lane >> 2, t4 = lane & 3;
  const int fa = wa * 16 + g;   // A fragment client; + 8
  const int fb = wb * 8 + g;    // B fragment client

  double acc[RG][Q][4];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int s = 0; s < Q; ++s)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[r][s][x] = 0.0;

  const int lo = split * split_rows;
  const int hi = min(n, lo + split_rows);
  const int nchunks = (hi - lo + NC - 1) / NC;
  auto stage = [&](int c) {
    const int slot = c % NS;
    stage_async<P, T::TA, T::LSA, NC, T::THREADS>(sA + slot * T::STA, Ua, sak,
                                                  san, sap, Ka, n, a0,
                                                  lo + c * NC, tid, vec_a);
    stage_async<Q, T::TB, T::LSB, NC, T::THREADS>(sB + slot * T::STB, Ub, sbk,
                                                  sbn, sbq, Kb, n, b0,
                                                  lo + c * NC, tid, vec_b);
  };
#pragma unroll
  for (int c = 0; c < NS - 1; ++c) {
    if (c < nchunks) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (c + NS - 1 < nchunks) stage(c + NS - 1);
    cp_async_commit();
    const float* xa = sA + (c % NS) * T::STA;
    const float* xb = sB + (c % NS) * T::STB;
    // Q B-fragments, then per row r one A-fragment and Q mmas
    double fb_[Q][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int s = 0; s < Q; ++s)
        fb_[s][x] = static_cast<double>(xb[fb * T::LSB + (t4 + 4 * x) * Q + s]);
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      double fa_[8];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = (t4 + 4 * x) * P + r0 + r;
        fa_[2 * x] = static_cast<double>(xa[fa * T::LSA + col]);
        fa_[2 * x + 1] = static_cast<double>(xa[(fa + 8) * T::LSA + col]);
      }
#pragma unroll
      for (int s = 0; s < Q; ++s) mma_f64(acc[r][s], fa_, fb_[s]);
    }
  }
  cp_async_wait<0>();

  // lane (g, t4) holds pairs (wa * 16 + g + 8 (x / 2), wb * 8 + 2 t4 + x % 2)
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int al = wa * 16 + g + 8 * (x >> 1);
    const int bl = wb * 8 + 2 * t4 + (x & 1);
    if (ws != nullptr) {
      double* dst = ws + (static_cast<long long>(split) * gridDim.x + tile) *
                             (P * Q * T::PAIRS) + al * T::TB + bl;
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int s = 0; s < Q; ++s)
          dst[static_cast<long long>((r0 + r) * Q + s) * T::PAIRS] = acc[r][s][x];
    } else {
      if constexpr (T::GROUPS == 1) {
        double gd[P * Q];
#pragma unroll
        for (int r = 0; r < P; ++r)
#pragma unroll
          for (int s = 0; s < Q; ++s) gd[r * Q + s] = acc[r][s][x];
        eq2_store<P, Q>(gd, a0 + al, b0 + bl, Ka, Kb, sym != 0, bi == bj, C, ldc);
      }
    }
  }
}

// Second pass of a split (or grouped) eq2 grid.  A block takes 32 pairs of
// a tile: its threads add the splits' partial Grams in split order, one
// (entry, pair) at a time with the pairs across lanes (coalesced reads,
// several splits' loads in flight), into shared memory; then one warp runs
// the epilogue, a pair a lane.  No atomics: the result is the same bitwise
// from run to run.
constexpr int kReduceThreads = 256;
constexpr int kReducePairs = 32;

template <int P, int Q>
__global__ void __launch_bounds__(kReduceThreads)
eq2_reduce_ws(const double* __restrict__ ws, long long tiles, int splits,
              int Ka, int Kb, int sym, float* __restrict__ C, long long ldc) {
  using T = Eq2Tile<P, Q>;
  constexpr int PQ = P * Q, CHUNKS = T::PAIRS / kReducePairs;
  __shared__ double g[PQ][kReducePairs + 1];
  const long long tile = blockIdx.x / CHUNKS;
  const int p0 = static_cast<int>(blockIdx.x % CHUNKS) * kReducePairs;
  const long long stride = static_cast<long long>(PQ) * T::PAIRS;  // a split's tile
  const long long split_stride = tiles * stride;
  const double* src = ws + tile * stride + p0;
  for (int item = threadIdx.x; item < PQ * kReducePairs; item += kReduceThreads) {
    const int e = item / kReducePairs, pl = item - (item / kReducePairs) * kReducePairs;
    const double* x = src + e * T::PAIRS + pl;
    double v = x[0];
#pragma unroll 8
    for (int sp = 1; sp < splits; ++sp) v += x[sp * split_stride];
    g[e][pl] = v;
  }
  __syncthreads();
  if (threadIdx.x >= kReducePairs) return;
  int bi, bj;
  eq2_tile(tile, sym, Kb, T::TB, bi, bj);
  const int pair = p0 + static_cast<int>(threadIdx.x);
  double gd[PQ];
#pragma unroll
  for (int e = 0; e < PQ; ++e) gd[e] = g[e][threadIdx.x];
  eq2_store<P, Q>(gd, bi * T::TA + pair / T::TB, bj * T::TB + pair % T::TB, Ka, Kb,
                  sym != 0, bi == bj, C, ldc);
}

// The host plan (kernels/proximity/proximity.py::eq2_plan) gives split_rows,
// splits and the tile count it sized ws for; the launch refuses a plan that
// does not match this grid.  ws: FP64 (splits, tiles, p * q, 32 * 32), or
// null when the plan has one split and one row group.
template <int P, int Q>
int launch_eq2_tc(const float* Ua, long long sak, long long san, long long sap,
                  int Ka, const float* Ub, long long sbk, long long sbn,
                  long long sbq, int Kb, int n, float* C, long long ldc,
                  int split_rows, int splits, long long plan_tiles, double* ws,
                  cudaStream_t stream) {
  using T = Eq2Tile<P, Q>;
  static int done[kMaxDevices];  // smem attribute: 0 unset, 1 set, else -(error)
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev] == 0) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        eq2_tc<P, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM));
    done[dev] = rc == 0 ? 1 : -rc;
  }
  if (done[dev] != 1) return -done[dev];
  // the same stack on both sides: upper-triangle tiles only
  const bool sym = Ua == Ub && Ka == Kb && sak == sbk && san == sbn &&
                   sap == sbq && P == Q;
  const long long nta = (Ka + T::TA - 1) / T::TA, ntb = (Kb + T::TB - 1) / T::TB;
  const long long tiles = sym ? nta * (nta + 1) / 2 : nta * ntb;
  const bool two_pass = splits > 1 || T::GROUPS > 1;
  if (tiles != plan_tiles || tiles > 2147483647LL || split_rows <= 0 ||
      split_rows % T::NC != 0 || splits > 65535 ||
      splits != (n + split_rows - 1) / split_rows || two_pass != (ws != nullptr))
    return cudaErrorInvalidValue;
  eq2_tc<P, Q><<<dim3(static_cast<unsigned>(tiles), splits, T::GROUPS),
                 T::THREADS, T::SMEM, stream>>>(
      Ua, sak, san, sap, Ka, Ub, sbk, sbn, sbq, Kb, n, C, ldc, sym ? 1 : 0,
      stage_vec(Ua, sak, san, sap, P), stage_vec(Ub, sbk, sbn, sbq, Q),
      split_rows, ws);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || !two_pass) return rc;
  const long long blocks = tiles * (T::PAIRS / kReducePairs);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  eq2_reduce_ws<P, Q><<<static_cast<unsigned>(blocks), kReduceThreads, 0, stream>>>(
      ws, tiles, splits, Ka, Kb, sym ? 1 : 0, C, ldc);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int pick_q(int q, const float* Ua, long long sak, long long san,
           long long sap, int Ka, const float* Ub, long long sbk,
           long long sbn, long long sbq, int Kb, int n, float* C,
           long long ldc, int split_rows, int splits, long long plan_tiles,
           double* ws, cudaStream_t stream) {
#define PROX_Q(QQ)                                                           \
  case QQ:                                                                   \
    return launch_eq2_tc<P, QQ>(Ua, sak, san, sap, Ka, Ub, sbk, sbn, sbq,    \
                                Kb, n, C, ldc, split_rows, splits,           \
                                plan_tiles, ws, stream);
  switch (q) {
    PROX_Q(1) PROX_Q(2) PROX_Q(3) PROX_Q(4)
    PROX_Q(5) PROX_Q(6) PROX_Q(7) PROX_Q(8)
    default: return cudaErrorInvalidValue;
  }
#undef PROX_Q
}

// ---------------------------------------------------------------------------
// Runtime-rank path: any p, q.
// ---------------------------------------------------------------------------

constexpr int kDynChunk = 16;
constexpr int kDynMaxWarps = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

struct DynLayout {
  int entries;        // Gram entries a pair accumulates: p (eq3) or p*q
  size_t warp_bytes;  // FP64 totals, then staged rows of a and b, then G^T G
  __host__ __device__ DynLayout(int p, int q, int eq2)
      : entries(eq2 ? p * q : p),
        warp_bytes(sizeof(double) * (eq2 ? p * q : p) +
                   sizeof(float) * (kDynChunk * (p + q) + (eq2 ? q * q : 0))) {
    warp_bytes = (warp_bytes + 15) / 16 * 16;
  }
};

__global__ void __launch_bounds__(32 * kDynMaxWarps)
proximity_any_rank(const float* __restrict__ Ua, long long sak, long long san,
                   long long sap, int Ka, const float* __restrict__ Ub,
                   long long sbk, long long sbn, long long sbq, int Kb, int n,
                   int p, int q, int eq2, float* __restrict__ C,
                   long long ldc) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const DynLayout lay(p, q, eq2);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long pair =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (pair >= static_cast<long long>(Ka) * Kb) return;
  const int a = static_cast<int>(pair / Kb);
  const int b = static_cast<int>(pair - static_cast<long long>(a) * Kb);

  unsigned char* base = dyn_smem + lay.warp_bytes * warp;
  double* tot = reinterpret_cast<double*>(base);
  float* sa = reinterpret_cast<float*>(tot + lay.entries);  // [kDynChunk][p]
  float* sb = sa + kDynChunk * p;                            // [kDynChunk][q]
  float* bq = sb + kDynChunk * q;                            // [q][q]

  for (int e = lane; e < lay.entries; e += 32) tot[e] = 0.0;
  const float* A = Ua + a * sak;
  const float* B = Ub + b * sbk;
  for (int t0 = 0; t0 < n; t0 += kDynChunk) {
    __syncwarp();
    for (int e = lane; e < kDynChunk * p; e += 32) {
      const int t = e / p, r = e - t * p;
      sa[e] = t0 + t < n ? A[(t0 + t) * san + r * sap] : 0.f;
    }
    for (int e = lane; e < kDynChunk * q; e += 32) {
      const int t = e / q, s = e - t * q;
      sb[e] = t0 + t < n ? B[(t0 + t) * sbn + s * sbq] : 0.f;
    }
    __syncwarp();
    for (int e = lane; e < lay.entries; e += 32) {
      const int r = eq2 ? e / q : e;
      const int s = eq2 ? e - r * q : e;
      float part = 0.f;
      for (int t = 0; t < kDynChunk; ++t)
        part = fmaf(sa[t * p + r], sb[t * q + s], part);
      tot[e] += part;
    }
  }
  __syncwarp();

  float out;
  if (!eq2) {
    float total = 0.f;
    for (int r = 0; r < p; ++r) {
      float d = fabsf(static_cast<float>(tot[r]));
      d = d > 1.f ? 1.f : d;
      const float ang = acosf(d) * kDegPerRad;
      total = r == 0 ? ang : total + ang;
    }
    out = total;
  } else {
    // Packed upper triangle of G^T G, entry (i, j) at bq[i * q + j], i <= j.
    for (int e = lane; e < q * q; e += 32) {
      const int i = e / q, j = e - i * q;
      if (i > j) continue;
      float acc = static_cast<float>(tot[i]) * static_cast<float>(tot[j]);
      for (int k = 1; k < p; ++k)
        acc = acc + static_cast<float>(tot[k * q + i]) *
                        static_cast<float>(tot[k * q + j]);
      bq[e] = acc;
    }
    __syncwarp();
    float lam = bq[0];
    if (q > 1) {
      const int sweeps = q <= 5 ? 4 : 6;
      for (int it = 0; it < sweeps; ++it) {
        for (int i = 0; i < q - 1; ++i) {
          for (int j = i + 1; j < q; ++j) {
            const float bii = bq[i * q + i], bjj = bq[j * q + j];
            const float bij = bq[i * q + j];
            const float d = bjj - bii;
            const float e = bij + bij;
            const float den = fabsf(d) + sqrtf(d * d + e * e) + kTiny;
            const float sgn = d >= 0.f ? 1.f : -1.f;
            const float t = sgn * e / den;
            const float c = rsqrtf(1.f + t * t);
            const float s = t * c;
            __syncwarp();
            for (int k = lane; k < q; k += 32) {
              if (k == i || k == j) continue;
              float& bik = k < i ? bq[k * q + i] : bq[i * q + k];
              float& bjk = k < j ? bq[k * q + j] : bq[j * q + k];
              const float x = bik, y = bjk;
              bik = c * x - s * y;
              bjk = s * x + c * y;
            }
            if (lane == 0) {
              const float tb = t * bij;
              bq[i * q + i] = bii - tb;
              bq[j * q + j] = bjj + tb;
              bq[i * q + j] = 0.f;
            }
            __syncwarp();
          }
        }
      }
      lam = bq[0];
      for (int i = 1; i < q; ++i) {
        const float v = bq[i * q + i];
        lam = v > lam ? v : lam;
      }
    }
    lam = lam < 0.f ? 0.f : lam;
    float smax = sqrtf(lam);
    smax = smax > 1.f ? 1.f : smax;
    out = acosf(smax) * kDegPerRad;
  }
  if (lane == 0) C[a * ldc + b] = out;
}

int launch_any_rank(const float* Ua, long long sak, long long san,
                    long long sap, int Ka, const float* Ub, long long sbk,
                    long long sbn, long long sbq, int Kb, int n, int p, int q,
                    int eq2, float* C, long long ldc, cudaStream_t stream) {
  if (!eq2 && p != q) return cudaErrorInvalidValue;
  const DynLayout lay(p, q, eq2);
  if (lay.warp_bytes > kMaxSmem) return cudaErrorInvalidValue;
  int warps = static_cast<int>(kDefaultSmem / lay.warp_bytes);
  warps = warps < 1 ? 1 : (warps > kDynMaxWarps ? kDynMaxWarps : warps);
  const size_t smem = lay.warp_bytes * warps;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        proximity_any_rank, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long pairs = static_cast<long long>(Ka) * Kb;
  const long long grid = (pairs + warps - 1) / warps;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  proximity_any_rank<<<static_cast<unsigned>(grid), 32 * warps, smem,
                       stream>>>(Ua, sak, san, sap, Ka, Ub, sbk, sbn, sbq, Kb,
                                 n, p, q, eq2, C, ldc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Ua (Ka, n, p) and Ub (Kb, n, q) float32 with element strides; C (Ka, Kb)
// float32 with row stride ldc.  Any p, q >= 1.  eq2 != 0 selects Eq. 2, else
// Eq. 3 (p == q).  Up to kMaxRank both run on the FP64 tensor cores (eq3_tc,
// eq2_tc; upper-triangle tiles when Ua and Ub are one stack); larger ranks
// take the runtime-rank path.  split_rows, splits, tiles and ws are eq2's
// plan (kernels/proximity/proximity.py::eq2_plan) and its FP64 workspace
// (null when the plan has one split and one row group); the other routes
// ignore them.  Returns cudaGetLastError() after the launch(es) (nonzero:
// not launched).
int proximity_cross_f32(const float* Ua, long long sak, long long san,
                        long long sap, int Ka, const float* Ub, long long sbk,
                        long long sbn, long long sbq, int Kb, int n, int p,
                        int q, int eq2, float* C, long long ldc, int split_rows,
                        int splits, long long tiles, double* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Ka <= 0 || Kb <= 0 || n <= 0 || p <= 0 || q <= 0)
    return cudaErrorInvalidValue;
  if (!eq2 && p != q) return cudaErrorInvalidValue;
  if (p > kMaxRank || q > kMaxRank)
    return launch_any_rank(Ua, sak, san, sap, Ka, Ub, sbk, sbn, sbq, Kb, n, p,
                           q, eq2, C, ldc, st);
#define PROX_P(PP)                                                           \
  case PP:                                                                   \
    return eq2 ? pick_q<PP>(q, Ua, sak, san, sap, Ka, Ub, sbk, sbn, sbq, Kb, \
                            n, C, ldc, split_rows, splits, tiles, ws, st)    \
               : launch_eq3_tc<PP>(Ua, sak, san, sap, Ka, Ub, sbk, sbn, sbq, \
                                   Kb, n, C, ldc, st);
  switch (p) {
    PROX_P(1) PROX_P(2) PROX_P(3) PROX_P(4)
    PROX_P(5) PROX_P(6) PROX_P(7) PROX_P(8)
    default: return cudaErrorInvalidValue;
  }
#undef PROX_P
}

const char* proximity_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
