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
// Ranks above kMaxRank (the largest rank a template unrolls) run on the same
// tiles, over column views of the stacks.  eq3 takes the p columns in
// chunks of at most 8, one eq3_tc launch each; every launch after the first
// reads C[a, b] and goes on adding its angles to it, so the float32 sum runs
// over r = 0 ... p - 1 in the reference's order.  A chunk's row is 8 (or
// p mod 8) contiguous floats at stride p, staged in 16-byte copies when
// p % 4 == 0 (kStageRowQuads).  eq2 forms each pair's p x q Gram in pieces
// of PC rows x QC columns (eq2_tc<PC, QC> on the views Ua[:, :, r..r+PC),
// Ub[:, :, s..s+QC); the host plan picks PC, QC <= 8), grid z enumerating
// the pieces of one shape, at most four shapes for the ragged edges; every
// piece writes its FP64 entries into the workspace at their place in the
// full p x q Gram.  eq2_form_any then adds the splits in split order and
// forms each epilogue's packed G^T G (on the symmetric grid also G G^T for
// C[b, a]) in float32 in the reference's order, and eq2_jacobi_any runs the
// cyclic Jacobi of each, a thread an epilogue, in shared memory with the
// runtime order q.  The workspace is bounded by running the tiles in
// batches (eq2_plan's batch_tiles): each batch's pieces, then its reduce.
// At K = 1024, p = q = 16 the Gram pieces take about two thirds of the time
// and the Jacobis (a million 16 x 16, six sweeps each) most of the rest.
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kTiny = 1e-30f;
constexpr float kDegPerRad = 57.295779513082320876798f;
constexpr int kMaxRank = 8;  // largest rank the templates unroll
constexpr int kMaxDevices = 64;

// The in-order clipped arccos sum over r; add: continue the sum `total` of
// the columns before these (a later rank chunk), else start it here.
template <int P>
__device__ __forceinline__ float eq3_reduce(const double (&gd)[P], float total,
                                            bool add) {
  float g[P];
#pragma unroll
  for (int r = 0; r < P; ++r) g[r] = static_cast<float>(gd[r]);
#pragma unroll
  for (int r = 0; r < P; ++r) {
    float d = fabsf(g[r]);
    d = d > 1.f ? 1.f : d;
    const float ang = acosf(d) * kDegPerRad;
    total = r == 0 && !add ? ang : total + ang;
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

// How a stack's stage rows are copied (stage_mode picks one on the host):
// kStageFlat, a client's rows are contiguous and 16-byte aligned (sn == P,
// sp == 1): 16-byte chunks over the client's whole stage row;
// kStageRowQuads, P % 4 == 0 and each row's P columns contiguous and
// 16-byte aligned (sp == 1, sn % 4 == 0; a column view of a wider stack):
// 16-byte chunks within each row; kStageScalar, one 4-byte copy per element.
constexpr int kStageScalar = 0, kStageFlat = 1, kStageRowQuads = 2;

// Stage rows [t0, t0 + NC) of T clients from k0 into s[i * LS + t * P + r]
// as `mode` says.  Clients and rows past the edge are zeros.
template <int P, int T, int LS, int NC, int THREADS>
__device__ __forceinline__ void stage_async(float* s, const float* __restrict__ U,
                                            long long sk, long long sn,
                                            long long sp, int K, int n, int k0,
                                            int t0, int tid, int mode) {
  constexpr int kRow = NC * P;
  if constexpr (P % 4 == 0) {
    if (mode == kStageRowQuads) {
      constexpr int kQuads = P / 4;
      constexpr int kChunks = NC * kQuads;   // 16-byte chunks a client
      for (int e = tid; e < T * kChunks; e += THREADS) {
        const int i = e / kChunks, rem = e - (e / kChunks) * kChunks;
        const int t = rem / kQuads, part = rem - (rem / kQuads) * kQuads;
        const int k = k0 + i;
        const bool valid = k < K && t0 + t < n;
        cp_async16(&s[i * LS + t * P + 4 * part],
                   valid ? U + k * sk + (t0 + t) * sn + 4 * part : U, valid ? 16 : 0);
      }
      return;
    }
  }
  if (mode == kStageFlat) {
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
// add != 0: these are columns after the first chunk of a wider stack, and
// the sum goes on from C[a, b] (which only this block of the grid reads).
template <int P>
__global__ void __launch_bounds__(Eq3Tile<P>::THREADS)
eq3_tc(const float* __restrict__ Ua, long long sak, long long san,
       long long sap, int Ka, const float* __restrict__ Ub, long long sbk,
       long long sbn, long long sbq, int Kb, int n, float* __restrict__ C,
       long long ldc, int sym, int mode_a, int mode_b, int add) {
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
                                                tid, mode_a);
      stage_async<P, T::TB, LS, NC, T::THREADS>(sB + c * T::STAGE, Ub, sbk,
                                                sbn, sbq, Kb, n, b0, c * NC,
                                                tid, mode_b);
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
                                                  cn * NC, tid, mode_a);
        stage_async<P, T::TB, LS, NC, T::THREADS>(sB + slot * T::STAGE, Ub,
                                                  sbk, sbn, sbq, Kb, n, b0,
                                                  cn * NC, tid, mode_b);
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
        const float out = eq3_reduce<P>(gd, add ? C[a * ldc + b] : 0.f, add != 0);
        C[a * ldc + b] = out;
        if (sym && a != b) C[b * ldc + a] = out;
      }
    }
  }
}

// The operands and output of one call: Ua (Ka, n, p), Ub (Kb, n, q) float32
// with element strides, C (Ka, Kb) float32 with row stride ldc.
struct Operands {
  const float* Ua;
  long long sak, san, sap;
  int Ka;
  const float* Ub;
  long long sbk, sbn, sbq;
  int Kb;
  int n;
  float* C;
  long long ldc;
};

// How the kernels stage a stack's column view of `rank` columns at U
// (stage_async's modes).
int stage_mode(const float* U, long long sk, long long sn, long long sp, int rank) {
  if (sp != 1 || sk % 4 != 0 || reinterpret_cast<unsigned long long>(U) % 16 != 0)
    return kStageScalar;
  if (sn == rank) return kStageFlat;
  return rank % 4 == 0 && sn % 4 == 0 ? kStageRowQuads : kStageScalar;
}

// Sets a kernel's dynamic shared memory limit once per device: 0 or an error.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, int (&done)[kMaxDevices]) {
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev] < bytes) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    if (rc != 0) return rc;
    done[dev] = bytes;
  }
  return 0;
}

// eq3 over the columns [r0, r0 + P) of both stacks; sym: they are one stack
// (upper-triangle tiles); add: continue the sums in C (a chunk after the
// first).
template <int P>
int launch_eq3_tc(const Operands& o, int r0, bool sym, bool add, cudaStream_t stream) {
  using T = Eq3Tile<P>;
  static int smem_set[kMaxDevices];
  int rc = allow_smem(eq3_tc<P>, T::SMEM, smem_set);
  if (rc != 0) return rc;
  dim3 grid;
  if (sym) {
    const long long nt = (o.Ka + T::TA - 1) / T::TA;
    const long long tiles = nt * (nt + 1) / 2;
    if (tiles > 2147483647LL) return cudaErrorInvalidValue;
    grid = dim3(static_cast<unsigned>(tiles));
  } else {
    const long long gx = (o.Kb + T::TB - 1) / T::TB;
    const long long gy = (o.Ka + T::TA - 1) / T::TA;
    if (gy > 65535 || gx > 2147483647LL) return cudaErrorInvalidValue;
    grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  }
  const float* Ua = o.Ua + r0 * o.sap;
  const float* Ub = o.Ub + r0 * o.sbq;
  eq3_tc<P><<<grid, T::THREADS, T::SMEM, stream>>>(
      Ua, o.sak, o.san, o.sap, o.Ka, Ub, o.sbk, o.sbn, o.sbq, o.Kb, o.n, o.C,
      o.ldc, sym ? 1 : 0, stage_mode(Ua, o.sak, o.san, o.sap, P),
      stage_mode(Ub, o.sbk, o.sbn, o.sbq, P), add ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// eq3 at any rank p: chunks of kMaxRank columns, then the rest, each
// launch after the first adding into C (chunks of 4 or 6 columns took
// longer at p = 12 and 16, though eq3_tc<8> spills 56 bytes a thread).
int launch_eq3(const Operands& o, int p, bool sym, cudaStream_t stream) {
  for (int r0 = 0; r0 < p; r0 += kMaxRank) {
    const int w = p - r0 < kMaxRank ? p - r0 : kMaxRank;
    int rc;
    switch (w) {
#define PROX_EQ3(PP) \
  case PP: rc = launch_eq3_tc<PP>(o, r0, sym, r0 > 0, stream); break;
      PROX_EQ3(1) PROX_EQ3(2) PROX_EQ3(3) PROX_EQ3(4)
      PROX_EQ3(5) PROX_EQ3(6) PROX_EQ3(7) PROX_EQ3(8)
#undef PROX_EQ3
      default: rc = cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
  }
  return 0;
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

// Where a launch's blocks sit.  Grid x: the tiles of a batch, from tile0.
// Grid z: pieces x GROUPS; piece x of a launch is the view whose columns
// start at (x / col_chunks) * P of Ua and (x % col_chunks) * Q of Ub, past
// its first piece's (the pointers the kernel gets), which is Gram row
// r_base, column s_base.  The workspace holds each pair's full Gram, ws_q
// columns a row, ws_entries entries.
struct Eq2Grid {
  long long tile0;
  int col_chunks;
  int r_base, s_base;
  int ws_q, ws_entries;
};

// Block (tile, split, piece and group): the FP64 Gram entries of the
// piece's rows r in [group * RG, (group + 1) * RG) and its Q columns, for
// the tile's pairs, summed over the split's rows [split * split_rows, ...)
// of n (a multiple of 16).  ws null (one split, one piece, one group): the
// Jacobi epilogue in registers, into C.  Else the partial Grams go to
// ws[split][tile - tile0][r * ws_q + s][pair] (r, s in the full Gram),
// pair = 32 * (a - a0) + (b - b0), for eq2_reduce_ws or eq2_form_any.
template <int P, int Q>
__global__ void __launch_bounds__(Eq2Tile<P, Q>::THREADS)
eq2_tc(const float* __restrict__ Ua, long long sak, long long san,
       long long sap, int Ka, const float* __restrict__ Ub, long long sbk,
       long long sbn, long long sbq, int Kb, int n, float* __restrict__ C,
       long long ldc, int sym, int mode_a, int mode_b, int split_rows,
       double* __restrict__ ws, Eq2Grid grid) {
  using T = Eq2Tile<P, Q>;
  constexpr int NC = T::NC, NS = T::NS, RG = T::RG;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                  // [NS][TA][LSA]
  float* sB = smem + NS * T::STA;    // [NS][TB][LSB]

  const long long tile = grid.tile0 + blockIdx.x;
  const int split = blockIdx.y;
  const int piece = blockIdx.z / T::GROUPS;
  const int r0 = (blockIdx.z - piece * T::GROUPS) * RG;
  const int pr = piece / grid.col_chunks, pc = piece - pr * grid.col_chunks;
  Ua += static_cast<long long>(pr) * P * sap;
  Ub += static_cast<long long>(pc) * Q * sbq;
  const int ra = grid.r_base + pr * P;   // the piece's first Gram row
  const int sb = grid.s_base + pc * Q;   // and column
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
                                                  lo + c * NC, tid, mode_a);
    stage_async<Q, T::TB, T::LSB, NC, T::THREADS>(sB + slot * T::STB, Ub, sbk,
                                                  sbn, sbq, Kb, n, b0,
                                                  lo + c * NC, tid, mode_b);
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
      double* dst = ws + (static_cast<long long>(split) * gridDim.x + blockIdx.x) *
                             (static_cast<long long>(grid.ws_entries) * T::PAIRS) +
                    al * T::TB + bl;
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int s = 0; s < Q; ++s)
          dst[static_cast<long long>((ra + r0 + r) * grid.ws_q + sb + s) * T::PAIRS] =
              acc[r][s][x];
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

// Second pass of a split (or grouped) eq2 grid at p, q <= kMaxRank, over a
// batch of tiles from tile0.  A block takes 32 pairs of a tile: its threads
// add the splits' partial Grams in split order, one (entry, pair) at a time
// with the pairs across lanes (coalesced reads, several splits' loads in
// flight), into shared memory; then one warp runs the epilogue, a pair a
// lane.  No atomics: the result is the same bitwise from run to run.
constexpr int kReduceThreads = 256;
constexpr int kReducePairs = 32;

template <int P, int Q>
__global__ void __launch_bounds__(kReduceThreads)
eq2_reduce_ws(const double* __restrict__ ws, long long tile0, long long batch_tiles,
              int splits, int Ka, int Kb, int sym, float* __restrict__ C, long long ldc) {
  using T = Eq2Tile<P, Q>;
  constexpr int PQ = P * Q, CHUNKS = T::PAIRS / kReducePairs;
  __shared__ double g[PQ][kReducePairs + 1];
  const long long slot = blockIdx.x / CHUNKS;
  const int p0 = static_cast<int>(blockIdx.x % CHUNKS) * kReducePairs;
  const long long stride = static_cast<long long>(PQ) * T::PAIRS;  // a split's tile
  const long long split_stride = batch_tiles * stride;
  const double* src = ws + slot * stride + p0;
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
  eq2_tile(tile0 + slot, sym, Kb, T::TB, bi, bj);
  const int pair = p0 + static_cast<int>(threadIdx.x);
  double gd[PQ];
#pragma unroll
  for (int e = 0; e < PQ; ++e) gd[e] = g[e][threadIdx.x];
  eq2_store<P, Q>(gd, bi * T::TA + pair / T::TB, bj * T::TB + pair % T::TB, Ka, Kb,
                  sym != 0, bi == bj, C, ldc);
}

// Second pass of the any-rank grid (p or q > kMaxRank), p and q at run
// time, over a batch of tiles, in two kernels.  Each block of either takes
// `pairs` pairs of a tile (jobs / 2 on the symmetric grid, else jobs) and
// runs `jobs` epilogues: the Jacobi of G^T G (q x q) for C[a, b], and on
// the symmetric grid of G G^T (p x p, p == q) for C[b, a].
//
// eq2_form_any: the block's threads add the splits' FP64 pieces in split
// order (pairs across lanes, several loads in flight a thread), round each
// Gram entry to float32 into shared memory, then form each epilogue's
// matrix in float32 in the reference's order as eq2_reduce does (the packed
// upper triangle, (i, j) at tri_row(i, m) + j) and write it back over the
// block's own columns of the workspace's first split: entry t of job j is
// float f = t * jobs + j of the block's columns, 2 * pairs floats a row of
// the workspace (which has `entries` rows a tile, enough for them).
//
// eq2_jacobi_any: a thread an epilogue.  Its matrix is copied into its own
// column of shared memory (interleaved by job, so a warp's accesses are
// conflict-free) and swept there by the cyclic Jacobi with the same plane
// order, sweep count, tangent, 1e-30 guard and rsqrt as rotate().  What
// bounds it: the dependent chain of each rotation (two loads, sqrt, divide,
// rsqrt) and the shared-memory traffic of its m - 2 off-plane updates, so
// the more epilogues an SM holds the better: the Gram, which only the
// forming needs, is not in this kernel's shared memory.  A rotation issues
// its first kRotGroup updates' loads before the chain, and the updates
// address their entries through one table for the block, idx[a * m + b] =
// the packed entry (min, max) of (a, b) times jobs, whose diagonal points at
// each job's scratch slot: the updates at k = i and k = j then need no test
// (they write the scratch slot and (i, j), which is stored afterwards).
// No atomics and no stack.
constexpr int kAnyThreads = 256;   // threads of a forming block
constexpr int kAnyJobs = 64;       // the most epilogues a block runs
constexpr int kLoadUnroll = 4;
constexpr int kRotGroup = 8;
constexpr int kTilePairs = 32 * 32;   // a tile's pairs: the workspace's last axis

__host__ __device__ __forceinline__ int tri_row(int i, int m) {
  return i * m - i * (i + 1) / 2;
}

// Shared memory of the two kernels' blocks, in 4-byte words: the Gram of
// the block's pairs; each job's packed triangle and scratch slot and the
// offset table.
__host__ __device__ __forceinline__ long long form_any_words(int p, int q, int jobs, bool sym) {
  return static_cast<long long>(p) * q * (sym ? jobs / 2 : jobs);
}
__host__ __device__ __forceinline__ long long jacobi_any_words(int q, int jobs) {
  return (static_cast<long long>(q) * (q + 1) / 2 + 1) * jobs + static_cast<long long>(q) * q;
}

__global__ void __launch_bounds__(kAnyThreads)
eq2_form_any(double* __restrict__ ws, long long batch_tiles, int splits, int p, int q,
             int entries, int jobs, int sym) {
  extern __shared__ __align__(16) float g[];   // [pq][pairs]
  const int pq = p * q, m = q;   // m: the matrices' order (p == q on the symmetric grid)
  const int pairs = sym ? jobs / 2 : jobs;
  const int chunks = kTilePairs / pairs;
  const long long slot = blockIdx.x / chunks;
  const int p0 = static_cast<int>(blockIdx.x - slot * chunks) * pairs;
  const long long stride = static_cast<long long>(entries) * kTilePairs;   // a split's tile
  const long long split_stride = batch_tiles * stride;
  double* src = ws + slot * stride + p0;
  const int total = pq * pairs;
  for (int base = threadIdx.x; base < total; base += kLoadUnroll * kAnyThreads) {
    const double* x[kLoadUnroll];
    double v[kLoadUnroll];
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int item = base + u * kAnyThreads;
      const int e = item / pairs, pl = item - (item / pairs) * pairs;
      x[u] = src + static_cast<long long>(e) * kTilePairs + pl;
      v[u] = item < total ? x[u][0] : 0.0;
    }
    for (int sp = 1; sp < splits; ++sp) {
#pragma unroll
      for (int u = 0; u < kLoadUnroll; ++u)
        if (base + u * kAnyThreads < total) v[u] += x[u][sp * split_stride];
    }
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u)
      if (base + u * kAnyThreads < total) g[base + u * kAnyThreads] = static_cast<float>(v[u]);
  }
  __syncthreads();
  // kAnyThreads / jobs threads a job, rows i apart; X (terms x m) is G
  // (p x q) for C[a, b], G^T (q x p) for C[b, a]
  float* out = reinterpret_cast<float*>(src);
  const int per_job = kAnyThreads / jobs;
  for (int w = threadIdx.x; w < jobs * per_job; w += kAnyThreads) {
    const int job = w % jobs, h = w / jobs;
    const bool tr = sym && job >= pairs;
    const int terms = tr ? q : p;
    const int xk = (tr ? 1 : q) * pairs, xi = (tr ? q : 1) * pairs;
    const float* X = g + (tr ? job - pairs : job);
    for (int i = h; i < m; i += per_job) {
      const int ri = tri_row(i, m);
      for (int j = i; j < m; ++j) {
        float acc = X[i * xi] * X[j * xi];
        for (int k = 1; k < terms; ++k) acc = acc + X[k * xk + i * xi] * X[k * xk + j * xi];
        const int f = (ri + j) * jobs + job;
        out[2LL * (f / (2 * pairs)) * kTilePairs + f % (2 * pairs)] = acc;
      }
    }
  }
}

__global__ void __launch_bounds__(kAnyJobs)
eq2_jacobi_any(const double* __restrict__ ws, long long tile0, int q, int entries, int jobs,
               int Ka, int Kb, int sym, float* __restrict__ C, long long ldc) {
  extern __shared__ __align__(16) float bq[];   // [tri + 1][jobs], then idx
  const int m = q;
  const int tri = m * (m + 1) / 2;
  const int pairs = sym ? jobs / 2 : jobs;
  const int chunks = kTilePairs / pairs;
  const long long slot = blockIdx.x / chunks;
  const int p0 = static_cast<int>(blockIdx.x - slot * chunks) * pairs;
  const float* in = reinterpret_cast<const float*>(
      ws + slot * static_cast<long long>(entries) * kTilePairs + p0);
  int* idx = reinterpret_cast<int*>(bq + (tri + 1) * jobs);   // [m][m]
  for (int f = threadIdx.x; f < tri * jobs; f += blockDim.x)
    bq[f] = in[2LL * (f / (2 * pairs)) * kTilePairs + f % (2 * pairs)];
  for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
    const int r = e / m, c = e - (e / m) * m;
    idx[e] = (r == c ? tri : (r < c ? tri_row(r, m) + c : tri_row(c, m) + r)) * jobs;
  }
  __syncthreads();
  const int job = threadIdx.x;
  if (job >= jobs) return;
  const bool tr = sym && job >= pairs;   // the G G^T epilogue, for C[b, a]
  const int pl = tr ? job - pairs : job;
  int bi, bj;
  eq2_tile(tile0 + slot, sym, Kb, 32, bi, bj);
  const int a = bi * 32 + (p0 + pl) / 32, b = bj * 32 + (p0 + pl) % 32;
  if (a >= Ka || b >= Kb || (sym && bi == bj && a > b) || (tr && a == b)) return;
  float* B = bq + job;
  float lam = B[0];
  if (m > 1) {
    const int sweeps = m <= 5 ? 4 : 6;
    for (int it = 0; it < sweeps; ++it) {
      for (int i = 0; i < m - 1; ++i) {
        const int ri = tri_row(i, m);
        const int* row_i = idx + i * m;
        float bii = B[(ri + i) * jobs];   // only the planes (i, j) below change it
        for (int j = i + 1; j < m; ++j) {
          const int* row_j = idx + j * m;
          const int jj = (tri_row(j, m) + j) * jobs, ij = (ri + j) * jobs;
          float x[kRotGroup], y[kRotGroup];
          int xo[kRotGroup], yo[kRotGroup];
          auto load = [&](int k0) {
#pragma unroll
            for (int u = 0; u < kRotGroup; ++u) {
              if (k0 + u < m) {
                xo[u] = row_i[k0 + u];
                yo[u] = row_j[k0 + u];
                x[u] = B[xo[u]];
                y[u] = B[yo[u]];
              }
            }
          };
          load(0);
          const float bjj = B[jj], bij = B[ij];
          const float d = bjj - bii;
          const float e = bij + bij;
          const float den = fabsf(d) + sqrtf(d * d + e * e) + kTiny;
          const float sgn = d >= 0.f ? 1.f : -1.f;
          const float t = sgn * e / den;
          const float c = rsqrtf(1.f + t * t);
          const float s = t * c;
          const float tb = t * bij;
          for (int k0 = 0; k0 < m; k0 += kRotGroup) {
            if (k0 > 0) load(k0);
#pragma unroll
            for (int u = 0; u < kRotGroup; ++u) {
              if (k0 + u < m) {
                B[xo[u]] = c * x[u] - s * y[u];
                B[yo[u]] = s * x[u] + c * y[u];
              }
            }
          }
          bii = bii - tb;
          B[jj] = bjj + tb;
          B[ij] = 0.f;
        }
        B[(ri + i) * jobs] = bii;
      }
    }
    lam = B[0];
    for (int i = 1; i < m; ++i) {
      const float v = B[(tri_row(i, m) + i) * jobs];
      lam = v > lam ? v : lam;
    }
  }
  lam = lam < 0.f ? 0.f : lam;
  float smax = sqrtf(lam);
  smax = smax > 1.f ? 1.f : smax;
  const float out = acosf(smax) * kDegPerRad;
  if (tr) {
    C[b * ldc + a] = out;
  } else {
    C[a * ldc + b] = out;
  }
}

// eq2's host plan (kernels/proximity/proximity.py::eq2_plan): n in `splits`
// of split_rows rows; the Gram in pieces of chunk_p x chunk_q (p x q: one
// piece, the templates' route); the tiles in batches of batch_tiles, each
// batch's pieces then its reduce; reduce_jobs epilogues a block of
// eq2_form_any and eq2_jacobi_any; ws the FP64 workspace (splits,
// batch_tiles, entries, 32 * 32), entries = p * q or more (see launch_eq2),
// null when the plan has one split, one piece and one row group.
struct Eq2Plan {
  int split_rows, splits;
  long long tiles, batch_tiles;
  int chunk_p, chunk_q, reduce_jobs;
  double* ws;
};

template <int P, int Q>
int launch_eq2_tc(const Operands& o, bool sym, const Eq2Plan& plan, const Eq2Grid& grid,
                  int row_chunks, long long tiles, cudaStream_t stream) {
  using T = Eq2Tile<P, Q>;
  static int smem_set[kMaxDevices];
  int rc = allow_smem(eq2_tc<P, Q>, T::SMEM, smem_set);
  if (rc != 0) return rc;
  const long long z = static_cast<long long>(row_chunks) * grid.col_chunks * T::GROUPS;
  if (z > 65535 || tiles > 2147483647LL) return cudaErrorInvalidValue;
  const float* Ua = o.Ua + grid.r_base * o.sap;
  const float* Ub = o.Ub + grid.s_base * o.sbq;
  eq2_tc<P, Q><<<dim3(static_cast<unsigned>(tiles), plan.splits, static_cast<unsigned>(z)),
                 T::THREADS, T::SMEM, stream>>>(
      Ua, o.sak, o.san, o.sap, o.Ka, Ub, o.sbk, o.sbn, o.sbq, o.Kb, o.n, o.C, o.ldc,
      sym ? 1 : 0, stage_mode(Ua, o.sak, o.san, o.sap, P),
      stage_mode(Ub, o.sbk, o.sbn, o.sbq, Q), plan.split_rows, plan.ws, grid);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int Q>
int launch_eq2_reduce_ws(const Operands& o, bool sym, const Eq2Plan& plan, long long tile0,
                         long long tiles, cudaStream_t stream) {
  const long long blocks = tiles * (Eq2Tile<P, Q>::PAIRS / kReducePairs);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  eq2_reduce_ws<P, Q><<<static_cast<unsigned>(blocks), kReduceThreads, 0, stream>>>(
      plan.ws, tile0, tiles, plan.splits, o.Ka, o.Kb, sym ? 1 : 0, o.C, o.ldc);
  return static_cast<int>(cudaGetLastError());
}

// f(integral_constant P, integral_constant Q) for runtime 1 <= P, Q <= kMaxRank.
template <int P, typename F>
int with_q(int q, F&& f) {
  switch (q) {
#define PROX_Q(QQ) \
  case QQ: return f(std::integral_constant<int, P>{}, std::integral_constant<int, QQ>{});
    PROX_Q(1) PROX_Q(2) PROX_Q(3) PROX_Q(4) PROX_Q(5) PROX_Q(6) PROX_Q(7) PROX_Q(8)
#undef PROX_Q
    default: return cudaErrorInvalidValue;
  }
}
template <typename F>
int with_pq(int p, int q, F&& f) {
  switch (p) {
#define PROX_P(PP) \
  case PP: return with_q<PP>(q, f);
    PROX_P(1) PROX_P(2) PROX_P(3) PROX_P(4) PROX_P(5) PROX_P(6) PROX_P(7) PROX_P(8)
#undef PROX_P
    default: return cudaErrorInvalidValue;
  }
}


int launch_eq2(const Operands& o, int p, int q, bool sym, const Eq2Plan& plan,
               cudaStream_t stream) {
  constexpr int kTile = 32;
  const long long nta = (o.Ka + kTile - 1) / kTile, ntb = (o.Kb + kTile - 1) / kTile;
  const long long tiles = sym ? nta * (nta + 1) / 2 : nta * ntb;
  const bool pieces = plan.chunk_p < p || plan.chunk_q < q;
  const bool grouped = !pieces && eq2_row_group(p, q) < p;
  const bool two_pass = pieces || grouped || plan.splits > 1;
  // workspace rows a tile: the Gram's p * q, or on the any-rank route enough
  // for the forming kernel's matrices (tri(q) floats an epilogue, two doubles
  // a float pair)
  const long long tri_q = static_cast<long long>(q) * (q + 1) / 2;
  const long long rows = pieces ? (tri_q * (sym ? 2 : 1) + 1) / 2 : 0;
  const int entries = static_cast<int>(rows > static_cast<long long>(p) * q ? rows : p * q);
  if (tiles != plan.tiles || plan.split_rows <= 0 || plan.split_rows % kStageRows != 0 ||
      plan.splits > 65535 || plan.splits != (o.n + plan.split_rows - 1) / plan.split_rows ||
      plan.chunk_p < 1 || plan.chunk_p > kMaxRank || plan.chunk_p > p ||
      plan.chunk_q < 1 || plan.chunk_q > kMaxRank || plan.chunk_q > q ||
      plan.batch_tiles < 1 || plan.batch_tiles > tiles ||
      (!two_pass && plan.batch_tiles != tiles) || two_pass != (plan.ws != nullptr))
    return cudaErrorInvalidValue;
  long long form_smem = 0, jacobi_smem = 0;
  if (pieces) {
    const int jobs = plan.reduce_jobs;
    form_smem = 4 * form_any_words(p, q, jobs, sym);
    jacobi_smem = 4 * jacobi_any_words(q, jobs);
    if (jobs < 1 || jobs > kAnyJobs || (sym && jobs % 2 != 0) ||
        kTilePairs % (sym ? jobs / 2 : jobs) != 0 || form_smem > 232448 ||
        jacobi_smem > 232448)
      return cudaErrorInvalidValue;
    static int form_set[kMaxDevices], jacobi_set[kMaxDevices];
    int rc = allow_smem(eq2_form_any, static_cast<int>(form_smem), form_set);
    if (rc == 0) rc = allow_smem(eq2_jacobi_any, static_cast<int>(jacobi_smem), jacobi_set);
    if (rc != 0) return rc;
  }
  // the pieces: rows [0, fp) in chunks of chunk_p, then [fp, p); columns alike
  const int fp = p - p % plan.chunk_p, fq = q - q % plan.chunk_q;
  const int row_w[2] = {plan.chunk_p, p - fp}, row_n[2] = {p / plan.chunk_p, 1},
            row_0[2] = {0, fp};
  const int col_w[2] = {plan.chunk_q, q - fq}, col_n[2] = {q / plan.chunk_q, 1},
            col_0[2] = {0, fq};
  for (long long t0 = 0; t0 < tiles; t0 += plan.batch_tiles) {
    const long long bt = tiles - t0 < plan.batch_tiles ? tiles - t0 : plan.batch_tiles;
    for (int i = 0; i < 2; ++i) {
      for (int j = 0; j < 2; ++j) {
        if (row_w[i] == 0 || col_w[j] == 0) continue;
        const Eq2Grid grid{t0, col_n[j], row_0[i], col_0[j], q, entries};
        const int rc = with_pq(row_w[i], col_w[j], [&](auto P, auto Q) {
          return launch_eq2_tc<decltype(P)::value, decltype(Q)::value>(
              o, sym, plan, grid, row_n[i], bt, stream);
        });
        if (rc != 0) return rc;
      }
    }
    if (!two_pass) continue;
    int rc;
    if (pieces) {
      const int jobs = plan.reduce_jobs;
      const long long blocks = bt * (kTilePairs / (sym ? jobs / 2 : jobs));
      if (blocks > 2147483647LL) return cudaErrorInvalidValue;
      eq2_form_any<<<static_cast<unsigned>(blocks), kAnyThreads,
                     static_cast<size_t>(form_smem), stream>>>(plan.ws, bt, plan.splits, p, q,
                                                               entries, jobs, sym ? 1 : 0);
      rc = static_cast<int>(cudaGetLastError());
      if (rc != 0) return rc;
      eq2_jacobi_any<<<static_cast<unsigned>(blocks), jobs, static_cast<size_t>(jacobi_smem),
                       stream>>>(plan.ws, t0, q, entries, jobs, o.Ka, o.Kb, sym ? 1 : 0, o.C,
                                 o.ldc);
      rc = static_cast<int>(cudaGetLastError());
    } else {
      rc = with_pq(p, q, [&](auto P, auto Q) {
        return launch_eq2_reduce_ws<decltype(P)::value, decltype(Q)::value>(o, sym, plan, t0,
                                                                            bt, stream);
      });
    }
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

extern "C" {

// Ua (Ka, n, p) and Ub (Kb, n, q) float32 with element strides; C (Ka, Kb)
// float32 with row stride ldc.  Any p, q >= 1.  eq2 != 0 selects Eq. 2, else
// Eq. 3 (p == q).  Both run on the FP64 tensor cores (eq3_tc in chunks of at
// most kMaxRank columns; eq2_tc in pieces, then eq2_reduce_ws or
// eq2_form_any and eq2_jacobi_any), on the upper-triangle tiles when Ua and Ub are one stack
// (same pointer, strides and K).  split_rows ... ws are eq2's plan
// (kernels/proximity/proximity.py::eq2_plan) and its FP64 workspace (null
// when the plan has one split, one piece and one row group); eq3 ignores
// them.  Returns cudaGetLastError() after the last launch (nonzero: that
// launch and the ones after it did not run).
int proximity_cross_f32(const float* Ua, long long sak, long long san,
                        long long sap, int Ka, const float* Ub, long long sbk,
                        long long sbn, long long sbq, int Kb, int n, int p,
                        int q, int eq2, float* C, long long ldc, int split_rows,
                        int splits, long long tiles, long long batch_tiles,
                        int chunk_p, int chunk_q, int reduce_jobs, double* ws,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Ka <= 0 || Kb <= 0 || n <= 0 || p <= 0 || q <= 0)
    return cudaErrorInvalidValue;
  if (!eq2 && p != q) return cudaErrorInvalidValue;
  const Operands o{Ua, sak, san, sap, Ka, Ub, sbk, sbn, sbq, Kb, n, C, ldc};
  // the same stack on both sides: upper-triangle tiles only
  const bool sym = Ua == Ub && Ka == Kb && sak == sbk && san == sbn && sap == sbq && p == q;
  if (!eq2) return launch_eq3(o, p, sym, st);
  const Eq2Plan plan{split_rows, splits, tiles, batch_tiles, chunk_p, chunk_q, reduce_jobs, ws};
  return launch_eq2(o, p, q, sym, plan, st);
}

const char* proximity_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
