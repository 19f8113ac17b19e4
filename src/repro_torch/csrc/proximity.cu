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
// K * n * p floats that stay resident in the 50 MB L2.  The products are
// FP32 on the CUDA cores, never TF32: near G ~ 1 the arccos amplifies TF32's
// ~1e-3 relative error far beyond the 1e-3 degree parity tolerance.  For
// the same reason each NC-row chunk is summed in a fresh FP32 register and
// the chunk sums are added in FP64: at n = 3072 a plain sequential FP32 sum
// carries ~1e-6 of rounding in G, which arccos turns into >1e-3 degrees for
// angles of a few degrees (the within-cluster regime).
//
// Design: a 2-D grid of client-pair tiles, 16 x 16 threads, each thread a
// RA x RB micro-tile of pairs (sized so its FP32 chunk sums stay <= 32
// registers beside their FP64 totals).  The block walks n in chunks of NC
// rows staged through shared memory: the stage is laid out [row*P + col][client] so a warp's staging
// stores hit 32 distinct banks and the compute loop reads each thread's
// clients as one vector load.  Each pair accumulates only what its measure
// needs in registers (the p Gram diagonal entries for eq3, all p*q entries
// for eq2) and is reduced in-thread: eq3 by the clipped arccos sum, eq2 by
// the reference's fixed-sweep cyclic Jacobi on the packed q x q matrix
// G^T G (same plane order, sweep count, cancellation-free tangent, 1e-30
// denominator guard and rsqrt as measures.py::_jacobi_rotate).  Clients and
// rows past the edge are staged as zeros and never written.
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 16;
constexpr int kTy = 16;
constexpr int kThreads = kTx * kTy;
constexpr float kTiny = 1e-30f;
constexpr float kDegPerRad = 57.295779513082320876798f;
constexpr int kMaxRank = 8;

// Pairs per thread along a and b: RA * RB * ACC <= 32 chunk sums (one pair
// per thread when a single pair needs more).
template <int ACC> struct Micro {
  static constexpr int RA = ACC <= 4 ? 4 : (ACC <= 16 ? 2 : 1);
  static constexpr int RB = ACC <= 2 ? 4 : (ACC <= 8 ? 2 : 1);
};

template <int R>
__device__ __forceinline__ void lds(const float* p, float (&v)[R]) {
  if constexpr (R == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (R == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

// Stage rows [t0, t0 + NC) of T clients starting at k0 into s[row*P + r][i].
// A warp covers 4 clients x 8 consecutive (row, col) entries: 4 fully used
// 32-byte sectors per load on contiguous input, 32 distinct banks per store.
template <int P, int T, int L, int NC>
__device__ __forceinline__ void stage(float (*s)[L], const float* __restrict__ U,
                                      long long sk, long long sn, long long sp,
                                      int K, int n, int k0, int t0, int tid) {
  constexpr int kOcts = NC * P / 8;
  constexpr int kItems = T * NC * P;
  for (int e = tid; e < kItems; e += kThreads) {
    const int lane = e & 31;
    const int w = e >> 5;
    const int i = (w / kOcts) * 4 + (lane >> 3);
    const int rowidx = (w % kOcts) * 8 + (lane & 7);
    const int t = rowidx / P;
    const int r = rowidx - t * P;
    const int k = k0 + i;
    const int row = t0 + t;
    float v = 0.f;
    if (k < K && row < n) v = U[k * sk + row * sn + r * sp];
    s[rowidx][i] = v;
  }
}

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

template <int P, int Q, bool EQ2>
struct Shape {
  static constexpr int ACC = EQ2 ? P * Q : P;
  static constexpr int RA = Micro<ACC>::RA;
  static constexpr int RB = Micro<ACC>::RB;
  static constexpr int TA = kTy * RA;
  static constexpr int TB = kTx * RB;
  static constexpr int LA = TA + 4;  // row pad: keeps 16-byte alignment
  static constexpr int LB = TB + 4;
  static constexpr int NC = 16 * (P * LA + Q * LB) * 4 <= 48 * 1024 ? 16 : 8;
};

template <int P, int Q, bool EQ2>
__global__ void __launch_bounds__(kThreads)
proximity_kernel(const float* __restrict__ Ua, long long sak, long long san,
                 long long sap, int Ka, const float* __restrict__ Ub,
                 long long sbk, long long sbn, long long sbq, int Kb, int n,
                 float* __restrict__ C, long long ldc) {
  using S = Shape<P, Q, EQ2>;
  constexpr int RA = S::RA, RB = S::RB, NC = S::NC, ACC = S::ACC;
  __shared__ __align__(16) float sA[NC * P][S::LA];
  __shared__ __align__(16) float sB[NC * Q][S::LB];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTx + tx;
  const int a0 = blockIdx.y * S::TA;
  const int b0 = blockIdx.x * S::TB;

  double acc[RA][RB][ACC];
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j)
#pragma unroll
      for (int x = 0; x < ACC; ++x) acc[i][j][x] = 0.0;

  for (int t0 = 0; t0 < n; t0 += NC) {
    stage<P, S::TA, S::LA, NC>(sA, Ua, sak, san, sap, Ka, n, a0, t0, tid);
    stage<Q, S::TB, S::LB, NC>(sB, Ub, sbk, sbn, sbq, Kb, n, b0, t0, tid);
    __syncthreads();
    float part[RA][RB][ACC];
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j)
#pragma unroll
        for (int x = 0; x < ACC; ++x) part[i][j][x] = 0.f;
#pragma unroll 4
    for (int t = 0; t < NC; ++t) {
      float va[P][RA], vb[Q][RB];
#pragma unroll
      for (int r = 0; r < P; ++r) lds<RA>(&sA[t * P + r][ty * RA], va[r]);
#pragma unroll
      for (int s = 0; s < Q; ++s) lds<RB>(&sB[t * Q + s][tx * RB], vb[s]);
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          if constexpr (EQ2) {
#pragma unroll
            for (int r = 0; r < P; ++r)
#pragma unroll
              for (int s = 0; s < Q; ++s)
                part[i][j][r * Q + s] =
                    fmaf(va[r][i], vb[s][j], part[i][j][r * Q + s]);
          } else {
#pragma unroll
            for (int r = 0; r < P; ++r)
              part[i][j][r] = fmaf(va[r][i], vb[r][j], part[i][j][r]);
          }
        }
    }
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j)
#pragma unroll
        for (int x = 0; x < ACC; ++x) acc[i][j][x] += part[i][j][x];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RA; ++i) {
    const int a = a0 + ty * RA + i;
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int b = b0 + tx * RB + j;
      if (a < Ka && b < Kb) {
        float out;
        if constexpr (EQ2) {
          out = eq2_reduce<P, Q>(acc[i][j]);
        } else {
          out = eq3_reduce<P>(acc[i][j]);
        }
        C[a * ldc + b] = out;
      }
    }
  }
}

template <int P, int Q, bool EQ2>
int launch(const float* Ua, long long sak, long long san, long long sap,
           int Ka, const float* Ub, long long sbk, long long sbn,
           long long sbq, int Kb, int n, float* C, long long ldc,
           cudaStream_t stream) {
  using S = Shape<P, Q, EQ2>;
  const long long gx = (Kb + S::TB - 1) / S::TB;
  const long long gy = (Ka + S::TA - 1) / S::TA;
  if (gy > 65535 || gx > 2147483647LL) return cudaErrorInvalidValue;
  proximity_kernel<P, Q, EQ2><<<dim3((unsigned)gx, (unsigned)gy),
                                dim3(kTx, kTy), 0, stream>>>(
      Ua, sak, san, sap, Ka, Ub, sbk, sbn, sbq, Kb, n, C, ldc);
  return (int)cudaGetLastError();
}

template <int P, int Q>
int launch_pq(int eq2, const float* Ua, long long sak, long long san,
              long long sap, int Ka, const float* Ub, long long sbk,
              long long sbn, long long sbq, int Kb, int n, float* C,
              long long ldc, cudaStream_t stream) {
  if (eq2)
    return launch<P, Q, true>(Ua, sak, san, sap, Ka, Ub, sbk, sbn, sbq, Kb,
                              n, C, ldc, stream);
  if constexpr (P == Q) {
    return launch<P, Q, false>(Ua, sak, san, sap, Ka, Ub, sbk, sbn, sbq, Kb,
                               n, C, ldc, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <int P>
int pick_q(int q, int eq2, const float* Ua, long long sak, long long san,
           long long sap, int Ka, const float* Ub, long long sbk,
           long long sbn, long long sbq, int Kb, int n, float* C,
           long long ldc, cudaStream_t stream) {
#define PROX_Q(QQ)                                                           \
  case QQ:                                                                   \
    return launch_pq<P, QQ>(eq2, Ua, sak, san, sap, Ka, Ub, sbk, sbn, sbq,   \
                            Kb, n, C, ldc, stream);
  switch (q) {
    PROX_Q(1) PROX_Q(2) PROX_Q(3) PROX_Q(4)
    PROX_Q(5) PROX_Q(6) PROX_Q(7) PROX_Q(8)
    default: return cudaErrorInvalidValue;
  }
#undef PROX_Q
}

}  // namespace

extern "C" {

int proximity_max_rank() { return kMaxRank; }

// Ua (Ka, n, p) and Ub (Kb, n, q) float32 with element strides; C (Ka, Kb)
// float32 with row stride ldc.  eq2 != 0 selects Eq. 2, else Eq. 3 (p == q).
// Returns cudaGetLastError() after the launch (nonzero: not launched).
int proximity_cross_f32(const float* Ua, long long sak, long long san,
                        long long sap, int Ka, const float* Ub, long long sbk,
                        long long sbn, long long sbq, int Kb, int n, int p,
                        int q, int eq2, float* C, long long ldc,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Ka <= 0 || Kb <= 0 || n <= 0) return cudaErrorInvalidValue;
#define PROX_P(PP)                                                           \
  case PP:                                                                   \
    return pick_q<PP>(q, eq2, Ua, sak, san, sap, Ka, Ub, sbk, sbn, sbq, Kb,  \
                      n, C, ldc, st);
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
