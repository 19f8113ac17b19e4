// Batched, strided tall-skinny GEMM: C[z] = A[z] @ B[z] with float32
// accumulation, A (Bt, m, k) and B (Bt, k, p) float32 or bfloat16, C
// (Bt, m, p) float32, every operand addressed through its own strides.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tsgemm/tsgemm.py
// (_tsgemm_kernel / tsgemm_pallas), which the reference vmaps over clients
// for the randomized-SVD sketch products of src/repro/core/svd.py.  Here the
// batch rides in blockIdx.z instead.
//
// What bounds it on an H100: reading A.  p is the sketch width (rank +
// oversample, 11 for the paper's p = 3), so B and C are small and the
// product does ~2p flops per A element, far below the card's flop/byte
// ridge.  The callers pass D, D^T and Q^T views; taking strides instead of
// a .contiguous() copy keeps each A element read from device memory once.
//
// Design: a block owns BM = 128 rows of C and a PT = 16 column slice, and
// walks k in BK = 32 steps.  Each step stages the (BM, BK) A tile in shared
// memory through 16-byte vector loads along whichever axis of A is
// contiguous (float32, aligned, full tile) or coalesced scalar loads along
// it (bfloat16, ragged edge, unaligned views), and the (BK, PT) B slab
// beside it; out-of-range entries are staged as zeros.  Each thread then
// accumulates one row against the whole slab, with B read as broadcast
// vectors.  The row pad of the A stage keeps both staging layouts free of
// bank conflicts.  The wrapper turns a product whose B is the wide operand
// (Q^T @ D) into its transpose, so A is always the large operand.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;
constexpr int kBK = 32;
constexpr int kPT = 16;
constexpr int kThreads = kBM;
constexpr int kLdaMax = kBM + 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// a_mode: 0 = m is the fast axis of A, 1 = k is; vec: 16-byte loads allowed.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tsgemm_kernel(const T* __restrict__ A, long long sab, long long sam,
              long long sak, const T* __restrict__ B, long long sbb,
              long long sbk, long long sbp, float* __restrict__ C,
              long long scb, long long scm, long long scp, int m, int k,
              int p, int a_mode, int vec) {
  constexpr bool kVecType = sizeof(T) == sizeof(float);
  __shared__ __align__(16) float sA[kBK * kLdaMax];
  __shared__ __align__(16) float sB[kBK][kPT];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int j0 = blockIdx.y * kPT;
  const long long z = blockIdx.z;
  const T* Az = A + z * sab;
  const T* Bz = B + z * sbb;
  // k-fast staging stores a column per warp: pad 1 spreads it over banks;
  // m-fast staging stores rows as float4: pad 4 keeps them aligned.
  const int lda = a_mode == 1 ? kBM + 1 : kBM + 4;

  float acc[kPT];
#pragma unroll
  for (int j = 0; j < kPT; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    if (a_mode == 0) {
      if (kVecType && vec && m0 + kBM <= m) {
        constexpr int kQ = kBM / 4;
#pragma unroll 4
        for (int e = tid; e < kBM * kBK / 4; e += kThreads) {
          const int mq = e % kQ, kk = e / kQ;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k0 + kk < k)
            v = *reinterpret_cast<const float4*>(
                reinterpret_cast<const float*>(Az) + (m0 + 4 * mq) * sam +
                (k0 + kk) * sak);
          *reinterpret_cast<float4*>(&sA[kk * lda + 4 * mq]) = v;
        }
      } else {
#pragma unroll 4
        for (int e = tid; e < kBM * kBK; e += kThreads) {
          const int mm = e % kBM, kk = e / kBM;
          float v = 0.f;
          if (m0 + mm < m && k0 + kk < k)
            v = to_f32(Az[(m0 + mm) * sam + (k0 + kk) * sak]);
          sA[kk * lda + mm] = v;
        }
      }
    } else {
      if (kVecType && vec && k0 + kBK <= k) {
        constexpr int kQ = kBK / 4;
#pragma unroll 4
        for (int e = tid; e < kBM * kBK / 4; e += kThreads) {
          const int kq = e % kQ, mm = e / kQ;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (m0 + mm < m)
            v = *reinterpret_cast<const float4*>(
                reinterpret_cast<const float*>(Az) + (m0 + mm) * sam +
                (k0 + 4 * kq) * sak);
          sA[(4 * kq + 0) * lda + mm] = v.x;
          sA[(4 * kq + 1) * lda + mm] = v.y;
          sA[(4 * kq + 2) * lda + mm] = v.z;
          sA[(4 * kq + 3) * lda + mm] = v.w;
        }
      } else {
#pragma unroll 4
        for (int e = tid; e < kBM * kBK; e += kThreads) {
          const int kk = e % kBK, mm = e / kBK;
          float v = 0.f;
          if (m0 + mm < m && k0 + kk < k)
            v = to_f32(Az[(m0 + mm) * sam + (k0 + kk) * sak]);
          sA[kk * lda + mm] = v;
        }
      }
    }
    for (int e = tid; e < kBK * kPT; e += kThreads) {
      const int jj = e % kPT, kk = e / kPT;
      float v = 0.f;
      if (k0 + kk < k && j0 + jj < p)
        v = to_f32(Bz[(k0 + kk) * sbk + (j0 + jj) * sbp]);
      sB[kk][jj] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float a = sA[kk * lda + tid];
#pragma unroll
      for (int j4 = 0; j4 < kPT / 4; ++j4) {
        const float4 b = *reinterpret_cast<const float4*>(&sB[kk][4 * j4]);
        acc[4 * j4 + 0] = fmaf(a, b.x, acc[4 * j4 + 0]);
        acc[4 * j4 + 1] = fmaf(a, b.y, acc[4 * j4 + 1]);
        acc[4 * j4 + 2] = fmaf(a, b.z, acc[4 * j4 + 2]);
        acc[4 * j4 + 3] = fmaf(a, b.w, acc[4 * j4 + 3]);
      }
    }
    __syncthreads();
  }

  const int row = m0 + tid;
  if (row < m) {
    float* Cz = C + z * scb + row * scm;
#pragma unroll
    for (int j = 0; j < kPT; ++j)
      if (j0 + j < p) Cz[(j0 + j) * scp] = acc[j];
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (A and B share it).  Strides are in
// elements.  Returns cudaGetLastError() after the launch.
int tsgemm_batched(int dtype, const void* A, long long sab, long long sam,
                   long long sak, const void* B, long long sbb, long long sbk,
                   long long sbp, float* C, long long scb, long long scm,
                   long long scp, int batch, int m, int k, int p, int a_mode,
                   int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || m <= 0 || k <= 0 || p <= 0 || batch > 65535)
    return cudaErrorInvalidValue;
  const long long gy = (p + kPT - 1) / kPT;
  if (gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid((m + kBM - 1) / kBM, (unsigned)gy, batch);
  if (dtype == 0) {
    tsgemm_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(A), sab, sam, sak,
        static_cast<const float*>(B), sbb, sbk, sbp, C, scb, scm, scp, m, k,
        p, a_mode, vec);
  } else if (dtype == 1) {
    tsgemm_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(A), sab, sam, sak,
        static_cast<const __nv_bfloat16*>(B), sbb, sbk, sbp, C, scb, scm,
        scp, m, k, p, a_mode, 0);
  } else {
    return cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* tsgemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
