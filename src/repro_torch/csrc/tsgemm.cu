// Batched, strided tall-skinny GEMM: C[z] = A[z] @ B[z] with float32
// accumulation, A (Bt, m, k) and B (Bt, k, p) float32 or bfloat16, C
// (Bt, m, p) float32, every operand addressed through its own strides.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tsgemm/tsgemm.py:51
// (_tsgemm_kernel / tsgemm_pallas), which the reference vmaps over clients
// for the randomized-SVD sketch products of src/repro/core/svd.py.  Here the
// batch rides in blockIdx.z instead.
//
// What bounds it on an H100: reading A.  p is the sketch width (rank +
// oversample, 11 for the paper's p = 3), so B and C are small and the
// product does ~2p flops per A element, far below the card's flop/byte
// ridge: D (64, 3072, 512) float32 is 403 MB, 0.12 ms at 3.35 TB/s.  The
// callers pass D, D^T and Q^T views; taking strides instead of a
// .contiguous() copy keeps each A element read from device memory once.
// Streaming at that rate needs ~16-20 KB of A in flight per SM at all
// times.  The first version staged synchronously (load, sync, FMA, sync), ran
// 256 blocks of 128 threads at the m = 512 products and padded p = 11 to 16
// columns: 0.411 ms (D @ Omega) and 0.747 ms (D^T @ Q) against
// torch.matmul's 0.227 and 0.246 ms (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Design: a block owns BM = 128 rows of C (one per thread) and a slab of PT
// columns, PT in {4, 8, 12, 16} fitted to p by the wrapper's plan (12 for
// p = 11; wider p tiles over slabs), and walks its k range in BK = 32 steps.
// * A cp.async ring of 3 stages keeps two (BM, BK) A tiles and their
//   (BK, PT) B slabs in flight while one is computed; a block never waits
//   on a load it could have issued a tile earlier.  The A stage follows
//   whichever axis of A is contiguous: 16-byte cp.async.cg along it where
//   the view allows (4 float32 or 8 bfloat16 values; a ragged edge copies
//   fewer bytes and zero-fills), else 4-byte cp.async per float32 element
//   or plain loads per bfloat16 element.  A 16-byte row pad keeps the
//   stores and the compute reads free of bank conflicts in both layouts.
// * Split-K for the short-m products (D^T @ Q: m = 512, k = 3072, 256
//   blocks unsplit): the plan cuts k into nsplit ranges of whole tiles so
//   the grid reaches ~4 blocks per SM; each block writes its partial C tile
//   to float32 scratch the wrapper allocates, and a second kernel sums the
//   partials in fixed split order (no atomics: a signature is the same from
//   run to run).
// The wrapper turns a product whose B is the wide operand (Q^T @ D) into
// its transpose, so A is always the large operand.
//
// Measured (NVIDIA H100 80GB HBM3, power limit 700 W; chip_smoke.py phase 7
// and benchmarks/torch_kernel_ab.py, CUDA events behind a device sleep), at
// D (64, 3072, 512) float32, p = 11: D @ Omega 0.170 ms, D^T @ Q 0.179 ms,
// Q^T @ D 0.179 ms against torch.matmul's 0.200, 0.191 and 0.250 ms and
// the first version's 0.373, 0.652 and 0.651 ms by the same timer; 2.4
// TB/s of A, 72% of the 3.35 TB/s bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;  // rows of C per block, one per thread
constexpr int kBK = 32;   // k per tile
constexpr int kThreads = kBM;
constexpr int kStages = 3;
constexpr int kMaxDevices = 64;

template <typename T, int PT>
struct Cfg {
  static constexpr int EPV = 16 / static_cast<int>(sizeof(T));  // per 16 B
  static constexpr int LDK = kBK + EPV;  // k-fast stage: [kBM][LDK]
  static constexpr int LDM = kBM + EPV;  // m-fast stage: [kBK][LDM]
  static constexpr int A_ELEMS = kBM * LDK > kBK * LDM ? kBM * LDK : kBK * LDM;
  static constexpr int A_BYTES = A_ELEMS * static_cast<int>(sizeof(T));
  static constexpr int STAGE = A_BYTES + kBK * PT * 4;  // + float B slab
  static constexpr int SMEM = kStages * STAGE;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy of `bytes` (the rest zero-filled).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4-byte async copy, or zero when `in` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One element of A or B into the stage (B always as float32).
__device__ __forceinline__ void stage_elem(float* dst, const float* src,
                                           bool in) {
  cp_async4(dst, src, in);
}
__device__ __forceinline__ void stage_elem(bf16* dst, const bf16* src,
                                           bool in) {
  *dst = in ? *src : __float2bfloat16(0.f);
}
__device__ __forceinline__ void stage_b(float* dst, const float* src,
                                        bool in) {
  cp_async4(dst, src, in);
}
__device__ __forceinline__ void stage_b(float* dst, const bf16* src, bool in) {
  *dst = in ? __bfloat162float(*src) : 0.f;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// 16 bytes of the stage as floats.
__device__ __forceinline__ void load_vec(const float* p, float (&a)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  a[0] = x.x;
  a[1] = x.y;
  a[2] = x.z;
  a[3] = x.w;
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&a)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    a[2 * i] = f.x;
    a[2 * i + 1] = f.y;
  }
}

// acc += a * (one k row of the B slab).
template <int PT>
__device__ __forceinline__ void fma_row(float (&acc)[PT], float a,
                                        const float* brow) {
#pragma unroll
  for (int q = 0; q < PT / 4; ++q) {
    const float4 b = reinterpret_cast<const float4*>(brow)[q];
    acc[4 * q + 0] = fmaf(a, b.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(a, b.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(a, b.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(a, b.w, acc[4 * q + 3]);
  }
}

// a_mode: 0 = m is the fast axis of A, 1 = k is; vec: 16-byte copies along
// it allowed.  blockIdx.x = (m tile * nsplit + split) * n_slabs + slab.
template <typename T, int PT>
__global__ void __launch_bounds__(kThreads)
tsgemm_kernel(const T* __restrict__ A, long long sab, long long sam,
              long long sak, const T* __restrict__ B, long long sbb,
              long long sbk, long long sbp, float* __restrict__ C,
              long long scb, long long scm, long long scp,
              float* __restrict__ part, int Bt, int m, int k, int p,
              int a_mode, int vec, int n_slabs, int nsplit, int split_len) {
  using Cf = Cfg<T, PT>;
  constexpr int EPV = Cf::EPV, LDK = Cf::LDK, LDM = Cf::LDM;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int slab = blockIdx.x % n_slabs;
  const int rest = blockIdx.x / n_slabs;
  const int split = rest % nsplit, mt = rest / nsplit;
  const int m0 = mt * kBM, j0 = slab * PT;
  const int z = blockIdx.z;
  const T* Az = A + z * sab;
  const T* Bz = B + z * sbb;
  const int k_begin = split * split_len;
  const int k_end = min(k, k_begin + split_len);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  auto stage_a = [&](int slot) {
    return reinterpret_cast<T*>(smem + slot * Cf::STAGE);
  };
  auto stage_bs = [&](int slot) {
    return reinterpret_cast<float*>(smem + slot * Cf::STAGE + Cf::A_BYTES);
  };
  auto load_tile = [&](int t, int slot) {
    const int k0 = k_begin + t * kBK;
    T* sA = stage_a(slot);
    if (a_mode == 1) {  // k fast: sA[row][kk]
      if (vec) {
        constexpr int VPR = kBK / EPV;
        for (int e = tid; e < kBM * VPR; e += kThreads) {
          const int r = e / VPR, c = (e - r * VPR) * EPV;
          const int gm = m0 + r, gk = k0 + c;
          const int n = gm < m ? max(0, min(EPV, k_end - gk)) : 0;
          cp_async16(sA + r * LDK + c, n > 0 ? Az + gm * sam + gk : Az,
                     n * static_cast<int>(sizeof(T)));
        }
      } else {
        for (int e = tid; e < kBM * kBK; e += kThreads) {
          const int r = e / kBK, c = e - r * kBK;
          const int gm = m0 + r, gk = k0 + c;
          const bool in = gm < m && gk < k_end;
          stage_elem(sA + r * LDK + c, in ? Az + gm * sam + gk * sak : Az, in);
        }
      }
    } else {  // m fast: sA[kk][row]
      if (vec) {
        constexpr int VPR = kBM / EPV;
        for (int e = tid; e < kBK * VPR; e += kThreads) {
          const int kk = e / VPR, c = (e - kk * VPR) * EPV;
          const int gm = m0 + c, gk = k0 + kk;
          const int n = gk < k_end ? max(0, min(EPV, m - gm)) : 0;
          cp_async16(sA + kk * LDM + c, n > 0 ? Az + gk * sak + gm : Az,
                     n * static_cast<int>(sizeof(T)));
        }
      } else {
        for (int e = tid; e < kBM * kBK; e += kThreads) {
          const int kk = e / kBM, r = e - kk * kBM;
          const int gm = m0 + r, gk = k0 + kk;
          const bool in = gm < m && gk < k_end;
          stage_elem(sA + kk * LDM + r, in ? Az + gm * sam + gk * sak : Az,
                     in);
        }
      }
    }
    float* sB = stage_bs(slot);
    for (int e = tid; e < kBK * PT; e += kThreads) {
      const int kk = e / PT, jj = e - kk * PT;
      const int gk = k0 + kk, gj = j0 + jj;
      const bool in = gk < k_end && gj < p;
      stage_b(sB + e, in ? Bz + gk * sbk + gj * sbp : Bz, in);
    }
  };

  float acc[PT];
#pragma unroll
  for (int j = 0; j < PT; ++j) acc[j] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // and everyone is done with tile t - 1
    {
      const int nt = t + kStages - 1;
      if (nt < ntiles) load_tile(nt, nt % kStages);
      cp_async_commit();
    }
    const T* sA = stage_a(t % kStages);
    const float* sB = stage_bs(t % kStages);
    if (a_mode == 1) {
      const T* arow = sA + tid * LDK;
#pragma unroll
      for (int kv = 0; kv < kBK; kv += EPV) {
        float a[EPV];
        load_vec(arow + kv, a);
#pragma unroll
        for (int u = 0; u < EPV; ++u) fma_row(acc, a[u], sB + (kv + u) * PT);
      }
    } else {
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk)
        fma_row(acc, to_f32(sA[kk * LDM + tid]), sB + kk * PT);
    }
  }
  cp_async_wait<0>();

  const int row = m0 + tid;
  if (row < m) {
    if (nsplit == 1) {
      float* Cz = C + z * scb + row * scm;
#pragma unroll
      for (int j = 0; j < PT; ++j)
        if (j0 + j < p) Cz[(j0 + j) * scp] = acc[j];
    } else {
      float* P = part + ((static_cast<long long>(split) * Bt + z) * m + row) * p;
#pragma unroll
      for (int j = 0; j < PT; ++j)
        if (j0 + j < p) P[j0 + j] = acc[j];
    }
  }
}

// C = the sum of the nsplit partials (nsplit, Bt, m, p), in split order.
__global__ void __launch_bounds__(256)
tsgemm_reduce(const float* __restrict__ part, float* __restrict__ C,
              long long scb, long long scm, long long scp, int Bt, int m,
              int p, int nsplit) {
  const long long total = static_cast<long long>(Bt) * m * p;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int j = static_cast<int>(i % p);
  const long long r = i / p;
  const int row = static_cast<int>(r % m);
  const long long z = r / m;
  float s = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) s += part[sp * total + i];
  C[z * scb + row * scm + j * scp] = s;
}

// cudaFuncSetAttribute for the dynamic shared memory, once per device.
template <typename T, int PT>
int smem_attribute() {
  static int done[kMaxDevices];  // 0 unset, 1 set, else -(error)
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev] == 0) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        tsgemm_kernel<T, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg<T, PT>::SMEM));
    done[dev] = rc == 0 ? 1 : -rc;
  }
  return done[dev] == 1 ? 0 : -done[dev];
}

template <typename T, int PT>
int launch(const void* A, long long sab, long long sam, long long sak,
           const void* B, long long sbb, long long sbk, long long sbp,
           float* C, long long scb, long long scm, long long scp, float* part,
           int batch, int m, int k, int p, int a_mode, int vec, int nsplit,
           int split_len, cudaStream_t st) {
  int rc = smem_attribute<T, PT>();
  if (rc != 0) return rc;
  const int n_slabs = (p + PT - 1) / PT;
  const long long gx =
      static_cast<long long>((m + kBM - 1) / kBM) * nsplit * n_slabs;
  if (gx > 2147483647LL) return cudaErrorInvalidValue;
  constexpr int smem = Cfg<T, PT>::SMEM;
  tsgemm_kernel<T, PT><<<dim3(static_cast<unsigned>(gx), 1, batch), kThreads,
                         smem, st>>>(
      static_cast<const T*>(A), sab, sam, sak, static_cast<const T*>(B), sbb,
      sbk, sbp, C, scb, scm, scp, part, batch, m, k, p, a_mode, vec, n_slabs,
      nsplit, split_len);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || nsplit == 1) return rc;
  const long long total = static_cast<long long>(batch) * m * p;
  tsgemm_reduce<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      part, C, scb, scm, scp, batch, m, p, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_slab(int slab, const void* A, long long sab, long long sam,
                long long sak, const void* B, long long sbb, long long sbk,
                long long sbp, float* C, long long scb, long long scm,
                long long scp, float* part, int batch, int m, int k, int p,
                int a_mode, int vec, int nsplit, int split_len,
                cudaStream_t st) {
#define TSGEMM_SLAB(W)                                                       \
  case W:                                                                    \
    return launch<T, W>(A, sab, sam, sak, B, sbb, sbk, sbp, C, scb, scm,     \
                        scp, part, batch, m, k, p, a_mode, vec, nsplit,      \
                        split_len, st);
  switch (slab) {
    TSGEMM_SLAB(4) TSGEMM_SLAB(8) TSGEMM_SLAB(12) TSGEMM_SLAB(16)
    default: return cudaErrorInvalidValue;
  }
#undef TSGEMM_SLAB
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (A and B share it).  Strides are in
// elements.  vec = 1 promises A's fast axis has stride 1 and its other
// strides and address are 16-byte multiples.  slab in {4, 8, 12, 16}
// columns of C per block.  nsplit > 1 cuts k into ranges of split_len (a
// multiple of 32) with (nsplit - 1) * split_len < k <= nsplit * split_len
// and needs float32 scratch `part` of (nsplit, batch, m, p); nsplit = 1
// ignores it.  Returns cudaGetLastError() after the launch(es).
int tsgemm_batched(int dtype, const void* A, long long sab, long long sam,
                   long long sak, const void* B, long long sbb, long long sbk,
                   long long sbp, float* C, long long scb, long long scm,
                   long long scp, float* part, int batch, int m, int k, int p,
                   int a_mode, int vec, int slab, int nsplit, int split_len,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || m <= 0 || k <= 0 || p <= 0 || batch > 65535 || nsplit < 1)
    return cudaErrorInvalidValue;
  if (nsplit == 1) {
    split_len = k;
  } else if (part == nullptr || split_len <= 0 || split_len % kBK != 0 ||
             static_cast<long long>(nsplit - 1) * split_len >= k ||
             static_cast<long long>(nsplit) * split_len < k) {
    return cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return launch_slab<float>(slab, A, sab, sam, sak, B, sbb, sbk, sbp, C,
                              scb, scm, scp, part, batch, m, k, p, a_mode, vec,
                              nsplit, split_len, st);
  if (dtype == 1)
    return launch_slab<bf16>(slab, A, sab, sam, sak, B, sbb, sbk, sbp, C, scb,
                             scm, scp, part, batch, m, k, p, a_mode, vec,
                             nsplit, split_len, st);
  return cudaErrorInvalidValue;
}

const char* tsgemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
