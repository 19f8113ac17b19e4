// CPU thread emulation of the CUDA subset the port's proximity kernel uses,
// for checking its index arithmetic and reductions without a GPU
// (tools/cuda_emu/proximity_check.py).  A block's threads run as OS threads;
// __syncthreads is a barrier over them, mma_f64 (m16n8k16 FP64) an exchange
// among a warp's 32 threads, cp.async a plain copy (with its zero fill);
// shared memory is poisoned with NaN at each block's start.
#pragma once
#include <cmath>
#include <cstddef>
#include <cstring>
#include <vector>
#include <thread>
#include <mutex>
#include <condition_variable>
#include <algorithm>
#include <memory>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(x)
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3s { unsigned x, y, z; };
extern thread_local uint3s threadIdx, blockIdx;
extern uint3s blockDim, gridDim;
typedef int cudaError_t;
typedef struct CUstream_st* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
template <class T> cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
using std::min; using std::max;

struct Barrier {
  std::mutex m; std::condition_variable cv; int n, count = 0, gen = 0;
  explicit Barrier(int n_) : n(n_) {}
  void wait() { std::unique_lock<std::mutex> l(m); int g = gen; if (++count == n) { count = 0; gen++; cv.notify_all(); } else cv.wait(l, [&] { return gen != g; }); }
};
struct WarpScratch { Barrier bar{32}; double A[16][16]; double B[16][8]; };
struct BlockCtx { Barrier* bar; std::vector<std::unique_ptr<WarpScratch>> warps; char* dyn; char* stat; };
extern thread_local BlockCtx* emu_ctx;
inline void __syncthreads() { emu_ctx->bar->wait(); }

inline void cp_async4(float* dst, const float* src, bool valid) { *dst = valid ? *src : 0.f; }
inline void cp_async16(float* dst, const float* src, int bytes) {
  char buf[16] = {0}; std::memcpy(buf, src, bytes); std::memcpy(dst, buf, 16); }
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
inline void mma_f64(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
  WarpScratch& w = *emu_ctx->warps[threadIdx.x / 32];
  const int l = threadIdx.x % 32, g = l >> 2, t = l & 3;
  for (int i = 0; i < 8; ++i) w.A[g + 8 * (i % 2)][t + 4 * (i / 2)] = a[i];
  for (int i = 0; i < 4; ++i) w.B[t + 4 * i][g] = b[i];
  w.bar.wait();
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i / 2), c = 2 * t + i % 2;
    double s = d[i];
    for (int k = 0; k < 16; ++k) s += w.A[r][k] * w.B[k][c];
    d[i] = s;
  }
  w.bar.wait();
}
template <class F> void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, F fn) {
  gridDim = {grid.x, grid.y, grid.z}; blockDim = {block.x, block.y, block.z};
  for (unsigned z = 0; z < grid.z; ++z) for (unsigned y = 0; y < grid.y; ++y) for (unsigned x = 0; x < grid.x; ++x) {
    Barrier bar(block.x);
    BlockCtx ctx; ctx.bar = &bar;
    for (unsigned w = 0; w < (block.x + 31) / 32; ++w) ctx.warps.emplace_back(new WarpScratch);
    std::vector<double> dyn((smem + 7) / 8 + 2), stat(1 << 14);
    // poison shared memory
    std::fill(dyn.begin(), dyn.end(), std::nan(""));
    ctx.dyn = reinterpret_cast<char*>(dyn.data()); ctx.stat = reinterpret_cast<char*>(stat.data());
    std::vector<std::thread> th;
    for (unsigned t = 0; t < block.x; ++t) th.emplace_back([&, t] { threadIdx = {t, 0, 0}; blockIdx = {x, y, z}; emu_ctx = &ctx; fn(); });
    for (auto& t : th) t.join();
  }
}
