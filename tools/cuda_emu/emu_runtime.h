// CPU thread emulation of the CUDA subset the port's proximity and WKV
// backward kernels use, for checking their index arithmetic and reductions
// without a GPU (tools/cuda_emu/proximity_check.py, wkv_bwd_check.py).  A
// block's threads run as OS threads; __syncthreads is a barrier over them,
// __syncwarp one over a warp's 32 threads, mma_f64 (m16n8k16 FP64),
// mma_tf32 (m16n8k8 TF32, float32 sums; its operands' low 13 mantissa bits
// ignored, as the tensor cores ignore them) and __shfl_xor_sync exchanges
// among a warp's 32 threads, tf32_rna is cvt.rna.tf32.f32 (to nearest, ties
// away from zero), cp.async a plain copy (with its zero fill); bfloat16 is
// its 16-bit pattern; shared memory is poisoned with NaN at each block's
// start.
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
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
struct __nv_bfloat16 { unsigned short bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {__uint_as_float(unsigned(v.x.bits) << 16), __uint_as_float(unsigned(v.y.bits) << 16)}; }
inline float __bfloat162float(__nv_bfloat16 v) { return __uint_as_float(unsigned(v.bits) << 16); }
using std::min; using std::max;

struct Barrier {
  std::mutex m; std::condition_variable cv; int n, count = 0, gen = 0;
  explicit Barrier(int n_) : n(n_) {}
  void wait() { std::unique_lock<std::mutex> l(m); int g = gen; if (++count == n) { count = 0; gen++; cv.notify_all(); } else cv.wait(l, [&] { return gen != g; }); }
};
struct WarpScratch { Barrier bar{32}; double A[16][16]; double B[16][8]; float Af[16][8]; float Bf[8][8]; float lanes[32]; };
struct BlockCtx { Barrier* bar; std::vector<std::unique_ptr<WarpScratch>> warps; char* dyn; char* stat; };
extern thread_local BlockCtx* emu_ctx;
inline void __syncthreads() { emu_ctx->bar->wait(); }
inline void __syncwarp() { emu_ctx->warps[threadIdx.x / 32]->bar.wait(); }

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
inline unsigned tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }
inline void mma_tf32(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  WarpScratch& w = *emu_ctx->warps[threadIdx.x / 32];
  const int l = threadIdx.x % 32, g = l >> 2, t = l & 3;
  auto tf32 = [](unsigned u) { return __uint_as_float(u & 0xffffe000u); };
  w.Af[g][t] = tf32(a[0]); w.Af[g + 8][t] = tf32(a[1]);
  w.Af[g][t + 4] = tf32(a[2]); w.Af[g + 8][t + 4] = tf32(a[3]);
  w.Bf[t][g] = tf32(b[0]); w.Bf[t + 4][g] = tf32(b[1]);
  w.bar.wait();
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i / 2), c = 2 * t + i % 2;
    float s = d[i];
    for (int k = 0; k < 8; ++k) s += w.Af[r][k] * w.Bf[k][c];
    d[i] = s;
  }
  w.bar.wait();
}
inline float __shfl_xor_sync(unsigned, float v, int off) {
  WarpScratch& w = *emu_ctx->warps[threadIdx.x / 32];
  const int l = threadIdx.x % 32;
  w.lanes[l] = v;
  w.bar.wait();
  const float got = w.lanes[l ^ off];
  w.bar.wait();
  return got;
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
