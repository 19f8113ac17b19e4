// Backward of the RWKV6 WKV recurrence.  The forward (wkv.cu):
//
//   out_t[j] = sum_i r_t[i] * (S_t[i][j] + u[i] * k_t[i] * v_t[j])
//   S_{t+1}[i][j] = w_t[i] * S_t[i][j] + k_t[i] * v_t[j]
//
// Given dout (B, S, H, hd) and dstateT (B, H, hd, hd) or null for zeros, all
// float32, with dS_{t+1} the gradient of the state after step t (dS_S =
// dstateT), it gives, in float32:
//
//   dr_t[i] = sum_j dout_t[j] * (S_t[i][j] + u[i] * k_t[i] * v_t[j])
//   dk_t[i] = r_t[i] * u[i] * (dout_t . v_t) + sum_j dS_{t+1}[i][j] * v_t[j]
//   dv_t[j] = (sum_i r_t[i] u[i] k_t[i]) * dout_t[j] + sum_i dS_{t+1}[i][j] * k_t[i]
//   dw_t[i] = sum_j dS_{t+1}[i][j] * S_t[i][j]
//   du[i]   = sum over b and t of r_t[i] * k_t[i] * (dout_t . v_t)
//   dS_t    = w_t (.)rows dS_{t+1} + r_t dout_t^T,    dstate0 = dS_0
//
// The reference has no WKV backward kernel: it differentiates the
// jax.checkpoint-ed two-level lax.scan of rwkv_time_mix
// (src/repro/models/ssm.py:303) with JAX's autodiff; the TPU kernel
// src/repro/kernels/wkv/wkv.py:53 (ported in wkv.cu) is forward only.
// r, k, v are float32 or bfloat16 (converted to float32 on load, exactly, as
// the forward does); all arithmetic is float32 on the CUDA cores.
//
// What bounds it on an H100: the arithmetic, about 12 flops a step and state
// entry (recomputing the state 2, dS 2, dr, dk, dv and dw 2 each) at the
// FP32 rate, against the forward's 5; the bytes (r, k, v, w, dout read, five
// gradients written) come second.  dw needs S_t and dS_{t+1} together at
// every step: the chunk identity of gated linear attention gives w_t dw_t,
// and dividing by w is ruled out (fast decays underflow w's products to 0,
// see wkv.cu), so the states are recomputed, never reconstructed backward.
//
// Design (a simple one; a redesign is owed): the sequence is cut into the
// forward's chunks of C steps (a multiple of kT = 16, at most kMaxChunk),
// whose start states the forward's chunked route keeps (the caller passes
// them, or state0 as the one chunk of a short sequence).  Four kernels:
//   1. wkv_bwd_chunk, one block per chunk: the chunk's share of the state
//      gradient at its start, G_c = sum_t (prod_{c0 <= m < t} w_m) r_t
//      dout_t^T, and its decay D_c = prod_t w_t (products formed forward);
//   2. wkv_bwd_scan: per (b, h) and slice of the state, dS at the chunk's
//      start = D_c * dS at its end + G_c, from dstateT back to dstate0,
//      overwriting G_c with the gradient at the chunk's end;
//   3. wkv_bwd_grad, one block per chunk: for each slice of kCols state
//      columns in turn, two threads a state row, each holding kCPT columns
//      in registers: the start state of every sub-block of kT steps,
//      stepped forward from the chunk's start state into registers; then
//      the sub-blocks last first: the sub-block's kT states stepped forward
//      again into shared memory (each thread its own slots, so no barrier),
//      then its steps walked backward carrying the slice's dS.  dr, dk, dw
//      of a row sum over the slices' columns: the slice's part is reduced
//      over the row's two threads by a shuffle and added to the output by
//      its one writer in slice order; dv of a column sums over rows: a
//      shuffle tree over the warp's 16 rows (a reduce-scatter, each lane
//      ending with one column), then the warps in order, per sub-block
//      through shared memory; du's share of the chunk goes to a workspace;
//   4. wkv_bwd_du: du summed over batch rows, then chunks, in order.
// No atomics: every sum has one fixed order, so two launches give the same
// bits (kernels/wkv/ref.py::wkv_bwd_chunked_ref walks the same schedule).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 16;                   // steps per sub-block
constexpr int kMaxChunk = 128;           // longest chunk (kernels/wkv/wkv.py CHUNK)
constexpr int kSubs = kMaxChunk / kT;    // sub-blocks of the longest chunk
constexpr int kCols = 16;                // state columns of a slice (kernel 3)
constexpr int kCPT = 8;                  // columns a thread holds (kernel 3)
constexpr int kScanThreads = 256;
constexpr int kMaxDevices = 64;

// One element, as float.  bfloat16: the aligned 32-bit word holding it (it
// and its neighbour), its half picked by the element's parity.
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  const auto a = reinterpret_cast<unsigned long long>(p);
  const unsigned wd = *reinterpret_cast<const unsigned*>(a & ~3ull);
  return __uint_as_float((a & 2) ? (wd & 0xffff0000u) : (wd << 16));
}
// Four consecutive elements (16-byte aligned for float, 8 for bfloat16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// kCPT consecutive elements into x.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&x)[kCPT]) {
#pragma unroll
  for (int e = 0; e < kCPT; e += 4) {
    const float4 f = load4(p + e);
    x[e] = f.x;
    x[e + 1] = f.y;
    x[e + 2] = f.z;
    x[e + 3] = f.w;
  }
}

__device__ __forceinline__ long long step_base(int b, int t, int h, int S, int H, int HD) {
  return ((static_cast<long long>(b) * S + t) * H + h) * HD;
}

// Kernel 1.  Grid (chunks, H, B), 4 HD threads: thread (i, quarter) holds
// HD / 4 columns of row i of G_c.  wsd (B, H, chunks, HD, HD), wd (B, H,
// chunks, HD).
template <int HD, typename TI>
__global__ void __launch_bounds__(4 * HD)
wkv_bwd_chunk(const TI* __restrict__ r, const float* __restrict__ w,
              const float* __restrict__ dout, float* __restrict__ wsd,
              float* __restrict__ wd, int S, int H, int C) {
  constexpr int CPT = HD / 4;
  const int tid = threadIdx.x, i = tid >> 2, j0 = (tid & 3) * CPT;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nchunks = gridDim.x;
  const int t0c = c * C, len = min(C, S - t0c);
  const long long bh = static_cast<long long>(b) * H + h;
  float acc[CPT];
#pragma unroll
  for (int x = 0; x < CPT; ++x) acc[x] = 0.f;
  float f = 1.f;   // prod_{c0 <= m < t} w_m[i]
  for (int t = 0; t < len; ++t) {
    const long long base = step_base(b, t0c + t, h, S, H, HD);
    const float a = f * load1(r + base + i);
    f *= w[base + i];
#pragma unroll
    for (int x = 0; x < CPT; x += 4) {
      const float4 d = load4(dout + base + j0 + x);
      acc[x] = fmaf(a, d.x, acc[x]);
      acc[x + 1] = fmaf(a, d.y, acc[x + 1]);
      acc[x + 2] = fmaf(a, d.z, acc[x + 2]);
      acc[x + 3] = fmaf(a, d.w, acc[x + 3]);
    }
  }
  float* dst = wsd + ((bh * nchunks + c) * HD + i) * HD + j0;
#pragma unroll
  for (int x = 0; x < CPT; x += 4)
    *reinterpret_cast<float4*>(dst + x) =
        make_float4(acc[x], acc[x + 1], acc[x + 2], acc[x + 3]);
  if ((tid & 3) == 0) wd[(bh * nchunks + c) * HD + i] = f;
}

// Kernel 2.  Grid (slices, H, B): each thread carries 4 entries of row i of
// the state gradient back through the chunks: wsd[c] <- dS at the end of
// chunk c (overwriting G_c), then dS at its start = D_c[i] * that + G_c; the
// last is dstate0.
template <int HD>
__global__ void __launch_bounds__(kScanThreads)
wkv_bwd_scan(float* __restrict__ wsd, const float* __restrict__ wd,
             const float* __restrict__ dstateT, float* __restrict__ dstate0,
             int H, int nchunks) {
  const int e = 4 * (blockIdx.x * kScanThreads + threadIdx.x);
  if (e >= HD * HD) return;
  const int i = e / HD;
  const long long bh = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (dstateT != nullptr)
    g = *reinterpret_cast<const float4*>(dstateT + bh * HD * HD + e);
  for (int c = nchunks - 1; c >= 0; --c) {
    const long long cc = bh * nchunks + c;
    float4* p = reinterpret_cast<float4*>(wsd + cc * HD * HD + e);
    const float4 G = *p;
    const float d = wd[cc * HD + i];
    *p = g;
    g.x = fmaf(d, g.x, G.x);
    g.y = fmaf(d, g.y, G.y);
    g.z = fmaf(d, g.z, G.z);
    g.w = fmaf(d, g.w, G.w);
  }
  *reinterpret_cast<float4*>(dstate0 + bh * HD * HD + e) = g;
}

template <int HD>
struct Grad {
  static constexpr int NT = 2 * HD;        // two threads a state row
  static constexpr int NW = NT / 32;       // warps: 16 rows each
  static constexpr int SLICES = HD / kCols;
  // a sub-block's states, [kT][2][NT] float4 (each thread's own slots), then
  // the warps' dv row sums [NW][kT][kCols]
  static constexpr int kStates = kT * 2 * NT * 4;
  static constexpr int SMEM = (kStates + NW * kT * kCols) * 4;
  static constexpr int MINB = HD <= 64 ? 3 : 1;
  static_assert(HD % kCols == 0 && kCols == 2 * kCPT && NT % 32 == 0, "wkv_bwd_grad shape");
};

// The state S_{t+1} (the thread's kCPT columns of row i) from S_t.
template <int HD, typename TI>
__device__ __forceinline__ void advance(float (&st)[kCPT], const TI* k, const TI* v,
                                        const float* w, long long base, int i, int j0) {
  const float kt = load1(k + base + i), wt = w[base + i];
  float vv[kCPT];
  load8(v + base + j0, vv);
#pragma unroll
  for (int x = 0; x < kCPT; ++x) st[x] = fmaf(wt, st[x], kt * vv[x]);
}

// Sum p[x] over the warp's 16 rows (lanes of one parity), scattered: lane l
// ends with the total of column x = 4 b4 + 2 b3 + b2 of its half (b the bits
// of l) in p[0]; lanes l and l ^ 2 hold the same.
__device__ __forceinline__ void row_reduce(float (&p)[kCPT], int lane) {
  int n = kCPT;
#pragma unroll
  for (int off = 16; off >= 4; off >>= 1) {
    const bool hi = (lane & off) != 0;
    n >>= 1;
#pragma unroll
    for (int x = 0; x < kCPT / 2; ++x) {
      if (x < n) {
        const float send = hi ? p[x] : p[x + n];
        const float keep = hi ? p[x + n] : p[x];
        p[x] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    }
  }
  p[0] += __shfl_xor_sync(0xffffffffu, p[0], 2);
}

// Kernel 3.  Grid (chunks, H, B), 2 HD threads: thread (i, q) holds columns
// sl * kCols + q * kCPT + x of row i.  starts (B, H, chunks, HD, HD) the
// chunk-start states, wsd the state gradient at each chunk's end; du_part
// (B, H, chunks, HD).
template <int HD, typename TI>
__global__ void __launch_bounds__(Grad<HD>::NT, Grad<HD>::MINB)
wkv_bwd_grad(const TI* __restrict__ r, const TI* __restrict__ k,
             const TI* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ dout,
             const float* __restrict__ starts, const float* __restrict__ wsd,
             float* __restrict__ dr, float* __restrict__ dk,
             float* __restrict__ dv, float* __restrict__ dw,
             float* __restrict__ du_part, int S, int H, int C) {
  using Cfg = Grad<HD>;
  constexpr int NT = Cfg::NT;
  extern __shared__ __align__(16) float smem[];
  float4* sst = reinterpret_cast<float4*>(smem);
  float* dvbuf = smem + Cfg::kStates;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid >> 1, q = tid & 1;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nchunks = gridDim.x;
  const int t0c = c * C, len = min(C, S - t0c);
  const long long bh = static_cast<long long>(b) * H + h;
  const long long srow = ((bh * nchunks + c) * HD + i) * HD;   // row i of the chunk's state
  const float ui = u[h * HD + i];
  const int xsel = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
  float du_acc = 0.f;

  for (int sl = 0; sl < Cfg::SLICES; ++sl) {
    const int j0 = sl * kCols + q * kCPT;
    float st[kCPT], sub_start[kSubs][kCPT];
    load8(starts + srow + j0, st);
#pragma unroll
    for (int sb = 0; sb < kSubs; ++sb) {
#pragma unroll
      for (int x = 0; x < kCPT; ++x) sub_start[sb][x] = st[x];
      if ((sb + 1) * kT < len) {
        for (int t = sb * kT; t < (sb + 1) * kT; ++t)
          advance<HD>(st, k, v, w, step_base(b, t0c + t, h, S, H, HD), i, j0);
      }
    }
    float ds[kCPT];
    load8(wsd + srow + j0, ds);
#pragma unroll
    for (int sb = kSubs - 1; sb >= 0; --sb) {
      const int tb = sb * kT;
      if (tb >= len) continue;   // block-uniform
      const int te = min(tb + kT, len);
#pragma unroll
      for (int x = 0; x < kCPT; ++x) st[x] = sub_start[sb][x];
      for (int t = tb; t < te; ++t) {
        sst[(2 * (t - tb)) * NT + tid] = make_float4(st[0], st[1], st[2], st[3]);
        sst[(2 * (t - tb) + 1) * NT + tid] = make_float4(st[4], st[5], st[6], st[7]);
        if (t + 1 < te) advance<HD>(st, k, v, w, step_base(b, t0c + t, h, S, H, HD), i, j0);
      }
      for (int t = te - 1; t >= tb; --t) {
        const long long base = step_base(b, t0c + t, h, S, H, HD);
        const float rt = load1(r + base + i), kt = load1(k + base + i), wt = w[base + i];
        float vv[kCPT], dd[kCPT], s[kCPT];
        load8(v + base + j0, vv);
        load8(dout + base + j0, dd);
        const float4 s0 = sst[(2 * (t - tb)) * NT + tid];
        const float4 s1 = sst[(2 * (t - tb) + 1) * NT + tid];
        s[0] = s0.x; s[1] = s0.y; s[2] = s0.z; s[3] = s0.w;
        s[4] = s1.x; s[5] = s1.y; s[6] = s1.z; s[7] = s1.w;
        // the slice's parts of dout . v, S_t dout, dS_{t+1} . S_t, dS_{t+1} v
        float dot = 0.f, sdo = 0.f, dwp = 0.f, dkp = 0.f;
#pragma unroll
        for (int x = 0; x < kCPT; ++x) {
          dot = fmaf(dd[x], vv[x], dot);
          sdo = fmaf(dd[x], s[x], sdo);
          dwp = fmaf(ds[x], s[x], dwp);
          dkp = fmaf(ds[x], vv[x], dkp);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        sdo += __shfl_xor_sync(0xffffffffu, sdo, 1);
        dwp += __shfl_xor_sync(0xffffffffu, dwp, 1);
        dkp += __shfl_xor_sync(0xffffffffu, dkp, 1);
        // dv_t[j] = sum_i k_t[i] dS_{t+1}[i][j] + (r_t u k_t)[i] dout_t[j]
        const float ruk = rt * ui * kt;
        float pv[kCPT];
#pragma unroll
        for (int x = 0; x < kCPT; ++x) pv[x] = fmaf(ruk, dd[x], kt * ds[x]);
        row_reduce(pv, lane);
        if ((lane & 2) == 0)
          dvbuf[(warp * kT + (t - tb)) * kCols + q * kCPT + xsel] = pv[0];
        if (q == 0) {
          const long long o = base + i;
          const float gr = fmaf(ui * kt, dot, sdo), gk = fmaf(rt * ui, dot, dkp);
          if (sl == 0) {
            dr[o] = gr;
            dk[o] = gk;
            dw[o] = dwp;
          } else {
            dr[o] += gr;
            dk[o] += gk;
            dw[o] += dwp;
          }
          du_acc = fmaf(rt * kt, dot, du_acc);
        }
#pragma unroll
        for (int x = 0; x < kCPT; ++x) ds[x] = fmaf(wt, ds[x], rt * dd[x]);
      }
      __syncthreads();
      // dv of the sub-block's steps, the slice's columns: the warps' row
      // sums in order
      for (int e = tid; e < kT * kCols; e += NT) {
        const int tl = e / kCols, jj = e - tl * kCols;
        if (tb + tl < te) {
          float sum = dvbuf[tl * kCols + jj];
          for (int w2 = 1; w2 < Cfg::NW; ++w2) sum += dvbuf[(w2 * kT + tl) * kCols + jj];
          dv[step_base(b, t0c + tb + tl, h, S, H, HD) + sl * kCols + jj] = sum;
        }
      }
      __syncthreads();
    }
  }
  if (q == 0) du_part[(bh * nchunks + c) * HD + i] = du_acc;
}

// Kernel 4.  Grid H, HD threads: du[h][i] = sum_b sum_c du_part[b][h][c][i].
template <int HD>
__global__ void __launch_bounds__(HD)
wkv_bwd_du(const float* __restrict__ du_part, float* __restrict__ du, int B, int H,
           int nchunks) {
  const int i = threadIdx.x, h = blockIdx.x;
  float sum = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nchunks; ++c)
      sum += du_part[((static_cast<long long>(b) * H + h) * nchunks + c) * HD + i];
  du[h * HD + i] = sum;
}

// cudaFuncSetAttribute for kernel 3's dynamic shared memory, once per device
// and instantiation.
template <int HD, typename TI>
int smem_attribute() {
  static int done[kMaxDevices];  // 0 unset, 1 set, else -(error)
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev] == 0) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        wkv_bwd_grad<HD, TI>, cudaFuncAttributeMaxDynamicSharedMemorySize, Grad<HD>::SMEM));
    done[dev] = rc == 0 ? 1 : -rc;
  }
  return done[dev] == 1 ? 0 : -done[dev];
}

template <int HD, typename TI>
int launch(const TI* r, const TI* k, const TI* v, const float* w, const float* u,
           const float* dout, const float* starts, const float* dstateT, float* dr,
           float* dk, float* dv, float* dw, float* du, float* dstate0, float* wsd,
           float* wd, float* du_part, int B, int S, int H, int C, cudaStream_t stream) {
  if (C <= 0 || C > kMaxChunk || C % kT != 0) return cudaErrorInvalidValue;
  int rc = smem_attribute<HD, TI>();
  if (rc != 0) return rc;
  const int nchunks = (S + C - 1) / C;
  const dim3 grid(nchunks, H, B);
  wkv_bwd_chunk<HD, TI><<<grid, 4 * HD, 0, stream>>>(r, w, dout, wsd, wd, S, H, C);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int slices = (HD * HD / 4 + kScanThreads - 1) / kScanThreads;
  wkv_bwd_scan<HD><<<dim3(slices, H, B), kScanThreads, 0, stream>>>(wsd, wd, dstateT, dstate0,
                                                                     H, nchunks);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  wkv_bwd_grad<HD, TI><<<grid, Grad<HD>::NT, Grad<HD>::SMEM, stream>>>(
      r, k, v, w, u, dout, starts, wsd, dr, dk, dv, dw, du_part, S, H, C);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  wkv_bwd_du<HD><<<H, HD, 0, stream>>>(du_part, du, B, H, nchunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI>
int dispatch(int hd, const TI* r, const TI* k, const TI* v, const float* w, const float* u,
             const float* dout, const float* starts, const float* dstateT, float* dr,
             float* dk, float* dv, float* dw, float* du, float* dstate0, float* wsd,
             float* wd, float* du_part, int B, int S, int H, int C, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<16, TI>(r, k, v, w, u, dout, starts, dstateT, dr, dk, dv, dw, du, dstate0,
                            wsd, wd, du_part, B, S, H, C, stream);
    case 32:
      return launch<32, TI>(r, k, v, w, u, dout, starts, dstateT, dr, dk, dv, dw, du, dstate0,
                            wsd, wd, du_part, B, S, H, C, stream);
    case 64:
      return launch<64, TI>(r, k, v, w, u, dout, starts, dstateT, dr, dk, dv, dw, du, dstate0,
                            wsd, wd, du_part, B, S, H, C, stream);
    case 128:
      return launch<128, TI>(r, k, v, w, u, dout, starts, dstateT, dr, dk, dv, dw, du,
                             dstate0, wsd, wd, du_part, B, S, H, C, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// All operands contiguous: r, k, v (B, S, H, hd) of dtype 0 float32 or
// 1 bfloat16; w, dout, dr, dk, dv, dw (B, S, H, hd), u and du (H, hd),
// dstateT (or null for zeros) and dstate0 (B, H, hd, hd), starts and the
// workspace wsd (B, H, chunks, hd, hd), the workspaces wd and du_part
// (B, H, chunks, hd), all float32; chunks = ceil(S / chunk), chunk a
// multiple of 16 up to 128.  hd in {16, 32, 64, 128}.  Returns
// cudaGetLastError() after the launches.
int wkv_bwd(int dtype, const void* r, const void* k, const void* v, const float* w,
            const float* u, const float* dout, const float* starts, const float* dstateT,
            float* dr, float* dk, float* dv, float* dw, float* du, float* dstate0,
            float* wsd, float* wd, float* du_part, int B, int S, int H, int hd, int chunk,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(hd, static_cast<const float*>(r), static_cast<const float*>(k),
                           static_cast<const float*>(v), w, u, dout, starts, dstateT, dr, dk,
                           dv, dw, du, dstate0, wsd, wd, du_part, B, S, H, chunk, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(
        hd, static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), w, u, dout, starts, dstateT, dr, dk, dv, dw, du,
        dstate0, wsd, wd, du_part, B, S, H, chunk, st);
  return cudaErrorInvalidValue;
}

const char* wkv_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
