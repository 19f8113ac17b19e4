// RWKV6 WKV recurrence with the state resident on chip: r, k, v, w
// (B, S, H, hd), u (H, hd) and an optional state0 (B, H, hd, hd), all
// float32, give out (B, S, H, hd) and the final state (B, H, hd, hd), both
// float32:
//
//   out_t[j] = sum_i r_t[i] * (S_t[i][j] + (u[i] * k_t[i]) * v_t[j])
//   S_{t+1}[i][j] = w_t[i] * S_t[i][j] + k_t[i] * v_t[j]
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv/wkv.py (_wkv_kernel /
// wkv_pallas), which keeps each head's (hd, hd) state in VMEM and loops the
// sequence; this kernel keeps it in registers.
//
// What bounds it on an H100: in principle reading r, k, v, w and writing out
// once (bytes), but the recurrence is a chain of S dependent steps over only
// B * H independent (b, h) states, so at B * H = 128 on 132 SMs the time is
// set by the latency of one step times S, not by bandwidth.
//
// Design: one block per (h, b) with hd threads; thread j holds column j of
// the state (hd floats) in registers for the whole sequence.  Chunks of kTc
// time steps of r, k, w and u * k are staged in shared memory (one
// __syncthreads pair per chunk, not per step) and read as broadcasts; each
// thread keeps its own v_t[j].  The output dot product runs four partial sums
// to shorten the dependent chain.  Writes of out are coalesced across j.
#include <cuda_runtime.h>

namespace {

constexpr int kTc = 16;  // time steps staged per chunk

template <int HD>
__global__ void __launch_bounds__(HD)
wkv_fwd(const float* __restrict__ r, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ w,
        const float* __restrict__ u, const float* __restrict__ state0,
        float* __restrict__ out, float* __restrict__ stateT, int S, int H) {
  __shared__ __align__(16) float sr[kTc][HD];
  __shared__ __align__(16) float sk[kTc][HD];
  __shared__ __align__(16) float suk[kTc][HD];
  __shared__ __align__(16) float sw[kTc][HD];
  __shared__ float sv[kTc][HD];

  const int j = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long sbase = (static_cast<long long>(b) * H + h) * HD * HD;
  const float uj = u[h * HD + j];

  float st[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i)
    st[i] = state0 != nullptr ? state0[sbase + i * HD + j] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kTc) {
    const int nt = min(kTc, S - t0);
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const long long idx =
          ((static_cast<long long>(b) * S + t0 + t) * H + h) * HD + j;
      const float kj = k[idx];
      sr[t][j] = r[idx];
      sk[t][j] = kj;
      suk[t][j] = uj * kj;
      sw[t][j] = w[idx];
      sv[t][j] = v[idx];
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float vj = sv[t][j];
      float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(&sr[t][i]);
        const float4 kk = *reinterpret_cast<const float4*>(&sk[t][i]);
        const float4 uk = *reinterpret_cast<const float4*>(&suk[t][i]);
        const float4 ww = *reinterpret_cast<const float4*>(&sw[t][i]);
        o0 = fmaf(rr.x, st[i] + uk.x * vj, o0);
        o1 = fmaf(rr.y, st[i + 1] + uk.y * vj, o1);
        o2 = fmaf(rr.z, st[i + 2] + uk.z * vj, o2);
        o3 = fmaf(rr.w, st[i + 3] + uk.w * vj, o3);
        st[i] = fmaf(ww.x, st[i], kk.x * vj);
        st[i + 1] = fmaf(ww.y, st[i + 1], kk.y * vj);
        st[i + 2] = fmaf(ww.z, st[i + 2], kk.z * vj);
        st[i + 3] = fmaf(ww.w, st[i + 3], kk.w * vj);
      }
      out[((static_cast<long long>(b) * S + t0 + t) * H + h) * HD + j] =
          (o0 + o1) + (o2 + o3);
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) stateT[sbase + i * HD + j] = st[i];
}

}  // namespace

extern "C" {

// All operands contiguous float32: r, k, v, w and out (B, S, H, hd); u
// (H, hd); state0 (B, H, hd, hd) or null for zeros; stateT (B, H, hd, hd).
// hd in {16, 32, 64, 128}.  Returns cudaGetLastError() after the launch.
int wkv_fwd_f32(const float* r, const float* k, const float* v,
                const float* w, const float* u, const float* state0,
                float* out, float* stateT, int B, int S, int H, int hd,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid(H, B);
#define WKV_HD(D)                                                            \
  case D:                                                                    \
    wkv_fwd<D><<<grid, D, 0, st>>>(r, k, v, w, u, state0, out, stateT, S, H); \
    break;
  switch (hd) {
    WKV_HD(16) WKV_HD(32) WKV_HD(64) WKV_HD(128)
    default: return cudaErrorInvalidValue;
  }
#undef WKV_HD
  return static_cast<int>(cudaGetLastError());
}

const char* wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
