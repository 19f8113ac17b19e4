// RWKV6 WKV recurrence: r, k, v (B, S, H, hd) in float32 or bfloat16, w
// (B, S, H, hd) float32, u (H, hd) float32 and an optional state0
// (B, H, hd, hd) float32 give out (B, S, H, hd) and the final state
// (B, H, hd, hd), both float32:
//
//   out_t[j] = sum_i r_t[i] * (S_t[i][j] + (u[i] * k_t[i]) * v_t[j])
//   S_{t+1}[i][j] = w_t[i] * S_t[i][j] + k_t[i] * v_t[j]
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv/wkv.py (_wkv_kernel /
// wkv_pallas), which keeps each head's (hd, hd) state in VMEM and loops the
// sequence.  bfloat16 operands are converted to float32 on load (exactly);
// all arithmetic is float32 on the CUDA cores.
//
// What bounds it on an H100: reading r, k, v, w and writing out once
// (bytes).  A plain recurrence cannot get there: it is a chain of S dependent
// steps over only B * H states (128 at rwkv6-1.6b's batch 4), so its time is
// S times one step's latency.  Two routes, chosen by the host
// (kernels/wkv/wkv.py::wkv_plan):
//
// Recurrent (decode, short S): wkv_step.  At decode (S = 1) it is bounded
// by bytes: the (hd, hd) float32 states, read and written once (2 MB each
// way at rwkv6-1.6b's batch 4), while r, k, v, w are a few KB; the
// arithmetic is 5 flops a state entry.  So the state's loads must all be in
// flight at once and 16 bytes wide, and the step must not wait on a
// barrier.  Columns are independent at a step: out[j] and S[:, j] need only
// column j plus r, k, u, w and v[j].  A warp holds 2 column quads (8
// columns) over 16 row groups: lane (g, x) holds the 4 state columns of
// quad x of the rows i = g + 16 m (m < hd / 16) in registers, loaded and
// stored as float4 (bfloat16 r, k are read as the 32-bit words that hold
// them: 16-bit loads made the step 13% slower); a block is 2 warps (16
// columns), so rwkv6's decode launches 4 x 32 x 4 = 512 blocks of 64
// threads.  out[j] sums over rows in a fixed order: each thread's rows in
// order, then the 16 row groups, all lanes of one warp, by an xor-shuffle
// tree (pairwise, lower group on the left), so the kernel is deterministic
// and needs no shared memory or barrier (kernels/wkv/ref.py::
// wkv_recurrent_ref repeats that order).  For S > 1 the next step's r, k,
// w, v are loaded while the current one is computed.
//
// Chunked (prefill): the sequence is cut into chunks of C steps (a multiple
// of kT = 16), and each chunk into sub-blocks of kT steps.  With
// lp_t = prod_{b <= m < t} w_m (product from the sub-block start b) and
// ls_s = prod_{s < m < b + kT} w_m (to its end), the state at the next
// sub-block and the outputs are
//
//   S_{b+kT} = lp_{b+kT} * S_b + sum_s (ls_s k_s) v_s^T
//   out_t    = (lp_t r_t)^T S_b
//            + sum_{b <= s < t} (sum_i r_t[i] k_s[i] prod_{s<m<t} w_m[i]) v_s
//            + (sum_i r_t[i] u[i] k_t[i]) v_t
//
// Three kernels, launched by one host call:
//   1. wkv_chunk<OUT = false>, one block per chunk (all chunks in parallel):
//      the chunk's state contribution dS_c (the rule above from S = 0) and
//      its decay D_c = prod_t w_t, into the workspace;
//   2. wkv_scan: per (b, h) and slice of the state, the short sequential scan
//      S_{c+1} = D_c * S_c + dS_c over the chunks, from state0; it writes the
//      chunk-start state S_c over dS_c and the final state;
//   3. wkv_chunk<OUT = true>, one block per chunk: the outputs, walking the
//      chunk's sub-blocks from S_c.
// Every decay factor is a product of w's in (0, 1], formed by multiplying
// forward or backward from a known point, never by dividing: no factor can
// overflow however fast the decay (w down to ~6e-4 a step gives 1e-206 over
// 64 steps, which underflows to 0 as the true contribution does).  In a block
// of NT threads, thread (j, g) holds column j of the state for its IPT rows
// i in registers (at hd 64: 128 threads, 32 rows each); the G = NT / hd
// threads of a column are adjacent lanes and reduce outputs with shuffles.  The diagonal sub-block's pair weights are
// running products per (t, i), reduced over i by shuffles.  Each sub-block's
// operands are loaded into registers while the previous one is computed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 16;           // chunked route: steps per sub-block
constexpr int kRowsPerThread = 32;  // chunked route: state rows a thread holds
constexpr int kRegs = 128;          // chunked route: registers a thread may use
constexpr int kScanThreads = 256;
constexpr int kScanBatch = 4;     // chunks whose loads the scan starts at once
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

// ---------------------------------------------------------------------------
// Recurrent route
// ---------------------------------------------------------------------------

// Block shape of the recurrent route: a warp holds QW column quads (4
// state columns each) over G row groups, lane = QW * g + x for quad x; a
// block WARPS warps, so COLS state columns of one (h, b).
template <int HD>
struct Step {
  static constexpr int G = 16;                    // row groups: a thread's rows g + 16 m
  static constexpr int RPT = HD / G;              // state rows a thread holds
  static constexpr int QW = 32 / G;               // column quads a warp
  static constexpr int WARPS = 2;
  static constexpr int NT = 32 * WARPS;           // threads per block
  static constexpr int COLS = 4 * QW * WARPS;     // state columns a block
  static_assert(HD % G == 0 && HD % COLS == 0, "wkv_step shape");
};

template <int HD, typename TI>
__global__ void __launch_bounds__(Step<HD>::NT)
wkv_step(const TI* __restrict__ r, const TI* __restrict__ k,
         const TI* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, const float* __restrict__ state0,
         float* __restrict__ out, float* __restrict__ stateT, int S, int H) {
  using T = Step<HD>;
  constexpr int G = T::G, RPT = T::RPT, QW = T::QW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / QW;
  const int c = 4 * ((blockIdx.x * T::WARPS + warp) * QW + lane % QW);   // first column
  const int h = blockIdx.y, b = blockIdx.z;
  const long long sbase = (static_cast<long long>(b) * H + h) * HD * HD + c;

  float4 st[RPT];
  float uu[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const int i = g + G * m;
    uu[m] = u[h * HD + i];
    st[m] = state0 != nullptr
                ? *reinterpret_cast<const float4*>(state0 + sbase + i * HD)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // step t's operands: r, k, w of the thread's rows, v of its columns
  float rr[RPT], kk[RPT], ww[RPT];
  float4 vv;
  auto fetch = [&](int t, float (&r_)[RPT], float (&k_)[RPT], float (&w_)[RPT],
                   float4& v_) {
    const long long base = ((static_cast<long long>(b) * S + t) * H + h) * HD;
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const int i = g + G * m;
      r_[m] = load1(r + base + i);
      k_[m] = load1(k + base + i);
      w_[m] = w[base + i];
    }
    v_ = load4(v + base + c);
  };
  fetch(0, rr, kk, ww, vv);

  for (int t = 0; t < S; ++t) {
    float nr[RPT], nk[RPT], nw[RPT];
    float4 nv;
    if (t + 1 < S) fetch(t + 1, nr, nk, nw, nv);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const float uk = uu[m] * kk[m];
      o.x = fmaf(rr[m], st[m].x + uk * vv.x, o.x);
      o.y = fmaf(rr[m], st[m].y + uk * vv.y, o.y);
      o.z = fmaf(rr[m], st[m].z + uk * vv.z, o.z);
      o.w = fmaf(rr[m], st[m].w + uk * vv.w, o.w);
      st[m].x = fmaf(ww[m], st[m].x, kk[m] * vv.x);
      st[m].y = fmaf(ww[m], st[m].y, kk[m] * vv.y);
      st[m].z = fmaf(ww[m], st[m].z, kk[m] * vv.z);
      st[m].w = fmaf(ww[m], st[m].w, kk[m] * vv.w);
    }
    // the 16 row groups of a column quad are lanes of one warp: pairwise
    // tree, lower group on the left; no shared memory, no barrier
#pragma unroll
    for (int off = QW; off < 32; off <<= 1) {
      o.x += __shfl_xor_sync(0xffffffffu, o.x, off);
      o.y += __shfl_xor_sync(0xffffffffu, o.y, off);
      o.z += __shfl_xor_sync(0xffffffffu, o.z, off);
      o.w += __shfl_xor_sync(0xffffffffu, o.w, off);
    }
    if (g == 0)
      *reinterpret_cast<float4*>(
          out + ((static_cast<long long>(b) * S + t) * H + h) * HD + c) = o;
    if (t + 1 < S) {
#pragma unroll
      for (int m = 0; m < RPT; ++m) { rr[m] = nr[m]; kk[m] = nk[m]; ww[m] = nw[m]; }
      vv = nv;
    }
  }
#pragma unroll
  for (int m = 0; m < RPT; ++m)
    *reinterpret_cast<float4*>(stateT + sbase + (g + G * m) * HD) = st[m];
}

// ---------------------------------------------------------------------------
// Chunked route
// ---------------------------------------------------------------------------

template <int HD>
struct Chunk {
  // G threads per state column, each holding IPT rows in registers: up to
  // kRowsPerThread rows a thread (fewer, fuller threads measured faster
  // than 8 or 16 rows: fewer shuffles per output), at least 64 threads a
  // block; at hd 64, 128 threads and four blocks an SM
  static constexpr int GA = HD >= kRowsPerThread ? HD / kRowsPerThread : 1;
  static constexpr int GB = HD <= 64 ? 64 / HD : 1;
  static constexpr int G = GA > GB ? GA : GB;
  static constexpr int NT = G * HD;           // threads per block
  static constexpr int IPT = HD / G;          // state rows per thread (>= 4)
  // blocks per SM the registers allow at kRegs a thread
  static constexpr int MINB_ = 65536 / (NT * kRegs);
  static constexpr int MINB = MINB_ < 1 ? 1 : (MINB_ > 8 ? 8 : MINB_);
  static constexpr int IG = HD / 16;          // rows per thread, diagonal step
  // 4-element groups of a (kT, HD) operand tile each thread stages
  static constexpr int NE = (kT * HD / 4 + NT - 1) / NT;
  // Row stride of the decayed r and k tiles: each thread's IPT rows are
  // contiguous (float4 reads), its group padded by 4 so the G groups of a
  // warp's broadcast reads start in different banks.
  static constexpr int RS = G * (IPT + 4);
  // Shared memory, in floats: raw r, k, w, v tiles; decayed r and k tiles;
  // the pair weights P; the sub-block's decay.
  static constexpr int kRaw = kT * HD;
  static constexpr int kDec = kT * RS;
  static constexpr int PS = kT + 4;           // row stride of P (float4 rows)
  static constexpr int kP = kT * PS;
  static constexpr int TPL = kT / G;          // output rows each lane stores
  static constexpr int FLOATS = 4 * kRaw + 2 * kDec + kP + HD;
  static constexpr int SMEM = FLOATS * 4;
};

// Sum N values over a group of L adjacent lanes (L | N, powers of two),
// scattered: lane l of the group ends with the totals of v[l * N / L + x]
// in v[x], x < N / L.
template <int N, int L>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int l) {
  int n = N;
#pragma unroll
  for (int lanes = L; lanes > 1; lanes >>= 1) {
    const int off = lanes >> 1;
    const bool hi = (l & off) != 0;
    n >>= 1;
#pragma unroll
    for (int x = 0; x < N / 2; ++x) {
      if (x < n) {
        const float send = hi ? v[x] : v[x + n];
        const float keep = hi ? v[x + n] : v[x];
        v[x] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    }
  }
}

// OUT = false: phase 1, the chunk's dS (into ws) and decay (into wd).
// OUT = true: phase 3, the chunk's outputs from its start state in ws.
// Grid (chunks, H, B); ws (B, H, chunks, HD, HD), wd (B, H, chunks, HD).
template <int HD, bool OUT, typename TI>
__global__ void __launch_bounds__(Chunk<HD>::NT, Chunk<HD>::MINB)
wkv_chunk(const TI* __restrict__ r, const TI* __restrict__ k,
          const TI* __restrict__ v, const float* __restrict__ w,
          const float* __restrict__ u, float* __restrict__ out,
          float* __restrict__ ws, float* __restrict__ wd, int S, int H,
          int C) {
  using Cfg = Chunk<HD>;
  constexpr int NT = Cfg::NT, G = Cfg::G, IPT = Cfg::IPT, IG = Cfg::IG;
  constexpr int NE = Cfg::NE, RS = Cfg::RS;
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;                      // [kT][HD] raw r
  float* sk = sr + Cfg::kRaw;            // [kT][HD] raw k
  float* sw = sk + Cfg::kRaw;            // [kT][HD] w
  float* sv = sw + Cfg::kRaw;            // [kT][HD] v
  float* rd = sv + Cfg::kRaw;            // [kT][RS] lp_t r_t
  float* kd = rd + Cfg::kDec;            // [kT][RS] ls_s k_s
  float* sP = kd + Cfg::kDec;            // [kT][PS] pair weights
  float* slp = sP + Cfg::kP;             // [HD] sub-block decay

  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nchunks = gridDim.x;
  const int t0c = c * C;
  const int len = min(C, S - t0c);
  const int j = tid / G, g = tid - (tid / G) * G;
  const long long bh = static_cast<long long>(b) * H + h;
  float* wsc = ws + (bh * nchunks + c) * HD * HD;

  // operands of one sub-block, 4-element group e = tid + x * NT of its
  // (kT, HD) tile, loaded one sub-block ahead
  constexpr int kGroups = kT * HD / 4;
  float4 pr[NE], pk[NE], pv[NE], pw[NE];
  auto fetch = [&](int tb) {
#pragma unroll
    for (int x = 0; x < NE; ++x) {
      const int e = tid + x * NT;
      const int t = e / (HD / 4), i = 4 * (e - t * (HD / 4));
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      pr[x] = pk[x] = pv[x] = zero;
      pw[x] = make_float4(1.f, 1.f, 1.f, 1.f);
      if (e < kGroups && tb + t < len) {
        const long long idx =
            ((static_cast<long long>(b) * S + t0c + tb + t) * H + h) * HD + i;
        pk[x] = load4(k + idx);
        pv[x] = load4(v + idx);
        pw[x] = load4(w + idx);
        if (OUT) pr[x] = load4(r + idx);
      }
    }
  };
  fetch(0);

  float st[IPT];
#pragma unroll
  for (int m = 0; m < IPT; ++m)
    st[m] = OUT ? wsc[(g * IPT + m) * HD + j] : 0.f;
  float decay = 1.f;  // phase 1: the chunk's decay of row tid (tid < HD)

  for (int tb = 0; tb < len; tb += kT) {
#pragma unroll
    for (int x = 0; x < NE; ++x) {
      const int e = tid + x * NT;
      if (e < kGroups) {
        reinterpret_cast<float4*>(sr)[e] = pr[x];
        reinterpret_cast<float4*>(sk)[e] = pk[x];
        reinterpret_cast<float4*>(sv)[e] = pv[x];
        reinterpret_cast<float4*>(sw)[e] = pw[x];
      }
    }
    if (tb + kT < len) fetch(tb + kT);
    __syncthreads();

    for (int q = tid; q < 2 * HD; q += NT) {
      // decayed tiles: rows q < HD multiply backward for k (and the
      // sub-block's decay), q = HD + i forward for r
      const int i = q < HD ? q : q - HD;
      const int col = (i / IPT) * (IPT + 4) + (i - (i / IPT) * IPT);
      float wv[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t) wv[t] = sw[t * HD + i];
      if (q < HD) {
        float p = 1.f;
#pragma unroll
        for (int s = kT - 1; s >= 0; --s) {
          kd[s * RS + col] = sk[s * HD + i] * p;
          p *= wv[s];
        }
        slp[i] = p;
        decay *= p;
      } else if (OUT) {
        float f = 1.f;
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          rd[t * RS + col] = sr[t * HD + i] * f;
          f *= wv[t];
        }
      }
    }
    // pair weights of the diagonal sub-block: a half-warp takes the rows
    // t1 < 8 and t2 = 15 - t1 (15 pairs between them: balanced), lane ig
    // the rows i = m * 16 + ig of acc[s] = sum_i r_t[i] k_s[i]
    // prod_{s<m<t} w_m[i] (and the bonus at s = t), sharing each k_s, w_s
    // load between the two rows; then the half-warp reduces them
    for (int slot = tid; OUT && slot < 8 * 16; slot += NT) {
      const int t1 = slot >> 4, t2 = kT - 1 - t1, ig = slot & 15;
      float acc1[kT], acc2[kT];
#pragma unroll
      for (int s = 0; s < kT; ++s) acc1[s] = acc2[s] = 0.f;
      float bonus1 = 0.f, bonus2 = 0.f;
#pragma unroll
      for (int m = 0; m < IG; ++m) {
        const int i = m * 16 + ig;
        const float r1 = sr[t1 * HD + i], r2 = sr[t2 * HD + i];
        const float ui = u[h * HD + i];
        bonus1 = fmaf(r1 * ui, sk[t1 * HD + i], bonus1);
        bonus2 = fmaf(r2 * ui, sk[t2 * HD + i], bonus2);
        float rf1 = r1, rf2 = r2;
#pragma unroll
        for (int s = kT - 2; s >= 0; --s) {
          const float ks = sk[s * HD + i], wsv = sw[s * HD + i];
          if (s < t2) {   // t2 >= 8: always for s < 8
            acc2[s] = fmaf(rf2, ks, acc2[s]);
            rf2 *= wsv;
          }
          if (s < 8 && s < t1) {
            acc1[s] = fmaf(rf1, ks, acc1[s]);
            rf1 *= wsv;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kT; ++s) {
        acc1[s] = s == t1 ? bonus1 : acc1[s];
        acc2[s] = s == t2 ? bonus2 : acc2[s];
      }
      reduce_scatter<kT, 16>(acc1, ig);
      reduce_scatter<kT, 16>(acc2, ig);
      sP[t1 * Cfg::PS + ig] = ig <= t1 ? acc1[0] : 0.f;
      sP[t2 * Cfg::PS + ig] = ig <= t2 ? acc2[0] : 0.f;
    }
    __syncthreads();

    if (OUT) {
      // out_t[j] = rd_t . S_b[:, j] + sum_{s <= t} P[t][s] v_s[j]: partial
      // dot products over the lane's IPT rows for every t, reduced over the
      // column's G lanes so that lane g holds rows t = g * TPL + x, to
      // which it adds their P . v terms (P is 0 above the diagonal)
      constexpr int TPL = Cfg::TPL;
      const float* rdg = rd + g * (IPT + 4);
      float o[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        float o0 = 0.f, o1 = 0.f;
#pragma unroll
        for (int m = 0; m < IPT; m += 4) {
          const float4 x = *reinterpret_cast<const float4*>(rdg + t * RS + m);
          o0 = fmaf(x.x, st[m], o0);
          o1 = fmaf(x.y, st[m + 1], o1);
          o0 = fmaf(x.z, st[m + 2], o0);
          o1 = fmaf(x.w, st[m + 3], o1);
        }
        o[t] = o0 + o1;
      }
      reduce_scatter<kT, G>(o, g);
#pragma unroll
      for (int s4 = 0; s4 < kT; s4 += 4) {
        const float v0 = sv[s4 * HD + j], v1 = sv[(s4 + 1) * HD + j];
        const float v2 = sv[(s4 + 2) * HD + j], v3 = sv[(s4 + 3) * HD + j];
#pragma unroll
        for (int x = 0; x < TPL; ++x) {
          const float4 pp = *reinterpret_cast<const float4*>(
              sP + (g * TPL + x) * Cfg::PS + s4);
          o[x] = fmaf(pp.x, v0, o[x]);
          o[x] = fmaf(pp.y, v1, o[x]);
          o[x] = fmaf(pp.z, v2, o[x]);
          o[x] = fmaf(pp.w, v3, o[x]);
        }
      }
#pragma unroll
      for (int x = 0; x < TPL; ++x) {
        const int t = g * TPL + x;
        if (tb + t < len)
          out[((static_cast<long long>(b) * S + t0c + tb + t) * H + h) * HD +
              j] = o[x];
      }
    }

    // S_{b+kT}[i][j] = lp[i] * S_b[i][j] + sum_s kd_s[i] v_s[j] (phase 3
    // needs no state after the chunk's last sub-block)
    if (!OUT || tb + kT < len) {
      const float* kdg = kd + g * (IPT + 4);
#pragma unroll
      for (int m = 0; m < IPT; ++m) st[m] *= slp[g * IPT + m];
#pragma unroll 4
      for (int s = 0; s < kT; ++s) {
        const float vj = sv[s * HD + j];
#pragma unroll
        for (int m = 0; m < IPT; m += 4) {
          const float4 x = *reinterpret_cast<const float4*>(kdg + s * RS + m);
          st[m] = fmaf(x.x, vj, st[m]);
          st[m + 1] = fmaf(x.y, vj, st[m + 1]);
          st[m + 2] = fmaf(x.z, vj, st[m + 2]);
          st[m + 3] = fmaf(x.w, vj, st[m + 3]);
        }
      }
    }
    __syncthreads();
  }

  if (!OUT) {
#pragma unroll
    for (int m = 0; m < IPT; ++m) wsc[(g * IPT + m) * HD + j] = st[m];
    if (tid < HD) wd[(bh * nchunks + c) * HD + tid] = decay;
  }
}

// Phase 2.  Grid (slices, H, B): each thread carries 4 state entries of one
// row i through the chunks: ws[c] <- S_c (overwriting dS_c), then
// S_{c+1} = D_c[i] * S_c + dS_c; the last is the final state.
template <int HD>
__global__ void __launch_bounds__(kScanThreads)
wkv_scan(float* __restrict__ ws, const float* __restrict__ wd,
         const float* __restrict__ state0, float* __restrict__ stateT,
         int H, int nchunks) {
  const int e = 4 * (blockIdx.x * kScanThreads + threadIdx.x);
  if (e >= HD * HD) return;
  const int i = e / HD;
  const long long bh = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (state0 != nullptr)
    s = *reinterpret_cast<const float4*>(state0 + bh * HD * HD + e);
  // kScanBatch chunks' loads start before any of their stores
  for (int c0 = 0; c0 < nchunks; c0 += kScanBatch) {
    float4 ds[kScanBatch];
    float d[kScanBatch];
#pragma unroll
    for (int x = 0; x < kScanBatch; ++x) {
      if (c0 + x < nchunks) {
        const long long cc = bh * nchunks + c0 + x;
        ds[x] = *reinterpret_cast<const float4*>(ws + cc * HD * HD + e);
        d[x] = wd[cc * HD + i];
      }
    }
#pragma unroll
    for (int x = 0; x < kScanBatch; ++x) {
      if (c0 + x < nchunks) {
        *reinterpret_cast<float4*>(ws + (bh * nchunks + c0 + x) * HD * HD + e) = s;
        s.x = fmaf(d[x], s.x, ds[x].x);
        s.y = fmaf(d[x], s.y, ds[x].y);
        s.z = fmaf(d[x], s.z, ds[x].z);
        s.w = fmaf(d[x], s.w, ds[x].w);
      }
    }
  }
  *reinterpret_cast<float4*>(stateT + bh * HD * HD + e) = s;
}

// cudaFuncSetAttribute for the chunk kernels' dynamic shared memory, once
// per device and instantiation.
template <int HD, bool OUT, typename TI>
int smem_attribute() {
  static int done[kMaxDevices];  // 0 unset, 1 set, else -(error)
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev] == 0) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        wkv_chunk<HD, OUT, TI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Chunk<HD>::SMEM));
    done[dev] = rc == 0 ? 1 : -rc;
  }
  return done[dev] == 1 ? 0 : -done[dev];
}

template <int HD, typename TI>
int launch_chunked(const TI* r, const TI* k, const TI* v, const float* w,
                   const float* u, const float* state0, float* out,
                   float* stateT, float* ws, float* wd, int B, int S, int H,
                   int C, cudaStream_t stream) {
  if (C <= 0 || C % kT != 0 || ws == nullptr || wd == nullptr)
    return cudaErrorInvalidValue;
  int rc = smem_attribute<HD, false, TI>();
  if (rc == 0) rc = smem_attribute<HD, true, TI>();
  if (rc != 0) return rc;
  const int nchunks = (S + C - 1) / C;
  const dim3 grid(nchunks, H, B);
  constexpr int smem = Chunk<HD>::SMEM;
  constexpr int nt = Chunk<HD>::NT;
  wkv_chunk<HD, false, TI><<<grid, nt, smem, stream>>>(
      r, k, v, w, u, out, ws, wd, S, H, C);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int slices = (HD * HD / 4 + kScanThreads - 1) / kScanThreads;
  wkv_scan<HD><<<dim3(slices, H, B), kScanThreads, 0, stream>>>(
      ws, wd, state0, stateT, H, nchunks);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  wkv_chunk<HD, true, TI><<<grid, nt, smem, stream>>>(
      r, k, v, w, u, out, ws, wd, S, H, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI>
int launch(const TI* r, const TI* k, const TI* v, const float* w,
           const float* u, const float* state0, float* out, float* stateT,
           float* ws, float* wd, int B, int S, int H, int hd, int chunk,
           cudaStream_t stream) {
#define WKV_HD(D)                                                            \
  case D:                                                                    \
    if (chunk > 0)                                                           \
      return launch_chunked<D, TI>(r, k, v, w, u, state0, out, stateT, ws,   \
                                   wd, B, S, H, chunk, stream);              \
    wkv_step<D, TI><<<dim3(D / Step<D>::COLS, H, B), Step<D>::NT, 0,         \
                      stream>>>(r, k, v, w, u, state0, out, stateT, S, H);   \
    return static_cast<int>(cudaGetLastError());
  switch (hd) {
    WKV_HD(16) WKV_HD(32) WKV_HD(64) WKV_HD(128)
    default: return cudaErrorInvalidValue;
  }
#undef WKV_HD
}

}  // namespace

extern "C" {

// All operands contiguous: r, k, v (B, S, H, hd) of dtype 0 float32 or
// 1 bfloat16; w and out (B, S, H, hd), u (H, hd), state0 (B, H, hd, hd) or
// null for zeros, stateT (B, H, hd, hd), all float32.  hd in {16, 32, 64,
// 128}.  chunk == 0 runs the recurrent route; chunk > 0 (a multiple of 16)
// the chunked route, with float32 workspaces ws (B, H, chunks, hd, hd) and
// wd (B, H, chunks, hd), chunks = ceil(S / chunk).  Returns
// cudaGetLastError() after the launch(es).
int wkv_fwd(int dtype, const void* r, const void* k, const void* v,
            const float* w, const float* u, const float* state0, float* out,
            float* stateT, float* ws, float* wd, int B, int S, int H, int hd,
            int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535 || chunk < 0)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(static_cast<const float*>(r),
                         static_cast<const float*>(k),
                         static_cast<const float*>(v), w, u, state0, out,
                         stateT, ws, wd, B, S, H, hd, chunk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(r),
                                 static_cast<const __nv_bfloat16*>(k),
                                 static_cast<const __nv_bfloat16*>(v), w, u,
                                 state0, out, stateT, ws, wd, B, S, H, hd,
                                 chunk, st);
  return cudaErrorInvalidValue;
}

const char* wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
