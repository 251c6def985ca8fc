// Surround meter hot path for NVIDIA Hopper (sm_90a): K-meter smoothers,
// block peaks, the correlator lowpass and the routed pair sums in one pass
// over the input.
//
// Replaces meters_lv2_tpu/ops/pallas_surround.py::fused_core (the Pallas TPU
// kernel).  For each stream b and channel c of x[b, c, 0:T], T % 128 == 0:
//   km_z'  the K-meter's grouped-4 two-stage smoother state on x^2
//          (kmeterdsp.cc:77-107), advanced per 128-sample block in the
//          blocked form s' = s @ At + x^2 @ G (host-built operator,
//          ops/lti.py grouped4_smoother_system(w).op(32)).  At[1][0] is
//          exactly 0 and is multiplied, not skipped: an infinite z2 makes z1
//          NaN as in the plain version's products;
//   pk     the block max of x^2, NaN samples skipped (kmeterdsp.cc:124):
//          fmaxf drops NaN and lets +Inf win, bit for bit the plain
//          version's max of where(isnan(q), 0, q);
//   zl'    the correlator one-pole lowpass state after the block, on x + eps
//          (stcorrdsp.cc:56-60);
// and for each routed pair p, with ya = sum_c sel_a[p][c] y_c and yb alike
// over EVERY channel (a non-finite y in any channel reaches every pair
// through 0 * NaN, as the JAX package's one-hot product does):
//   pacc   sum_t wv[t] (ya yb, ya ya, yb yb)(t), the closed-form weighted
//          sums of the w2 averages (the caller adds zp (1 - w2)^T).
//
// Arithmetic: IEEE fp32 FMAs, no tensor cores, no TF32, no fast math.  The
// plain PyTorch version (ops/surround_fused.py::fused_core_reference) runs
// the same blocked recurrences as float32 matrix products, so the two agree
// to a stated tolerance; zl and pacc are non-finite where the plain
// version's are (the meter flushes both through isfinite).
//
// What bounds it: the function reads x once, B*C*T*4 bytes, and does about
// 9 fp32 operations a channel-sample plus 4C + 9 a pair-sample: at C = 8 it
// is bound by the bytes (0.117 ms at 3.35 TB/s against 0.04 ms of
// operations at B = 256, T = 48000).
//
// What the design does about it: CUDA blocks run in no order, so the time
// loop lives inside the CTA.  One CTA owns one stream; its 128 threads take
// 128 consecutive 128-sample blocks at a time (a chunk), each thread one
// block of every channel, read once as float4 loads.  A thread runs its
// block's lowpass from a zero state, sums x^2 against G's two columns, takes
// the peak and accumulates the pair sums of the zero-state outputs together
// with the sums that the carried state will add: with r_t = (1-w1)^(t+1)
// the true output is y_t + zin r_t, so
//   sum wv (ya + A r)(yb + B r) = S_ab + A R_b + B R_a + A B Q,
// R_a = sum wv r ya, R_b = sum wv r yb, Q = sum wv r^2, A = sel_a . zin.
// Then C threads step the chunk's blocks in order (zl' = a128 zl + e, the
// 2x2 K-meter step), which gives every block's entering state zin, and each
// thread adds its corrected sums.  The partial sums are reduced in a fixed
// order at the end, so a run is reproducible.  A 3- to 8-channel stream is
// one CTA, 256 CTAs at B = 256: one wave of about two CTAs per SM.  More
// CTAs per stream (a second pass for the carries) and staged loads are
// later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlk = 128;      // samples per block
constexpr int kThreads = 128;  // blocks per chunk, one per thread
constexpr int kStride = kThreads + 1;  // conflict-free column walks

template <int C, int P>
struct Smem {
  float g[2][kBlk];     // G's columns
  float sy[kBlk];       // (1 - w1)^(t+1)
  float e[C][kStride];  // zero-state lowpass value at each block's end
  float gin[C][2][kStride];
  float zin[C][kStride];  // lowpass state entering each block
  float red[(3 * P > C ? 3 * P : C)][kStride];
};

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <int C, int P>
__global__ void __launch_bounds__(kThreads)
surround_fused_kernel(const float* __restrict__ x, const float* __restrict__ km_z,
                      const float* __restrict__ zl0, const float* __restrict__ sel_a,
                      const float* __restrict__ sel_b, const float* __restrict__ wv,
                      const float* __restrict__ km_at, const float* __restrict__ km_g,
                      const float* __restrict__ lp_at, const float* __restrict__ lp_sy,
                      float w1, float om1, float eps, int T,
                      float* __restrict__ kmz_out, float* __restrict__ zl_out,
                      float* __restrict__ pk_out, float* __restrict__ pacc_out) {
  __shared__ Smem<C, P> sm;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int nblk = T / kBlk;

  for (int i = tid; i < kBlk; i += kThreads) {
    sm.g[0][i] = km_g[2 * i];
    sm.g[1][i] = km_g[2 * i + 1];
    sm.sy[i] = lp_sy[i];
  }
  float sa[P][C], sb[P][C];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sa[p][c] = sel_a[p * C + c];
      sb[p][c] = sel_b[p * C + c];
    }
  }
  // s' = s @ At: s0' = at00 s0 + at10 s1, s1' = at01 s0 + at11 s1
  const float at00 = km_at[0], at01 = km_at[1], at10 = km_at[2], at11 = km_at[3];
  const float a128 = lp_at[0];
  // the carried states of channel tid, on threads tid < C
  float zl = 0.f, s0 = 0.f, s1 = 0.f;
  if (tid < C) {
    const size_t o = (size_t)b * C + tid;
    zl = zl0[o];
    s0 = km_z[2 * o];
    s1 = km_z[2 * o + 1];
  }
  float pk[C];
#pragma unroll
  for (int c = 0; c < C; ++c) pk[c] = 0.f;
  float tot[P][3];
#pragma unroll
  for (int p = 0; p < P; ++p) tot[p][0] = tot[p][1] = tot[p][2] = 0.f;
  __syncthreads();

  const float* xb = x + (size_t)b * C * T;
  for (int c0 = 0; c0 < nblk; c0 += kThreads) {
    const int nb = min(kThreads, nblk - c0);
    float S[P][3], Ra[P], Rb[P], Q = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) S[p][0] = S[p][1] = S[p][2] = Ra[p] = Rb[p] = 0.f;
    if (tid < nb) {
      const size_t off = (size_t)(c0 + tid) * kBlk;
      float z[C], g0[C], g1[C];
#pragma unroll
      for (int c = 0; c < C; ++c) z[c] = g0[c] = g1[c] = 0.f;
      for (int t0 = 0; t0 < kBlk; t0 += 4) {
        float4 xv[C];
#pragma unroll
        for (int c = 0; c < C; ++c)
          xv[c] = *reinterpret_cast<const float4*>(xb + (size_t)c * T + off + t0);
        const float4 w4 = *reinterpret_cast<const float4*>(wv + off + t0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + u;
          const float gk0 = sm.g[0][t], gk1 = sm.g[1][t];
          float y[C];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float v = lane4(xv[c], u);
            const float q = v * v;
            pk[c] = fmaxf(pk[c], q);
            g0[c] = fmaf(q, gk0, g0[c]);
            g1[c] = fmaf(q, gk1, g1[c]);
            z[c] = fmaf(om1, z[c], w1 * (v + eps));
            y[c] = z[c];
          }
          const float wt = lane4(w4, u);
          const float r = sm.sy[t];
          const float wr = wt * r;
          Q = fmaf(wr, r, Q);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            float ya = sa[p][0] * y[0], yb = sb[p][0] * y[0];
#pragma unroll
            for (int c = 1; c < C; ++c) {
              ya = fmaf(sa[p][c], y[c], ya);
              yb = fmaf(sb[p][c], y[c], yb);
            }
            S[p][0] = fmaf(wt, ya * yb, S[p][0]);
            S[p][1] = fmaf(wt, ya * ya, S[p][1]);
            S[p][2] = fmaf(wt, yb * yb, S[p][2]);
            Ra[p] = fmaf(wr, ya, Ra[p]);
            Rb[p] = fmaf(wr, yb, Rb[p]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        sm.e[c][tid] = z[c];
        sm.gin[c][0][tid] = g0[c];
        sm.gin[c][1][tid] = g1[c];
      }
    }
    __syncthreads();
    // the chunk's blocks in order: the states entering each block
    if (tid < C) {
      for (int i = 0; i < nb; ++i) {
        sm.zin[tid][i] = zl;
        zl = fmaf(a128, zl, sm.e[tid][i]);
        const float n0 = fmaf(at10, s1, at00 * s0) + sm.gin[tid][0][i];
        const float n1 = fmaf(at11, s1, at01 * s0) + sm.gin[tid][1][i];
        s0 = n0;
        s1 = n1;
      }
    }
    __syncthreads();
    if (tid < nb) {
      float zi[C];
#pragma unroll
      for (int c = 0; c < C; ++c) zi[c] = sm.zin[c][tid];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float A = sa[p][0] * zi[0], Bv = sb[p][0] * zi[0];
#pragma unroll
        for (int c = 1; c < C; ++c) {
          A = fmaf(sa[p][c], zi[c], A);
          Bv = fmaf(sb[p][c], zi[c], Bv);
        }
        tot[p][0] += ((S[p][0] + A * Rb[p]) + Bv * Ra[p]) + A * Bv * Q;
        tot[p][1] += (S[p][1] + 2.f * A * Ra[p]) + A * A * Q;
        tot[p][2] += (S[p][2] + 2.f * Bv * Rb[p]) + Bv * Bv * Q;
      }
    }
    __syncthreads();  // the next chunk rewrites e, gin and zin
  }

  // fixed-order reductions over the threads
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int k = 0; k < 3; ++k) sm.red[3 * p + k][tid] = tot[p][k];
  }
  __syncthreads();
  if (tid < 3 * P) {
    float s = 0.f;
    for (int i = 0; i < kThreads; ++i) s += sm.red[tid][i];
    pacc_out[(size_t)b * 3 * P + tid] = s;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) sm.red[c][tid] = pk[c];
  __syncthreads();
  if (tid < C) {
    float m = 0.f;
    for (int i = 0; i < kThreads; ++i) m = fmaxf(m, sm.red[tid][i]);
    const size_t o = (size_t)b * C + tid;
    pk_out[o] = m;
    zl_out[o] = zl;
    kmz_out[2 * o] = s0;
    kmz_out[2 * o + 1] = s1;
  }
}

template <int C, int P>
int launch(const float* x, const float* km_z, const float* zl, const float* sel_a,
           const float* sel_b, const float* wv, const float* km_at, const float* km_g,
           const float* lp_at, const float* lp_sy, float w1, float om1, float eps, int B,
           int T, float* kmz, float* zlo, float* pk, float* pacc, cudaStream_t stream) {
  surround_fused_kernel<C, P><<<B, kThreads, 0, stream>>>(
      x, km_z, zl, sel_a, sel_b, wv, km_at, km_g, lp_at, lp_sy, w1, om1, eps, T, kmz, zlo,
      pk, pacc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// All pointers are device pointers: x [B, C, T], km_z [B, C, 2], zl [B, C, 1],
// sel_a, sel_b [P, C], wv [T], the K-meter block operator's at [2, 2] and
// g [128, 2], the lowpass operator's at [1, 1] and sy [1, 128]; outputs
// kmz [B, C, 2], zlo [B, C, 1], pk [B, C], pacc [B, P, 3].  C is 3..8 with
// P = 4 pairs (3 when C == 3); x and wv are 16-byte aligned.
int surround_fused_launch(const float* x, const float* km_z, const float* zl,
                          const float* sel_a, const float* sel_b, const float* wv,
                          const float* km_at, const float* km_g, const float* lp_at,
                          const float* lp_sy, float w1, float om1, float eps, int B, int C,
                          int T, float* kmz, float* zlo, float* pk, float* pacc,
                          void* stream) {
  if (B <= 0 || T < kBlk || T % kBlk != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SURROUND_CASE(NC, NP)                                                              \
  case NC:                                                                                 \
    return launch<NC, NP>(x, km_z, zl, sel_a, sel_b, wv, km_at, km_g, lp_at, lp_sy, w1,   \
                          om1, eps, B, T, kmz, zlo, pk, pacc, s);
  switch (C) {
    SURROUND_CASE(3, 3)
    SURROUND_CASE(4, 4)
    SURROUND_CASE(5, 4)
    SURROUND_CASE(6, 4)
    SURROUND_CASE(7, 4)
    SURROUND_CASE(8, 4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SURROUND_CASE
}

}  // extern "C"
