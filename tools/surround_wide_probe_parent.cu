// Surround meter hot path, wide layout, for NVIDIA Hopper (sm_90a): the
// function of surround_fused.cu with one unit of parallel work per
// (stream, channel) row.
//
// Replaces meters_lv2_tpu/ops/pallas_surround.py::_fused_core_wide (the
// Pallas TPU kernel that puts the (stream, channel) rows on sublanes).  It
// computes exactly what surround_fused.cu computes, for x[b, c, 0:T],
// T % 128 == 0: the K-meter smoother state km_z', the block peak pk of x^2
// (NaN skipped), the correlator lowpass state zl' on x + eps, and for each
// routed pair p the weighted sums
//   pacc = sum_t wv[t] (ya yb, ya ya, yb yb)(t),
// ya = sum_c sel_a[p][c] y_c over EVERY channel (a non-finite y in any
// channel reaches every pair, as the JAX package's one-hot product does).
// Its plain version is the narrow kernel's (ops/surround_fused.py::
// fused_core_reference).
//
// Arithmetic: the per-block expressions of surround_fused.cu, in the same
// order (IEEE fp32 FMAs, no fast math): the zero-state lowpass of a block,
// x^2 against G's two columns, the block peak, and the serial carries of
// zl and of the 2x2 K-meter step over the blocks in order.  So km_z', zl'
// and pk are bit-identical to the narrow kernel's.  The pair sums of a
// block also use its expressions, with the carried state composed in
// closed form (r_t = (1-w1)^(t+1), A = sel_a . zin, B = sel_b . zin):
//   sum wv (ya + A r)(yb + B r) = S_ab + A R_b + B R_a + A B Q;
// only the order in which the blocks' sums are added differs, so pacc
// agrees with the narrow kernel to float32 rounding.
//
// What bounds it: as the narrow kernel, the bytes of x read once (0.117 ms
// at B = 256, C = 8, T = 48000 on 3.35 TB/s).
//
// The layout: one CTA per stream, kLanes threads per channel row, C rows:
// thread (c, j) runs channel c's lowpass, K-meter sums and peak over block
// j of each chunk of kLanes consecutive 128-sample blocks, 4 samples a
// step.  Each step it puts its 4 zero-state lowpass outputs into a
// double-buffered shared array; after one barrier the threads of row p
// (p < P) read the C channels' outputs of their block and accumulate pair
// p's sums.  After a chunk one thread per row steps the chunk's blocks in
// order (the carries), and the pair threads add their blocks' corrected
// sums.  At the end the pair sums are reduced over the lanes and the peaks
// over the row, both in a fixed order: a run is reproducible.  The narrow
// kernel gives one thread every channel of a block; this one gives each
// row its own threads and pays a barrier per 4 samples for the exchange:
// 0.29 / 0.60 ms against the narrow kernel's 0.25 / 0.43 at C = 5 / 8,
// B = 256, T = 48000 (H100 80GB HBM3, 700 W, alternated in one run).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlk = 128;   // samples per block
constexpr int kLanes = 64;  // threads per (stream, channel) row: blocks per chunk
constexpr int kStride = kLanes + 1;

template <int C, int P>
struct Smem {
  float g[2][kBlk];            // G's columns
  float sy[kBlk];              // (1 - w1)^(t+1)
  float4 y[2][C][kLanes];      // zero-state lowpass outputs, 4 samples, 2 buffers
  float e[C][kStride];         // zero-state lowpass value at each block's end
  float gin[C][2][kStride];    // x^2 @ G of each block
  float zin[C][kStride];       // lowpass state entering each block
  float red[3 * P][kStride];   // the pair sums, per lane
  float pk[C][kStride];        // the peaks, per lane
};

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <int C, int P>
__global__ void __launch_bounds__(C * kLanes)
surround_wide_kernel(const float* __restrict__ x, const float* __restrict__ km_z,
                     const float* __restrict__ zl0, const float* __restrict__ sel_a,
                     const float* __restrict__ sel_b, const float* __restrict__ wv,
                     const float* __restrict__ km_at, const float* __restrict__ km_g,
                     const float* __restrict__ lp_at, const float* __restrict__ lp_sy,
                     float w1, float om1, float eps, int T,
                     float* __restrict__ kmz_out, float* __restrict__ zl_out,
                     float* __restrict__ pk_out, float* __restrict__ pacc_out) {
  __shared__ Smem<C, P> sm;
  const int tid = threadIdx.x;
  const int c = tid / kLanes;  // this thread's channel row
  const int j = tid % kLanes;  // its block within a chunk
  const bool pair = c < P;     // row c also accumulates pair c
  const int b = blockIdx.x;
  const int nblk = T / kBlk;

  for (int i = tid; i < kBlk; i += C * kLanes) {
    sm.g[0][i] = km_g[2 * i];
    sm.g[1][i] = km_g[2 * i + 1];
    sm.sy[i] = lp_sy[i];
  }
  float sa[C], sb[C];
#pragma unroll
  for (int cc = 0; cc < C; ++cc) {
    sa[cc] = pair ? sel_a[c * C + cc] : 0.f;
    sb[cc] = pair ? sel_b[c * C + cc] : 0.f;
  }
  const float at00 = km_at[0], at01 = km_at[1], at10 = km_at[2], at11 = km_at[3];
  const float a128 = lp_at[0];
  // the carried states of channel c, on the row's thread j == 0
  float zl = 0.f, s0 = 0.f, s1 = 0.f;
  if (j == 0) {
    const size_t o = (size_t)b * C + c;
    zl = zl0[o];
    s0 = km_z[2 * o];
    s1 = km_z[2 * o + 1];
  }
  float pk = 0.f;
  float tot[3] = {0.f, 0.f, 0.f};
  int buf = 0;
  __syncthreads();

  const float* xr = x + ((size_t)b * C + c) * T;
  for (int c0 = 0; c0 < nblk; c0 += kLanes) {
    const int nb = min(kLanes, nblk - c0);
    const bool live = j < nb;
    const size_t off = (size_t)(c0 + j) * kBlk;
    float z = 0.f, g0 = 0.f, g1 = 0.f;
    float S0 = 0.f, S1 = 0.f, S2 = 0.f, Ra = 0.f, Rb = 0.f, Q = 0.f;
    for (int t0 = 0; t0 < kBlk; t0 += 4) {
      float4 yo = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + off + t0);
        float yv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float v = lane4(xv, u);
          const float q = v * v;
          pk = fmaxf(pk, q);
          g0 = fmaf(q, sm.g[0][t0 + u], g0);
          g1 = fmaf(q, sm.g[1][t0 + u], g1);
          z = fmaf(om1, z, w1 * (v + eps));
          yv[u] = z;
        }
        yo = make_float4(yv[0], yv[1], yv[2], yv[3]);
      }
      sm.y[buf][c][j] = yo;
      __syncthreads();
      if (pair && live) {
        float4 yc[C];
#pragma unroll
        for (int cc = 0; cc < C; ++cc) yc[cc] = sm.y[buf][cc][j];
        const float4 w4 = *reinterpret_cast<const float4*>(wv + off + t0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float wt = lane4(w4, u);
          const float r = sm.sy[t0 + u];
          const float wr = wt * r;
          Q = fmaf(wr, r, Q);
          float ya = sa[0] * lane4(yc[0], u), yb = sb[0] * lane4(yc[0], u);
#pragma unroll
          for (int cc = 1; cc < C; ++cc) {
            ya = fmaf(sa[cc], lane4(yc[cc], u), ya);
            yb = fmaf(sb[cc], lane4(yc[cc], u), yb);
          }
          S0 = fmaf(wt, ya * yb, S0);
          S1 = fmaf(wt, ya * ya, S1);
          S2 = fmaf(wt, yb * yb, S2);
          Ra = fmaf(wr, ya, Ra);
          Rb = fmaf(wr, yb, Rb);
        }
      }
      buf ^= 1;  // the next step writes the other buffer: one barrier a step
    }
    if (live) {
      sm.e[c][j] = z;
      sm.gin[c][0][j] = g0;
      sm.gin[c][1][j] = g1;
    }
    __syncthreads();
    // the chunk's blocks in order: the states entering each block
    if (j == 0) {
      for (int i = 0; i < nb; ++i) {
        sm.zin[c][i] = zl;
        zl = fmaf(a128, zl, sm.e[c][i]);
        const float n0 = fmaf(at10, s1, at00 * s0) + sm.gin[c][0][i];
        const float n1 = fmaf(at11, s1, at01 * s0) + sm.gin[c][1][i];
        s0 = n0;
        s1 = n1;
      }
    }
    __syncthreads();
    if (pair && live) {
      float A = sa[0] * sm.zin[0][j], Bv = sb[0] * sm.zin[0][j];
#pragma unroll
      for (int cc = 1; cc < C; ++cc) {
        A = fmaf(sa[cc], sm.zin[cc][j], A);
        Bv = fmaf(sb[cc], sm.zin[cc][j], Bv);
      }
      tot[0] += ((S0 + A * Rb) + Bv * Ra) + A * Bv * Q;
      tot[1] += (S1 + 2.f * A * Ra) + A * A * Q;
      tot[2] += (S2 + 2.f * Bv * Rb) + Bv * Bv * Q;
    }
    // the next chunk's first writes of e, gin and zin come after its own
    // barriers, so no barrier is needed here
  }

  // fixed-order reductions over the lanes
  if (pair) {
#pragma unroll
    for (int k = 0; k < 3; ++k) sm.red[3 * c + k][j] = tot[k];
  }
  sm.pk[c][j] = pk;
  __syncthreads();
  if (tid < 3 * P) {
    float s = 0.f;
    for (int i = 0; i < kLanes; ++i) s += sm.red[tid][i];
    pacc_out[(size_t)b * 3 * P + tid] = s;
  }
  if (j == 0) {
    float m = 0.f;
    for (int i = 0; i < kLanes; ++i) m = fmaxf(m, sm.pk[c][i]);
    const size_t o = (size_t)b * C + c;
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
  surround_wide_kernel<C, P><<<B, C * kLanes, 0, stream>>>(
      x, km_z, zl, sel_a, sel_b, wv, km_at, km_g, lp_at, lp_sy, w1, om1, eps, T, kmz, zlo,
      pk, pacc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// The arguments of surround_fused_launch (surround_fused.cu), which the
// wrapper checks: device pointers x [B, C, T], km_z [B, C, 2], zl [B, C, 1],
// sel_a, sel_b [P, C], wv [T], the K-meter block operator's at [2, 2] and
// g [128, 2], the lowpass operator's at [1, 1] and sy [1, 128]; outputs
// kmz [B, C, 2], zlo [B, C, 1], pk [B, C], pacc [B, P, 3].  C is 3..8 with
// P = 4 pairs (3 when C == 3); x and wv are 16-byte aligned.
int surround_wide_launch(const float* x, const float* km_z, const float* zl,
                         const float* sel_a, const float* sel_b, const float* wv,
                         const float* km_at, const float* km_g, const float* lp_at,
                         const float* lp_sy, float w1, float om1, float eps, int B, int C,
                         int T, float* kmz, float* zlo, float* pk, float* pacc,
                         void* stream) {
  if (B <= 0 || T < kBlk || T % kBlk != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SURROUND_WIDE_CASE(NC, NP)                                                          \
  case NC:                                                                                 \
    return launch<NC, NP>(x, km_z, zl, sel_a, sel_b, wv, km_at, km_g, lp_at, lp_sy, w1,   \
                          om1, eps, B, T, kmz, zlo, pk, pacc, s);
  switch (C) {
    SURROUND_WIDE_CASE(3, 3)
    SURROUND_WIDE_CASE(4, 4)
    SURROUND_WIDE_CASE(5, 4)
    SURROUND_WIDE_CASE(6, 4)
    SURROUND_WIDE_CASE(7, 4)
    SURROUND_WIDE_CASE(8, 4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SURROUND_WIDE_CASE
}

}  // extern "C"
