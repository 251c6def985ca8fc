// The spectrum_fused body before its Hopper redesign, kept verbatim as the
// "parent" variant of tools/spectrum_probe.py and chip_smoke.py's yardstick;
// it is not part of the package.

// 30-band 1/3-octave spectrum hot path for NVIDIA Hopper (sm_90a): band
// filters, square, display smoother and peak of the smoothed series in one
// pass over the (downmixed) input.
//
// Replaces meters_lv2_tpu/ops/pallas_spectrum.py::fused_core (the Pallas TPU
// kernel).  For each stream b and band n it computes, from x[b, 0:T]:
//   y      = the band's IEC 61260 band-pass output, a 12-state banked LTI
//            (six 2x2 modal sections, src/spectr.c:68-87) run as blocked
//            recurrences of 128 samples: y_blk = x_blk @ K + s @ Sy,
//            s' = s @ At + x_blk @ G, with the host-built block operator
//            (ops/lti.py BankedLTISystem.op(128));
//   v_i    = the display one-pole on y^2, sample by sample,
//            v_i = v_{i-1} + w (y_i^2 - v_{i-1}) with w read on the card
//            (the runtime speed port, spectrumlv2.c:161-177, 210-224);
//   val    = v after the block, peak = max of v over the block,
//   zf     = the filter state after the block.
//
// Arithmetic: IEEE fp32 FMAs, never TF32 or tensor cores.  The plain
// PyTorch version (ops/spectrum_fused.py::fused_core_reference) follows the
// JAX meter's unfused path, where the smoother is a blocked Toeplitz product;
// here it is the sequential recurrence, so the two agree to a stated
// tolerance.  Non-finite values follow the plain version's dense products
// exactly:
//   * K is lower triangular; the upper-triangle zeros are skipped, so
//     y[i] = NaN is set explicitly where a non-finite x[j], j > i, would
//     have met a structural zero (i below the block's last non-finite x);
//   * Sy, At and G are applied densely (Inf * 0 = NaN as in the matmuls);
//   * the smoother's chain, v + w (q - v), turns an infinity into NaN
//     (Inf - Inf), so NaN / +Inf / -Inf entering it are flagged off the
//     chain, and val and peak are rebuilt from the flags as the plain
//     version's positive-coefficient sums give them; the peak is also NaN
//     when a block has a non-finite y^2 after its first sample (the
//     Toeplitz smoother's zeros make an earlier output of that block NaN).
//
// What bounds it: the function itself is six biquads a band-sample (30
// MACs) plus square, smoother and max, about 65 fp32 operations against 4
// bytes of x shared by 30 bands, so it is bound by operations.  The blocked
// form computed here spends about 181 a band-sample (64.5 MACs of the
// triangular K, 12 of Sy, 12 of G, and the smoother), 2.8x the function's
// own count, and within the SM it is bound by the shared-memory loads that
// feed the FMAs.
//
// What the design does about it: CUDA blocks run in no order, so the time
// loop lives inside the CTA.  One CTA owns one band and kS = 8 streams and
// walks their 128-sample blocks in order.  Four warps compute the outputs:
// thread i holds y[i] of all 8 streams, reads K[j][i] once per j for 8
// FMAs, and x[j][0..7] as two broadcast float4 loads.  Warp w's outputs
// 32w..32w+31 need rows j <= 32w+31 only, so K is stored packed by warp
// (40 KB instead of 64 KB) and each warp's loop bound is uniform.  G's
// product is split by the same warp tiles (12 lanes of each warp sum over
// the warp's 32 diagonal rows, without a divergent branch in the loop) and
// reduced in fixed order, so the state update is reproducible.  A fifth warp runs the sequential smoother of the
// previous block (8 lanes, one per stream) while the four warps compute the
// next one, so the smoother's latency chain (two dependent operations a
// sample, its non-finite bookkeeping kept off the chain) overlaps the
// products.  The next block's x is loaded into registers before the
// products start.  One CTA per (band, 8 streams) gives 960 CTAs at
// B = 256, three per SM; register tiling of the products (fewer shared-
// memory loads per FMA), wgmma and a parallel smoother are later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlk = 128;                 // samples per block
constexpr int kD = 12;                    // band state
constexpr int kNb = 30;                   // bands
constexpr int kS = 8;                     // streams per CTA
constexpr int kConvWarps = kBlk / 32;     // warps computing y
constexpr int kThreads = 32 * (kConvWarps + 1);  // + the smoother warp
constexpr int kKp = 32 * 32 * (1 + 2 + 3 + 4);   // packed K floats
constexpr int kSqStride = kBlk + 1;       // conflict-free smoother reads

// packed K: warp w's columns 32w..32w+31, rows 0..32w+31, row-major
__host__ __device__ constexpr int kp_base(int w) { return 1024 * (w * (w + 1) / 2); }

constexpr int kSmemFloats = kKp + kBlk * kD + kD * kD + kBlk * kS +
                            2 * kS * kSqStride + 2 * kS * kD +
                            kConvWarps * kS * kD;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats + sizeof(int) * 2 * kS;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// The smoother's record of non-finite values, kept off its dependency chain.
struct Smooth {
  float v;     // smoothed value
  float pk;    // max of v while it stays finite
  bool nan;    // a NaN entered (q, v at the start, or w)
  bool pos;    // +Inf entered
  bool neg;    // -Inf entered (only a non-finite v at the start can)
  bool late;   // a non-finite q after the first sample of its block
};

__device__ __forceinline__ void smooth_note(Smooth& sm, float u, bool late) {
  sm.nan |= u != u;
  sm.pos |= u == __int_as_float(0x7f800000);
  sm.neg |= u == -__int_as_float(0x7f800000);
  sm.late |= late & !isfinite(u);
}

// One block of the display smoother for one stream, v_i = v + w (q_i - v):
// two dependent operations a sample.  Where a q or v is non-finite this
// form gives NaN (Inf - Inf); smooth_val / smooth_peak rebuild the plain
// version's results from the flags instead.
__device__ __forceinline__ void smooth_block(const float* __restrict__ q, float w,
                                             Smooth& sm) {
  float v = sm.v, pk = sm.pk;
  for (int i0 = 0; i0 < kBlk; i0 += 8) {
    float qq[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) qq[u] = q[i0 + u];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      v = fmaf(w, qq[u] - v, v);
      pk = fmaxf(pk, v);  // drops NaN: the flags decide those cases
      smooth_note(sm, qq[u], i0 + u > 0);
    }
  }
  sm.v = v;
  sm.pk = pk;
}

// val as the plain version's products give it: NaN if a NaN entered (or
// both infinities), else the infinity that entered, else v.
__device__ __forceinline__ float smooth_val(const Smooth& sm) {
  const float inf = __int_as_float(0x7f800000);
  if (isfinite(sm.v)) return sm.v;
  if (sm.nan || (sm.pos && sm.neg)) return nan_f();
  return sm.neg ? -inf : inf;
}

// The block peak likewise; the Toeplitz smoother's zeros also make it NaN
// when a block holds a non-finite q after its first sample.
__device__ __forceinline__ float smooth_peak(const Smooth& sm) {
  if (sm.late || sm.nan || (sm.pos && sm.neg)) return nan_f();
  return sm.pos ? __int_as_float(0x7f800000) : sm.pk;
}

// Sample i of block blk of the kS streams b0.. into registers (0 past B).
__device__ __forceinline__ void load_x(float (&xn)[kS], const float* __restrict__ x,
                                       int b0, int B, int T, int blk, int i) {
#pragma unroll
  for (int s = 0; s < kS; ++s)
    xn[s] = b0 + s < B ? x[(size_t)(b0 + s) * T + (size_t)blk * kBlk + i] : 0.f;
}

// Stores them as row i of s_x [128][kS]; nf[s] becomes the last position
// of a non-finite sample of stream s in the block.
__device__ __forceinline__ void store_x(const float (&xn)[kS], float* s_x, int* nf, int i) {
  float4* dst = reinterpret_cast<float4*>(s_x + i * kS);
  dst[0] = make_float4(xn[0], xn[1], xn[2], xn[3]);
  dst[1] = make_float4(xn[4], xn[5], xn[6], xn[7]);
#pragma unroll
  for (int s = 0; s < kS; ++s)
    if (!isfinite(xn[s])) atomicMax(&nf[s], i);
}

__global__ void __launch_bounds__(kThreads, 3)
spectrum_fused_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                      const float* __restrict__ v0,
                      const float* __restrict__ omega,
                      const float* __restrict__ kmat,
                      const float* __restrict__ sy,
                      const float* __restrict__ at,
                      const float* __restrict__ g, int B, int T,
                      float* __restrict__ val, float* __restrict__ peak,
                      float* __restrict__ zf) {
  extern __shared__ __align__(16) float smem[];
  float* s_kp = smem;                          // [kKp]
  float* s_g = s_kp + kKp;                     // [128][12]
  float* s_at = s_g + kBlk * kD;               // [12][12]
  float* s_x = s_at + kD * kD;                 // [128][kS]: x[j][stream]
  float* s_sq = s_x + kBlk * kS;               // [2][kS][kSqStride]
  float* s_st = s_sq + 2 * kS * kSqStride;     // [2][kS][12]
  float* s_gp = s_st + 2 * kS * kD;            // [warp][kS][12] partial x@G
  int* s_nf = reinterpret_cast<int*>(s_gp + kConvWarps * kS * kD);  // [2][kS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int band = blockIdx.y;
  const int b0 = blockIdx.x * kS;
  const bool conv = warp < kConvWarps;

  // stage the band's operator
  const float* kb = kmat + (size_t)band * kBlk * kBlk;
  for (int p = tid; p < kKp; p += kThreads) {
    const int w = p < kp_base(1) ? 0 : p < kp_base(2) ? 1 : p < kp_base(3) ? 2 : 3;
    const int r = p - kp_base(w);
    s_kp[p] = kb[(r >> 5) * kBlk + 32 * w + (r & 31)];
  }
  for (int p = tid; p < kBlk * kD; p += kThreads) s_g[p] = g[(size_t)band * kBlk * kD + p];
  for (int p = tid; p < kD * kD; p += kThreads) s_at[p] = at[(size_t)band * kD * kD + p];
  for (int p = tid; p < kS * kD; p += kThreads) {
    const int b = b0 + p / kD;
    s_st[p] = b < B ? z0[((size_t)b * kNb + band) * kD + p % kD] : 0.f;
  }
  if (tid < 2 * kS) s_nf[tid] = -1;
  float sy_i[kD];
  if (conv) {
#pragma unroll
    for (int k = 0; k < kD; ++k) sy_i[k] = sy[((size_t)band * kD + k) * kBlk + tid];
  }
  const float w_sm = *omega;
  // The plain version builds its smoother from log1p(-w): a NaN w (set_speed
  // lets NaN through) or w >= 1 makes every val and peak NaN there.
  Smooth sm{0.f, -__int_as_float(0x7f800000), !(w_sm < 1.f), false, false, false};
  if (!conv && lane < kS && b0 + lane < B) {
    sm.v = v0[(size_t)(b0 + lane) * kNb + band];
    smooth_note(sm, sm.v, false);
  }

  float xn[kS];  // the next block of x, sample tid of each stream
  if (conv) load_x(xn, x, b0, B, T, 0, tid);
  __syncthreads();
  if (conv) store_x(xn, s_x, s_nf, tid);
  __syncthreads();

  const int nblk = T / kBlk;
  const float4* x4 = reinterpret_cast<const float4*>(s_x);
  for (int blk = 0; blk < nblk; ++blk) {
    const int cur = blk & 1;
    const float* st = s_st + cur * kS * kD;
    if (conv) {
      if (blk + 1 < nblk) load_x(xn, x, b0, B, T, blk + 1, tid);
      // y[i] for the 8 streams: the triangular K over rows 0..32w+31
      const float* kc = s_kp + kp_base(warp) + lane;
      float acc[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) acc[s] = 0.f;
      const int jd = 32 * warp;
#pragma unroll 4
      for (int j = 0; j < jd; ++j) {
        const float kv = kc[j * 32];
        const float4 lo = x4[2 * j], hi = x4[2 * j + 1];
        acc[0] = fmaf(lo.x, kv, acc[0]);
        acc[1] = fmaf(lo.y, kv, acc[1]);
        acc[2] = fmaf(lo.z, kv, acc[2]);
        acc[3] = fmaf(lo.w, kv, acc[3]);
        acc[4] = fmaf(hi.x, kv, acc[4]);
        acc[5] = fmaf(hi.y, kv, acc[5]);
        acc[6] = fmaf(hi.z, kv, acc[6]);
        acc[7] = fmaf(hi.w, kv, acc[7]);
      }
      // the warp's diagonal rows: K (zeros above the diagonal included)
      // and this warp's share of x @ G, column `lane` on lanes 0..11 (the
      // other lanes repeat column 0 and drop it: a branch here costs more)
      float gpv[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) gpv[s] = 0.f;
#pragma unroll 4
      for (int j = jd; j < jd + 32; ++j) {
        const float kv = kc[j * 32];
        const float4 lo = x4[2 * j], hi = x4[2 * j + 1];
        acc[0] = fmaf(lo.x, kv, acc[0]);
        acc[1] = fmaf(lo.y, kv, acc[1]);
        acc[2] = fmaf(lo.z, kv, acc[2]);
        acc[3] = fmaf(lo.w, kv, acc[3]);
        acc[4] = fmaf(hi.x, kv, acc[4]);
        acc[5] = fmaf(hi.y, kv, acc[5]);
        acc[6] = fmaf(hi.z, kv, acc[6]);
        acc[7] = fmaf(hi.w, kv, acc[7]);
        const float gk = s_g[j * kD + (lane < kD ? lane : 0)];
        gpv[0] = fmaf(lo.x, gk, gpv[0]);
        gpv[1] = fmaf(lo.y, gk, gpv[1]);
        gpv[2] = fmaf(lo.z, gk, gpv[2]);
        gpv[3] = fmaf(lo.w, gk, gpv[3]);
        gpv[4] = fmaf(hi.x, gk, gpv[4]);
        gpv[5] = fmaf(hi.y, gk, gpv[5]);
        gpv[6] = fmaf(hi.z, gk, gpv[6]);
        gpv[7] = fmaf(hi.w, gk, gpv[7]);
      }
      if (lane < kD) {
#pragma unroll
        for (int s = 0; s < kS; ++s) s_gp[(warp * kS + s) * kD + lane] = gpv[s];
      }
      // + s @ Sy (dense), square; NaN where a later non-finite x of the
      // block meets K's zeros in the plain version's dense product
      const int* nf = s_nf + cur * kS;
      float* sq = s_sq + cur * kS * kSqStride;
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const float4* s4 = reinterpret_cast<const float4*>(st + s * kD);
        const float4 c0 = s4[0], c1 = s4[1], c2 = s4[2];
        float t = c0.x * sy_i[0];
        t = fmaf(c0.y, sy_i[1], t);
        t = fmaf(c0.z, sy_i[2], t);
        t = fmaf(c0.w, sy_i[3], t);
        t = fmaf(c1.x, sy_i[4], t);
        t = fmaf(c1.y, sy_i[5], t);
        t = fmaf(c1.z, sy_i[6], t);
        t = fmaf(c1.w, sy_i[7], t);
        t = fmaf(c2.x, sy_i[8], t);
        t = fmaf(c2.y, sy_i[9], t);
        t = fmaf(c2.z, sy_i[10], t);
        t = fmaf(c2.w, sy_i[11], t);
        float y = acc[s] + t;
        if (tid < nf[s]) y = nan_f();
        sq[s * kSqStride + tid] = y * y;
      }
    } else {
      // the smoother warp: the previous block's smoothed series
      if (blk > 0 && lane < kS)
        smooth_block(s_sq + (cur ^ 1) * kS * kSqStride + lane * kSqStride, w_sm, sm);
      if (lane < kS) s_nf[(cur ^ 1) * kS + lane] = -1;  // for block blk + 1
    }
    __syncthreads();
    if (conv) {
      // state: s' = s @ At + x @ G (the four warp partials in fixed order)
      if (tid < kS * kD) {
        const int s = tid / kD, k = tid % kD;
        const float gin = ((s_gp[(0 * kS + s) * kD + k] + s_gp[(1 * kS + s) * kD + k]) +
                           s_gp[(2 * kS + s) * kD + k]) + s_gp[(3 * kS + s) * kD + k];
        const float* sr = st + s * kD;
        float u = sr[0] * s_at[k];
#pragma unroll
        for (int m = 1; m < kD; ++m) u = fmaf(sr[m], s_at[m * kD + k], u);
        const float sn = u + gin;
        s_st[(cur ^ 1) * kS * kD + tid] = sn;
        if (blk + 1 == nblk && b0 + s < B) zf[((size_t)(b0 + s) * kNb + band) * kD + k] = sn;
      }
      if (blk + 1 < nblk) store_x(xn, s_x, s_nf + (cur ^ 1) * kS, tid);
    }
    __syncthreads();
  }
  if (!conv && lane < kS) {
    smooth_block(s_sq + ((nblk - 1) & 1) * kS * kSqStride + lane * kSqStride, w_sm, sm);
    if (b0 + lane < B) {
      const size_t o = (size_t)(b0 + lane) * kNb + band;
      val[o] = smooth_val(sm);
      peak[o] = smooth_peak(sm);
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// All pointers are device pointers: x [B, T], z0 [B, 30, 12], v0 [B, 30],
// omega [] and the banked operator kmat [30, 128, 128], sy [30, 12, 128],
// at [30, 12, 12], g [30, 128, 12]; outputs val, peak [B, 30], zf [B, 30, 12].
int spectrum_fused_launch(const float* x, const float* z0, const float* v0,
                          const float* omega, const float* kmat,
                          const float* sy, const float* at, const float* g,
                          int B, int T, float* val, float* peak, float* zf,
                          void* stream) {
  if (B <= 0 || T < kBlk || T % kBlk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      spectrum_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((B + kS - 1) / kS, kNb);
  spectrum_fused_kernel<<<grid, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      x, z0, v0, omega, kmat, sy, at, g, B, T, val, peak, zf);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
