// The spectrum function as a direct recurrence, for tools/spectrum_probe.py:
// one warp per stream, lane n runs band n (30 of 32 lanes) sample by sample
// through its six 2x2 modal sections (ops/design.py
// cascade_modal_state_space: section i takes the previous section's output
// as its input; 9 MACs a section), squares, smooths and tracks the peak.
// IEEE fp32 FMAs; no non-finite bookkeeping (the probe feeds finite noise).
// Not part of the package: it measures the alternative to the blocked body.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kNb = 30;
constexpr int kSec = 6;
constexpr int kCoef = 9;  // a00 a01 a10 a11 b0 b1 c0 c1 d

__global__ void __launch_bounds__(32)
spectrum_direct_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                       const float* __restrict__ v0, const float* __restrict__ omega,
                       const float* __restrict__ coef, int B, int T,
                       float* __restrict__ val, float* __restrict__ peak,
                       float* __restrict__ zf) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x;  // one warp a CTA: the streams spread over every SM
  const int band = lane < kNb ? lane : kNb - 1;
  float c[kSec][kCoef], s[kSec][2];
#pragma unroll
  for (int i = 0; i < kSec; ++i) {
#pragma unroll
    for (int k = 0; k < kCoef; ++k) c[i][k] = coef[(band * kSec + i) * kCoef + k];
    s[i][0] = z0[((size_t)b * kNb + band) * 2 * kSec + 2 * i];
    s[i][1] = z0[((size_t)b * kNb + band) * 2 * kSec + 2 * i + 1];
  }
  const float w = *omega;
  float v = v0[(size_t)b * kNb + band];
  float pk = -__int_as_float(0x7f800000);
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)b * T);
  for (int t4 = 0; t4 < T / 4; ++t4) {
    const float4 xv = xr[t4];
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float in = xs[u];
#pragma unroll
      for (int i = 0; i < kSec; ++i) {
        const float y = fmaf(c[i][8], in, fmaf(c[i][7], s[i][1], c[i][6] * s[i][0]));
        const float n0 = fmaf(c[i][4], in, fmaf(c[i][1], s[i][1], c[i][0] * s[i][0]));
        const float n1 = fmaf(c[i][5], in, fmaf(c[i][3], s[i][1], c[i][2] * s[i][0]));
        s[i][0] = n0;
        s[i][1] = n1;
        in = y;
      }
      v = fmaf(w, in * in - v, v);
      pk = fmaxf(pk, v);
    }
  }
  if (lane < kNb) {
    const size_t o = (size_t)b * kNb + band;
    val[o] = v;
    peak[o] = pk;
#pragma unroll
    for (int i = 0; i < kSec; ++i) {
      zf[o * 2 * kSec + 2 * i] = s[i][0];
      zf[o * 2 * kSec + 2 * i + 1] = s[i][1];
    }
  }
}

}  // namespace

extern "C" int spectrum_direct_launch(const float* x, const float* z0, const float* v0,
                                      const float* omega, const float* coef, int B, int T,
                                      float* val, float* peak, float* zf, void* stream) {
  if (B <= 0 || T % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  spectrum_direct_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, z0, v0, omega, coef, B, T, val, peak, zf);
  return static_cast<int>(cudaGetLastError());
}
