// dBTP hot path for NVIDIA Hopper (sm_90a): 4x polyphase oversampling
// fused with the PPM-style ballistics on |up|, with the raw peak tracked.
//
// Replaces meters_lv2_tpu/ops/pallas_truepeak.py::truepeak_pallas (the
// Pallas TPU kernel).  For each row n of x [N, T] (row stride ld), T % 128
// == 0, with the carried 47-sample history hist [N, 47]:
//   up[4t + ph] = sum_i taps[ph, i] * [hist ++ x][t + i]   (upsample4.cuh)
//   then per group of the four phases of one input sample, on |up|:
//     z1 *= w3, z2 *= w3; per oversample u:
//       z1 = u > z1 ? z1 + w1*(u - z1) : z1   (z2 likewise, w2)
//       p  = u > p  ? u : p
//     m = max(m, z1 + z2), NaN-propagating like torch.maximum;
//   hist' = the last 47 samples of [hist ++ x].
// The 4T oversampled stream never leaves shared memory.
//
// Arithmetic follows the plain PyTorch version (ops/truepeak_fused.py::
// truepeak_fused_reference: resample.upsample4, abs, then the ballistics
// loop).  The FIR is fp32 FMA in r128_fused.cu's order; the plain version
// sums the same products as a block matmul, so oversamples agree to a few
// ulp and z1, z2, m, p inherit that.  The ballistics chain is the bit-exact
// group step of ballistics_step.cuh, shared with ballistics.cu, so the
// chain adds no difference of its own.  The plain version's
// non-finite rule (a NaN or Inf input makes every oversample of its
// 128-sample block's 175-sample frame that it does not feed NaN, and the
// ballistics skip NaN) is applied on the same block boundaries, counted
// from the call's first sample: hence T % 128 == 0.
//
// What bounds it: each row is a serial chain of 4T dependent ballistics
// steps (192,000 per second of 48 kHz audio, four dependent fp32
// operations each), against 192 FMA of FIR per input sample that the
// lanes of a warp share (about 0.07 ms of fp32 peak for the whole
// main-path shape).  The chain's latency is the time.
//
// What the design does about it: the TPU kernel carried state and a
// 64-sample halo across in-order grid steps; here one warp owns one row
// and walks its 128-sample blocks in order.  Per block the 32 lanes move
// the block (loaded coalesced into registers one block ahead, so the load
// overlaps the previous block's chain) into a shared window behind the
// 47-sample halo,
// find the frame's non-finite span with two warp reductions, compute the
// |FIR| of 4 input samples each (16 oversamples) into a shared buffer, and
// then lane 0 runs the 512-step chain from there with the state in
// registers.  Four warps (rows) per CTA; 512 rows at the main-path shape
// give 128 CTAs, about one per SM.  Overlapping the FIR of the next block
// with the chain (warp specialisation, a double buffer) is later work.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "ballistics_step.cuh"
#include "upsample4.cuh"

namespace {

using upsample4::kNh;
using upsample4::kPhases;
using upsample4::kTaps;
constexpr int kBlk = 128;           // input samples per block (NaN frame)
constexpr int kWarps = 4;           // rows per CTA, one warp each
constexpr int kOff = 48;            // block offset in the window buffer
constexpr int kBuf = kOff + kBlk;   // [pad, halo(47), block(128)]

__global__ void __launch_bounds__(kWarps * 32)
truepeak_fused_kernel(const float* __restrict__ x, int ld,
                      const float* __restrict__ hist0,
                      const float* __restrict__ z1in,
                      const float* __restrict__ z2in,
                      const float* __restrict__ m_in,
                      const float* __restrict__ pin,
                      const float* __restrict__ taps, int N, int T, float w1,
                      float w2, float w3, float* __restrict__ z1out,
                      float* __restrict__ z2out, float* __restrict__ mout,
                      float* __restrict__ pout, float* __restrict__ hist_out) {
  __shared__ float s_taps[kPhases * kTaps];
  __shared__ float s_win[kWarps][kBuf];
  __shared__ __align__(16) float s_up[kWarps][kPhases * kBlk];

  for (int k = threadIdx.x; k < kPhases * kTaps; k += kWarps * 32)
    s_taps[k] = taps[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * kWarps + warp;
  if (row >= (size_t)N) return;  // no CTA-wide barrier follows

  float* win = s_win[warp];
  float4* up4 = reinterpret_cast<float4*>(s_up[warp]);
  const float* xr = x + row * (size_t)ld;

  for (int i = lane; i < kNh; i += 32) win[1 + i] = hist0[row * kNh + i];
  if (lane == 0) win[0] = 0.f;  // pad, never read

  float z1 = 0.f, z2 = 0.f, m = 0.f, p = 0.f;
  if (lane == 0) {
    z1 = z1in[row];
    z2 = z2in[row];
    m = m_in[row];
    p = pin[row];
  }

  const int nblk = T / kBlk;
  float nxt[kBlk / 32];  // the next block's samples, loaded ahead
#pragma unroll
  for (int k = 0; k < kBlk / 32; ++k) nxt[k] = xr[lane + 32 * k];
  for (int blk = 0; blk < nblk; ++blk) {
    // the block behind the halo; frame positions (1 .. 175) of the
    // frame's non-finite inputs
    int lo = INT_MAX, hi = -1;
#pragma unroll
    for (int k = 0; k < kBlk / 32; ++k) {
      const int j = lane + 32 * k;
      const float v = nxt[k];
      win[kOff + j] = v;
      if (!isfinite(v)) {
        lo = min(lo, kOff + j);
        hi = max(hi, kOff + j);
      }
    }
    // issue the next block's loads now: they land while the chain runs
    if (blk + 1 < nblk) {
#pragma unroll
      for (int k = 0; k < kBlk / 32; ++k)
        nxt[k] = xr[(size_t)(blk + 1) * kBlk + lane + 32 * k];
    }
    __syncwarp();
    for (int i = lane; i < kNh; i += 32) {
      if (!isfinite(win[1 + i])) {
        lo = min(lo, 1 + i);
        hi = max(hi, 1 + i);
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);

    // |4x oversamples| of input samples lane, lane + 32, ... of the block
#pragma unroll
    for (int k = 0; k < kBlk / 32; ++k) {
      const int j = lane + 32 * k;
      float u0, u1, u2, u3;
      upsample4::fir(s_taps, win + 1 + j, u0, u1, u2, u3);
      float4 a;
      if (upsample4::frame_ok(lo, hi, 1 + j)) {
        a = make_float4(fabsf(u0), fabsf(u1), fabsf(u2), fabsf(u3));
      } else {
        const float nan = __int_as_float(0x7fc00000);
        a = make_float4(nan, nan, nan, nan);
      }
      up4[j] = a;
    }
    __syncwarp();

    if (lane == 0) {
#pragma unroll 4
      for (int j = 0; j < kBlk; ++j)
        ballistics::group_step<true>(up4[j], w1, w2, w3, z1, z2, m, p);
    }
    __syncwarp();
    // the block's last 47 samples become the next block's halo
    for (int i = lane; i < kNh; i += 32) win[1 + i] = win[kOff + kBlk - kNh + i];
    __syncwarp();
  }

  for (int i = lane; i < kNh; i += 32) hist_out[row * kNh + i] = win[1 + i];
  if (lane == 0) {
    z1out[row] = z1;
    z2out[row] = z2;
    mout[row] = m;
    pout[row] = p;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// x [N, T] with row stride ld (elements), T % 128 == 0; hist, hist_out
// [N, 47]; taps [4, 48]; states [N]; every pointer is a device pointer.
int truepeak_fused_launch(const float* x, int ld, const float* hist,
                          const float* z1, const float* z2, const float* m,
                          const float* p, const float* taps, int N, int T,
                          float w1, float w2, float w3, float* z1out,
                          float* z2out, float* mout, float* pout,
                          float* hist_out, void* stream) {
  if (N <= 0 || T < kBlk || T % kBlk != 0 || ld < T)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (N + kWarps - 1) / kWarps;
  truepeak_fused_kernel<<<grid, kWarps * 32, 0, st>>>(
      x, ld, hist, z1, z2, m, p, taps, N, T, w1, w2, w3, z1out, z2out, mout,
      pout, hist_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
