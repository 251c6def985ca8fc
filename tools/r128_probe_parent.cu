// The r128_fused body before its Hopper redesign, kept verbatim as the
// "parent" variant of tools/r128_probe.py; it is not part of the package.

// EBU R128 hot path for NVIDIA Hopper (sm_90a): K-weighted channel power
// and 4x-oversampled true-peak |max| in one pass over the input.
//
// Replaces meters_lv2_tpu/ops/pallas_r128.py::fused_core (the Pallas TPU
// kernel).  For each stream b it computes
//   p[b, t]    = sum_c gain_c * y_c[t]^2, y_c the K-weighting output of
//                channel c from the carried 4-dim state z0[b, c];
//   z[b, c]    = the K-weighting state after the block;
//   hist[b, c] = x[b, c, T-47 : T], the true-peak history;
//   tpmax[b]   = max over c, t, phase of |up4(x)|, NaN oversamples skipped.
// Seg mode (the TPU kernel's seg_info, pallas_r128.py:298-326), with off [B]
// int32, fragm > 128 and n_slots: instead of p, the per-fragment sums
//   seg[b, s]  = sum of p[b, t] over off[b] + t in [s*fragm, (s+1)*fragm),
// i.e. segment.shifted_segments(p, off, fragm, n_slots, "sum"); the
// full-rate p never leaves the SM.  z, hist and tpmax are computed by the
// same code as in full-rate mode, so they are bit-identical to it.
// x is channel-major: channel c of stream b starts at (b*C + c)*T, which is
// the memory of both the flat [B, C*T] and the [B, C, T] layout.
//
// Arithmetic follows the plain PyTorch version (ops/r128_fused.py::
// fused_core_reference) term for term, in IEEE fp32 FMA, never TF32:
//   * K-weighting, per 128-sample block: y = x_blk @ K + s @ Sy and
//     s' = s @ At + x_blk @ G, with the host-built block operator
//     (ops/lti.py).  The full 128-term Toeplitz row is summed, zeros of the
//     upper triangle included, so a non-finite input poisons the block
//     exactly as the matmul does.
//   * True peak: the direct 4-phase, 48-tap FIR
//     up[4t+ph] = sum_i taps[ph, i] * x[t-47+i] with the 47-sample halo.
//     The plain version multiplies a 175-sample frame by a block matrix
//     whose zeros turn a non-finite input anywhere in the frame into NaN
//     for every output it does not feed; the kernel applies the same rule
//     from the frame's first and last non-finite position.  Summation order
//     differs from the matmul, so results agree to a few ulp, not bit for
//     bit.
//
// What bounds it: about 128 + 192 FMA per input sample (Toeplitz row plus
// 4 x 48 FIR taps) against 4 bytes read and 4/C written, i.e. about 80 FMA
// per byte.  The H100's fp32 CUDA cores balance near 20 FLOP/byte against
// HBM, so the kernel is compute-bound, and within the SM it is bound by
// shared-memory loads feeding those FMAs.
//
// What the design does about it: the TPU kernel carried state across
// sequential grid steps; CUDA blocks run in no order, so the time loop
// lives inside the block.  One CTA of 128 threads owns one stream and walks
// its 128-sample blocks in order, channels inner; thread i produces output
// sample i of each block.  The 64 KB Toeplitz operator and the taps sit in
// shared memory for the whole stream; each input block is read from HBM
// once into a per-channel shared buffer that also keeps the halo; Sy, G and
// At live in registers; the channel power is summed in a register in fixed
// channel order (no atomics, reproducible); the 4-value state reduction is
// a warp shuffle tree plus a fixed-order sum over the four warps.  In seg
// mode each thread adds its samples' power to a register while the open
// fragment lasts; the block holding a fragment boundary (a 128-sample block
// holds at most one, fragm > 128) splits it at the boundary lane, each warp
// reduces the closing part with a shuffle tree and its lane 0 adds it to
// the warp's own slot sums in shared memory (no barrier: no other warp
// touches them).  The boundary is tracked by a countdown, with no division
// a block.  At the end the four warps' sums are added in a fixed order and
// written once (n_slots floats a stream instead of T): 1.70 ms at B = 256,
// C = 2, T = 48000, against 1.64 for full rate and 1.87 for full rate plus
// shifted_segments (H100 80GB HBM3, 700 W).  One CTA
// per stream leaves the card under-filled at small batch (256 CTAs on 132
// SMs at the main-path shape); wgmma/TMA and parallelism across time are
// later work.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "upsample4.cuh"

namespace {

using upsample4::kNh;                    // true-peak history, 2*24 - 1
using upsample4::kPhases;                // oversampling factor
using upsample4::kTaps;                  // FIR taps per phase
constexpr int kBlk = 128;                // samples per block == threads per CTA
constexpr int kMaxC = 5;                 // channels: R128 supports 1..5
constexpr int kOff = 48;                 // block offset in a channel buffer
constexpr int kBuf = kOff + kBlk;        // [pad, halo(47), block(128)]
constexpr int kWarps = kBlk / 32;

struct Gains {
  float g[kMaxC];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared memory: the Toeplitz operator kmat [128 x 128] (row j = input j,
// column i = output i), taps [4 x 48], then one kBuf buffer per channel:
// buf[1 .. 47] is the halo x[t-47 .. t-1], buf[48 .. 175] the current block.
// In seg mode kWarps x n_slots floats after the channel buffers hold each
// warp's slot sums.
template <int C, bool kSeg>
__global__ void __launch_bounds__(kBlk)
r128_fused_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                  const float* __restrict__ hist0,
                  const float* __restrict__ kmat, const float* __restrict__ sy,
                  const float* __restrict__ at, const float* __restrict__ g,
                  const float* __restrict__ taps, Gains gains, int T,
                  const int* __restrict__ off, int fragm, int n_slots,
                  float* __restrict__ p, float* __restrict__ zout,
                  float* __restrict__ hist_out, float* __restrict__ tpmax) {
  extern __shared__ __align__(16) float smem[];
  float* s_kmat = smem;
  float* s_taps = s_kmat + kBlk * kBlk;
  float* s_buf = s_taps + kPhases * kTaps;
  float* s_slot = s_buf + C * kBuf;  // seg mode only: [kWarps][n_slots]
  __shared__ float s_red[kWarps][4];
  __shared__ float s_max[kWarps];
  __shared__ int s_nf_lo, s_nf_hi;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t b = blockIdx.x;

  for (int k = tid; k < kBlk * kBlk; k += kBlk) s_kmat[k] = kmat[k];
  for (int k = tid; k < kPhases * kTaps; k += kBlk) s_taps[k] = taps[k];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (tid < kNh)
      s_buf[c * kBuf + 1 + tid] = hist0[(b * C + c) * kNh + tid];
    if (tid == 0) s_buf[c * kBuf] = 0.f;  // pad, never read
  }
  if (tid == 0) {
    s_nf_lo = INT_MAX;
    s_nf_hi = -1;
  }
  // seg mode: the open slot, its samples left from the block's start, and
  // this thread's power in it so far
  int lo = 0, rem = 0;
  float acc = 0.f;
  if (kSeg) {
    for (int k = tid; k < kWarps * n_slots; k += kBlk) s_slot[k] = 0.f;
    const int off_b = off[b];
    lo = off_b / fragm;
    rem = fragm - off_b % fragm;
  }

  // this thread's column of Sy and row of G; At (s' = s @ At) in full
  float sy_i[4], g_i[4], a[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sy_i[k] = sy[k * kBlk + tid];
    g_i[k] = g[tid * 4 + k];
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) a[k] = at[k];

  // carried K-weighting state, held by every thread
  float s[C][4];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k) s[c][k] = z0[(b * C + c) * 4 + k];

  float tp = 0.f;
  __syncthreads();

  const int nblk = T / kBlk;
  for (int blk = 0; blk < nblk; ++blk) {
    float pw = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float* buf = s_buf + c * kBuf;
      const float xv = x[(b * C + c) * (size_t)T + (size_t)blk * kBlk + tid];
      buf[kOff + tid] = xv;
      // frame positions (1 .. 175) of non-finite samples
      if (!isfinite(xv)) {
        atomicMin(&s_nf_lo, kOff + tid);
        atomicMax(&s_nf_hi, kOff + tid);
      }
      if (tid < kNh && !isfinite(buf[1 + tid])) {
        atomicMin(&s_nf_lo, 1 + tid);
        atomicMax(&s_nf_hi, 1 + tid);
      }
      __syncthreads();

      // K-weighting output sample tid: Toeplitz row + state term
      const float4* xb4 = reinterpret_cast<const float4*>(buf + kOff);
      float acc = 0.f;
#pragma unroll 4
      for (int j4 = 0; j4 < kBlk / 4; ++j4) {
        const float4 v = xb4[j4];
        const float* kc = s_kmat + (4 * j4) * kBlk + tid;
        acc = fmaf(v.x, kc[0], acc);
        acc = fmaf(v.y, kc[kBlk], acc);
        acc = fmaf(v.z, kc[2 * kBlk], acc);
        acc = fmaf(v.w, kc[3 * kBlk], acc);
      }
      float st = s[c][0] * sy_i[0];
      st = fmaf(s[c][1], sy_i[1], st);
      st = fmaf(s[c][2], sy_i[2], st);
      st = fmaf(s[c][3], sy_i[3], st);
      const float y = acc + st;
      pw += (y * y) * gains.g[c];

      // true peak: 4 phases of the 48-tap FIR over buf[1 + tid .. 48 + tid]
      float u0, u1, u2, u3;
      upsample4::fir(s_taps, buf + 1 + tid, u0, u1, u2, u3);
      if (upsample4::frame_ok(s_nf_lo, s_nf_hi, 1 + tid)) {
        // fmaxf returns the other operand for NaN: NaN oversamples skip
        tp = fmaxf(tp, fabsf(u0));
        tp = fmaxf(tp, fabsf(u1));
        tp = fmaxf(tp, fabsf(u2));
        tp = fmaxf(tp, fabsf(u3));
      }

      // state: s' = s @ At + x_blk @ G
      float r0 = warp_sum(xv * g_i[0]);
      float r1 = warp_sum(xv * g_i[1]);
      float r2 = warp_sum(xv * g_i[2]);
      float r3 = warp_sum(xv * g_i[3]);
      if (lane == 0) {
        s_red[warp][0] = r0;
        s_red[warp][1] = r1;
        s_red[warp][2] = r2;
        s_red[warp][3] = r3;
      }
      __syncthreads();
      float sn[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float gin = s_red[0][k];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) gin += s_red[w][k];
        float v = s[c][0] * a[k];
        v = fmaf(s[c][1], a[4 + k], v);
        v = fmaf(s[c][2], a[8 + k], v);
        v = fmaf(s[c][3], a[12 + k], v);
        sn[k] = v + gin;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) s[c][k] = sn[k];
      // the block's last 47 samples become the next block's halo
      if (tid < kNh) buf[1 + tid] = buf[kOff + kBlk - kNh + tid];
      if (tid == 0) {
        s_nf_lo = INT_MAX;
        s_nf_hi = -1;
      }
      __syncthreads();
    }
    if (kSeg) {
      if (rem > kBlk) {
        acc += pw;  // the whole block lies in slot lo
      } else {      // slot lo closes after lane rem - 1 (uniform over the CTA)
        const bool head = tid < rem;
        const float part = warp_sum(head ? acc + pw : acc);
        if (lane == 0 && lo < n_slots) s_slot[warp * n_slots + lo] += part;
        acc = head ? 0.f : pw;
        ++lo;
        rem += fragm;
      }
      rem -= kBlk;
    } else {
      p[b * T + (size_t)blk * kBlk + tid] = pw;
    }
  }

#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) zout[(b * C + c) * 4 + k] = s[c][k];
    }
    if (tid < kNh) hist_out[(b * C + c) * kNh + tid] = s_buf[c * kBuf + 1 + tid];
  }
  if (kSeg) {  // the open slot's part
    const float part = warp_sum(acc);
    if (lane == 0 && lo < n_slots) s_slot[warp * n_slots + lo] += part;
  }
  const float m = warp_max(tp);
  if (lane == 0) s_max[warp] = m;
  __syncthreads();
  if (tid == 0) {
    float v = s_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = fmaxf(v, s_max[w]);
    tpmax[b] = v;
  }
  if (kSeg) {  // every warp's last slot sums were added before the barrier
    for (int k = tid; k < n_slots; k += kBlk) {
      float v = s_slot[k];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += s_slot[w * n_slots + k];
      p[b * (size_t)n_slots + k] = v;
    }
  }
}

template <int C, bool kSeg>
int launch_mode(const float* x, const float* z0, const float* hist,
                const float* kmat, const float* sy, const float* at,
                const float* g, const float* taps, const Gains& gains, int B,
                int T, const int* off, int fragm, int n_slots, float* p,
                float* z, float* hist_out, float* tpmax, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBlk * kBlk + kPhases * kTaps + C * kBuf +
                                       (kSeg ? kWarps * n_slots : 0));
  cudaError_t e = cudaFuncSetAttribute(
      r128_fused_kernel<C, kSeg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  r128_fused_kernel<C, kSeg><<<B, kBlk, smem, stream>>>(
      x, z0, hist, kmat, sy, at, g, taps, gains, T, off, fragm, n_slots, p, z,
      hist_out, tpmax);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch(const float* x, const float* z0, const float* hist,
           const float* kmat, const float* sy, const float* at,
           const float* g, const float* taps, const Gains& gains, int B,
           int T, const int* off, int fragm, int n_slots, float* p, float* z,
           float* hist_out, float* tpmax, cudaStream_t stream) {
  if (off)
    return launch_mode<C, true>(x, z0, hist, kmat, sy, at, g, taps, gains, B, T,
                                off, fragm, n_slots, p, z, hist_out, tpmax,
                                stream);
  return launch_mode<C, false>(x, z0, hist, kmat, sy, at, g, taps, gains, B, T,
                               off, fragm, n_slots, p, z, hist_out, tpmax,
                               stream);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// Pointers are device pointers except `gains` (host, C floats).  With `off`
// (int32 [B]) non-null the kernel runs in seg mode and p is seg
// [B, n_slots]; fragm > 128, n_slots >= 2 and n_slots * fragm >= T + fragm
// - 1 (the wrapper checks them).
int r128_fused_launch(const float* x, const float* z0, const float* hist,
                      const float* kmat, const float* sy, const float* at,
                      const float* g, const float* taps, const float* gains,
                      int B, int C, int T, const int* off, int fragm,
                      int n_slots, float* p, float* z, float* hist_out,
                      float* tpmax, void* stream) {
  if (B <= 0 || C < 1 || C > kMaxC || T < kBlk || T % kBlk != 0 ||
      (off && (fragm <= kBlk || n_slots < 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  Gains gg{};
  for (int c = 0; c < C; ++c) gg.g[c] = gains[c];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
#define R128_CASE(N)                                                      \
  case N:                                                                 \
    return launch<N>(x, z0, hist, kmat, sy, at, g, taps, gg, B, T, off,   \
                     fragm, n_slots, p, z, hist_out, tpmax, st);
    R128_CASE(1)
    R128_CASE(2)
    R128_CASE(3)
    R128_CASE(4)
    R128_CASE(5)
#undef R128_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* meters_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
