// Signal-distribution histogram update (SigDistHist) for NVIDIA Hopper
// (sm_90a): the bin cast, the 361-bin histogram and the block moments of
// one update in one read of the block.
//
// Replaces no Pallas kernel: the JAX package leaves SigDistMeter.update
// (meters_lv2_tpu/models/sigdist.py) to XLA, and the port ran it as about
// forty PyTorch operations (models/sigdist.py, SigDistMeter._plain_update
// over ops/hist.py), each a pass over the block.  For each row n of x
// [N, T] (row stride ld, unit stride in time) and the state's leaves of
// that row, as the plain version computes them (src/sigdistlv2.c:287-326):
//   run = integrating[n] && time[n] < 2^31 - 1 - T;
//   per sample, v = rint(180 + 150 x) with two roundings (the plain
//     version's DIST_ZERO + x * DIST_RANGE: __fmul_rn and __fadd_rn, since
//     a contracted FMA rounds once and moves samples across bin edges;
//     rintf rounds half to even, as torch.round), cast as
//     ops/hist.float_to_int32 casts: NaN to bin 0 (counted, and its NaN
//     flows into the sums, as in the JAX package), v >= 2^31 (+Inf) to
//     INT32_MAX, the rest clamped at -2^31 and truncated; ok = run and
//     0 <= bin < 361.  For v already integral that is: ok = run and (v is
//     NaN or 0 <= v <= 360), bin = v (0 for NaN);
//   hist' = hist + the ok samples' counts (int32, exact);
//   the block's (n_b, mean_b, m2_b) over the ok samples (0, 0, 0 if none),
//     merged into (n, mean, m2) by ops/hist.welford_merge's Chan formula in
//     its order of operations, each rounded alone;
//   total' = total + the ok samples' sum; time' = time + (run ? T : 0).
// The histogram, n and time are exact, and the merge rounds as the plain
// version's; the block's mean, m2 and sum are float32 sums in another
// order.  Against float64 sums of the programme mix the kernel's sum and
// mean lie within 1.2e-8 of sum |x| (the plain version's 3.2e-7) and its
// m2 within 5.5e-7 of sum x^2 (4.0e-7), measured on an H100 (PERF.md
// section 6); tests/test_torch_cuda.py holds the kernel's to 1e-6.
// The kernel writes every output element itself: the caller allocates them
// uninitialised, and `integrating` passes through unchanged.
//
// What bounds it: the block is read once, 4 bytes a sample, and the state
// (1.47 KB a row) is read and written once: at the mastering batch,
// channel 0 of [4096, 2, 48000], 786 MB in and 6 MB each way, 0.24 ms at
// 3.35 TB/s.  The work is about 20 instructions a sample (the cast, a
// shared-memory add, the sums), so the bytes set the bound while the
// loads stay in flight.
//
// What the design does about it (H100 CUDA-event timings, PERF.md section 6):
//   * rows are read coalesced, 16 bytes a lane, eight loads in flight a
//     lane, from the 16-byte boundary at or before the row's start; a
//     strided row (channel 0 of a stereo block) costs nothing more: the
//     caller passes its stride and makes no copy.  Eight loads took
//     0.317 ms where four took 0.333 and two 0.346; the loads alone take
//     0.275;
//   * the histogram is one 361-bin array of shared counters a CTA, one
//     shared add an ok sample.  Programme material sits near bin 180 (a
//     standard deviation of 1.5 bins at -40 dBFS RMS, one bin for
//     silence), so the lanes of a warp often add to the same counter; on
//     this card that costs little: silence, every sample in bin 180, took
//     0.324 ms against 0.318 at -8 dBFS RMS, and neither a histogram a
//     warp nor a register window of the middle bins that kept those adds
//     off shared memory was faster (the window, 0.437 against 0.313, cost
//     more in instructions than it saved).  Cutting the adds saves 0.03 ms;
//   * the block's moments: each lane takes its 32 samples of a round as a
//     group, their mean and M2 in two passes over the registers, and
//     merges the group into its own by Chan's formula; lanes and warps
//     merge by the same formula in a fixed order, so every launch
//     gives the same bits.  A one-pass shifted sum a lane was as fast but
//     cancelled where a loud part meets silence in a row (5e-6 of sum x^2
//     on the programme mix, against 5.5e-7 now and the plain version's
//     4.0e-7); the moments cost 0.03 ms;
//   * one CTA of 256 threads a row at every N (31 CTAs an SM of work at
//     N = 4,096).  Rows are not split over CTAs: at the live shell's 1 to 8
//     rows a split over a cluster saved 1.8 us of a 12.8 us launch at
//     T = 24,000, cost 3.4 us at T = 4,800, and SigDistMeter's update
//     takes 90-145 us of host time there either way (PERF.md section 6).
//     Nothing is zeroed before the launch and no global atomic is issued.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 8;                  // float4 loads a lane per round
constexpr int kRoundQ = kThreads * kSlots; // float4s a CTA round (8,192 samples)
static_assert(4 * kSlots <= 32, "a round's samples are bits of one word");
constexpr int kBins = 361;
constexpr unsigned kFull = 0xffffffffu;

// (count, mean, M2, sum) of a set of ok samples
struct Mom {
  int n;
  float mean, m2, sum;
};

// Chan's merge of two partial results (internal: any rounding order)
__device__ __forceinline__ Mom merge(const Mom& a, const Mom& b) {
  Mom r;
  r.n = a.n + b.n;
  r.sum = a.sum + b.sum;
  if (r.n == 0) {
    r.mean = 0.f;
    r.m2 = 0.f;
    return r;
  }
  const float f = __fdiv_rn(static_cast<float>(b.n), static_cast<float>(r.n));
  const float d = b.mean - a.mean;
  r.mean = fmaf(d, f, a.mean);
  r.m2 = a.m2 + b.m2 + d * d * static_cast<float>(a.n) * f;
  return r;
}

__device__ __forceinline__ Mom shfl_down(const Mom& m, int o) {
  return Mom{__shfl_down_sync(kFull, m.n, o), __shfl_down_sync(kFull, m.mean, o),
             __shfl_down_sync(kFull, m.m2, o), __shfl_down_sync(kFull, m.sum, o)};
}

// A lane's round: its 4 kSlots samples (in: those inside the row), each
// cast to its bin and counted, and their moments as a group, in two passes
// over the registers, merged into the lane's.
__device__ __forceinline__ void take_round(Mom& lane, const float (&xs)[4 * kSlots], unsigned in,
                                           int* hist) {
  unsigned okm = 0u;
  int ng = 0;
  float sg = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * kSlots; ++i) {
    const float v = rintf(__fadd_rn(180.f, __fmul_rn(xs[i], 150.f)));
    const bool in_range = v >= 0.f && v <= 360.f;
    const bool ok = ((in >> i) & 1u) && (in_range || v != v);
    if (ok) atomicAdd(hist + (in_range ? static_cast<int>(v) : 0), 1);
    okm |= static_cast<unsigned>(ok) << i;
    sg += ok ? xs[i] : 0.f;
    ng += ok;
  }
  if (ng == 0) return;
  const float mg = __fdiv_rn(sg, static_cast<float>(ng));
  float m2g = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * kSlots; ++i) {
    const float d = ((okm >> i) & 1u) ? xs[i] - mg : 0.f;
    m2g = fmaf(d, d, m2g);
  }
  lane = merge(lane, Mom{ng, mg, m2g, sg});
}

__global__ void __launch_bounds__(kThreads, 4)
sigdist_fused_kernel(const float* __restrict__ x, int ld, int T,
                     const int* __restrict__ hist_in, const int* __restrict__ n_in,
                     const float* __restrict__ mean_in, const float* __restrict__ m2_in,
                     const float* __restrict__ total_in, const int* __restrict__ time_in,
                     const unsigned char* __restrict__ integrating, int* __restrict__ hist_out,
                     int* __restrict__ n_out, float* __restrict__ mean_out,
                     float* __restrict__ m2_out, float* __restrict__ total_out,
                     int* __restrict__ time_out) {
  __shared__ int hist[kBins];
  __shared__ Mom part[kWarps];
  const unsigned tid = threadIdx.x;
  const unsigned lane = tid & 31u;
  const unsigned warp = tid >> 5;
  const size_t row = blockIdx.x;
  const bool run = integrating[row] != 0 && time_in[row] < INT_MAX - T;

  for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
  __syncthreads();

  Mom m{0, 0.f, 0.f, 0.f};
  if (run) {  // uniform over the CTA
    // the row in float4s from the 16-byte boundary at or before its start
    const float* xr = x + row * static_cast<size_t>(ld);
    const int h = static_cast<int>((reinterpret_cast<uintptr_t>(xr) >> 2) & 3u);
    const float4* x4 = reinterpret_cast<const float4*>(xr - h);
    const int nq = (T + h + 3) / 4;
    for (int base = 0; base < nq; base += kRoundQ) {
      const int q0 = base + static_cast<int>(tid);
      float xs[4 * kSlots];
      unsigned in = 0u;  // the samples inside the row
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int q = q0 + j * kThreads;
        const float4 v = q < nq ? __ldg(x4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
        xs[4 * j] = v.x;
        xs[4 * j + 1] = v.y;
        xs[4 * j + 2] = v.z;
        xs[4 * j + 3] = v.w;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 4 * q - h + e;
          in |= static_cast<unsigned>(q < nq && static_cast<unsigned>(t) < static_cast<unsigned>(T))
                << (4 * j + e);
        }
      }
      take_round(m, xs, in, hist);
    }
  }

  // the moments: lanes, then warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = merge(m, shfl_down(m, o));
  if (lane == 0) part[warp] = m;
  __syncthreads();  // the histogram and the warps' moments are in
  if (tid == 0) {
    Mom blk = part[0];
    for (int w = 1; w < kWarps; ++w) blk = merge(blk, part[w]);
    // the state's merge, as ops/hist.welford_merge rounds it
    const int na = n_in[row];
    const float ma = mean_in[row];
    const float naf = static_cast<float>(na), nbf = static_cast<float>(blk.n);
    const float nsafe = fmaxf(__fadd_rn(naf, nbf), 1.f);
    const float d = __fsub_rn(blk.mean, ma);
    n_out[row] = na + blk.n;
    mean_out[row] = __fadd_rn(ma, __fmul_rn(d, __fdiv_rn(nbf, nsafe)));
    m2_out[row] = __fadd_rn(__fadd_rn(m2_in[row], blk.m2),
                            __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(d, d), naf), nbf), nsafe));
    total_out[row] = __fadd_rn(total_in[row], blk.sum);
    time_out[row] = time_in[row] + (run ? T : 0);
  }
  const size_t o = row * kBins;
  for (int b = tid; b < kBins; b += kThreads) hist_out[o + b] = hist_in[o + b] + hist[b];
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// x [N, T] with row stride ld (elements); the state's leaves in (hist
// [N, 361], n, mean, m2, total, time, integrating [N]) and out (hist, n,
// mean, m2, total, time: device buffers the kernel writes in full).
int sigdist_fused_launch(const float* x, int ld, int N, int T, const int* hist_in,
                         const int* n_in, const float* mean_in, const float* m2_in,
                         const float* total_in, const int* time_in,
                         const unsigned char* integrating, int* hist_out, int* n_out,
                         float* mean_out, float* m2_out, float* total_out, int* time_out,
                         void* stream) {
  if (N <= 0 || T <= 0 || ld < T) return static_cast<int>(cudaErrorInvalidValue);
  sigdist_fused_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, ld, T, hist_in, n_in, mean_in, m2_in, total_in, time_in, integrating, hist_out, n_out,
      mean_out, m2_out, total_out, time_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
