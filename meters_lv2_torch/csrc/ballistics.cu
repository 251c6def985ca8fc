// PPM / true-peak attack-release recurrence for NVIDIA Hopper (sm_90a).
//
// Replaces meters_lv2_tpu/ops/pallas_ballistics.py::ballistics_pallas
// (the Pallas TPU kernel, envelope=False).  For each row n of t [N, T],
// per 4-sample group, the step of ballistics_step.cuh:
//   z1 *= w3, z2 *= w3; per sample t:
//     z1 = t > z1 ? z1 + w1*(t - z1) : z1   (same for z2 with w2)
//     p  = t > p  ? t : p                   (track_peak only)
//   m = max(m, z1 + z2), NaN-propagating like torch.maximum.
// Bit-exact to the plain PyTorch version (ops/ballistics_core.py::
// ballistics_reference); denormals are kept (no fast-math).
//
// What bounds it: each row is a serial chain of T dependent steps (about
// four dependent fp32 operations per sample, 12,000 groups per second of
// 48 kHz audio), so the time is the chain's latency, not bytes or FLOPs:
// the input is read once, 4 bytes per sample.  The bare chain takes about
// 24 cycles a sample on an H100.
//
// What the design does about it: the TPU kernel carried (z1, z2, m, p) in
// VMEM scratch across in-order grid steps; CUDA blocks run in no order, so
// one thread owns one row and loops over its whole T with the state in
// registers.  Rows are T*4 bytes apart, so a warp reading one sample of 32
// rows would touch 32 sectors; instead each CTA of 32 rows streams tiles of
// 32 rows x 256 samples into shared memory through a two-slot ring of bulk
// copies (cp.async.bulk, one per row segment, issued by the row's own
// lane; an mbarrier per slot counts the bytes), and each thread reads its
// row back as float4s (row pitch 260 floats: conflict-free).  A slot is
// refilled as soon as the chain has left it, so the copy of tile k+2
// overlaps the chain over tile k+1.
//
// Tile length against rows (microbenchmarks on an H100 at 700 W, T=48000,
// no track_peak): the same chain fed by per-thread cp.async copies of
// 2 x 512-sample tiles took 1.10 ms at N=512 and, at 132 KB a CTA, one CTA
// per SM, so above 132*32 = 4,224 rows it ran in waves (2.19 ms at 8,448,
// 8.73 ms at 33,792).  Bulk copies cut the cost of staging a tile to near
// nothing: 2 x 512 samples took 0.67 ms at N=512 but still fits one CTA
// per SM; 2 x 256 samples (66.5 KB, three CTAs per SM) take 0.76 ms, flat
// up to 132*3*32 = 12,672 rows (0.77 ms at 8,448), then 1.55 ms at 16,896
// and 2.34 ms at 33,792.  Shorter tiles fit more CTAs but cost more per
// sample (2 x 128: 0.95 ms at N=512).  The time-parallel max-plus group
// form (the TPU kernel's envelope body) is the answer to the chain itself
// and is later work.

#include <cuda_runtime.h>

#include <cstddef>

#include "ballistics_step.cuh"

namespace {

constexpr int kRows = 32;            // rows per CTA (one per thread)
constexpr int kTile = 256;           // samples per tile
constexpr int kSlots = 2;            // tiles in the ring
constexpr int kPitch = kTile + 4;    // floats per tile row: 16 B aligned
constexpr size_t kSmem = sizeof(float) * kSlots * kRows * kPitch;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <bool kTrackPeak>
__global__ void __launch_bounds__(kRows)
ballistics_kernel(const float* __restrict__ t, const float* __restrict__ z1in,
                  const float* __restrict__ z2in, const float* __restrict__ m_in,
                  const float* __restrict__ pin, int N, int T, float w1,
                  float w2, float w3, float* __restrict__ z1out,
                  float* __restrict__ z2out, float* __restrict__ mout,
                  float* __restrict__ pout) {
  extern __shared__ __align__(128) float s_buf[];  // [kSlots][kRows][kPitch]
  __shared__ __align__(8) unsigned long long s_bar[kSlots];

  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrows = min(kRows, N - (int)row0);
  const int lane = threadIdx.x;
  const bool live = lane < nrows;
  const size_t row = row0 + lane;
  const int ntile = (T + kTile - 1) / kTile;

  if (lane == 0) {
    for (int i = 0; i < kSlots; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&s_bar[i]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // Tile k into slot k % kSlots: lane 0 arms the slot's barrier with the
  // tile's bytes, then every live lane copies its own row's segment.
  auto issue = [&](int k) {
    const int slot = k % kSlots;
    const int len = min(kTile, T - k * kTile);  // % 4 == 0: 16-byte sizes
    const unsigned bar = smem_addr(&s_bar[slot]);
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"(nrows * len * 4)
                   : "memory");
    __syncwarp();
    // the chain's reads of this slot come before the copy's writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (live)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_addr(s_buf + (slot * kRows + lane) * kPitch)),
          "l"(t + row * (size_t)T + (size_t)k * kTile), "r"(len * 4), "r"(bar)
          : "memory");
  };

  float z1 = 0.f, z2 = 0.f, m = 0.f, p = 0.f;
  if (live) {
    z1 = z1in[row];
    z2 = z2in[row];
    m = m_in[row];
    p = pin[row];
  }

  for (int k = 0; k < kSlots && k < ntile; ++k) issue(k);
  for (int k = 0; k < ntile; ++k) {
    const int slot = k % kSlots;
    const unsigned bar = smem_addr(&s_bar[slot]);
    const unsigned parity = (k / kSlots) & 1;
    unsigned ready = 0;
    do {
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
          " selp.u32 %0, 1, 0, p; }"
          : "=r"(ready)
          : "r"(bar), "r"(parity)
          : "memory");
    } while (!ready);
    if (live) {
      const float4* src =
          reinterpret_cast<const float4*>(s_buf + (slot * kRows + lane) * kPitch);
      const int ngroups = min(kTile, T - k * kTile) / 4;
#pragma unroll 4
      for (int g = 0; g < ngroups; ++g)
        ballistics::group_step<kTrackPeak>(src[g], w1, w2, w3, z1, z2, m, p);
    }
    __syncwarp();
    if (k + kSlots < ntile) issue(k + kSlots);
  }

  if (live) {
    z1out[row] = z1;
    z2out[row] = z2;
    mout[row] = m;
    pout[row] = p;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// t [N, T] row-major, 16-byte aligned, T % 4 == 0; states [N]; every
// pointer is a device pointer.
int ballistics_launch(const float* t, const float* z1, const float* z2,
                      const float* m, const float* p, int N, int T, float w1,
                      float w2, float w3, int track_peak, float* z1out,
                      float* z2out, float* mout, float* pout, void* stream) {
  if (N <= 0 || T <= 0 || T % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (N + kRows - 1) / kRows;
  auto kernel = track_peak ? ballistics_kernel<true> : ballistics_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kRows, kSmem, st>>>(t, z1, z2, m, p, N, T, w1, w2, w3, z1out,
                                     z2out, mout, pout);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
