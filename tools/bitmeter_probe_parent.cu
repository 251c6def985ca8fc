// Bit-meter IEEE-754 field statistics for NVIDIA Hopper (sm_90a).
//
// Replaces meters_lv2_tpu/ops/pallas_bitmeter.py::fused_stats (the Pallas
// TPU kernel).  For each row n of x [N, T] (row stride ld, unit stride in
// time), the unconditional sums over the row (src/bitmeter.c:63-105):
//   flags [5, N]: NaN, Inf, denormal, zero, positive-number counts;
//   vmin, vmax [N]: |min| and |max| of the normals (stay +inf and 0 when
//     the row has none: the wrapper fills them so);
//   hit [N, 280]: per absolute bit position j, the numbers whose field
//     covers j: a normal of raw exponent e covers e .. e+23 (23 mantissa
//     bits and the implicit bit), a denormal 1 .. 23 (e_eff = 1);
//   one [N, 280]: the same positions, counted where the bit is set;
//   dset [N, 23]: per mantissa bit k, the numbers with bit k set.
// NaN, Inf and zeros enter no bit field.  Every count is an exact int32
// sum, independent of the order of the atomics; min/max are exact.
//
// What bounds it: the input is read once, 4 bytes a sample: 49.2 MB at
// [256, 48000], 15 us at 3.35 TB/s.  The work is integer bit counting; a
// per-sample scatter of every set bit (up to 24 shared atomics a sample
// for `one`) would be bound by the atomics, far above the bytes.  This
// kernel is bound by its instruction throughput: warp votes, the exponent
// match and the leaders' atomics (0.27 ms at [256, 48000] on an H100, PERF.md).
//
// What the design does about it: the TPU kernel spread each sample's
// shifted 24-bit field over nine 32-bit words and counted positions with
// SWAR trees, time on sublanes.  Here the position of a bit is its raw
// exponent plus its index, so a CTA counts per (raw exponent e, mantissa
// bit k) in shared memory, s_bit[e][k], plus the numbers per exponent,
// s_exp[e], and folds those into hit/one/dset once at the end (the fold is
// 24 terms per position).  Within a warp, 32 consecutive samples share
// few exponents: __match_any_sync groups the lanes by exponent, 23
// ballots give the set lanes of each mantissa bit, and one leader lane per
// group adds popc(ballot & group) for each bit: at most 24 shared atomics
// per group of 32 samples instead of up to 24 per sample, and lanes of
// different groups hit different rows of s_bit.  (Taking the distinct
// exponents one at a time with a shuffle and a ballot, all 24 lanes adding
// at once, was slower on an H100: the loop is a serial dependency chain.)
// The five flags are ballots counted per warp in registers.  Many CTAs per
// row (kChunk = 4,096-sample chunks, 3,072 CTAs at [256, 48000]; a sweep
// from 2,048 to 24,000 moved the time little, PERF.md) fill the 132 SMs; each adds its partial sums into the zeroed outputs with
// global int32 atomics, and vmin/vmax with atomicMin/atomicMax on the bits
// of the non-negative floats, which order like the floats.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // samples of a row per CTA
constexpr int kNpos = 280;    // hit/one positions (reference region width)
constexpr int kMan = 23;      // mantissa bits
constexpr int kExp = 255;     // raw exponents of numbers (255 = NaN/Inf)
constexpr int kInfBits = 0x7f800000;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
bitmeter_stats_kernel(const float* __restrict__ x, int ld, int N, int T,
                      int nchunks, int* __restrict__ hit,
                      int* __restrict__ one, int* __restrict__ dset,
                      int* __restrict__ flags, float* __restrict__ vmin,
                      float* __restrict__ vmax) {
  __shared__ int s_bit[kExp][kMan];  // set bit k among numbers of exponent e
  __shared__ int s_exp[kExp];        // numbers of raw exponent e
  __shared__ int s_flag[5];          // nan, inf, den, zero, pos
  __shared__ int s_min, s_max;       // bits of |v| of normals

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = blockIdx.x / nchunks;
  const int c = blockIdx.x % nchunks;

  for (int i = tid; i < kExp * kMan; i += kThreads) (&s_bit[0][0])[i] = 0;
  for (int i = tid; i < kExp; i += kThreads) s_exp[i] = 0;
  if (tid < 5) s_flag[tid] = 0;
  if (tid == 0) {
    s_min = kInfBits;
    s_max = 0;
  }
  __syncthreads();

  const float* xr = x + row * (size_t)ld;
  const int t1 = min(T, (c + 1) * kChunk);
  int c_nan = 0, c_inf = 0, c_den = 0, c_zero = 0, c_pos = 0;  // warp-uniform
  int lo = kInfBits, hi = 0;  // per lane
  // each warp walks 32-sample segments; base is warp-uniform, so every
  // ballot below runs with all 32 lanes
  for (int base = c * kChunk + warp * 32; base < t1; base += kThreads) {
    const int t = base + lane;
    const bool in = t < t1;
    const unsigned bits = in ? __float_as_uint(xr[t]) : 0u;
    const unsigned e = (bits >> 23) & 0xFFu;
    const unsigned m = bits & 0x7FFFFFu;
    const bool is_num = in && e != 255u && (e != 0u || m != 0u);
    c_nan += __popc(__ballot_sync(kFull, in && e == 255u && m != 0u));
    c_inf += __popc(__ballot_sync(kFull, in && e == 255u && m == 0u));
    c_den += __popc(__ballot_sync(kFull, in && e == 0u && m != 0u));
    c_zero += __popc(__ballot_sync(kFull, in && e == 0u && m == 0u));
    c_pos += __popc(__ballot_sync(kFull, is_num && (bits >> 31) == 0u));
    if (is_num && e != 0u) {
      const int a = static_cast<int>(bits & 0x7FFFFFFFu);
      lo = min(lo, a);
      hi = max(hi, a);
    }
    if (__ballot_sync(kFull, is_num) == 0u) continue;
    // lanes of one raw exponent form a group; non-numbers share key 256
    const unsigned grp = __match_any_sync(kFull, is_num ? e : 256u);
    unsigned set[kMan];
#pragma unroll
    for (int k = 0; k < kMan; ++k) set[k] = __ballot_sync(kFull, (m >> k) & 1u);
    if (is_num && lane == __ffs(grp) - 1) {
      atomicAdd(&s_exp[e], __popc(grp));
#pragma unroll
      for (int k = 0; k < kMan; ++k) {
        const int n = __popc(set[k] & grp);
        if (n) atomicAdd(&s_bit[e][k], n);
      }
    }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {
    atomicAdd(&s_flag[0], c_nan);
    atomicAdd(&s_flag[1], c_inf);
    atomicAdd(&s_flag[2], c_den);
    atomicAdd(&s_flag[3], c_zero);
    atomicAdd(&s_flag[4], c_pos);
    atomicMin(&s_min, lo);
    atomicMax(&s_max, hi);
  }
  __syncthreads();

  // fold (e, k) into absolute positions j = e_eff + k
  int* hit_r = hit + row * kNpos;
  int* one_r = one + row * kNpos;
  for (int j = tid; j < kNpos; j += kThreads) {
    int h = 0, o = 0;
    // normals of raw exponent e cover e .. e+23, the implicit bit at e+23
    for (int e = max(1, j - kMan); e <= min(j, kExp - 1); ++e) {
      h += s_exp[e];
      o += (j - e < kMan) ? s_bit[e][j - e] : s_exp[e];
    }
    // denormals (e = 0, e_eff = 1) cover 1 .. 23
    if (j >= 1 && j <= kMan) {
      h += s_exp[0];
      o += s_bit[0][j - 1];
    }
    if (h) atomicAdd(&hit_r[j], h);
    if (o) atomicAdd(&one_r[j], o);
  }
  if (tid < kMan) {
    int d = 0;
    for (int e = 0; e < kExp; ++e) d += s_bit[e][tid];
    if (d) atomicAdd(&dset[row * kMan + tid], d);
  }
  if (tid < 5 && s_flag[tid]) atomicAdd(&flags[(size_t)tid * N + row], s_flag[tid]);
  if (tid == 0) {
    if (s_min != kInfBits) atomicMin(reinterpret_cast<int*>(vmin) + row, s_min);
    if (s_max != 0) atomicMax(reinterpret_cast<int*>(vmax) + row, s_max);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// x [N, T] with row stride ld (elements); the outputs are device buffers
// the caller has zeroed (vmin filled with +inf): hit, one [N, 280],
// dset [N, 23], flags [5, N] (nan, inf, den, zero, pos), vmin, vmax [N].
int bitmeter_stats_launch(const float* x, int ld, int N, int T, int* hit,
                          int* one, int* dset, int* flags, float* vmin,
                          float* vmax, void* stream) {
  if (N <= 0 || T <= 0 || ld < T) return static_cast<int>(cudaErrorInvalidValue);
  const int nchunks = (T + kChunk - 1) / kChunk;
  if ((long long)N * nchunks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bitmeter_stats_kernel<<<N * nchunks, kThreads, 0, st>>>(
      x, ld, N, T, nchunks, hit, one, dset, flags, vmin, vmax);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
