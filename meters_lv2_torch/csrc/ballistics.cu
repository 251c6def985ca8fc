// PPM / true-peak attack-release recurrence for NVIDIA Hopper (sm_90a).
//
// Replaces meters_lv2_tpu/ops/pallas_ballistics.py::ballistics_pallas
// (the Pallas TPU kernel, both of its bodies).  For each row n of t [N, T],
// per 4-sample group:
//   z1 *= w3, z2 *= w3; per sample t:
//     z1 = t > z1 ? z1 + w1*(t - z1) : z1   (same for z2 with w2)
//     p  = t > p  ? t : p                   (track_peak only)
//   m = max(m, z1 + z2), NaN-propagating like torch.maximum.
// Two bodies, chosen by the launch's `envelope` flag; denormals are kept
// (no fast-math) and nothing is contracted into an FMA.
//   * serial: ballistics_step.cuh's group_step, bit-exact to
//     ops/ballistics_core.py::ballistics_reference (the JAX package's
//     default body; the port's where the envelope does not hold).
//   * envelope: the same max-of-affine result per group,
//     z' = max(d, d + (b_k - d c_k)), d = w3 z, with the intercepts b_k
//     from a max-plus DP over the group that never reads z
//     (ballistics_step.cuh); bit-exact to ballistics_envelope_reference.
//     The PPM meters run it wherever 0 <= w1, w2 <= 1 (ops/ballistics.py).
//
// What bounds it: each row is a serial chain of 12,000 groups a second of
// 48 kHz audio; the input is read once, 4 bytes a sample (the bytes bound
// at N=512 T=48000 is 0.029 ms), so the time is the carried chain's
// latency at few rows and the issue of the instructions around it at many.
//   * serial: four dependent steps of sub, mul, add, select a sample and
//     state, about 24 cycles a sample on an H100: 0.77-0.89 ms at N=512.
//   * envelope: the chain is a multiply, then per candidate a multiply, a
//     subtraction and an addition, then a 3-deep fmaxf tree, about 40
//     cycles a group; the DP (70 fp32 instructions a group and row) and
//     the loads, peak and m around it are off the chain.  Measured on an
//     H100 80GB HBM3 at 700 W (tools/ballistics_probe.py, T=48000): at
//     N=512 the kernel takes 0.27 ms against the serial body's 0.77, the
//     chain alone (producers without the DP) 0.26 and the producers alone
//     (no chain) 0.28, so the two halves are balanced; at 4,224 rows 0.42
//     (0.37 / 0.40); at 12,672 rows the instructions of both halves set
//     the pace, 1.04 ms against the serial body's 0.88 (0.99 / 0.98), so
//     the meters run the serial body above 8,448 rows (ops/ballistics.py).
//
// What the design does about it.  The TPU kernel carried (z1, z2, m, p) in
// VMEM scratch across in-order grid steps; CUDA blocks run in no order, so
// a CTA owns its rows and walks their whole T.
//   * serial: one thread owns one row and loops over its whole T with the
//     state in registers.  Rows are T*4 bytes apart, so a warp reading one
//     sample of 32 rows would touch 32 sectors; instead each CTA of 32 rows
//     streams tiles of 32 rows x 256 samples into shared memory through a
//     two-slot ring of bulk copies (cp.async.bulk, one per row segment,
//     issued by the row's own lane; an mbarrier per slot counts the bytes),
//     and each thread reads its row back as float4s (row pitch 260 floats:
//     conflict-free).  A slot is refilled as soon as the chain has left it,
//     so the copy of tile k+2 overlaps the chain over tile k+1.  Tile
//     length against rows (microbenchmarks on an H100 at 700 W, T=48000,
//     no track_peak): per-thread cp.async copies of 2 x 512-sample tiles
//     took 1.10 ms at N=512 and, at 132 KB a CTA, one CTA per SM, ran in
//     waves above 4,224 rows (2.19 ms at 8,448, 8.73 ms at 33,792).  Bulk
//     copies cut the cost of staging a tile to near nothing: 2 x 512
//     samples took 0.67 ms at N=512 but still fit one CTA per SM; 2 x 256
//     samples (66.5 KB, three CTAs per SM) take 0.76 ms, flat up to
//     132*3*32 = 12,672 rows (0.77 ms at 8,448), then 1.55 ms at 16,896
//     and 2.34 ms at 33,792.  Shorter tiles fit more CTAs but cost more per
//     sample (2 x 128: 0.95 ms at N=512).
//   * envelope: warp specialised, truepeak_fused's split without the FIR.
//     A CTA owns R rows (R = 4 or 16, below) and walks their
//     128-sample blocks in order.  Producer warps load each block with
//     coalesced float4 loads one block ahead (lane l holds group l of a
//     row), take the DP of each group for w1 and w2 (NaN as -inf) and a
//     per-lane raw peak, write the 8 intercepts of each group and row into
//     one slot of a two-slot ring in shared memory (row pitch 264 floats:
//     the consumer's float4 reads of 4 rows hit distinct banks) and arrive
//     on the slot's "full" mbarrier.  The consumer, warp 0, carries the
//     chains: lanes 2r and 2r + 1 hold z1 and z2 of row r, one instruction
//     stream, the coefficients and intercepts chosen by lane, the
//     intercepts read 4 to 8 groups ahead of the chain (across the edge of
//     a block too).  It stores each group's z in a z slot (pitch 33 floats
//     a lane: conflict-free both ways; z over the consumed b_1, as in
//     truepeak_fused, took 1.19 ms against 1.04 at 12,672 rows, in two
//     calls of tools/ballistics_probe.py) and arrives on the slot's
//     "empty" mbarrier; before refilling the slot the producers fold
//     max(m, z1 + z2) from those values, so m and p stay off the chain.
//     The SM deals warps to its four schedulers by warp index mod 4; the
//     producers are warps 1-3 and 5-7 (1-3 and 5 at R = 4) and warp 4
//     exits at once, so no
//     producer takes issue slots from the chain (a producer beside it:
//     0.29 ms at N=512, 0.48 at 4,224).  With several 16-row CTAs on an
//     SM the roles rotate by the CTA's hardware warp slot, so that their
//     consumers sit on different schedulers (unrotated: 0.44 ms at 4,224).
//     A consumer warp carries up to 16 rows at the cost of one: R = 4
//     (up to 528 rows: one CTA an SM) spreads few rows over more SMs (16
//     rows a CTA at N=512: 0.30 ms), R = 16 wastes no consumer lanes when
//     many CTAs share an SM (4 rows a CTA at 4,224: 0.87 ms).

#include <cuda_runtime.h>

#include <cstddef>

#include "ballistics_step.cuh"
#include "mbarrier.cuh"

namespace {

// -- serial body ---------------------------------------------------------------

constexpr int kRows = 32;            // rows per CTA (one per thread)
constexpr int kTile = 256;           // samples per tile
constexpr int kSlots = 2;            // tiles in the ring
constexpr int kPitch = kTile + 4;    // floats per tile row: 16 B aligned
constexpr size_t kSmem = sizeof(float) * kSlots * kRows * kPitch;

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

// -- envelope body ---------------------------------------------------------------

constexpr int kEnvGroups = 32;                 // groups a row and block (128 samples)
constexpr int kEnvSlots = 2;                   // blocks in the ring
constexpr int kEnvPitch = 8 * kEnvGroups + 8;  // floats a row of an intercept slot
constexpr int kZPitch = kEnvGroups + 1;        // floats a consumer lane of a z slot
constexpr int kAhead = 4;                      // consumer: groups read ahead of the chain
// Rows per CTA: R = kEnvRowsFew up to kEnvFewRows rows, else kEnvRowsMany.
constexpr int kEnvRowsFew = 4;
constexpr int kEnvRowsMany = 16;
constexpr int kEnvFewRows = 528;  // 132 SMs x 4 rows: one CTA an SM

template <int R>
struct EnvShape {
  static_assert(R >= 1 && R <= 16, "a consumer warp carries at most 16 rows");
  static constexpr int kProd = R < 6 ? R : 6;           // producer warps
  static constexpr int kPer = (R + kProd - 1) / kProd;  // rows a producer
  // producer p has role p + 1 + p / 3 (1-3, 5-7): role 4 idles
  static constexpr int kWarps = kProd + (kProd - 1) / 3 + 1;
};

struct EnvArgs {
  const float* t;
  const float *z1, *z2, *m, *p;
  int N, T;
  float w3;
  ballistics::EnvCoeffs k1, k2;
  float *z1out, *z2out, *mout, *pout;
};

__device__ __forceinline__ void load_groups(const float* ring, int g, float4 (&b)[kAhead]) {
#pragma unroll
  for (int i = 0; i < kAhead; ++i) b[i] = *reinterpret_cast<const float4*>(ring + 8 * (g + i));
}

// kAhead groups of the chain from g on; each group's z into zs
__device__ __forceinline__ void carry_groups(float* zs, int g, const float4 (&b)[kAhead],
                                             float& z, float w3,
                                             const ballistics::EnvCoeffs& k, bool live) {
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    z = ballistics::env_carry_tree(z, w3, k, b[i]);
    if (live) zs[g + i] = z;
  }
}

// With the minimum of 1 CTA an SM in __launch_bounds__, ptxas schedules the
// chain with a few more registers (61 against 56 at R = 4), and the kernel
// ran 7-20 % faster at 512 to 4,224 rows (tools/ballistics_probe.py).
template <int R, bool kTrackPeak>
__global__ void __launch_bounds__(EnvShape<R>::kWarps * 32, 1)
ballistics_env_kernel(const EnvArgs a) {
  using S = EnvShape<R>;
  // [slot][row][group][8]: b_1..b_4 for z1, then for z2
  __shared__ __align__(16) float s_ring[kEnvSlots][R][kEnvPitch];
  // [slot][consumer lane][group]: each group's z1 (lane 2r) or z2 (2r + 1)
  __shared__ float s_z[kEnvSlots][2 * R][kZPitch];
  __shared__ __align__(8) unsigned long long s_full[kEnvSlots], s_empty[kEnvSlots];
  __shared__ int s_rot;

  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kEnvSlots; ++s) {
      mbar_init(&s_full[s], S::kProd * 32);  // every producer thread
      mbar_init(&s_empty[s], 32);            // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // 8-warp CTAs rotate the roles by their place on the SM (warp 0's
    // hardware slot over 8), so that the consumers of the CTAs sharing an
    // SM sit on different schedulers; the consumer and the idle role stay
    // 4 warps apart, on one scheduler, whatever the slots are
    unsigned slot;
    asm volatile("mov.u32 %0, %%warpid;" : "=r"(slot));
    s_rot = S::kWarps == 8 ? (slot / 8) & 3 : 0;
  }
  __syncthreads();
  // the warp's role: 0 the consumer, 4 idle, the rest producers
  const int warp = ((threadIdx.x >> 5) - s_rot + S::kWarps) % S::kWarps;

  const int ngroups = a.T / 4;
  const int nblk = (ngroups + kEnvGroups - 1) / kEnvGroups;
  const size_t row0 = (size_t)blockIdx.x * R;

  if (warp == 0) {
    // consumer: lanes 2r, 2r + 1 carry z1, z2 of row r; lanes past 2R
    // repeat the last row and store nothing, rows past N store no result
    const bool live = lane < 2 * R;
    const int r = live ? lane >> 1 : R - 1;
    const int second = lane & 1;
    const size_t row = row0 + r;
    const bool valid = live && row < (size_t)a.N;
    const ballistics::EnvCoeffs k = second ? a.k2 : a.k1;
    const float w3 = a.w3;
    float z = 0.f;
    if (valid) z = second ? a.z2[row] : a.z1[row];
    float4 ba[kAhead], bb[kAhead];
    mbar_wait(&s_full[0], 0);
    load_groups(&s_ring[0][r][4 * second], 0, ba);
    for (int blk = 0; blk < nblk; ++blk) {
      const int slot = blk % kEnvSlots;
      const float* ring = &s_ring[slot][r][4 * second];
      float* zs = s_z[slot][live ? lane : 0];
      const int ng = min(kEnvGroups, ngroups - blk * kEnvGroups);
      if (ng == kEnvGroups) {
        // the intercepts are read kAhead groups before their turn, so that
        // no shared-memory latency lands on the chain; the next block's
        // first ones once its slot is full
#pragma unroll
        for (int g = 0; g < kEnvGroups; g += 2 * kAhead) {
          load_groups(ring, g + kAhead, bb);
          carry_groups(zs, g, ba, z, w3, k, live);
          if (g + 2 * kAhead < kEnvGroups) {
            load_groups(ring, g + 2 * kAhead, ba);
          } else if (blk + 1 < nblk) {
            const int next = (blk + 1) % kEnvSlots;
            mbar_wait(&s_full[next], ((blk + 1) / kEnvSlots) & 1);
            load_groups(&s_ring[next][r][4 * second], 0, ba);
          }
          carry_groups(zs, g + kAhead, bb, z, w3, k, live);
        }
      } else {
        // the last block, shorter than 128 samples (T % 128 != 0)
        for (int g = 0; g < ng; ++g) {
          z = ballistics::env_carry_tree(z, w3, k,
                                         *reinterpret_cast<const float4*>(ring + 8 * g));
          if (live) zs[g] = z;
        }
      }
      mbar_arrive(&s_empty[slot]);
    }
    if (valid) (second ? a.z2out : a.z1out)[row] = z;
    return;
  }
  if ((warp & 3) == 0) return;  // role 4: the consumer's scheduler stays its own

  // producer pw of rows pw, pw + kProd, ...; rows past N are neither loaded
  // nor written, but every producer thread arrives on every "full" barrier
  const int pw = warp - 1 - (warp >> 2);
  const float ninf = -__int_as_float(0x7f800000);
  bool has[S::kPer];
  const float* src[S::kPer];
  float m[S::kPer];   // this lane's max of z1 + z2 (NaN-propagating)
  float pk[S::kPer];  // this lane's raw peak (the DP's samples hold no NaN)
  float4 nxt[S::kPer];
#pragma unroll
  for (int j = 0; j < S::kPer; ++j) {
    const int r = pw + S::kProd * j;
    has[j] = r < R && row0 + r < (size_t)a.N;
    src[j] = a.t + (has[j] ? (row0 + r) * (size_t)a.T : 0);
    m[j] = pk[j] = ninf;
    nxt[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (has[j] && lane < ngroups) nxt[j] = *reinterpret_cast<const float4*>(src[j] + 4 * lane);
  }
  // fold max(m, z1 + z2) of this lane's group of the block in `slot`
  auto fold = [&](int slot, int ng) {
#pragma unroll
    for (int j = 0; j < S::kPer; ++j) {
      const int r = pw + S::kProd * j;
      if (has[j] && lane < ng)
        m[j] = ballistics::max_nan(m[j], __fadd_rn(s_z[slot][2 * r][lane],
                                                   s_z[slot][2 * r + 1][lane]));
    }
  };

  for (int blk = 0; blk < nblk; ++blk) {
    const int slot = blk % kEnvSlots;
    const int g0 = blk * kEnvGroups;
    const int ng = min(kEnvGroups, ngroups - g0);
    if (blk >= kEnvSlots) {  // the consumer is done with block blk - 2 (a whole one)
      mbar_wait(&s_empty[slot], ((blk - kEnvSlots) / kEnvSlots) & 1);
      fold(slot, kEnvGroups);
    }
    const int g1 = g0 + kEnvGroups + lane;  // this lane's group of the next block
#pragma unroll
    for (int j = 0; j < S::kPer; ++j) {
      const float4 v = nxt[j];
      // the next block's load lands while this one is worked on
      if (has[j] && blk + 1 < nblk && g1 < ngroups)
        nxt[j] = *reinterpret_cast<const float4*>(src[j] + 4 * g1);
      if (!has[j] || lane >= ng) continue;
      const float ts[4] = {ballistics::nan_to_ninf(v.x), ballistics::nan_to_ninf(v.y),
                           ballistics::nan_to_ninf(v.z), ballistics::nan_to_ninf(v.w)};
      if (kTrackPeak) pk[j] = fmaxf(pk[j], fmaxf(fmaxf(ts[0], ts[1]), fmaxf(ts[2], ts[3])));
      float* ring = &s_ring[slot][pw + S::kProd * j][8 * lane];
      *reinterpret_cast<float4*>(ring) = ballistics::env_intercepts(ts, a.k1.w);
      *reinterpret_cast<float4*>(ring + 4) = ballistics::env_intercepts(ts, a.k2.w);
    }
    mbar_arrive(&s_full[slot]);
  }
  // the last blocks' z, once the consumer is done with them
  for (int blk = max(0, nblk - kEnvSlots); blk < nblk; ++blk) {
    mbar_wait(&s_empty[blk % kEnvSlots], (blk / kEnvSlots) & 1);
    fold(blk % kEnvSlots, min(kEnvGroups, ngroups - blk * kEnvGroups));
  }
#pragma unroll
  for (int j = 0; j < S::kPer; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m[j] = ballistics::max_nan(m[j], __shfl_xor_sync(0xffffffffu, m[j], off));
      if (kTrackPeak) pk[j] = fmaxf(pk[j], __shfl_xor_sync(0xffffffffu, pk[j], off));
    }
    if (lane == 0 && has[j]) {
      const size_t row = row0 + pw + S::kProd * j;
      a.mout[row] = ballistics::max_nan(a.m[row], m[j]);
      a.pout[row] = kTrackPeak ? ballistics::max_nan(a.p[row], pk[j]) : a.p[row];
    }
  }
}

template <int R>
cudaError_t env_launch(const EnvArgs& a, int track_peak, cudaStream_t st) {
  const int grid = (a.N + R - 1) / R;
  constexpr int threads = EnvShape<R>::kWarps * 32;
  if (track_peak)
    ballistics_env_kernel<R, true><<<grid, threads, 0, st>>>(a);
  else
    ballistics_env_kernel<R, false><<<grid, threads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// t [N, T] row-major, 16-byte aligned, T % 4 == 0; states [N]; every
// pointer is a device pointer except `env_dec`.  `envelope` selects the
// group-envelope body; env_dec (host, 8 floats) then holds c_1..c_4,
// c_k = 1 - (1 - w1)^k, then the same for w2, and is not read otherwise.
int ballistics_launch(const float* t, const float* z1, const float* z2,
                      const float* m, const float* p, int N, int T, float w1,
                      float w2, float w3, int track_peak, int envelope,
                      const float* env_dec, float* z1out, float* z2out,
                      float* mout, float* pout, void* stream) {
  if (N <= 0 || T <= 0 || T % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (envelope) {
    EnvArgs a{t, z1, z2, m, p, N, T, w3,
              {w1, env_dec[0], env_dec[1], env_dec[2], env_dec[3]},
              {w2, env_dec[4], env_dec[5], env_dec[6], env_dec[7]},
              z1out, z2out, mout, pout};
    return static_cast<int>(N <= kEnvFewRows ? env_launch<kEnvRowsFew>(a, track_peak, st)
                                             : env_launch<kEnvRowsMany>(a, track_peak, st));
  }
  const int grid = (N + kRows - 1) / kRows;
  auto kernel = track_peak ? ballistics_kernel<true> : ballistics_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kRows, kSmem, st>>>(t, z1, z2, m, p, N, T, w1, w2, w3, z1out, z2out,
                                     mout, pout);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
