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
// The 4T oversampled stream never leaves on-chip memory.  The plain
// version's non-finite rule (a NaN or Inf input makes every oversample of
// its 128-sample block's 175-sample frame that it does not feed NaN, and
// the ballistics skip NaN) is applied on the same block boundaries, counted
// from the call's first sample: hence T % 128 == 0.
//
// Two bodies, one template kernel.  Both compute the FIR in fp32 FMA in
// r128_fused.cu's order; the plain version (ops/truepeak_fused.py) sums the
// same products as a block matmul, so oversamples agree to a few ulp and
// z1, z2, m, p inherit that.
//   * envelope (the default): each group of four oversamples is the
//     ballistics_step.cuh envelope, z' = max(d, d + (b_k - d c_k)),
//     d = w3 z, with the intercepts b_1..b_4 from a max-plus DP over the
//     group that never reads z; bit-exact, FIR aside, to
//     ballistics_envelope_reference (the max as a tree, see below).
//   * serial: the bit-exact serial group step of ballistics_step.cuh,
//     shared with ballistics.cu (ballistics_reference).
//
// What bounds it: each row is a chain of 48,000 groups a second of 48 kHz
// audio, so the carried latency sets the time, not bytes or FLOPs (the
// FIR, 192 FMA an input sample, is about 0.07 ms of fp32 peak at the
// main-path shape).  The serial body carries four dependent steps of sub,
// mul, add, select a group per state.  The envelope's carried part is a
// multiply, then per candidate a multiply, a subtraction and an addition,
// then a 3-deep fmaxf tree: about 40 cycles a group on an H100, 4 rows to
// an SM at N=512, which is the whole kernel's time there (tools/
// truepeak_probe.py: the kernel with the producers' FIR and DP cut runs
// as long).  From a few thousand rows on, many CTAs share an SM, and the
// producers' issue (about 1,500 instructions per row-block) sets the pace.
//
// What the design does about it.  The TPU kernel carried state and a halo
// across in-order grid steps; here a CTA owns 4 rows and walks their
// 128-sample blocks in order.
//   * serial: one warp per row.  Per block the 32 lanes stage the block
//     (loaded coalesced one block ahead) behind the 47-sample halo, find
//     the frame's non-finite span with two warp reductions, write the
//     |FIR| of 4 input samples each into shared memory, and lane 0 runs
//     the 512-step chain while the other 31 lanes wait.
//   * envelope: warp specialised, 6 warps.  The producers, one warp per
//     row, do the serial body's staging, then the FIR of their lane's 4
//     input samples at once (the taps a __grid_constant__ parameter, each
//     tap read once for 16 FMAs) and, still in registers, the DP of each
//     group for w1 and w2, and fold the group's peak into a per-lane raw
//     peak.  They write the 8 intercepts of each group into one slot of a
//     two-slot ring in shared memory (row pitch 1032 floats: the
//     consumer's float4 reads of the 4 rows hit distinct banks) and arrive
//     on the slot's "full" mbarrier.  The consumer warp carries the
//     chains: lanes 2r and 2r + 1 hold z1 and z2 of row r, one instruction
//     stream, the coefficients and intercepts chosen by lane, the
//     intercepts read 4 to 8 groups ahead of the chain.  It stores each
//     group's z over the consumed b_1 and arrives on the slot's "empty"
//     mbarrier; before refilling the slot the producers fold
//     max(m, z1 + z2) from those values, so m and p leave the chain (a
//     shuffle between the partner lanes in the consumer instead cost more,
//     tools/truepeak_probe.py).  The producers thus work a block ahead:
//     the FIR and DP of block k + 1 overlap the chain over block k.  The
//     consumer takes z' as fmaxf(fmaxf(fmaxf(d, c1), c2), fmaxf(c3, c4)):
//     fmaxf drops NaN and is associative and commutative on everything the
//     chain meets, so the tree gives the plain version's sequential
//     torch.fmax chain bit for bit with one level less.  The SM deals
//     warps to its four schedulers by warp index mod 4; the consumer is
//     warp 0, the producers warps 1, 2, 3 and 5, and warp 4 exits at once,
//     so no producer takes issue slots from the chain (sharing one cost
//     about 28 % more time at N=512).
//   Four rows per CTA: 512 rows at the main-path shape give 128 CTAs,
//   about one per SM.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "ballistics_step.cuh"
#include "mbarrier.cuh"
#include "upsample4.cuh"

namespace {

using upsample4::kNh;
using upsample4::kPhases;
using upsample4::kTaps;
constexpr int kBlk = 128;           // input samples per block (NaN frame)
constexpr int kPer = kBlk / 32;     // input samples per lane and block
constexpr int kRows = 4;            // rows per CTA
constexpr int kOff = 48;            // block offset in the window buffer
constexpr int kBuf = kOff + kBlk;   // [pad, halo(47), block(128)]
constexpr int kSlots = 2;           // envelope: blocks in the ring
constexpr int kPitch = 8 * kBlk + 8;  // envelope: floats per row of a slot
// envelope: warp 0 the consumer, warps 1, 2, 3 and 5 the producers of
// rows 0-3, warp 4 idle (see the header)
constexpr int kEnvWarps = 6;

struct Args {
  const float* x;
  int ld;
  const float* hist;
  const float *z1, *z2, *m, *p;
  int N, T;
  float w1, w2, w3;
  ballistics::EnvCoeffs k1, k2;
  float *z1out, *z2out, *mout, *pout, *hist_out;
  float taps[kPhases * kTaps];  // [4, 48] row-major
};

// Moves the block held in nxt behind the halo in win, issues the loads of
// the next block into nxt (they land while this block is worked on), and
// returns in lo, hi the window positions (1 .. 175) of the frame's first
// and last non-finite input (hi = -1: none).
__device__ __forceinline__ void stage_block(float* win, float (&nxt)[kPer],
                                            const float* xr, int blk, int nblk,
                                            int lane, int& lo, int& hi) {
  lo = INT_MAX;
  hi = -1;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = lane + 32 * k;
    const float v = nxt[k];
    win[kOff + j] = v;
    if (!isfinite(v)) {
      lo = min(lo, kOff + j);
      hi = max(hi, kOff + j);
    }
  }
  if (blk + 1 < nblk) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) nxt[k] = xr[(size_t)(blk + 1) * kBlk + lane + 32 * k];
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
}

// The block's last 47 samples become the next block's halo.
__device__ __forceinline__ void shift_halo(float* win, int lane) {
  __syncwarp();
  for (int i = lane; i < kNh; i += 32) win[1 + i] = win[kOff + kBlk - kNh + i];
  __syncwarp();
}

// |4x oversamples| of the input sample at window position 1 + j from
// u0..u3, or NaN where the plain version's frame rule makes them NaN.
__device__ __forceinline__ float4 rectify(float u0, float u1, float u2, float u3,
                                          int lo, int hi, int j) {
  if (upsample4::frame_ok(lo, hi, 1 + j))
    return make_float4(fabsf(u0), fabsf(u1), fabsf(u2), fabsf(u3));
  const float nan = __int_as_float(0x7fc00000);
  return make_float4(nan, nan, nan, nan);
}

// ---------------------------------------------------------------------------
// serial body: one warp per row, lane 0 runs the chain
// ---------------------------------------------------------------------------

__device__ __forceinline__ void serial_body(const Args& a) {
  __shared__ float s_taps[kPhases * kTaps];
  __shared__ float s_win[kRows][kBuf];
  __shared__ __align__(16) float s_up[kRows][kPhases * kBlk];

  for (int k = threadIdx.x; k < kPhases * kTaps; k += kRows * 32) s_taps[k] = a.taps[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * kRows + warp;
  if (row >= (size_t)a.N) return;  // no CTA-wide barrier follows

  float* win = s_win[warp];
  float4* up4 = reinterpret_cast<float4*>(s_up[warp]);
  const float* xr = a.x + row * (size_t)a.ld;

  for (int i = lane; i < kNh; i += 32) win[1 + i] = a.hist[row * kNh + i];
  if (lane == 0) win[0] = 0.f;  // pad, never read

  float z1 = 0.f, z2 = 0.f, m = 0.f, p = 0.f;
  if (lane == 0) {
    z1 = a.z1[row];
    z2 = a.z2[row];
    m = a.m[row];
    p = a.p[row];
  }

  const int nblk = a.T / kBlk;
  float nxt[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) nxt[k] = xr[lane + 32 * k];
  for (int blk = 0; blk < nblk; ++blk) {
    int lo, hi;
    stage_block(win, nxt, xr, blk, nblk, lane, lo, hi);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = lane + 32 * k;
      float u0, u1, u2, u3;
      upsample4::fir(s_taps, win + 1 + j, u0, u1, u2, u3);
      up4[j] = rectify(u0, u1, u2, u3, lo, hi, j);
    }
    __syncwarp();
    if (lane == 0) {
#pragma unroll 4
      for (int j = 0; j < kBlk; ++j)
        ballistics::group_step<true>(up4[j], a.w1, a.w2, a.w3, z1, z2, m, p);
    }
    shift_halo(win, lane);
  }

  for (int i = lane; i < kNh; i += 32) a.hist_out[row * kNh + i] = win[1 + i];
  if (lane == 0) {
    a.z1out[row] = z1;
    a.z2out[row] = z2;
    a.mout[row] = m;
    a.pout[row] = p;
  }
}

// ---------------------------------------------------------------------------
// envelope body: 4 producer warps (FIR + DP), 1 consumer warp (the chains)
// ---------------------------------------------------------------------------

using ballistics::env_carry_tree;  // the carried half, as a fmaxf tree

constexpr int kAhead = 4;  // consumer: groups read ahead of the chain

__device__ __forceinline__ void load_groups(const float* ring, int g, float4 (&b)[kAhead]) {
#pragma unroll
  for (int i = 0; i < kAhead; ++i) b[i] = *reinterpret_cast<const float4*>(ring + 8 * (g + i));
}

// kAhead groups of the chain from g on; each group's z over its b_1
__device__ __forceinline__ void carry_groups(float* ring, int g, const float4 (&b)[kAhead],
                                             float& z, float w3,
                                             const ballistics::EnvCoeffs& k) {
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    z = env_carry_tree(z, w3, k, b[i]);
    ring[8 * (g + i)] = z;
  }
}

// upsample4::fir for the lane's kPer input samples (window positions
// 1 + lane + 32 k) at once: each oversample gets fir's FMAs in fir's order,
// and each tap, read once from the kernel parameter, serves 4 kPer FMAs.
__device__ __forceinline__ void fir_lane(const float* taps, const float* win, int lane,
                                         float (&u)[kPer][kPhases]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k)
#pragma unroll
    for (int ph = 0; ph < kPhases; ++ph) u[k][ph] = 0.f;
#pragma unroll
  for (int i = 0; i < kTaps; ++i) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float xi = win[1 + lane + 32 * k + i];
#pragma unroll
      for (int ph = 0; ph < kPhases; ++ph) u[k][ph] = fmaf(taps[ph * kTaps + i], xi, u[k][ph]);
    }
  }
}

__device__ __forceinline__ void envelope_body(const Args& a) {
  __shared__ float s_win[kRows][kBuf];
  // [slot][row][group][8]: b_1..b_4 for z1, then for z2; the consumer
  // writes each group's z1 and z2 over the two b_1
  __shared__ __align__(16) float s_ring[kSlots][kRows][kPitch];
  __shared__ __align__(8) unsigned long long s_full[kSlots], s_empty[kSlots];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&s_full[s], kRows * 32);  // every producer thread
      mbar_init(&s_empty[s], 32);         // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nblk = a.T / kBlk;
  const size_t row0 = (size_t)blockIdx.x * kRows;

  if (warp == 0) {
    // consumer: lanes 2r, 2r + 1 carry z1, z2 of row r; lanes 8-31 idle
    const bool live = lane < 2 * kRows;
    const int r = (lane >> 1) & (kRows - 1);
    const int second = lane & 1;
    const size_t row = row0 + r;
    const bool valid = live && row < (size_t)a.N;
    const ballistics::EnvCoeffs k = second ? a.k2 : a.k1;
    const float w3 = a.w3;
    float z = 0.f;
    if (valid) z = second ? a.z2[row] : a.z1[row];
    for (int blk = 0; blk < nblk; ++blk) {
      const int slot = blk % kSlots;
      mbar_wait(&s_full[slot], (blk / kSlots) & 1);
      if (live) {
        // the intercepts are read kAhead groups before their turn, so that
        // no shared-memory latency lands on the chain
        float* ring = &s_ring[slot][r][4 * second];
        float4 ba[kAhead], bb[kAhead];
        load_groups(ring, 0, ba);
#pragma unroll 1
        for (int g = 0; g < kBlk; g += 2 * kAhead) {
          load_groups(ring, g + kAhead, bb);
          carry_groups(ring, g, ba, z, w3, k);
          if (g + 2 * kAhead < kBlk) load_groups(ring, g + 2 * kAhead, ba);
          carry_groups(ring, g + kAhead, bb, z, w3, k);
        }
      }
      mbar_arrive(&s_empty[slot]);
    }
    if (valid) (second ? a.z2out : a.z1out)[row] = z;
    return;
  }

  if (warp == 4) return;
  // producer of row row0 + pr; a CTA's missing rows repeat the last row
  // (the ring is filled for all 4) and write nothing
  const int pr = warp < 4 ? warp - 1 : kRows - 1;
  const bool valid = row0 + pr < (size_t)a.N;
  const size_t row = valid ? row0 + pr : (size_t)a.N - 1;
  float* win = s_win[pr];
  const float* xr = a.x + row * (size_t)a.ld;
  for (int i = lane; i < kNh; i += 32) win[1 + i] = a.hist[row * kNh + i];
  if (lane == 0) win[0] = 0.f;  // pad, never read

  const float ninf = -__int_as_float(0x7f800000);
  float m = ninf;  // this lane's max of z1 + z2 (NaN-propagating)
  float p = ninf;  // this lane's raw peak (the DP's samples hold no NaN)
  // fold max(m, z1 + z2) of this lane's groups of the block in `slot`
  auto fold_m = [&](int slot) {
    const float* ring = s_ring[slot][pr];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = lane + 32 * k;
      m = ballistics::max_nan(m, __fadd_rn(ring[8 * j], ring[8 * j + 4]));
    }
  };

  float nxt[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) nxt[k] = xr[lane + 32 * k];
  for (int blk = 0; blk < nblk; ++blk) {
    int lo, hi;
    stage_block(win, nxt, xr, blk, nblk, lane, lo, hi);
    const int slot = blk % kSlots;
    if (blk >= kSlots) {  // the consumer is done with block blk - 2
      mbar_wait(&s_empty[slot], ((blk - kSlots) / kSlots) & 1);
      fold_m(slot);
    }
    float* ring = s_ring[slot][pr];
    float u[kPer][kPhases];
    fir_lane(a.taps, win, lane, u);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = lane + 32 * k;
      const float4 v = rectify(u[k][0], u[k][1], u[k][2], u[k][3], lo, hi, j);
      const float ts[4] = {ballistics::nan_to_ninf(v.x), ballistics::nan_to_ninf(v.y),
                           ballistics::nan_to_ninf(v.z), ballistics::nan_to_ninf(v.w)};
      p = fmaxf(p, fmaxf(fmaxf(ts[0], ts[1]), fmaxf(ts[2], ts[3])));
      *reinterpret_cast<float4*>(ring + 8 * j) = ballistics::env_intercepts(ts, a.k1.w);
      *reinterpret_cast<float4*>(ring + 8 * j + 4) = ballistics::env_intercepts(ts, a.k2.w);
    }
    mbar_arrive(&s_full[slot]);
    shift_halo(win, lane);
  }
  // the last blocks' z, once the consumer is done with them
  for (int blk = max(0, nblk - kSlots); blk < nblk; ++blk) {
    mbar_wait(&s_empty[blk % kSlots], (blk / kSlots) & 1);
    fold_m(blk % kSlots);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = ballistics::max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
    p = fmaxf(p, __shfl_xor_sync(0xffffffffu, p, off));
  }
  if (!valid) return;
  for (int i = lane; i < kNh; i += 32) a.hist_out[row * kNh + i] = win[1 + i];
  if (lane == 0) {
    a.mout[row] = ballistics::max_nan(a.m[row], m);
    a.pout[row] = ballistics::max_nan(a.p[row], p);
  }
}

template <bool kEnvelope>
__global__ void __launch_bounds__((kEnvelope ? kEnvWarps : kRows) * 32)
truepeak_fused_kernel(const __grid_constant__ Args a) {
  if constexpr (kEnvelope)
    envelope_body(a);
  else
    serial_body(a);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// x [N, T] with row stride ld (elements), T % 128 == 0; hist, hist_out
// [N, 47]; states [N]: device pointers.  taps (host, [4, 48] row-major)
// and env_dec (host, 8 floats: c_1..c_4, c_k = 1 - (1 - w1)^k, then the
// same for w2; read only by the envelope body).  `envelope` selects the
// body.
int truepeak_fused_launch(const float* x, int ld, const float* hist, const float* z1,
                          const float* z2, const float* m, const float* p,
                          const float* taps, int N, int T, float w1, float w2, float w3,
                          int envelope, const float* env_dec, float* z1out,
                          float* z2out, float* mout, float* pout, float* hist_out,
                          void* stream) {
  if (N <= 0 || T < kBlk || T % kBlk != 0 || ld < T)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.ld = ld;
  a.hist = hist;
  a.z1 = z1;
  a.z2 = z2;
  a.m = m;
  a.p = p;
  a.N = N;
  a.T = T;
  a.w1 = w1;
  a.w2 = w2;
  a.w3 = w3;
  a.k1 = {w1, env_dec[0], env_dec[1], env_dec[2], env_dec[3]};
  a.k2 = {w2, env_dec[4], env_dec[5], env_dec[6], env_dec[7]};
  a.z1out = z1out;
  a.z2out = z2out;
  a.mout = mout;
  a.pout = pout;
  a.hist_out = hist_out;
  for (int i = 0; i < kPhases * kTaps; ++i) a.taps[i] = taps[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (N + kRows - 1) / kRows;
  if (envelope)
    truepeak_fused_kernel<true><<<grid, kEnvWarps * 32, 0, st>>>(a);
  else
    truepeak_fused_kernel<false><<<grid, kRows * 32, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
