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
// Arithmetic, in IEEE fp32 FMA throughout (never TF32), per 128-sample
// block of the host-built block operator (ops/lti.py): y = x_blk @ K +
// s @ Sy and s' = s @ At + x_blk @ G.  K is the lower-triangular Toeplitz
// matrix of the impulse response h, K[j][i] = h[i - j] (the wrapper checks
// that and passes h = K's first row), so
//   * y0[i] = sum_{m=0..i} h[m] x[i-m], the triangle only: taps m ascending,
//     those below 32 q for output i = 32 q + r' from the block, the last 32
//     from a copy of the block's first 32 samples behind 32 zeros.  The
//     dense product's zeros turn a non-finite x[j] into NaN for every output
//     i < j; the kernel applies that rule from the block's last non-finite
//     sample, so NaN and Inf land where the matmul puts them.  Summation
//     order differs from the matmul and from the parent kernel (which summed
//     the full dense row): results agree to a few ulp of the terms.
//   * x @ G as eight partials of 16 samples a block, summed by the state
//     chain in a fixed tree; s @ At and s @ Sy dense, as the matmuls.
//   * p = sum over channels in ascending order of (y*y)*gain_c.
//   * True peak: the direct 4-phase, 48-tap FIR up[4t+ph] = sum_i
//     taps[ph, i] * x[t-47+i] with the 47-sample halo, each oversample's
//     FMAs in upsample4::fir's order (ascending taps from 0), so tpmax is
//     bit-identical to the parent kernel's.  The plain version multiplies a
//     175-sample frame by a block matrix whose zeros turn a non-finite input
//     anywhere in the frame into NaN for every output it does not feed; the
//     kernel applies the same rule (upsample4::frame_ok).
//
// What bounds it: about 64.5 (triangle) + 192 (FIR) + 8 (G, Sy) FMA per
// channel-sample against 4 bytes read and 4/C written: far past the H100's
// ~20 FLOP/byte balance, so the fp32 pipes' issue rate bounds it.  The
// parent body (one CTA of 128 threads a stream, thread i making output i of
// every block) issued about one shared-memory load per FMA (a K column
// entry per Toeplitz term, a tap and a window value per FIR term), waited
// on each block's global load, and reduced x @ G with four shuffle trees
// and two barriers a channel-block: 1.64 ms at B = 256, C = 2, T = 48000
// on an H100 (700 W), 11x the function's bound.
//
// What the design does about it.  One CTA still owns one stream (CUDA
// blocks run in no order; the K-weighting state is carried), but its warps
// are specialised and the stream's blocks run in parallel:
//   * P producer warps take units of 4 consecutive blocks (512 samples,
//     all channels) round-robin: warp w the units w, w + P, ...
//     Each keeps a two-slot ring of its units in shared memory, filled by
//     bulk copies (cp.async.bulk, one per channel, the 48-sample halo with
//     it) that complete on the slot's mbarrier a unit ahead of the
//     arithmetic.  Lane l works on block l / 8 of the unit and its samples
//     32 q + 4 (l % 8) + k (q, k = 0..3): four consecutive samples per q,
//     so a window of float4 loads slides over the taps and each load feeds
//     16 FMAs.  The taps (h and the FIR's 192) are a __grid_constant__
//     parameter, read by the FMAs as constant operands: no load at all.
//     The Toeplitz loops are unrolled per q, so a warp skips the triangle's
//     zeros (80 FMAs an output on average instead of 128; 64.5 is the
//     triangle itself).  A producer first writes its unit's x @ G partials
//     and arrives on its "g full" barrier, then computes y0 and the FIR
//     (folding |up| into a per-lane max), waits on its "s full" barrier
//     for the states entering its blocks, and finishes y = y0 + s @ Sy and
//     p.  Non-finite inputs are looked for once per channel-unit; only a
//     unit that holds one takes the per-block span and the NaN rules.
//   * warp 0 carries the state: lane c runs channel c, s' = s @ At + g over
//     the stream's blocks in order (16 FMAs and the partials' sum a block),
//     and publishes each block's entering s to its producer.  It needs only
//     the partials, which producers post at the start of a unit, so it runs
//     ahead of the products that need its states.  No shuffle tree and no
//     CTA barrier sits in the block loop.
//   * seg mode: each producer leaves a block's sums before and after the
//     fragment boundary (an integer division a block, fragm > 128 so at most
//     one boundary) in shared memory; the state warp adds them in block
//     order into the open slot, a register, and stores each slot once when
//     it closes: one fixed summation order, no shared slot array.
// P = 8 while the batch fits the SMs one CTA each (a single stream keeps 8
// warps of one SM busy, so small batches run faster than the parent body,
// not slower), P = 4 beyond, where two CTAs share an SM: two producers a
// scheduler either way (the SM deals warps to its four schedulers by warp
// index, the state warp with producers 4 and 8).  Shared memory: 4 KB (G^T,
// Sy) plus per producer 1264 C + 272 floats; with P = 4, 49 KB at C = 2 and
// 109 KB at C = 5, so 256 streams are one wave on 132 SMs.
// Measured (tools/r128_probe.py; H100 80GB HBM3, 700 W): 0.40 ms at B = 256,
// C = 2, T = 48000 against the parent body's 1.66, 0.22 against 1.25 at
// B = 1, 0.92 against 4.0 at B = 256, C = 5.  Without the FIR it runs in
// 0.18 ms, without the triangle in 0.29: the FIR's 768 FMAs a lane and q,
// at about 70 % of the fp32 issue rate (inferred from those times), set
// the pace.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "mbarrier.cuh"
#include "upsample4.cuh"

namespace {

using upsample4::kNh;                  // true-peak history, 2*24 - 1
using upsample4::kPhases;              // oversampling factor
using upsample4::kTaps;                // FIR taps per phase
constexpr int kBlk = 128;              // samples per block
constexpr int kMaxC = 5;               // channels: R128 supports 1..5
constexpr int kUb = 4;                 // blocks per unit
constexpr int kUnit = kUb * kBlk;      // samples per unit
constexpr int kHalo = 48;              // [pad, 47-sample halo] before a unit
constexpr int kXb = kHalo + kUnit;     // floats per channel of a ring slot
// producer warps a CTA: 8 where a CTA has an SM to itself (B at most the
// SM count), 4 where two CTAs share one; either way two producers a
// scheduler (tools/r128_probe.py: four a scheduler ran 10 % slower)
constexpr int kProdAlone = 8;
constexpr int kProdShared = 4;
constexpr int kZp = 64;                // a block's [32 zeros][x 0..31]

struct Args {
  const float* x;
  const float* z0;
  const float* hist;
  const float* sy;  // [4, 128]
  const float* at;  // [4, 4]
  const float* g;   // [128, 4]
  const int* off;   // seg mode: [B]; null: full rate
  int fragm, n_slots;
  int T;
  float *p, *z, *hist_out, *tpmax;
  float gains[kMaxC];
  float h[kBlk];                  // K[0][i]: K[j][i] = h[i - j]
  float taps[kPhases * kTaps];    // [4, 48] row-major
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// One producer warp's shared memory (floats, every part 16-byte aligned)
// and barriers.
template <int C>
struct WarpMem {
  static constexpr int kRing = 2 * C * kXb;  // [slot][channel][kXb]
  static constexpr int kGpart = C * kUb * 8 * 4;  // [channel][block][lane % 8][4]
  static constexpr int kSst = C * kUb * 4;   // [channel][block][4]: entering s
  static constexpr int kSeg = kUb * 4;       // [block]: head, tail, slot, rem
  static constexpr int kFloats = kRing + kUb * kZp + kGpart + kSst + kSeg;
  static_assert(kFloats % 4 == 0, "alignment");
  float *ring, *zp, *gpart, *sst, *segp;
  unsigned long long *xfull, *gfull, *sfull;  // xfull[2]
  __device__ WarpMem(float* warps, unsigned long long* bars, int w) {
    ring = warps + w * kFloats;
    zp = ring + kRing;
    gpart = zp + kUb * kZp;
    sst = gpart + kGpart;
    segp = sst + kSst;
    xfull = bars + 4 * w;
    gfull = xfull + 2;
    sfull = xfull + 3;
  }
};

template <int C, int kProd>
constexpr size_t smem_bytes() {
  return sizeof(float) * (8 * kBlk + kProd * WarpMem<C>::kFloats) + 8 * 4 * kProd;
}

// Unit u of the stream (channel 0 at xs) into ring slot `slot`: per channel
// x[512 u - 48 .. 512 u + 128 nb), the halo with it (unit 0 takes its halo
// from hist, after the wait), as one bulk copy completing on the slot's
// barrier; plain loads where x is not 16-byte aligned.
template <int C>
__device__ __forceinline__ void issue_unit(const WarpMem<C>& m, int slot, const float* xs, int T,
                                           int u, int nblk, bool aligned, int lane) {
  const int nb = min(kUb, nblk - kUb * u);
  const int lead = u ? kHalo : 0;
  const int n = lead + kBlk * nb;  // floats per channel
  const size_t src = (size_t)u * kUnit - lead;
  float* dst = m.ring + slot * C * kXb + (kHalo - lead);
  unsigned long long* bar = &m.xfull[slot];
  // this warp's reads of the slot (the unit before last) precede the copy
  __syncwarp();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
  if (aligned) {
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                   "r"(C * n * 4)
                   : "memory");
    __syncwarp();
    if (lane < C)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst + lane * kXb)),
          "l"(xs + (size_t)lane * T + src), "r"(n * 4), "r"(smem_addr(bar))
          : "memory");
  } else {
    for (int c = 0; c < C; ++c)
      for (int i = lane; i < n; i += 32) dst[c * kXb + i] = xs[(size_t)c * T + src + i];
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  }
}

// Any non-finite value at frame positions of the unit's nb blocks (buffer
// positions 1 .. 48 + 128 nb - 1 of one channel)?
__device__ __forceinline__ bool any_nonfinite(const float* cb, int nb, int lane) {
  bool bad = false;
  for (int i = lane; i < (kHalo + kBlk * nb) / 4; i += 32) {
    const float4 v = ld4(cb + 4 * i);
    bad |= (i > 0 && !isfinite(v.x)) || !isfinite(v.y) || !isfinite(v.z) || !isfinite(v.w);
  }
  return __any_sync(0xffffffffu, bad);
}

// Frame positions lo .. hi (1 .. 175; hi = -1: none) of the non-finite
// inputs of the frame at fb (fb[p] is position p), over the 8 lanes of
// the block.
__device__ __forceinline__ void frame_span(const float* fb, int r, int& lo, int& hi) {
  lo = INT_MAX;
  hi = -1;
  for (int p = 1 + r; p < kHalo + kBlk; p += 8) {
    if (!isfinite(fb[p])) {
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// y[q][k] = sum_{m=0..i} h[m] x[i-m] for i = 32 q + 4 r + k, taps ascending:
// m < 32 q from the block px, the last 32 from zb (zb[32 + n] = x[n],
// zb[n] = 0 for n < 32).  Each float4 load feeds 16 FMAs (64 in part B,
// shared by the four q); the taps are constant operands.
__device__ __forceinline__ void toeplitz(const float* h, const float* px, const float* zb, int r,
                                         float (&y)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k) y[q][k] = 0.f;
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    const float* e = px + 32 * q + 4 * r;  // x[e0 .. e0 + 3], e0 = 32 q + 4 r
    float4 cur = ld4(e);
#pragma unroll
    for (int a = 0; a < 8 * q; ++a) {
      const float4 nxt = ld4(e - 4 * (a + 1));
      const float c[8] = {nxt.x, nxt.y, nxt.z, nxt.w, cur.x, cur.y, cur.z, cur.w};
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)  // m = 4 a + bb: x[e0 + k - m] = c[4 + k - bb]
#pragma unroll
        for (int k = 0; k < 4; ++k) y[q][k] = fmaf(h[4 * a + bb], c[4 + k - bb], y[q][k]);
      cur = nxt;
    }
  }
  const float* e = zb + 32 + 4 * r;
  float4 cur = ld4(e);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float4 nxt = ld4(e - 4 * (a + 1));
    const float c[8] = {nxt.x, nxt.y, nxt.z, nxt.w, cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)  // m = 32 q + 4 a + bb: x[4 r + k - 4 a - bb]
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          y[q][k] = fmaf(h[32 * q + 4 * a + bb], c[4 + k - bb], y[q][k]);
    cur = nxt;
  }
}

// upsample4::fir for the four samples t .. t + 3 whose windows start at fb
// (fb[1 + k + i] = x[t + k - 47 + i]): each oversample gets fir's FMAs in
// fir's order; each float4 window load feeds 64 FMAs.
__device__ __forceinline__ void fir4(const float* taps, const float* fb, float (&u)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int ph = 0; ph < kPhases; ++ph) u[k][ph] = 0.f;
  float4 cur = ld4(fb);
#pragma unroll
  for (int a = 0; a < kTaps / 4; ++a) {
    const float4 nxt = ld4(fb + 4 * (a + 1));
    const float c[8] = {cur.x, cur.y, cur.z, cur.w, nxt.x, nxt.y, nxt.z, nxt.w};
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)  // tap i = 4 a + bb
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int ph = 0; ph < kPhases; ++ph)
          u[k][ph] = fmaf(taps[ph * kTaps + 4 * a + bb], c[1 + k + bb], u[k][ph]);
    cur = nxt;
  }
}

template <int C, bool kSeg, int kProd>
__device__ __forceinline__ void producer(const Args& a, const WarpMem<C>& m, const float* s_gt,
                                         const float* s_sy, float* s_tp, int pw, int lane,
                                         size_t b, int nblk, int nunits) {
  const int bl = lane >> 3;  // this lane's block of the unit
  const int r = lane & 7;
  const int T = a.T;
  const bool aligned = (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  const float* xs = a.x + b * C * (size_t)T;
  const int off_b = kSeg ? a.off[b] : 0;
  float tp = 0.f;

  for (int k = 0; k < kUb; ++k) m.zp[k * kZp + lane] = 0.f;  // the zeros of zp, once
  if (pw < nunits) issue_unit<C>(m, 0, xs, T, pw, nblk, aligned, lane);
  int k = 0;
  for (int u = pw; u < nunits; u += kProd, ++k) {
    const int slot = k & 1;
    const int nb = min(kUb, nblk - kUb * u);
    const bool live = bl < nb;
    if (u + kProd < nunits) issue_unit<C>(m, slot ^ 1, xs, T, u + kProd, nblk, aligned, lane);
    mbar_wait(&m.xfull[slot], (k >> 1) & 1);
    float* ring = m.ring + slot * C * kXb;
    if (u == 0) {
      for (int c = 0; c < C; ++c) {
        for (int i = lane; i < kNh; i += 32)
          ring[c * kXb + 1 + i] = a.hist[(b * C + c) * kNh + i];
        if (lane == 0) ring[c * kXb] = 0.f;  // pad, never read as a frame position
      }
      __syncwarp();
    }

    // x @ G: this lane's partial over its 16 samples, for the state warp
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      const float* px = ring + c * kXb + kHalo + kBlk * bl;
      float gp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 xv = ld4(px + 32 * q + 4 * r);
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const float4 gv = ld4(s_gt + c4 * kBlk + 32 * q + 4 * r);
          gp[c4] = fmaf(xv.x, gv.x, gp[c4]);
          gp[c4] = fmaf(xv.y, gv.y, gp[c4]);
          gp[c4] = fmaf(xv.z, gv.z, gp[c4]);
          gp[c4] = fmaf(xv.w, gv.w, gp[c4]);
        }
      }
      st4(m.gpart + ((c * kUb + bl) * 8 + r) * 4, make_float4(gp[0], gp[1], gp[2], gp[3]));
    }
    mbar_arrive(m.gfull);

    float pwr[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pwr[q][kk] = 0.f;
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      const float* cb = ring + c * kXb;        // frame of block j at cb + 128 j
      const float* px = cb + kHalo + kBlk * bl;  // this lane's block
      int lo = INT_MAX, hi = -1;
      if (any_nonfinite(cb, nb, lane)) frame_span(cb + kBlk * bl, r, lo, hi);
      float* zb = m.zp + bl * kZp;
      __syncwarp();  // the last channel's reads of zp are done
      st4(zb + 32 + 4 * r, ld4(px + 4 * r));
      __syncwarp();
      float y[4][4];
      toeplitz(a.h, px, zb, r, y);
      if (hi >= kHalo) {  // outputs before the block's last non-finite x
        const int last = hi - kHalo;
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (32 * q + 4 * r + kk < last) y[q][kk] = nan_f();
      }
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        float up[4][4];
        fir4(a.taps, cb + kBlk * bl + 32 * q + 4 * r, up);
        if (live) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (upsample4::frame_ok(lo, hi, 1 + 32 * q + 4 * r + kk)) {
              // fmaxf returns the other operand for NaN: NaN oversamples skip
#pragma unroll
              for (int ph = 0; ph < kPhases; ++ph) tp = fmaxf(tp, fabsf(up[kk][ph]));
            }
        }
      }
      if (c == 0) mbar_wait(m.sfull, k & 1);
      const float4 s = ld4(m.sst + (c * kUb + bl) * 4);
      const float gain = a.gains[c];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i0 = 32 * q + 4 * r;
        const float4 v0 = ld4(s_sy + i0), v1 = ld4(s_sy + kBlk + i0),
                     v2 = ld4(s_sy + 2 * kBlk + i0), v3 = ld4(s_sy + 3 * kBlk + i0);
        const float sy0[4] = {v0.x, v0.y, v0.z, v0.w}, sy1[4] = {v1.x, v1.y, v1.z, v1.w},
                    sy2[4] = {v2.x, v2.y, v2.z, v2.w}, sy3[4] = {v3.x, v3.y, v3.z, v3.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float st = s.x * sy0[kk];
          st = fmaf(s.y, sy1[kk], st);
          st = fmaf(s.z, sy2[kk], st);
          st = fmaf(s.w, sy3[kk], st);
          const float yv = y[q][kk] + st;
          pwr[q][kk] += (yv * yv) * gain;
        }
      }
    }

    if (kSeg) {
      // this block's sums before and after its fragment boundary
      const int pos = off_b + (kUb * u + bl) * kBlk;
      const int slot_lo = pos / a.fragm;
      const int rem = a.fragm - (pos - slot_lo * a.fragm);  // samples left in slot_lo
      float head = 0.f, tail = 0.f;
      if (live) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (32 * q + 4 * r + kk < rem)
              head += pwr[q][kk];
            else
              tail += pwr[q][kk];
          }
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        head += __shfl_xor_sync(0xffffffffu, head, o);
        tail += __shfl_xor_sync(0xffffffffu, tail, o);
      }
      if (r == 0)
        st4(m.segp + 4 * bl, make_float4(head, tail, __int_as_float(slot_lo), __int_as_float(rem)));
    } else if (live) {
      float* pb = a.p + b * (size_t)T + (size_t)u * kUnit + kBlk * bl + 4 * r;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        st4(pb + 32 * q, make_float4(pwr[q][0], pwr[q][1], pwr[q][2], pwr[q][3]));
    }
    if (u == nunits - 1) {  // the last 47 samples become the history
      for (int c = 0; c < C; ++c)
        for (int i = lane; i < kNh; i += 32)
          a.hist_out[(b * C + c) * kNh + i] = ring[c * kXb + kHalo + kBlk * nb - kNh + i];
    }
  }
  if (kSeg) mbar_arrive(m.gfull);  // this warp's last block sums are in segp
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) tp = fmaxf(tp, __shfl_xor_sync(0xffffffffu, tp, o));
  if (lane == 0) s_tp[pw] = tp;
}

// Seg mode, the state warp's lane 0: block sums of one unit into the open
// slot `cur` (sum `acc`), each slot stored once, when it closes.
__device__ __forceinline__ void seg_take(const Args& a, const float* segp, int nb, size_t b,
                                         int& cur, float& acc) {
  float* seg = a.p + b * (size_t)a.n_slots;
  for (int j = 0; j < nb; ++j) {
    const float4 v = ld4(segp + 4 * j);
    const int lo = __float_as_int(v.z), rem = __float_as_int(v.w);
    if (lo != cur) {
      if (cur >= 0 && cur < a.n_slots) seg[cur] = acc;
      cur = lo;
      acc = 0.f;
    }
    acc += v.x;
    if (rem < kBlk) {  // slot lo closes inside the block
      if (lo < a.n_slots) seg[lo] = acc;
      cur = lo + 1;
      acc = v.y;
    }
  }
}

template <int C, bool kSeg, int kProd>
__device__ __forceinline__ void state_warp(const Args& a, float* s_warps,
                                           unsigned long long* bars, int lane, size_t b,
                                           int nblk, int nunits) {
  const bool act = lane < C;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, at[16];
  if (act) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = a.z0[(b * C + lane) * 4 + k];
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) at[k] = a.at[k];
  int cur = -1;
  float acc = 0.f;
  if (kSeg) {  // slots no sample reaches stay 0
    for (int i = lane; i < a.n_slots; i += 32) a.p[b * (size_t)a.n_slots + i] = 0.f;
    __syncwarp();
  }
  for (int u = 0; u < nunits; ++u) {
    const WarpMem<C> m(s_warps, bars, u % kProd);
    mbar_wait(m.gfull, (u / kProd) & 1);
    // that warp's unit u - 8 is complete: its block sums
    if (kSeg && u >= kProd && lane == 0) seg_take(a, m.segp, kUb, b, cur, acc);
    if (act) {
      const int nb = min(kUb, nblk - kUb * u);
      for (int j = 0; j < nb; ++j) {
        st4(m.sst + (lane * kUb + j) * 4, make_float4(s[0], s[1], s[2], s[3]));
        const float* gp = m.gpart + (lane * kUb + j) * 32;
        float4 pt[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) pt[i] = ld4(gp + 4 * i);
        const float gin[4] = {
            ((pt[0].x + pt[1].x) + (pt[2].x + pt[3].x)) + ((pt[4].x + pt[5].x) + (pt[6].x + pt[7].x)),
            ((pt[0].y + pt[1].y) + (pt[2].y + pt[3].y)) + ((pt[4].y + pt[5].y) + (pt[6].y + pt[7].y)),
            ((pt[0].z + pt[1].z) + (pt[2].z + pt[3].z)) + ((pt[4].z + pt[5].z) + (pt[6].z + pt[7].z)),
            ((pt[0].w + pt[1].w) + (pt[2].w + pt[3].w)) + ((pt[4].w + pt[5].w) + (pt[6].w + pt[7].w))};
        float sn[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float v = s[0] * at[k];
          v = fmaf(s[1], at[4 + k], v);
          v = fmaf(s[2], at[8 + k], v);
          v = fmaf(s[3], at[12 + k], v);
          sn[k] = v + gin[k];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) s[k] = sn[k];
      }
    }
    mbar_arrive(m.sfull);
  }
  if (kSeg) {  // the last unit of each producer, after its final arrive
    for (int u = max(0, nunits - kProd); u < nunits; ++u) {
      const WarpMem<C> m(s_warps, bars, u % kProd);
      mbar_wait(m.gfull, (u / kProd + 1) & 1);
      if (lane == 0) seg_take(a, m.segp, min(kUb, nblk - kUb * u), b, cur, acc);
    }
    if (lane == 0 && cur >= 0 && cur < a.n_slots) a.p[b * (size_t)a.n_slots + cur] = acc;
  }
  if (act) {
#pragma unroll
    for (int k = 0; k < 4; ++k) a.z[(b * C + lane) * 4 + k] = s[k];
  }
}

template <int C, bool kSeg, int kProd>
__global__ void __launch_bounds__(32 * (kProd + 1), C <= 2 ? 2 : 1)
r128_fused_kernel(const __grid_constant__ Args a) {
  constexpr int kThreads = 32 * (kProd + 1);
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_tp[kProd];
  float* s_gt = smem;            // G^T [4][128]
  float* s_sy = smem + 4 * kBlk;  // Sy [4][128]
  float* s_warps = smem + 8 * kBlk;
  auto* bars = reinterpret_cast<unsigned long long*>(s_warps + kProd * WarpMem<C>::kFloats);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t b = blockIdx.x;
  const int nblk = a.T / kBlk;
  const int nunits = (nblk + kUb - 1) / kUb;

  for (int k = tid; k < 4 * kBlk; k += kThreads) {
    s_gt[k] = a.g[(k % kBlk) * 4 + k / kBlk];
    s_sy[k] = a.sy[k];
  }
  if (tid == 0) {
    for (int w = 0; w < kProd; ++w) {
      mbar_init(&bars[4 * w], 1);       // x full, slot 0: the copy's issuer
      mbar_init(&bars[4 * w + 1], 1);   // x full, slot 1
      mbar_init(&bars[4 * w + 2], 32);  // g full: every producer lane
      mbar_init(&bars[4 * w + 3], 32);  // s full: every state-warp lane
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0)
    state_warp<C, kSeg, kProd>(a, s_warps, bars, lane, b, nblk, nunits);
  else
    producer<C, kSeg, kProd>(a, WarpMem<C>(s_warps, bars, warp - 1), s_gt, s_sy, s_tp, warp - 1,
                             lane, b, nblk, nunits);
  __syncthreads();
  if (tid == 0) {
    float v = s_tp[0];
#pragma unroll
    for (int w = 1; w < kProd; ++w) v = fmaxf(v, s_tp[w]);
    a.tpmax[b] = v;
  }
}

template <int C, bool kSeg, int kProd>
int launch_mode(const Args& a, int B, cudaStream_t stream) {
  auto kern = r128_fused_kernel<C, kSeg, kProd>;
  const int bytes = static_cast<int>(smem_bytes<C, kProd>());
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  // two CTAs an SM at C <= 2 need the largest shared-memory carveout
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<B, 32 * (kProd + 1), bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int C, bool kSeg>
int launch_prod(const Args& a, int B, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  return B > sms ? launch_mode<C, kSeg, kProdShared>(a, B, stream)
                 : launch_mode<C, kSeg, kProdAlone>(a, B, stream);
}

template <int C>
int launch(const Args& a, int B, cudaStream_t stream) {
  return a.off ? launch_prod<C, true>(a, B, stream) : launch_prod<C, false>(a, B, stream);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// x, z0, hist, sy [4, 128], at [4, 4], g [128, 4] and the outputs are
// device pointers; h (K's first row, 128 floats), taps ([4, 48]) and gains
// (C floats) are host arrays.  With `off` (int32 [B]) non-null the kernel
// runs in seg mode and p is seg [B, n_slots]; fragm > 128, n_slots >= 2 and
// n_slots * fragm >= T + fragm - 1 (the wrapper checks them).
int r128_fused_launch(const float* x, const float* z0, const float* hist, const float* sy,
                      const float* at, const float* g, const float* h, const float* taps,
                      const float* gains, int B, int C, int T, const int* off, int fragm,
                      int n_slots, float* p, float* z, float* hist_out, float* tpmax,
                      void* stream) {
  if (B <= 0 || C < 1 || C > kMaxC || T < kBlk || T % kBlk != 0 ||
      (off && (fragm <= kBlk || n_slots < 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x;
  a.z0 = z0;
  a.hist = hist;
  a.sy = sy;
  a.at = at;
  a.g = g;
  a.off = off;
  a.fragm = fragm;
  a.n_slots = n_slots;
  a.T = T;
  a.p = p;
  a.z = z;
  a.hist_out = hist_out;
  a.tpmax = tpmax;
  for (int c = 0; c < C; ++c) a.gains[c] = gains[c];
  for (int i = 0; i < kBlk; ++i) a.h[i] = h[i];
  for (int i = 0; i < kPhases * kTaps; ++i) a.taps[i] = taps[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(a, B, st);
    case 2: return launch<2>(a, B, st);
    case 3: return launch<3>(a, B, st);
    case 4: return launch<4>(a, B, st);
    case 5: return launch<5>(a, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* meters_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
