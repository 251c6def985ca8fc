// 30-band 1/3-octave spectrum hot path for NVIDIA Hopper (sm_90a): band
// filters, square, display smoother and peak of the smoothed series in one
// pass over the (downmixed) input.
//
// Replaces meters_lv2_tpu/ops/pallas_spectrum.py::fused_core (the Pallas TPU
// kernel).  For each stream b and band n it computes, from x[b, 0:T]:
//   y      = the band's IEC 61260 band-pass output, a 12-state banked LTI
//            (six 2x2 modal sections, src/spectr.c:68-87) run as blocked
//            recurrences of 128 samples: y_k = x_k @ K + s_k @ Sy,
//            s_{k+1} = s_k @ At + x_k @ G, with the host-built block operator
//            (ops/lti.py BankedLTISystem.op(128));
//   v_i    = the display one-pole on y^2, sample by sample,
//            v_i = v_{i-1} + w (y_i^2 - v_{i-1}) with w read on the card
//            (the runtime speed port, spectrumlv2.c:161-177, 210-224);
//   val    = v after the block, peak = max of v over the block,
//   zf     = the filter state after the block.
//
// Arithmetic.  The two products that depend on nothing carried, x_k @ K and
// x_k @ G, and s_k @ Sy run on the tensor cores in 3xTF32: each operand is
// split into a TF32 high part and the TF32 rounding of the rest, and a
// product is a_lo b_hi + a_hi b_lo + a_hi b_hi (the lo-lo term dropped,
// about 2^-22 of each product), accumulated in fp32.  No single-pass TF32
// is used anywhere.  The state chain s @ At + gx and the smoother are IEEE
// fp32 FMAs on the CUDA cores.  The plain PyTorch version
// (ops/spectrum_fused.py::fused_core_reference) follows the JAX meter's
// unfused path, where the smoother is a blocked Toeplitz product; the two
// agree to a stated tolerance (chip_smoke.py SPEC_TOL).
//
// Non-finite values follow the plain version's dense products exactly:
//   * the TF32 split does not carry a non-finite value (an infinity's low
//     part is Inf - Inf; a NaN with its top mantissa bits set, such as the
//     card's own 0x7fffffff from 0.5 (L + R) with a NaN or +Inf against
//     -Inf, splits into two signed zeros) nor one that rounds to an
//     infinity, so a (stream, block) whose x or incoming state holds such a
//     value, found from the values themselves, is recomputed in IEEE fp32
//     on the CUDA cores (exact_y/exact_g, the flag path): Sy, G and the K
//     entries on and below the diagonal densely, and y[i] = NaN where a
//     non-finite x[j], j > i, would have met K's structural zeros;
//   * At is applied densely (Inf * 0 = NaN as in the matmuls);
//   * the smoother's chain, v + w (q - v), turns an infinity into NaN
//     (Inf - Inf), so NaN / +Inf / -Inf entering it are flagged off the
//     chain, and val and peak are rebuilt from the flags as the plain
//     version's positive-coefficient sums give them; the peak is also NaN
//     when a block has a non-finite y^2 after its first sample (the
//     Toeplitz smoother's zeros make an earlier output of that block NaN).
//
// What bounds it.  The function is six biquads a band-sample (30 MACs) plus
// square, smoother and max, about 65 fp32 operations against 4 bytes of x
// shared by 30 bands: operations.  The blocked form computed here does
// 64.5 MACs of the triangular K, 12 of G and 12 of Sy a band-sample (on the
// tensor cores, three TF32 products each), 1.1 of At and the smoother's
// 4 operations.  With 32 streams to a CTA and two CTAs to an SM, the
// tensor-core passes set the pace: tools/spectrum_probe.py on an H100
// (700 W) times the body at about 2.0 ms at B = 256, T = 48000, about 1.2
// with one TF32 pass of the three, 1.5 without the operand splits, 0.45
// without the products and the smoother, and within 3 % of the kernel
// without the state chain's s @ At or without the x copies.  That is, by
// inference from those times, about 10 cycles an m16n8k8 per SM
// sub-partition (2,400 of them an SM per block step): mma.sync does not
// reach the tensor cores' full rate, which wgmma would (with x^T as a
// K-major B operand of 32 or 64 streams and K^T as A, a later redesign).  The smoother's chain (2 dependent operations a
// sample) costs ~7 % beside the products.
//
// What the design does about it.  CUDA blocks run in no order, so the time
// loop lives inside the CTA: one CTA owns one band and kS = 32 streams and
// walks their 128-sample blocks in order, its warps specialised and
// connected by mbarriers in shared memory:
//   * warp 0, the smoother: lane s runs stream s's one-pole over the block's
//     y^2 (float4 reads; its non-finite bookkeeping off the chain, and taken
//     sample by sample only for 8-sample groups whose sum is not finite), then
//     refills the slot it has consumed with the block two ahead: one bulk
//     copy (cp.async.bulk) of 512 bytes per stream, completing on the
//     slot's "x full" mbarrier (plain loads where x is not 16-byte aligned);
//   * warp 1, the state chain: lane s carries stream s's 12 states,
//     s_{k+1} = s_k @ At + (the four partials of x_k @ G, in fixed order),
//     and publishes s_{k+1} with a non-finite flag; it waits only for x_k @
//     G, so it runs ahead of the products that need s_k;
//   * warps 2-5, the products: warp p owns K's column tiles p, 7-p, 8+p and
//     15-p of 8 outputs, 34 of the 136 lower-triangular 8x8 tiles for every
//     warp, so the triangle is balanced across warps; G's rows 32p..32p+31;
//     and Sy's column tiles as K's.  Per block a warp computes x_k @ K and
//     its G partial for both M tiles of 16 streams with mma.sync m16n8k8
//     (each B fragment split once for the two M tiles, whose chains
//     interleave), flags the rows of its G k-steps' x that the split does
//     not carry (the four warps together see every x; a named barrier
//     joins their flags), publishes the partial, waits for s_k, adds s_k @ Sy,
//     takes the flag path for flagged rows, and after a named barrier of
//     the four writes y^2 over the consumed x in the same ring slot.
//     The operands are split into TF32 parts with integer operations
//     (tf32_rna), not cvt, whose pipe runs at a fraction of the integer
//     rate: the splits outnumber the products.  The k-steps run in four
//     phases whose column tiles are known at compile time (4, 3, 2, 1 of
//     them), so a phase's loop body holds no branch and its loads, splits
//     and mma.sync interleave.
// The x / y^2 ring has two slots; the K, G and Sy tiles are staged once per
// CTA in the mma fragment layout (one 8-byte load per lane per tile, split
// into TF32 parts in registers).  192 threads; shared memory per CTA: K
// 34,816 B, G and Sy 8,192 B each, At 576 B, the ring 33,792 B, the state
// ring 5,120 B, the G partials 12,288 B, flags and barriers 832 B:
// 103,808 B, so two CTAs fit on an SM (with the largest carveout).  At
// B = 256 the grid is 8 x 30 = 240 CTAs: one wave on 132 SMs.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBlk = 128;                  // samples per block
constexpr int kD = 12;                     // band state
constexpr int kNb = 30;                    // bands
constexpr int kS = 32;                     // streams per CTA
constexpr int kMt = kS / 16;               // M tiles of 16 streams
static_assert(kMt == 2, "the product warps take two M tiles");
constexpr int kProdWarps = 4;              // product warps: 4 column tiles each
constexpr int kNtW = 4;                    // column tiles of a product warp
constexpr int kThreads = 32 * (2 + kProdWarps);
constexpr int kSlots = 2;                  // x / y^2 ring
constexpr int kXp = kBlk + 4;              // ring row pitch: conflict-free fragments
constexpr int kSp = 20;                    // state row pitch: likewise
constexpr int kNt = kBlk / 8;              // K's column tiles
constexpr int kTile = 64;                  // floats per staged 8x8 tile
constexpr int kKTiles = kNt * (kNt + 1) / 2;
constexpr int kGTiles = kNt * 2;           // 16 k-steps x 2 column tiles (12 + 4 zero)
constexpr int kSyTiles = 2 * kNt;          // 2 k-steps (12 + 4 zero) x 16 column tiles

// shared memory, in floats
constexpr int kOffK = 0;
constexpr int kOffG = kOffK + kKTiles * kTile;
constexpr int kOffSy = kOffG + kGTiles * kTile;
constexpr int kOffAt = kOffSy + kSyTiles * kTile;
constexpr int kOffRing = kOffAt + kD * kD;
constexpr int kOffS = kOffRing + kSlots * kS * kXp;
constexpr int kOffGx = kOffS + 2 * kS * kSp;
constexpr int kOffFlag = kOffGx + 2 * kProdWarps * kS * kD;
constexpr int kOffXf = kOffFlag + 2 * kS;
constexpr int kOffBar = kOffXf + kProdWarps * kS;
constexpr int kNumBars = 4 * 2;  // x full, gx full, s full, y^2 full: 2 slots each
constexpr size_t kSmemBytes = sizeof(float) * kOffBar + 8 * kNumBars;
static_assert(kOffRing % 4 == 0 && kOffS % 4 == 0 && kOffBar % 2 == 0, "alignment");

__host__ __device__ constexpr int ktile(int kk, int n) { return n * (n + 1) / 2 + kk; }

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned ready = 0;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(ready)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!ready);
}

// |f|'s bits from which the TF32 split below is no rounding: finite values
// that round to an infinity, the infinities and every NaN.
constexpr uint32_t kSplitMax = 0x7f7ff000u;

__device__ __forceinline__ uint32_t abs_bits(float f) { return __float_as_uint(f) & 0x7fffffffu; }

__device__ __forceinline__ bool split_ok(float f) { return abs_bits(f) < kSplitMax; }

// -- product tile: 3xTF32 on mma.sync m16n8k8 ------------------------------
// Position of element (jj, ii) (row jj = k index, column ii = output) of an
// 8x8 tile as staged: lane 4 ii + (jj & 3) holds rows jj and jj + 4 of its
// column, the B fragment of mma.m16n8k8.tf32, as one float2.
__device__ __forceinline__ int tile_pos(int jj, int ii) {
  return 2 * (ii * 4 + (jj & 3)) + (jj >> 2);
}

// f rounded to TF32 (10 mantissa bits, to nearest, ties away from zero, as
// cvt.rna.tf32.f32) with integer operations: half an ulp added, the low 13
// bits cleared.  cvt runs on the SM's conversion pipe at a fraction of the
// integer rate, and the splits outnumber the products.
__device__ __forceinline__ uint32_t tf32_rna(float f) {
  return (__float_as_uint(f) + 0x1000u) & 0xffffe000u;
}

// f = hi + lo + (under 2^-22 f) for |f| under kSplitMax.  Past it the split
// is not that: the half ulp carries into the exponent (f rounds to an
// infinity) or, for a NaN with its top mantissa bits set (0x7fffffff, the
// card's own NaN), into the sign bit and out of the word, so that hi and lo
// come out as signed zeros and the NaN adds nothing to the products.  Rows
// holding such a value take the flag path (split_ok).  lo keeps its low 13
// bits: the tensor cores ignore them, so lo + half an ulp is its TF32
// rounding there, as CUTLASS's fast 3xTF32 conversion does.
__device__ __forceinline__ void split_tf32(float f, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(f);
  lo = __float_as_uint(f - __uint_as_float(hi)) + 0x1000u;
}

// One k-step (8 columns) of rows g and g + 8 of a 16-row tile: as loaded,
// and split into TF32 parts.
struct ARaw {
  float v[4];
};
struct AFrag {
  uint32_t hi[4], lo[4];
};

// Rows g, g + 8 of the 16-row tile at base (row pitch `pitch`), columns
// 8 kk + t and 8 kk + t + 4.
__device__ __forceinline__ ARaw load_a(const float* base, int pitch, int kk, int g, int t) {
  const float* r0 = base + g * pitch + 8 * kk + t;
  const float* r1 = r0 + 8 * pitch;
  return ARaw{{r0[0], r1[0], r0[4], r1[4]}};
}

// mag[0], mag[1]: the largest |x| bits seen so far of rows g and g + 8
__device__ __forceinline__ void note_rows(uint32_t (&mag)[2], const ARaw& r) {
  mag[0] = max(mag[0], max(abs_bits(r.v[0]), abs_bits(r.v[2])));
  mag[1] = max(mag[1], max(abs_bits(r.v[1]), abs_bits(r.v[3])));
}

__device__ __forceinline__ AFrag split_a(const ARaw& r) {
  AFrag a;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(r.v[i], a.hi[i], a.lo[i]);
  return a;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A B fragment (an 8x8 tile as staged: this lane's two values), split.
struct BFrag {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ BFrag load_b(const float* tile, int lane) {
  const float2 b = *reinterpret_cast<const float2*>(tile + 2 * lane);
  BFrag f;
  split_tf32(b.x, f.hi[0], f.lo[0]);
  split_tf32(b.y, f.hi[1], f.lo[1]);
  return f;
}

// c[m][q] += a[m] @ b[q] for the two M tiles and column tiles q0..nq-1 of
// one k-step, as a_lo b_hi + a_hi b_lo + a_hi b_hi: each pass over every
// chain before the next, so that independent mma.sync separate two that
// share an accumulator.
template <int q0, int nq>
__device__ __forceinline__ void products(float (&c)[kMt][nq][4], const AFrag (&a)[kMt],
                                         const BFrag (&b)[nq]) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
#pragma unroll
    for (int q = q0; q < nq; ++q)
#pragma unroll
      for (int m = 0; m < kMt; ++m) {
        const uint32_t(&av)[4] = pass == 0 ? a[m].lo : a[m].hi;
        const uint32_t(&bv)[2] = pass == 1 ? b[q].lo : b[q].hi;
        mma_tf32(c[m][q], av, bv[0], bv[1]);
      }
}
// -- end product tile --------------------------------------------------------

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
    const float4 a = *reinterpret_cast<const float4*>(q + i0);
    const float4 b = *reinterpret_cast<const float4*>(q + i0 + 4);
    const float qq[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    // q = y^2 is >= 0, +Inf or NaN: the group's sum is finite unless one
    // of them is not (or the sum overflows), and only then are the flags
    // taken sample by sample
    const float sum = ((qq[0] + qq[1]) + (qq[2] + qq[3])) + ((qq[4] + qq[5]) + (qq[6] + qq[7]));
    if (!isfinite(sum)) {
#pragma unroll
      for (int u = 0; u < 8; ++u) smooth_note(sm, qq[u], i0 + u > 0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      v = fmaf(w, qq[u] - v, v);
      pk = fmaxf(pk, v);  // drops NaN: the flags decide those cases
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

struct Smem {
  float *k, *g, *sy, *at, *ring, *s, *gx;
  int* flag;   // [2][kS] the state's flags (a value the split does not carry)
  int* xflag;  // [kProdWarps][kS] the block's x flags, from each product warp
  unsigned long long *xfull, *gxfull, *sfull, *qfull;
};

// Block blk of streams b0.. into ring slot blk % 2, by the whole smoother
// warp: a bulk copy of each valid stream's 512 bytes completing on the
// slot's "x full" barrier, or plain loads where x is not 16-byte aligned.
__device__ __forceinline__ void issue_x(const Smem& sm, const float* __restrict__ x, int b0,
                                        int nvalid, int T, int blk, bool aligned, int lane) {
  const int slot = blk & 1;
  float* dst = sm.ring + slot * kS * kXp;
  unsigned long long* bar = &sm.xfull[slot];
  // the reads and writes of this slot (y^2) come before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (aligned) {
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                       smem_addr(bar)),
                   "r"(nvalid * kBlk * 4)
                   : "memory");
    __syncwarp();
    if (lane < nvalid)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst + lane * kXp)),
          "l"(x + (size_t)(b0 + lane) * T + (size_t)blk * kBlk), "r"(kBlk * 4),
          "r"(smem_addr(bar))
          : "memory");
  } else {
    for (int r = 0; r < nvalid; ++r) {
      const float* src = x + (size_t)(b0 + r) * T + (size_t)blk * kBlk;
#pragma unroll
      for (int i = 0; i < kBlk / 32; ++i) dst[r * kXp + lane + 32 * i] = src[lane + 32 * i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  }
}

// K[j][i] and Sy[m][i] from the staged tiles (the flag path)
__device__ __forceinline__ float k_at(const float* sk, int j, int i) {
  return sk[ktile(j >> 3, i >> 3) * kTile + tile_pos(j & 7, i & 7)];
}
__device__ __forceinline__ float sy_at(const float* ssy, int m, int i) {
  return ssy[((m >> 3) * kNt + (i >> 3)) * kTile + tile_pos(m & 7, i & 7)];
}
__device__ __forceinline__ float g_at(const float* sg, int j, int c) {
  return sg[((j >> 3) * 2 + (c >> 3)) * kTile + tile_pos(j & 7, c & 7)];
}

// The flag path for one row (x row xr, state row sr): y at outputs
// 8 nt[q] + 2t + e in IEEE fp32 with the plain version's non-finite
// results, into acc[q][h + e] (h = 0 for row g, 2 for row g + 8).
__device__ __forceinline__ void exact_y(float (&acc)[kNtW][4], const int (&nt)[kNtW], int h,
                                        const float* xr, const float* sr, const Smem& sm, int t) {
  int last = -1;  // the row's last non-finite x
  for (int j = 0; j < kBlk; ++j)
    if (!isfinite(xr[j])) last = j;
#pragma unroll
  for (int q = 0; q < kNtW; ++q) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 8 * nt[q] + 2 * t + e;
      float y = 0.f;
      for (int j = 0; j <= i; ++j) y = fmaf(xr[j], k_at(sm.k, j, i), y);
      if (i < last) y = nan_f();
      float u = sr[0] * sy_at(sm.sy, 0, i);
      for (int m = 1; m < kD; ++m) u = fmaf(sr[m], sy_at(sm.sy, m, i), u);
      acc[q][h + e] = y + u;
    }
  }
}

// The flag path for a row's share of x @ G (rows j0..j0+31 of G), columns
// 8 c + 2t + e, into accg[h + e].
__device__ __forceinline__ void exact_g(float (&accg)[4], int h, const float* xr, int j0, int c,
                                        const Smem& sm, int t) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int col = 8 * c + 2 * t + e;
    float s = 0.f;
    for (int j = j0; j < j0 + 32; ++j) s = fmaf(xr[j], g_at(sm.g, j, col), s);
    accg[h + e] = s;
  }
}

// x_k @ K over k-steps kb..ke for the column tiles q0.. of this warp, the
// ones that reach those k-steps: a compile-time tile set, so the loop body
// is one block of loads, splits and mma.sync with no branch in it.
template <int q0>
__device__ __forceinline__ void k_phase(float (&acc)[kMt][kNtW][4], const float* xs,
                                        const float* sk, const int (&nt)[kNtW], int kb, int ke,
                                        int lane, int g, int t) {
#pragma unroll 2
  for (int kk = kb; kk <= ke; ++kk) {
    BFrag b[kNtW];
#pragma unroll
    for (int q = q0; q < kNtW; ++q) b[q] = load_b(sk + ktile(kk, nt[q]) * kTile, lane);
    const AFrag a[kMt] = {split_a(load_a(xs, kXp, kk, g, t)),
                          split_a(load_a(xs + 16 * kXp, kXp, kk, g, t))};
    products<q0>(acc, a, b);
  }
}

__device__ __forceinline__ void product_warp(const Smem& sm, int p, int lane, int nblk,
                                             int nvalid) {
  const int g = lane >> 2, t = lane & 3;
  // 34 tiles of the triangle for every warp, in ascending order; G's
  // k-steps 4p..4p+3
  const int nt[kNtW] = {p, 7 - p, 8 + p, kNt - 1 - p};
  for (int blk = 0; blk < nblk; ++blk) {
    const int slot = blk & 1;
    const unsigned par = (blk >> 1) & 1;
    float* xs = sm.ring + slot * kS * kXp;  // M tile m: rows 16m..16m+15
    float acc[kMt][kNtW][4], accg[kMt][2][4];  // [M tile][column tile][C fragment]
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int q = 0; q < kNtW; ++q) acc[m][q][e] = 0.f;
        accg[m][0][e] = accg[m][1][e] = 0.f;
      }

    mbar_wait(&sm.xfull[slot], par);
    // column tile q takes k-steps 0..nt[q]: four phases of 4, 3, 2, 1 tiles
    k_phase<0>(acc, xs, sm.k, nt, 0, nt[0], lane, g, t);
    k_phase<1>(acc, xs, sm.k, nt, nt[0] + 1, nt[1], lane, g, t);
    k_phase<2>(acc, xs, sm.k, nt, nt[1] + 1, nt[2], lane, g, t);
    k_phase<3>(acc, xs, sm.k, nt, nt[2] + 1, nt[3], lane, g, t);
    // the largest |x| bits of rows g + 8h of each M tile over G's k-steps
    // 4p..4p+3: the four warps together see every x of the block
    uint32_t mag[kMt][2] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // this warp's rows of G
      const int kk = 4 * p + i;
      const BFrag b[2] = {load_b(sm.g + 2 * kk * kTile, lane),
                          load_b(sm.g + (2 * kk + 1) * kTile, lane)};
      const ARaw r[kMt] = {load_a(xs, kXp, kk, g, t), load_a(xs + 16 * kXp, kXp, kk, g, t)};
#pragma unroll
      for (int m = 0; m < kMt; ++m) note_rows(mag[m], r[m]);
      const AFrag a[kMt] = {split_a(r[0]), split_a(r[1])};
      products<0>(accg, a, b);
    }
    // Rows that hold an x the split does not carry (non-finite, or rounding
    // to an infinity) take the flag path: the split can turn a NaN into
    // zeros, so the products alone would not show it.  Warp 0 also flags
    // the rows whose last column tile (outputs 120..127, every k-step) came
    // out non-finite, as a product overflow does.
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bool bad = mag[m][h] >= kSplitMax;
        if (p == 0)
          bad |= !isfinite(acc[m][kNtW - 1][2 * h]) || !isfinite(acc[m][kNtW - 1][2 * h + 1]);
        const unsigned b = __ballot_sync(0xffffffffu, bad);
        if (t == 0) sm.xflag[p * kS + 16 * m + g + 8 * h] = (b >> lane) & 0xfu;
      }
    asm volatile("bar.sync 1, %0;" ::"r"(32 * kProdWarps) : "memory");
    bool fx[kMt][2];
    bool fany = false;
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * m + g + 8 * h;
        fx[m][h] = sm.xflag[row] | sm.xflag[kS + row] | sm.xflag[2 * kS + row] |
                   sm.xflag[3 * kS + row];
        fany |= fx[m][h];
      }
    if (__any_sync(0xffffffffu, fany)) {
#pragma unroll
      for (int m = 0; m < kMt; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (fx[m][h]) {
#pragma unroll
            for (int c = 0; c < 2; ++c)
              exact_g(accg[m][c], 2 * h, xs + (16 * m + g + 8 * h) * kXp, 32 * p, c, sm, t);
          }
    }
    // this warp's partial of x @ G for the state chain
    float* gx = sm.gx + (slot * kProdWarps + p) * kS * kD;
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * c + 2 * t + e;
            if (col < kD) gx[(16 * m + g + 8 * h) * kD + col] = accg[m][c][2 * h + e];
          }
    mbar_arrive(&sm.gxfull[slot]);

    // + s_k @ Sy, once the chain has published s_k
    mbar_wait(&sm.sfull[slot], par);
    const float* ss = sm.s + slot * kS * kSp;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      BFrag b[kNtW];
#pragma unroll
      for (int q = 0; q < kNtW; ++q) b[q] = load_b(sm.sy + (kk * kNt + nt[q]) * kTile, lane);
      const AFrag a[kMt] = {split_a(load_a(ss, kSp, kk, g, t)),
                            split_a(load_a(ss + 16 * kSp, kSp, kk, g, t))};
      products<0>(acc, a, b);
    }
    const int* fl = sm.flag + slot * kS;
    bool f[kMt][2];
    fany = false;
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        f[m][h] = fx[m][h] || fl[16 * m + g + 8 * h];
        fany |= f[m][h];
      }
    if (__any_sync(0xffffffffu, fany)) {
#pragma unroll
      for (int m = 0; m < kMt; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (f[m][h])
            exact_y(acc[m], nt, 2 * h, xs + (16 * m + g + 8 * h) * kXp,
                    ss + (16 * m + g + 8 * h) * kSp, sm, t);
    }
    // every product warp is done with x_k (and with the x flags): y^2 over
    // it (rows past B keep their zeros: no copy refills them)
    asm volatile("bar.sync 1, %0;" ::"r"(32 * kProdWarps) : "memory");
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * m + g + 8 * h;
        if (row < nvalid) {
#pragma unroll
          for (int q = 0; q < kNtW; ++q)
            *reinterpret_cast<float2*>(xs + row * kXp + 8 * nt[q] + 2 * t) =
                make_float2(acc[m][q][2 * h] * acc[m][q][2 * h],
                            acc[m][q][2 * h + 1] * acc[m][q][2 * h + 1]);
        }
      }
    mbar_arrive(&sm.qfull[slot]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
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
  Smem sm;
  sm.k = smem + kOffK;
  sm.g = smem + kOffG;
  sm.sy = smem + kOffSy;
  sm.at = smem + kOffAt;
  sm.ring = smem + kOffRing;
  sm.s = smem + kOffS;
  sm.gx = smem + kOffGx;
  sm.flag = reinterpret_cast<int*>(smem + kOffFlag);
  sm.xflag = reinterpret_cast<int*>(smem + kOffXf);
  auto* bars = reinterpret_cast<unsigned long long*>(smem + kOffBar);
  sm.xfull = bars;
  sm.gxfull = bars + 2;
  sm.sfull = bars + 4;
  sm.qfull = bars + 6;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int band = blockIdx.y;
  const int b0 = blockIdx.x * kS;
  const int nvalid = min(kS, B - b0);
  const int nblk = T / kBlk;

  // stage the band's operator in the fragment layout; zero the ring (rows
  // past B are never copied) and the state rows' padding
  const float* kb = kmat + (size_t)band * kBlk * kBlk;
  for (int p = tid; p < kKTiles * kTile; p += kThreads) {
    const int tile = p / kTile, e = p % kTile;
    int n = 0;
    while (ktile(0, n + 1) <= tile) ++n;
    const int kk = tile - ktile(0, n), jj = e >> 3, ii = e & 7;
    sm.k[tile * kTile + tile_pos(jj, ii)] = kb[(8 * kk + jj) * kBlk + 8 * n + ii];
  }
  for (int p = tid; p < kGTiles * kTile; p += kThreads) {
    const int tile = p / kTile, e = p % kTile, jj = e >> 3, ii = e & 7;
    const int j = 8 * (tile >> 1) + jj, c = 8 * (tile & 1) + ii;
    sm.g[tile * kTile + tile_pos(jj, ii)] = c < kD ? g[((size_t)band * kBlk + j) * kD + c] : 0.f;
  }
  for (int p = tid; p < kSyTiles * kTile; p += kThreads) {
    const int tile = p / kTile, e = p % kTile, jj = e >> 3, ii = e & 7;
    const int mm = 8 * (tile / kNt) + jj, i = 8 * (tile % kNt) + ii;
    sm.sy[tile * kTile + tile_pos(jj, ii)] =
        mm < kD ? sy[((size_t)band * kD + mm) * kBlk + i] : 0.f;
  }
  for (int p = tid; p < kD * kD; p += kThreads) sm.at[p] = at[(size_t)band * kD * kD + p];
  for (int p = tid; p < kSlots * kS * kXp; p += kThreads) sm.ring[p] = 0.f;
  for (int p = tid; p < 2 * kS * kSp; p += kThreads) sm.s[p] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&sm.xfull[s], 1);
      mbar_init(&sm.gxfull[s], 32 * kProdWarps);
      mbar_init(&sm.sfull[s], 32);
      mbar_init(&sm.qfull[s], 32 * kProdWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // the smoother, and the x loads
    const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const float w_sm = *omega;
    // The plain version builds its smoother from log1p(-w): a NaN w
    // (set_speed lets NaN through) or w >= 1 makes every val and peak NaN.
    Smooth st{0.f, -__int_as_float(0x7f800000), !(w_sm < 1.f), false, false, false};
    if (lane < nvalid) {
      st.v = v0[(size_t)(b0 + lane) * kNb + band];
      smooth_note(st, st.v, false);
    }
    for (int blk = 0; blk < kSlots && blk < nblk; ++blk)
      issue_x(sm, x, b0, nvalid, T, blk, aligned, lane);
    for (int blk = 0; blk < nblk; ++blk) {
      const int slot = blk & 1;
      mbar_wait(&sm.qfull[slot], (blk >> 1) & 1);
      smooth_block(sm.ring + slot * kS * kXp + lane * kXp, w_sm, st);
      __syncwarp();
      if (blk + kSlots < nblk) issue_x(sm, x, b0, nvalid, T, blk + kSlots, aligned, lane);
    }
    if (lane < nvalid) {
      const size_t o = (size_t)(b0 + lane) * kNb + band;
      val[o] = smooth_val(st);
      peak[o] = smooth_peak(st);
    }
  } else if (warp == 1) {
    // the state chain: lane s carries stream s
    const bool valid = lane < nvalid;
    float s[kD];
#pragma unroll
    for (int k = 0; k < kD; ++k)
      s[k] = valid ? z0[((size_t)(b0 + lane) * kNb + band) * kD + k] : 0.f;
    auto publish = [&](int slot) {
      bool nf = false;
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        sm.s[(slot * kS + lane) * kSp + k] = s[k];
        nf |= !split_ok(s[k]);
      }
      sm.flag[slot * kS + lane] = nf;
      mbar_arrive(&sm.sfull[slot]);
    };
    publish(0);
    for (int blk = 0; blk < nblk; ++blk) {
      const int slot = blk & 1;
      mbar_wait(&sm.gxfull[slot], (blk >> 1) & 1);
      const float* gp = sm.gx + slot * kProdWarps * kS * kD + lane * kD;
      float sn[kD];
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        const float gin = ((gp[k] + gp[kS * kD + k]) + gp[2 * kS * kD + k]) + gp[3 * kS * kD + k];
        float u = s[0] * sm.at[k];
#pragma unroll
        for (int mm = 1; mm < kD; ++mm) u = fmaf(s[mm], sm.at[mm * kD + k], u);
        sn[k] = u + gin;
      }
#pragma unroll
      for (int k = 0; k < kD; ++k) s[k] = sn[k];
      if (blk + 1 < nblk) publish(slot ^ 1);
    }
    if (valid) {
#pragma unroll
      for (int k = 0; k < kD; ++k) zf[((size_t)(b0 + lane) * kNb + band) * kD + k] = s[k];
    }
  } else {
    product_warp(sm, warp - 2, lane, nblk, nvalid);
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
  // two CTAs to an SM need the largest shared-memory carveout
  e = cudaFuncSetAttribute(spectrum_fused_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((B + kS - 1) / kS, kNb);
  spectrum_fused_kernel<<<grid, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      x, z0, v0, omega, kmat, sy, at, g, B, T, val, peak, zf);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
