// Bit-meter IEEE-754 field statistics for NVIDIA Hopper (sm_90a).
//
// Replaces meters_lv2_tpu/ops/pallas_bitmeter.py::fused_stats (the Pallas
// TPU kernel).  For each row n of x [N, T] (row stride ld, unit stride in
// time), the unconditional sums over the row (src/bitmeter.c:63-105):
//   flags [5, N]: NaN, Inf, denormal, zero, positive-number counts;
//   vmin, vmax [N]: |min| and |max| of the normals (+inf and 0 when the
//     row has none);
//   hit [N, 280]: per absolute bit position j, the numbers whose field
//     covers j: a normal of raw exponent e covers e .. e+23 (23 mantissa
//     bits and the implicit bit), a denormal 1 .. 23 (e_eff = 1);
//   one [N, 280]: the same positions, counted where the bit is set;
//   dset [N, 23]: per mantissa bit k, the numbers with bit k set.
// NaN, Inf and zeros enter no bit field.  Every count is an exact int32
// sum, independent of the order of the additions; min/max are exact.  The
// kernel writes every output element itself: the caller allocates them
// uninitialised.
//
// What bounds it: the input is read once, 4 bytes a sample: 49.2 MB at
// [256, 48000], 15 us at 3.35 TB/s.  The work is bit counting, and its
// integer instructions (LOP3, SHF, SEL on the 16-lane integer pipe of each
// SM sub-partition, half the issue rate) set the pace.  The parent body
// measured 0.194 ms at [256, 48000] on an H100 (tools/bitmeter_probe.py,
// which keeps it as tools/bitmeter_probe_parent.cu): about 344 instructions
// a 32-sample warp step, five flag ballots, a __match_any_sync on the
// exponent, 23 mantissa ballots and a group leader's 24 popcounts and
// shared atomics.  Its cuts showed no single part leading (the match 8 %,
// the atomics 17 %, the fold and flush 6 %): the per-segment stream of
// votes and popcounts was the cost.
//
// What the design does about it: the position of a set bit is its raw
// exponent plus its index, and the exponent's top three bits (a = e >> 5)
// are the same for almost every sample of a signal (all of |x| in
// [2^-31, 2) has a = 3).  For a sample of e = 32 a + b the 24-bit field
// shifted left by b is a 56-bit word whose bit L is position 32 a + L, so
// the counts a position are vertical bit counts over samples: each lane
// adds its samples' words into bit-sliced counters (Harley-Seal carry-save
// adders: ones, twos, fours, eights, two LOP3 a word), and every 16
// samples the 'sixteens' word leaves through a 32x32 bit transpose across
// the warp (five shuffles, the same instructions on every lane) and a
// popcount: lane L then holds the count of bit L.  Four words a sample are
// counted so: the field's low and high shifted halves (one), 1 << b (the
// exponent histogram, from which hit is a 24-wide window sum at the end)
// and the mantissa with the sign (dset and the negative numbers).  That is
// about 30 integer instructions a sample, with no atomics and no votes a
// sample.  A warp's a is the majority of its lanes' first samples in each
// 512-sample block; the counters are flushed when it changes, and the fast
// path runs only where half the first samples share it.  Every other
// nonzero sample (another a, NaN, Inf, denormals) takes the generic pass:
// per 32 samples its words are transposed once, and each distinct a adds
// its popcounts with one shared atomic a lane.  Zeros cost nothing: their
// count is T less every other kind.  The per-CTA fixed cost is small: 581
// shared counters and a prefix sum for hit, no fold.  The CTAs of a row
// form one thread-block cluster (16 at a live meter's few streams, 2 at
// N = 256); at the end each CTA adds its nonzero counters into the first
// CTA's through distributed shared memory, and that one writes the row's
// outputs with plain stores.  So nothing is zeroed before the launch and no
// global atomic is issued.  Measured by the probe at [256, 48000] of
// 0.1 N(0, 1): 0.041 ms, 4.8x the parent; the loads, the a choice and the
// flushes alone 0.023 ms (PERF.md section 6).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;                 // float4 loads a lane per block
constexpr int kBlockQ = 32 * kSlots;      // float4s a warp-block (512 samples)
constexpr int kMaxCluster = 16;           // cluster size (above 8: non-portable)
constexpr int kFastMin = 16;              // first samples of a block on the warp's a
constexpr int kNpos = 280;                // hit/one positions
constexpr int kMan = 23;                  // mantissa bits
constexpr unsigned kFull = 0xffffffffu;
// the CTA's counters, one int array (summed across the cluster at the end)
constexpr int kOne = 0;      // [288] set bits at position j (32 a + 63 < 288)
constexpr int kCnt = 288;    // [256] normals of raw exponent e
constexpr int kDset = 544;   // [32] D-plane counts: 0..22 dset, 31 negatives
constexpr int kFlag = 576;   // [3] nan, inf, den (zeros: T less every other kind)
constexpr int kMin = 579;    // bits of |v| of the normals (unsigned min)
constexpr int kMax = 580;    // (unsigned max)
constexpr int kAcc = 581;

// Per-lane rotations of transpose32: rot[0] = R16, rot[k] = R(j / 2) - R(j)
// after the step of j, rot[5] = -R1, where R(j) = j for a lane whose index
// has bit j, else 0 (mod 32).
struct Tr {
  unsigned rot[6];
};

__device__ __forceinline__ Tr make_tr(unsigned lane) {
  Tr t;
  unsigned prev = 0u;
#pragma unroll
  for (int k = 0, j = 16; k < 5; ++k, j >>= 1) {
    const unsigned r = lane & j;
    t.rot[k] = (r - prev) & 31u;
    prev = r;
  }
  t.rot[5] = (0u - prev) & 31u;
  return t;
}

__device__ __forceinline__ unsigned rotl(unsigned x, unsigned r) {
  return __funnelshift_l(x, x, r);  // r & 31
}

// Lane L of the result holds bit L of every lane's x (bit s from lane s);
// without `exact`, a lane with an odd index holds it rotated left by one
// (enough for a popcount).  Step j trades bit j of the lane index with bit
// j of the bit index.  The lane with bit j clear keeps its bits i with
// i & j == 0 and takes its partner's rotated up by j; the partner keeps
// i & j != 0 and takes the others rotated down by j.  A lane with bit j
// set holds its word rotated left by j through the step (rot), so both
// take (own & m) | (partner's & ~m): the step is the same on every lane.
__device__ __forceinline__ unsigned transpose32(unsigned x, const Tr& t, bool exact) {
  x = rotl(x, t.rot[0]);
#pragma unroll
  for (int k = 0, j = 16; k < 5; ++k, j >>= 1) {
    const unsigned m = j == 16 ? 0x0000ffffu
                       : j == 8 ? 0x00ff00ffu
                       : j == 4 ? 0x0f0f0f0fu
                       : j == 2 ? 0x33333333u
                                : 0x55555555u;
    const unsigned y = __shfl_xor_sync(kFull, x, j);
    x = (x & m) | (y & ~m);
    if (k < 4 || exact) x = rotl(x, t.rot[k + 1]);
  }
  return x;
}

// carry-save adder: a + b + c = l + 2 h in every bit
__device__ __forceinline__ void csa(unsigned& h, unsigned& l, unsigned a, unsigned b,
                                    unsigned c) {
  const unsigned u = a ^ b;
  h = (a & b) | (u & c);
  l = u ^ c;
}

// bit-sliced counters of one word stream: the count of bit i is
// ones_i + 2 twos_i + 4 fours_i + 8 eights_i + 16 c16 (c16 after transpose)
struct Hs {
  unsigned ones, twos, fours, eights;
  int c16;  // lane L: sixteens counted at bit L
};

struct HsTmp {
  unsigned ta, fa, fb, ea;
};

// pair p (0..7) of a 16-word Harley-Seal round; returns the sixteens word
// at p = 7 (0 before)
template <int P>
__device__ __forceinline__ unsigned hs_pair(Hs& s, HsTmp& t, unsigned x0, unsigned x1) {
  unsigned tb, sixteens = 0u;
  if constexpr (P % 2 == 0) {
    csa(t.ta, s.ones, s.ones, x0, x1);
  } else {
    csa(tb, s.ones, s.ones, x0, x1);
    if constexpr (P % 4 == 1) {
      csa(t.fa, s.twos, s.twos, t.ta, tb);
    } else {
      csa(t.fb, s.twos, s.twos, t.ta, tb);
      if constexpr (P == 3) {
        csa(t.ea, s.fours, s.fours, t.fa, t.fb);
      } else {
        unsigned eb;
        csa(eb, s.fours, s.fours, t.fa, t.fb);
        csa(sixteens, s.eights, s.eights, t.ea, eb);
      }
    }
  }
  return sixteens;
}

__device__ __forceinline__ void hs_sixteens(Hs& s, unsigned sixteens, const Tr& t) {
  if (__any_sync(kFull, sixteens != 0u)) s.c16 += __popc(transpose32(sixteens, t, false));
}

// lane L: the count of bit L over the warp's words, and the counters reset
__device__ __forceinline__ int hs_take(Hs& s, const Tr& t) {
  const int n = 16 * s.c16 + __popc(transpose32(s.ones, t, false)) +
                2 * __popc(transpose32(s.twos, t, false)) +
                4 * __popc(transpose32(s.fours, t, false)) +
                8 * __popc(transpose32(s.eights, t, false));
  s = Hs{0u, 0u, 0u, 0u, 0};
  return n;
}

// the four words of a sample for the fast path: a28 = a << 28 of the
// warp's a (1..6: every such exponent is a normal's), or ~0 for none
struct Words {
  unsigned d, lo, hi, o;
};

struct Lane {
  unsigned lo, hi;         // |v| bits of the normals: unsigned min / max
  int nnan, ninf, nden;    // generic pass flags (zeros are T less the rest)
  int dgen;                // generic pass D-plane count (lane L: bit L)
};

__device__ __forceinline__ Words fast_words(unsigned w, unsigned a28, Lane& st,
                                            unsigned& slow) {
  const bool fast = (w & 0x70000000u) == a28;
  const unsigned b = (w >> 23) & 31u;
  const unsigned field = (w & 0x7fffffu) | 0x800000u;
  const unsigned s = fast ? b : 32u;   // a shift by 32 gives 0
  const unsigned bf = fast ? b : 0u;
  const unsigned fm = fast ? kFull : 0u;
  const unsigned ab = w & 0x7fffffffu;
  st.lo = min(st.lo, ab | ~fm);
  st.hi = max(st.hi, ab & fm);
  slow |= (w + w) & ~fm;  // a nonzero sample the fast path did not take
  Words r;
  r.d = w & 0x807fffffu & fm;
  r.lo = __funnelshift_lc(0u, field, s);   // field << b: positions 32 a + 0..31
  r.hi = __funnelshift_lc(field, 0u, bf);  // field >> (32 - b): 32 a + 32..63
  r.o = __funnelshift_lc(0u, 1u, s);       // 1 << b: exponent 32 a + b
  return r;
}

// One nonzero sample a lane (take: counted here), any other kind.  The
// words are transposed once; each distinct a among the segment's numbers
// adds its popcounts at positions 32 a + lane with one shared atomic a lane.
__device__ __forceinline__ void generic_step(unsigned w, bool take, unsigned lane, const Tr& t,
                                             Lane& st, int* acc) {
  const unsigned e = (w >> 23) & 0xffu;
  const unsigned m = w & 0x7fffffu;
  const bool nonfinite = e == 255u;
  const bool num = take && !nonfinite;
  const bool normal = num && e != 0u;
  st.nnan += take && nonfinite && m != 0u;
  st.ninf += take && nonfinite && m == 0u;
  st.nden += num && e == 0u;
  if (normal) {
    st.lo = min(st.lo, w & 0x7fffffffu);
    st.hi = max(st.hi, w & 0x7fffffffu);
  }
  const unsigned nums = __ballot_sync(kFull, num);
  if (nums == 0u) return;
  const unsigned ee = normal ? e : 1u;  // denormals: effective exponent 1
  const unsigned a = ee >> 5, b = ee & 31u;
  const unsigned field = num ? (m | (normal ? 0x800000u : 0u)) : 0u;
  st.dgen += __popc(transpose32(num ? (w & 0x807fffffu) : 0u, t, false));
  const unsigned tlo = transpose32(field << b, t, true);
  const unsigned thi = transpose32(__funnelshift_lc(field, 0u, b), t, true);
  const unsigned to = transpose32(normal ? 1u << b : 0u, t, true);
  unsigned rem = nums;
  while (rem) {
    const unsigned ag = __shfl_sync(kFull, a, __ffs(rem) - 1);
    const unsigned g = __ballot_sync(kFull, num && a == ag);
    rem &= ~g;
    const int c1 = __popc(tlo & g), c2 = __popc(thi & g), c3 = __popc(to & g);
    int* one = acc + kOne + 32 * ag + lane;
    atomicAdd(one, c1);
    atomicAdd(one + 32, c2);
    atomicAdd(acc + kCnt + 32 * ag + lane, c3);
  }
}

// the fast path's a-dependent counters into the CTA's, at base a
__device__ __forceinline__ void flush_a(unsigned a, Hs& hlo, Hs& hhi, Hs& ho, const Tr& t,
                                        unsigned lane, int* acc) {
  const int clo = hs_take(hlo, t), chi = hs_take(hhi, t), co = hs_take(ho, t);
  int* p = acc + kOne + 32 * a + lane;
  if (clo) atomicAdd(p, clo);
  if (chi) atomicAdd(p + 32, chi);
  if (co) atomicAdd(acc + kCnt + 32 * a + lane, co);
}

// the cluster's barrier, in two halves
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_bits(const float* p) {
  return __float_as_uint(__ldg(p));
}

__global__ void __launch_bounds__(kThreads, 3)
bitmeter_stats_kernel(const float* __restrict__ x, int ld, int N, int T, int csize,
                      int* __restrict__ hit, int* __restrict__ one, int* __restrict__ dset,
                      int* __restrict__ flags, float* __restrict__ vmin,
                      float* __restrict__ vmax) {
  __shared__ int acc[kAcc];
  const unsigned tid = threadIdx.x;
  const unsigned lane = tid & 31u;
  const unsigned warp = tid >> 5;
  const size_t row = blockIdx.x / csize;
  const int rank = blockIdx.x % csize;

  for (int i = tid; i < kAcc; i += kThreads) acc[i] = i == kMin ? -1 : 0;
  cluster_arrive();  // zeroed: the others may add into the first CTA's counters
  __syncthreads();

  // the row in float4s from the 16-byte boundary at or before its start
  const float* xr = x + row * (size_t)ld;
  const int h = static_cast<int>((reinterpret_cast<uintptr_t>(xr) >> 2) & 3u);
  const float4* x4 = reinterpret_cast<const float4*>(xr - h);
  const int nq = (T + h + 3) / 4;
  const int nb = (nq + kBlockQ - 1) / kBlockQ;
  const int per = (nb + csize - 1) / csize;
  const int b1 = min(nb, (rank + 1) * per);

  const Tr tr = make_tr(lane);
  Hs hd{}, hlo{}, hhi{}, ho{};
  Lane st{kFull, 0u, 0, 0, 0, 0};
  unsigned A = 0u;  // the warp's a (1..6), 0 before the first choice
  for (int blk = rank * per + warp; blk < b1; blk += kWarps) {
    unsigned w[4 * kSlots];
    const int tb = 4 * kBlockQ * blk - h;  // the block's first sample
    if (tb >= 0 && tb + 4 * kBlockQ <= T) {  // inside the row (warp-uniform)
      const float4* p = x4 + blk * kBlockQ + lane;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const float4 v = __ldg(p + 32 * j);
        w[4 * j] = __float_as_uint(v.x);
        w[4 * j + 1] = __float_as_uint(v.y);
        w[4 * j + 2] = __float_as_uint(v.z);
        w[4 * j + 3] = __float_as_uint(v.w);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4 * kSlots; ++i) {
        const int t = tb + 4 * (32 * (i >> 2) + static_cast<int>(lane)) + (i & 3);
        w[i] = t >= 0 && t < T ? ld_bits(xr + t) : 0u;  // outside the row: a zero, not counted
      }
    }
    // the warp's a: kept while half the lanes' first samples have it, else
    // the a with more support among them takes its place; the fast path
    // runs when half the first samples have the warp's a
    const unsigned a0 = (w[0] >> 28) & 7u;
    int support = __popc(__ballot_sync(kFull, A != 0u && a0 == A));
    if (support < 16) {
      const unsigned cand = __ballot_sync(kFull, a0 >= 1u && a0 <= 6u);
      if (cand) {
        const unsigned na = __shfl_sync(kFull, a0, __ffs(cand) - 1);
        const int ns = __popc(__ballot_sync(kFull, a0 == na));
        if (na != A && ns > support) {
          if (A != 0u) flush_a(A, hlo, hhi, ho, tr, lane, acc);
          A = na;
          support = ns;
        }
      }
    }
    const bool fast = support >= kFastMin;
    const unsigned a28 = fast ? A << 28 : kFull;
    unsigned slow = 0u;
    if (fast) {
      HsTmp td, tl, th, tq;
      unsigned sd = 0u, sl = 0u, sh = 0u, so = 0u;
#define BM_PAIR(P)                                                    \
  {                                                                   \
    const Words u = fast_words(w[2 * P], a28, st, slow);              \
    const Words v = fast_words(w[2 * P + 1], a28, st, slow);          \
    sd |= hs_pair<P>(hd, td, u.d, v.d);                               \
    sl |= hs_pair<P>(hlo, tl, u.lo, v.lo);                            \
    sh |= hs_pair<P>(hhi, th, u.hi, v.hi);                            \
    so |= hs_pair<P>(ho, tq, u.o, v.o);                               \
  }
      BM_PAIR(0) BM_PAIR(1) BM_PAIR(2) BM_PAIR(3)
      BM_PAIR(4) BM_PAIR(5) BM_PAIR(6) BM_PAIR(7)
#undef BM_PAIR
      hs_sixteens(hd, sd, tr);
      hs_sixteens(hlo, sl, tr);
      hs_sixteens(hhi, sh, tr);
      hs_sixteens(ho, so, tr);
    } else {
#pragma unroll
      for (int i = 0; i < 4 * kSlots; i += 2) slow |= w[i] | w[i + 1];
      slow &= 0x7fffffffu;  // a nonzero sample
    }
    // the nonzero samples the fast path left (another a, or not a
    // normal; every one when it did not run), loaded again (L1) so the
    // block's words stay in registers
    if (__any_sync(kFull, slow != 0u)) {
#pragma unroll 1
      for (int i = 0; i < 4 * kSlots; ++i) {
        const int t = tb + 4 * (32 * (i >> 2) + static_cast<int>(lane)) + (i & 3);
        const unsigned v = t >= 0 && t < T ? ld_bits(xr + t) : 0u;
        const bool take = (v + v) != 0u && (v & 0x70000000u) != a28;
        if (__any_sync(kFull, take)) generic_step(v, take, lane, tr, st, acc);
      }
    }
  }

  // the warp's counters into the CTA's
  if (A != 0u) flush_a(A, hlo, hhi, ho, tr, lane, acc);
  int cd = st.dgen;
  if (__any_sync(kFull, (hd.ones | hd.twos | hd.fours | hd.eights | hd.c16) != 0u))
    cd += hs_take(hd, tr);
  if (cd) atomicAdd(acc + kDset + lane, cd);
  const int nnan = __reduce_add_sync(kFull, st.nnan);
  const int ninf = __reduce_add_sync(kFull, st.ninf);
  const int nden = __reduce_add_sync(kFull, st.nden);
  const unsigned lo = __reduce_min_sync(kFull, st.lo);
  const unsigned hi = __reduce_max_sync(kFull, st.hi);
  if (lane == 0) {
    if (nnan) atomicAdd(acc + kFlag, nnan);
    if (ninf) atomicAdd(acc + kFlag + 1, ninf);
    if (nden) atomicAdd(acc + kFlag + 2, nden);
    atomicMin(reinterpret_cast<unsigned*>(acc + kMin), lo);
    atomicMax(reinterpret_cast<unsigned*>(acc + kMax), hi);
  }
  // the cluster's CTAs add their nonzero counters into the first one's
  // through distributed shared memory
  cluster_wait();  // every CTA's counters are zeroed
  __syncthreads();  // this CTA's warps have added theirs
  if (rank != 0) {
    unsigned* lead = cg::this_cluster().map_shared_rank(reinterpret_cast<unsigned*>(acc), 0);
    for (int i = tid; i < kAcc; i += kThreads) {
      const unsigned v = static_cast<unsigned>(acc[i]);
      if (i == kMin) {
        if (v != kFull) atomicMin(lead + i, v);
      } else if (i == kMax) {
        if (v) atomicMax(lead + i, v);
      } else if (v) {
        atomicAdd(lead + i, v);
      }
    }
  }
  cluster_arrive();  // the others' additions are done (and none reads this
  cluster_wait();    // CTA's shared memory after it leaves)
  if (rank != 0) return;

  // hit from the exponent histogram: P[i] = normals of exponent <= i
  if (warp == 0) {
    int part[8];
    int s = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += acc[kCnt + 8 * lane + i];
      part[i] = s;
    }
    int incl = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= static_cast<unsigned>(d)) incl += y;
    }
    const int base = incl - s;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[kCnt + 8 * lane + i] = base + part[i];
  }
  __syncthreads();
  const int* P = acc + kCnt;
  const int den = acc[kFlag + 2];
  for (int j = tid; j < kNpos; j += kThreads) {
    const int hj = P[min(j, 255)] - (j >= 24 ? P[min(j - 24, 255)] : 0) +
                   (j >= 1 && j <= kMan ? den : 0);
    hit[row * kNpos + j] = hj;
    one[row * kNpos + j] = acc[kOne + j];
  }
  if (tid < kMan) dset[row * kMan + tid] = acc[kDset + tid];
  if (tid == 0) {
    const int n_nan = acc[kFlag], n_inf = acc[kFlag + 1];
    flags[row] = n_nan;
    flags[(size_t)N + row] = n_inf;
    flags[2 * (size_t)N + row] = den;
    flags[3 * (size_t)N + row] = T - P[255] - den - n_nan - n_inf;  // zero
    flags[4 * (size_t)N + row] = P[255] + den - acc[kDset + 31];  // pos: less the negatives
    const unsigned mn = static_cast<unsigned>(acc[kMin]);
    vmin[row] = mn == kFull ? __int_as_float(0x7f800000) : __uint_as_float(mn);
    vmax[row] = __uint_as_float(static_cast<unsigned>(acc[kMax]));
  }
}

// CTAs (one cluster) a row: a power of two, enough CTAs in all for two an
// SM, at most 16, and at least one 512-sample block a CTA
int choose_cluster(int N, int T, int sms) {
  const int blocks = (T + 3 + 4 * kBlockQ - 1) / (4 * kBlockQ);
  const int want = (2 * sms + N - 1) / N;
  const int c = std::max(1, std::min({kMaxCluster, want, blocks}));
  return 1 << (31 - __builtin_clz(static_cast<unsigned>(c)));
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// x [N, T] with row stride ld (elements); the outputs are device buffers
// the kernel writes in full: hit, one [N, 280], dset [N, 23], flags [5, N]
// (nan, inf, den, zero, pos), vmin, vmax [N].
int bitmeter_stats_launch(const float* x, int ld, int N, int T, int* hit, int* one, int* dset,
                          int* flags, float* vmin, float* vmax, void* stream) {
  if (N <= 0 || T <= 0 || ld < T) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int csize = choose_cluster(N, T, sms);
  if ((long long)N * csize > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (csize > 8) {
    e = cudaFuncSetAttribute(bitmeter_stats_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(N * csize));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, bitmeter_stats_kernel, x, ld, N, T, csize, hit, one, dset, flags,
                         vmin, vmax);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
