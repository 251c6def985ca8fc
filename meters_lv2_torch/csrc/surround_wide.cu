// Surround meter hot path, wide layout, for NVIDIA Hopper (sm_90a): the
// function of surround_fused.cu with one unit of parallel work per
// (stream, channel) row.
//
// Replaces meters_lv2_tpu/ops/pallas_surround.py:252 _fused_core_wide (the
// Pallas TPU kernel that puts the (stream, channel) rows on sublanes).  It
// computes exactly what surround_fused.cu computes, for x[b, c, 0:T],
// T % 128 == 0: the K-meter smoother state km_z', the block peak pk of x^2
// (NaN skipped), the correlator lowpass state zl' on x + eps, and for each
// routed pair p the weighted sums
//   pacc = sum_t wv[t] (ya yb, ya ya, yb yb)(t),
// ya = sum_c sel_a[p][c] y_c over EVERY channel (a non-finite y in any
// channel reaches every pair, as the JAX package's one-hot product does).
// Its plain version is the narrow kernel's (ops/surround_fused.py::
// fused_core_reference).
//
// Arithmetic: the per-block expressions of surround_fused.cu, in the same
// order (IEEE fp32 FMAs, no fast math): the zero-state lowpass of a block,
// x^2 against G's two columns, the block peak, and the serial carries of
// zl and of the 2x2 K-meter step over the blocks in order.  So km_z', zl'
// and pk are bit-identical to the narrow kernel's.  The pair sums go through
// the channel products S_ij = sum wv y_i y_j, R_c = sum wv r y_c and Q =
// sum wv r^2 of each block's zero-state outputs (r_t = (1 - w1)^(t+1)),
// corrected with the block's entry state z as S_ij + z_i R_j + z_j R_i +
// z_i z_j Q, and with a CTA's own entry state Z through U_c = sum a^i (R_c
// + z_c Q) and V = sum a^2i Q, then contracted with the one-hot sel_a /
// sel_b over every channel: the narrow kernel's algebra, with its sums
// taken by other threads in another order, so pacc agrees with the narrow
// kernel to float32 rounding.
//
// What bounds it: as the narrow kernel, the bytes of x read once (0.117 ms
// at B = 256, C = 8, T = 48000 on 3.35 TB/s; 0.073 ms at C = 5).  The
// layout adds what the narrow one does not pay: every channel's outputs
// cross between threads through shared memory (each thread reads about C/2
// other rows a sample), and the carries' bits still need each 128-sample
// block stepped in order.  On the card the copies set the pace: with the
// arithmetic cut, the loads alone take ~90 % of the kernel's time
// (tools/surround_probe.py, wide-loads-only; PERF.md section 6).  A first
// version of this design copied each lane's 64-byte segment with its own
// cp.async.bulk and ran at the rate the copy unit takes requests (~11-34
// cycles each, 0.27 / 0.33 ms at C = 5 / 8), hence one box a row.  The
// parent body (tools/surround_wide_probe_parent.cu) ran one CTA of C x 64
// threads a stream, loaded each float4 from global memory in the step
// that used it, put a block-wide barrier after every 4 samples, left all
// but the first P rows idle through the routed pair sums, and walked each
// chunk's blocks on one thread a row while the others waited.
//
// What the design does about it:
//   * A channel row is one warp, a lane one 128-sample block of the chunk
//     (32 blocks).  The samples arrive through a ring of kStages slots in
//     shared memory, kSeg samples of every block a stage: x is seen as a
//     2-D tensor of 128-sample rows, [B C nblk, 128], and each row's warp
//     copies one box of it a stage (32 blocks x kSeg samples,
//     cp.async.bulk.tensor), row 0 also wv's ([nblk, 128]); one mbarrier
//     a slot counts the bytes.  The box's 16-byte pieces are swizzled, so
//     a warp's float4 reads, lanes a block apart, are conflict-free
//     (swz()), and L2 promotion to 256 bytes fetches the next stages'
//     samples of each block with the first.  The copies run kStages - 1
//     stages ahead, across chunk ends.
//   * Each stage: the lane runs its block's kSeg samples of its own channel
//     (peak, x^2 G, the zero-state lowpass) and writes its outputs over its
//     x in the slot; one barrier; then every row sums its share of the
//     C(C+1)/2 channel products, S_{c, c+d} for d = 0 .. C/2 (the last d
//     on half the rows when C is even), reading the other rows' outputs
//     from the slot.  No row idles, and one barrier covers kSeg samples
//     (the parent: one per 4).  The next stage's slot is refilled after
//     that barrier: every thread has finished the stage that used it.
//   * At a chunk's end every row's warp walks the chunk's blocks in order
//     with the block values broadcast by shuffles (every lane alike, so no
//     thread waits on another's loop), which gives each lane its block's
//     entry state; one barrier exchanges z and R_c between the rows, and
//     each lane corrects its block's products.
//   * One wave at B = 256: C x 32 threads a CTA, __launch_bounds__ for two
//     CTAs an SM, and a ring of 2 x (C + 1) boxes of 4 KB (72 KB at C = 8).
//     Where the streams alone do not give every SM a CTA, a stream's blocks
//     are split over a thread-block cluster of up to 8 CTAs (ranges of at
//     most 64 blocks).  The carries stay exact: the first CTA walks its own
//     range from the stream's entry state, the others push their blocks'
//     end values and x^2 G sums into its ring through distributed shared
//     memory, and it walks on through them, which also gives each CTA's
//     lowpass entry state Z for the composition above.
//   * Every sum is taken in a fixed order (per lane over the chunks, then
//     warp butterflies, then the CTAs in rank order): a run is reproducible.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "mbarrier.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kBlk = 128;                // samples a block
constexpr int kLanes = 32;               // blocks a chunk: a lane each, a row a warp
constexpr int kSeg = 32;                 // samples of each block a stage
constexpr int kSegs = kBlk / kSeg;       // stages a chunk
constexpr int kRowBytes = kSeg * 4;      // a block's segment: one row of a tensor box
constexpr int kStages = 2;               // the ring's slots
constexpr int kAlign = 1024;             // the ring's alignment: the swizzle's period
constexpr CUtensorMapSwizzle kSwizzle = kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
constexpr CUtensorMapL2promotion kPromote = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
constexpr int kMaxSplit = 8;             // cluster size (portable)
constexpr int kMaxPer = 2 * kLanes;      // blocks a CTA's range when a stream is split
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

template <int C>
struct Dims {
  static constexpr int kThreads = C * kLanes;
  static constexpr int kNm = C * (C + 1) / 2;       // S_ij, i <= j
  static constexpr int kNs = kNm + C + 1;           // S, U, V
  static constexpr int kMaxD = C / 2 + 1;           // products a row sums
  static constexpr int kTile = (C + 1) * kLanes * kSeg;  // floats a slot: C rows of x, then wv
};

// index of S_ij (i <= j) in the upper triangle, row by row
template <int C>
__host__ __device__ constexpr int tri(int i, int j) {
  return i * C - i * (i - 1) / 2 + (j - i);
}

// One CTA's sums, pushed into the cluster's first CTA.
template <int C>
struct Summary {
  float s[Dims<C>::kNs];  // S_ij, then U_c, then V
  float pk[C];
};

template <int C>
struct Smem {
  float4 g4[2][kBlk / 4];  // G's columns
  float4 sy4[kBlk / 4];    // (1 - w1)^(t+1)
  unsigned long long full[kStages];
  float zx[C][kLanes];     // each block's lowpass entry state from the CTA's zero state
  float rx[C][kLanes];     // and its R_c
  float rng[3][kMaxPer][C];  // (split) the range's block end values and x^2 G sums
  float acc[Dims<C>::kNs];
  float pkc[C];
  float zent[kMaxSplit][C];  // (first CTA) the lowpass state entering each CTA
  float mtot[Dims<C>::kNm];
  Summary<C> sums[kMaxSplit];  // (first CTA) every CTA's sums

};

// the dynamic shared memory: Smem<C>, then the ring at the next kAlign
// boundary of the shared window (the same offset in every CTA)
template <int C>
constexpr size_t smem_bytes() {
  return sizeof(Smem<C>) + kAlign + (size_t)kStages * Dims<C>::kTile * sizeof(float);
}

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// one box of a 2-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int x, int y,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// the float offset of a lane's 4 samples h in its row of a box: the box's
// rows are kRowBytes each, their 16-byte pieces permuted by the swizzle
// (piece h of row j sits at h ^ ((j kRowBytes / 128) mod (kRowBytes / 16)))
__device__ __forceinline__ int swz(int lane, int h) {
  return lane * kSeg + 4 * (h ^ ((lane * kRowBytes >> 7) & (kRowBytes / 16 - 1)));
}

// the cluster's barrier in two halves: every CTA has started once it completes
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// the K-meter's block step s' = s @ At, as the walk takes it
__device__ __forceinline__ void km_step(float& s0, float& s1, float at00, float at01,
                                        float at10, float at11) {
  const float n0 = fmaf(at10, s1, at00 * s0);
  const float n1 = fmaf(at11, s1, at01 * s0);
  s0 = n0;
  s1 = n1;
}

template <int C, int P>
__global__ void __launch_bounds__(Dims<C>::kThreads, 2)
surround_wide_kernel(const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmw, const float* __restrict__ km_z,
                     const float* __restrict__ zl0, const float* __restrict__ sel_a,
                     const float* __restrict__ sel_b, const float* __restrict__ km_at,
                     const float* __restrict__ km_g, const float* __restrict__ lp_at,
                     const float* __restrict__ lp_sy,
                     float w1, float om1, float eps, int T, int split,
                     float* __restrict__ kmz_out, float* __restrict__ zl_out,
                     float* __restrict__ pk_out, float* __restrict__ pacc_out) {
  using D = Dims<C>;
  constexpr int NM = D::kNm, NS = D::kNs, kThreads = D::kThreads, kMaxD = D::kMaxD;
  extern __shared__ float4 dyn[];
  Smem<C>& sm = *reinterpret_cast<Smem<C>*>(dyn);
  const unsigned base = smem_addr(&sm);
  const unsigned ring_off = ((base + sizeof(Smem<C>) + kAlign - 1) & ~(kAlign - 1u)) - base;
  float* ring = reinterpret_cast<float*>(reinterpret_cast<char*>(&sm) + ring_off);
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = tid >> 5;  // this warp's channel row; the lane is a block of the chunk
  const int rank = blockIdx.x % split;
  const int b = blockIdx.x / split;
  const int nblk = T / kBlk;
  const int per = (nblk + split - 1) / split;
  const int first = rank * per;
  const int n = min(per, nblk - first);  // >= 1: the launcher's split
  const int nchunks = (n + kLanes - 1) / kLanes;
  const int total = nchunks * kSegs;
  // the products this row sums: S_{c, c+d mod C}, d < nd (each unordered pair once)
  const int nd = (C % 2 == 1 || c < C / 2) ? kMaxD : kMaxD - 1;
  cluster_arrive_relaxed();  // waited on before the first push into the first CTA

  if (tid < kBlk / 4) {
    sm.g4[0][tid] = make_float4(km_g[8 * tid], km_g[8 * tid + 2], km_g[8 * tid + 4],
                                km_g[8 * tid + 6]);
    sm.g4[1][tid] = make_float4(km_g[8 * tid + 1], km_g[8 * tid + 3], km_g[8 * tid + 5],
                                km_g[8 * tid + 7]);
    sm.sy4[tid] = reinterpret_cast<const float4*>(lp_sy)[tid];
  }
  if (tid < kStages) mbar_init(&sm.full[tid], C);  // one arrival a row's warp
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();

  // the copies of stage s (chunk s / kSegs, samples kSeg (s % kSegs) on of
  // each block): lane 0 of each row's warp arms the slot with its bytes and
  // copies one box, the chunk's 32 blocks x kSeg samples of its channel (x
  // seen as rows of 128 samples, [B C nblk, 128]), and row 0 also wv's
  // ([nblk, 128]); a box past the chunk reads other rows, or zeros past
  // the tensor, into lanes that are not live
  const int xrow = (b * C + c) * nblk + first;
  auto issue = [&](int s) {
    if (s >= total || lane != 0) return;
    const int chunk = s / kSegs, seg = s % kSegs;
    float* slot = ring + (s % kStages) * D::kTile;
    unsigned long long* bar = &sm.full[s % kStages];
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"((c == 0 ? 2 : 1) * kLanes * kRowBytes)
                 : "memory");
    tensor_copy(slot + c * kLanes * kSeg, &tmx, seg * kSeg, xrow + chunk * kLanes, bar);
    if (c == 0)
      tensor_copy(slot + C * kLanes * kSeg, &tmw, seg * kSeg, first + chunk * kLanes, bar);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  const float at00 = km_at[0], at01 = km_at[1], at10 = km_at[2], at11 = km_at[3];
  const float a128 = lp_at[0];
  // the walks, every lane of a row alike: the lowpass from the CTA's zero
  // state (wz, for the products), a128^i (wa), and in the first CTA the
  // lowpass and the K-meter from the stream's entry state (wx, ws)
  float wz = 0.f, wa = 1.f, wx = 0.f, ws0 = 0.f, ws1 = 0.f;
  const size_t o = (size_t)b * C + c;
  if (rank == 0) {
    wx = zl0[o];
    ws0 = km_z[2 * o];
    ws1 = km_z[2 * o + 1];
  }
  float pk = 0.f;
  float tot[kMaxD], U = 0.f, V = 0.f;  // this lane's sums over its chunks
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) tot[d] = 0.f;
  // this lane's block: its channel's zero-state sums and its products
  float z = 0.f, g0 = 0.f, g1 = 0.f, S[kMaxD], R = 0.f, Q = 0.f;
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) S[d] = 0.f;

  for (int s = 0; s < total; ++s) {
    const int chunk = s / kSegs, seg = s % kSegs;
    const int nb = min(kLanes, n - chunk * kLanes);
    const bool live = lane < nb;
    float* slot = ring + (s % kStages) * D::kTile;
    if (seg == 0) {
      z = g0 = g1 = R = Q = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) S[d] = 0.f;
    }
    mbar_wait(&sm.full[s % kStages], (s / kStages) & 1);
    // -- own channel: peak, x^2 G, the zero-state lowpass; outputs over x --
    float yv[kSeg];
    float* row = slot + c * kLanes * kSeg;
    if (live) {
#pragma unroll
      for (int h = 0; h < kSeg / 4; ++h) {
        float4* mine = reinterpret_cast<float4*>(row + swz(lane, h));
        const float4 xv = *mine;
        const int q4 = seg * (kSeg / 4) + h;
        const float4 G0 = sm.g4[0][q4], G1 = sm.g4[1][q4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float v = lane4(xv, u);
          const float q = v * v;
          pk = fmaxf(pk, q);
          g0 = fmaf(q, lane4(G0, u), g0);
          g1 = fmaf(q, lane4(G1, u), g1);
          z = fmaf(om1, z, w1 * (v + eps));
          yv[4 * h + u] = z;
        }
        *mine = make_float4(yv[4 * h], yv[4 * h + 1], yv[4 * h + 2], yv[4 * h + 3]);
      }
    }
    // these writes of the slot come before the copy that next refills it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // every row's outputs are in; the slot of stage s - 1 is free
    issue(s + kStages - 1);
    // -- this row's share of the channel products --
    if (live) {
#pragma unroll
      for (int h = 0; h < kSeg / 4; ++h) {
        const int at = swz(lane, h);
        const float4 W = *reinterpret_cast<const float4*>(slot + C * kLanes * kSeg + at);
        const float4 SY = sm.sy4[seg * (kSeg / 4) + h];
        float4 yo[kMaxD];
#pragma unroll
        for (int d = 1; d < kMaxD; ++d) {
          const int e = c + d < C ? c + d : c + d - C;
          yo[d] = d < nd ? *reinterpret_cast<const float4*>(slot + e * kLanes * kSeg + at)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float wt = lane4(W, u), r = lane4(SY, u), wr = wt * r;
          const float y = yv[4 * h + u], wy = wt * y;
          S[0] = fmaf(wy, y, S[0]);
#pragma unroll
          for (int d = 1; d < kMaxD; ++d)
            if (d < nd) S[d] = fmaf(wy, lane4(yo[d], u), S[d]);
          R = fmaf(wr, y, R);
          Q = fmaf(wr, r, Q);
        }
      }
    }
    if (seg != kSegs - 1) continue;

    // -- the chunk's end: its blocks in order, each row's warp alike --
    float zin = 0.f, ai = 0.f;
    if (rank == 0) {
#pragma unroll 4
      for (int i = 0; i < nb; ++i) {
        const float e = __shfl_sync(kFull, z, i);
        const float h0 = __shfl_sync(kFull, g0, i), h1 = __shfl_sync(kFull, g1, i);
        if (lane == i) {
          zin = wz;
          ai = wa;
        }
        wz = fmaf(a128, wz, e);
        wa *= a128;
        wx = fmaf(a128, wx, e);
        km_step(ws0, ws1, at00, at01, at10, at11);
        ws0 += h0;
        ws1 += h1;
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < nb; ++i) {
        const float e = __shfl_sync(kFull, z, i);
        if (lane == i) {
          zin = wz;
          ai = wa;
        }
        wz = fmaf(a128, wz, e);
        wa *= a128;
      }
      if (live) {  // kept for the first CTA's walk
        const int i = chunk * kLanes + lane;
        sm.rng[0][i][c] = z;
        sm.rng[1][i][c] = g0;
        sm.rng[2][i][c] = g1;
      }
    }
    sm.zx[c][lane] = zin;
    sm.rx[c][lane] = R;
    __syncthreads();
    // the block's products with its entry state z (from the CTA's zero
    // state): S_ij + z_i R_j + z_j R_i + z_i z_j Q; the CTA's own entry
    // state Z adds Z_i U_j + Z_j U_i + Z_i Z_j V, U_c = a^i (R_c + z_c Q),
    // V = a^2i Q
    if (live) {
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (d < nd) {
          const int e = c + d < C ? c + d : c + d - C;
          const float ze = sm.zx[e][lane], Re = sm.rx[e][lane];
          tot[d] += fmaf(zin * ze, Q, fmaf(ze, R, fmaf(zin, Re, S[d])));
        }
      }
      U = fmaf(ai, fmaf(zin, Q, R), U);
      V = fmaf(ai * ai, Q, V);
    }
    // the next writes of zx and rx come a chunk of barriers later
  }

  // the CTA's sums, pushed into the first CTA (its own shared memory for it)
  cg::cluster_group cluster = cg::this_cluster();
  Smem<C>* lead = cluster.map_shared_rank(&sm, 0);
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) {
    const float v = warp_sum(tot[d]);
    const int e = c + d < C ? c + d : c + d - C;
    if (lane == 0 && d < nd) sm.acc[c <= e ? tri<C>(c, e) : tri<C>(e, c)] = v;
  }
  {
    const float u = warp_sum(U), v = warp_sum(V), m = warp_max(pk);
    if (lane == 0) {
      sm.acc[NM + c] = u;
      if (c == 0) sm.acc[NS - 1] = v;
      sm.pkc[c] = m;
    }
  }
  cluster_wait();  // every CTA of the cluster has started
  __syncthreads();
  for (int k = tid; k < NS; k += kThreads) lead->sums[rank].s[k] = sm.acc[k];
  if (tid < C) lead->sums[rank].pk[tid] = sm.pkc[tid];
  cluster.sync();  // every CTA's sums are in; the first CTA's ring is idle
  // the other CTAs' blocks: their end values and x^2 against G, into the
  // first CTA's ring
  const int rest = nblk - (split > 1 ? per : nblk);
  float* gath = reinterpret_cast<float*>(reinterpret_cast<char*>(lead) + ring_off);  // [3][rest][C]
  if (rank > 0) {
    for (int i = tid; i < n * C; i += kThreads) {
      const int blk = i / C, cc = i % C;
      const int f = (first - per + blk) * C + cc;
      gath[f] = sm.rng[0][blk][cc];
      gath[rest * C + f] = sm.rng[1][blk][cc];
      gath[2 * rest * C + f] = sm.rng[2][blk][cc];
    }
  }
  cluster.sync();  // pushed; only the first CTA goes on, on its own memory
  if (rank != 0) return;
  // the stream's carries, stepped block by block from the entry state as
  // the plain walk steps them: the first CTA's range was walked (wx, ws),
  // then the gathered blocks, on lane 0 of each row's warp
  gath = ring;
  if (lane == 0) {
    sm.zent[0][c] = zl0[o];
    for (int q = 1, f = 0; q < split; ++q) {
      sm.zent[q][c] = wx;  // the lowpass state entering CTA q
#pragma unroll 4
      for (const int end = min(nblk, (q + 1) * per) - per; f < end; ++f) {
        wx = fmaf(a128, wx, gath[f * C + c]);
        km_step(ws0, ws1, at00, at01, at10, at11);
        ws0 += gath[(rest + f) * C + c];
        ws1 += gath[(2 * rest + f) * C + c];
      }
    }
    zl_out[o] = wx;
    kmz_out[2 * o] = ws0;
    kmz_out[2 * o + 1] = ws1;
    float m = 0.f;
    for (int q = 0; q < split; ++q) m = fmaxf(m, sm.sums[q].pk[c]);
    pk_out[o] = m;
  }
  __syncthreads();
  if (tid < NM) {
    int i = 0;
    while (tid >= tri<C>(i, C - 1) + 1) ++i;
    const int j = i + (tid - tri<C>(i, i));
    float v = 0.f;
    for (int q = 0; q < split; ++q) {
      const Summary<C>* Rq = &sm.sums[q];
      const float Zi = sm.zent[q][i], Zj = sm.zent[q][j];
      v += fmaf(Zi * Zj, Rq->s[NS - 1],
                fmaf(Zj, Rq->s[NM + i], fmaf(Zi, Rq->s[NM + j], Rq->s[tid])));
    }
    sm.mtot[tid] = v;
  }
  __syncthreads();
  // the one-hot routing over every channel: sum_ij sa_i sb_j M_ij
  if (tid < 3 * P) {
    const int p = tid / 3, k = tid % 3;
    const float* ra = (k == 2 ? sel_b : sel_a) + p * C;
    const float* rb = (k == 1 ? sel_a : sel_b) + p * C;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
#pragma unroll
      for (int j = 0; j < C; ++j)
        v = fmaf(ra[i] * rb[j], sm.mtot[i <= j ? tri<C>(i, j) : tri<C>(j, i)], v);
    }
    pacc_out[((size_t)b * P + p) * 3 + k] = v;
  }
}

// cuTensorMapEncodeTiled from libcuda, found once through the runtime's entry points
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// `base` seen as [rows, 128] float32 in boxes of kLanes rows x kSeg samples,
// swizzled as swz() reads them
bool tensor_map(CUtensorMap* map, const float* base, unsigned long long rows) {
  const auto encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {kBlk, rows};
  const cuuint64_t strides[1] = {kBlk * sizeof(float)};
  const cuuint32_t box[2] = {kSeg, kLanes};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, kSwizzle, kPromote,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// CTAs (one cluster) a stream.  One where the streams alone give an SM a
// CTA each; else enough for an SM each in all, at most kMaxSplit, each
// range at most kMaxPer blocks and as even as the blocks allow, and the
// gathered blocks within the first CTA's ring (`cap` floats).
int choose_split(int B, int nblk, int C, int sms, int cap) {
  const int want = std::min({kMaxSplit, (sms + B - 1) / B, nblk});
  if (want <= 1) return 1;
  const int split = std::max(want, (nblk + kMaxPer - 1) / kMaxPer);
  if (split > kMaxSplit) return 1;
  const int per = (nblk + split - 1) / split;
  return (nblk - per) * 3 * C <= cap ? (nblk + per - 1) / per : 1;
}

template <int C, int P>
int launch(const float* x, const float* km_z, const float* zl, const float* sel_a,
           const float* sel_b, const float* wv, const float* km_at, const float* km_g,
           const float* lp_at, const float* lp_sy, float w1, float om1, float eps, int B,
           int T, float* kmz, float* zlo, float* pk, float* pacc, cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const size_t smem = smem_bytes<C>();
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(surround_wide_kernel<C, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = true;
  }
  const int nblk = T / kBlk;
  const int split = choose_split(B, nblk, C, sms, kStages * Dims<C>::kTile);
  if ((long long)B * split > 0x7fffffff || (long long)B * C * nblk > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmx, tmw;
  if (!tensor_map(&tmx, x, (unsigned long long)B * C * nblk) || !tensor_map(&tmw, wv, nblk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * split));
  cfg.blockDim = dim3(Dims<C>::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, surround_wide_kernel<C, P>, tmx, tmw, km_z, zl, sel_a, sel_b,
                         km_at, km_g, lp_at, lp_sy, w1, om1, eps, T, split, kmz, zlo, pk, pacc);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// The arguments of surround_fused_launch (surround_fused.cu), which the
// wrapper checks: device pointers x [B, C, T], km_z [B, C, 2], zl [B, C, 1],
// sel_a, sel_b [P, C], wv [T], the K-meter block operator's at [2, 2] and
// g [128, 2], the lowpass operator's at [1, 1] and sy [1, 128]; outputs
// kmz [B, C, 2], zlo [B, C, 1], pk [B, C], pacc [B, P, 3].  C is 3..8 with
// P = 4 pairs (3 when C == 3); x and wv are 16-byte aligned.
int surround_wide_launch(const float* x, const float* km_z, const float* zl,
                         const float* sel_a, const float* sel_b, const float* wv,
                         const float* km_at, const float* km_g, const float* lp_at,
                         const float* lp_sy, float w1, float om1, float eps, int B, int C,
                         int T, float* kmz, float* zlo, float* pk, float* pacc,
                         void* stream) {
  if (B <= 0 || T < kBlk || T % kBlk != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SURROUND_WIDE_CASE(NC, NP)                                                          \
  case NC:                                                                                 \
    return launch<NC, NP>(x, km_z, zl, sel_a, sel_b, wv, km_at, km_g, lp_at, lp_sy, w1,   \
                          om1, eps, B, T, kmz, zlo, pk, pacc, s);
  switch (C) {
    SURROUND_WIDE_CASE(3, 3)
    SURROUND_WIDE_CASE(4, 4)
    SURROUND_WIDE_CASE(5, 4)
    SURROUND_WIDE_CASE(6, 4)
    SURROUND_WIDE_CASE(7, 4)
    SURROUND_WIDE_CASE(8, 4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SURROUND_WIDE_CASE
}

}  // extern "C"
