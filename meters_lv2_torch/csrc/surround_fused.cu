// Surround meter hot path for NVIDIA Hopper (sm_90a): K-meter smoothers,
// block peaks, the correlator lowpass and the routed pair sums in one pass
// over the input.
//
// Replaces meters_lv2_tpu/ops/pallas_surround.py::fused_core (the Pallas TPU
// kernel).  For each stream b and channel c of x[b, c, 0:T], T % 128 == 0:
//   km_z'  the K-meter's grouped-4 two-stage smoother state on x^2
//          (kmeterdsp.cc:77-107), advanced per 128-sample block in the
//          blocked form s' = s @ At + x^2 @ G (host-built operator,
//          ops/lti.py grouped4_smoother_system(w).op(32)).  At[1][0] is
//          exactly 0 and is multiplied, not skipped: an infinite z2 makes z1
//          NaN as in the plain version's products;
//   pk     the block max of x^2, NaN samples skipped (kmeterdsp.cc:124):
//          fmaxf drops NaN and lets +Inf win, bit for bit the plain
//          version's max of where(isnan(q), 0, q);
//   zl'    the correlator one-pole lowpass state after the block, on x + eps
//          (stcorrdsp.cc:56-60);
// and for each routed pair p, with ya = sum_c sel_a[p][c] y_c and yb alike
// over EVERY channel (a non-finite y in any channel reaches every pair
// through 0 * NaN, as the JAX package's one-hot product does):
//   pacc   sum_t wv[t] (ya yb, ya ya, yb yb)(t), the closed-form weighted
//          sums of the w2 averages (the caller adds zp (1 - w2)^T).
//
// Arithmetic: IEEE fp32 FMAs, no tensor cores, no TF32, no fast math.  km_z
// and zl are stepped block by block exactly as the plain walk steps them, so
// they are the bits of csrc/surround_wide.cu (and of this kernel's parent
// body); pk is bit-exact.  The plain PyTorch version
// (ops/surround_fused.py::fused_core_reference) runs the same blocked
// recurrences as float32 matrix products, so the two agree to a stated
// tolerance; zl and pacc are non-finite where the plain version's are (the
// meter flushes both through isfinite).  Every sum is taken in a fixed
// order: two launches on the same input give the same bits.
//
// What bounds it: the function reads x once, B*C*T*4 bytes, and does about
// 9 fp32 operations a channel-sample plus 4C + 9 a pair-sample: it is bound
// by the bytes (at B = 256, T = 48000: 0.117 ms at C = 8 and 0.073 ms at
// C = 5 at 3.35 TB/s, against 0.04 ms of operations at C = 8).  The order in
// which the samples are consumed bounds it harder: the carries' bits need
// one thread to step each 128-sample block in order, so a CTA reads a slice
// of each of its blocks at a time, sectors 512 B apart, and the card
// delivers that pattern at about 2 TB/s (tools/surround_probe.py, the
// loads-only cut, PERF.md section 6).  The parent body
// (tools/surround_probe_parent.cu) ran one 128-thread CTA a stream (one SM
// for a live meter's stream), its lanes loading float4s 512 B apart just
// before use (half a sector each), and applied the routing as dense
// products per sample.
//
// What the design does about it:
//   * Each thread owns one block of its CTA's chunk (64 blocks at C >= 5,
//     128 at C = 4, 192 at C = 3).  The chunk's samples arrive through a ring of cp.async
//     stages in shared memory, 8 samples of every block a stage: each copy
//     moves a whole 32-byte sector (with a 128-byte L2 prefetch), and a
//     lane reads its block's samples as float4s laid out [stage][row]
//     [half][block], conflict-free.  The copies run kStages - 1 stages ahead
//     of the arithmetic, across chunk ends; the smaller CTAs at C >= 5 let
//     more of them share an SM.
//   * Where the streams alone do not give every SM a CTA (a live meter's
//     few streams), a stream's blocks are split over a thread-block cluster
//     of up to 8 CTAs, one chunk each.  The carries stay exact: the first
//     CTA walks its own range from the stream's entry state, the others push
//     their blocks' end values and x^2 G sums from registers into its ring
//     (idle by then) through distributed shared memory, and it walks on
//     through them, which also gives each CTA's lowpass entry state Z.
//   * The routing is applied once a stream, not per sample: each thread sums
//     the channel products S_ij = sum wv y_i y_j (i <= j) and
//     R_c = sum wv r y_c of its block's zero-state lowpass outputs (r_t =
//     (1 - w1)^(t+1)), C(C+1)/2 + C + 2 FMAs a sample in place of 5P + 2PC.
//     With the block's entry state z the true output is y + z r, so the
//     block adds S_ij + z_i R_j + z_j R_i + z_i z_j Q; the CTA's Z enters
//     through U_c = sum a^i (R_c + z_c Q) and V = sum a^2i Q.  The first CTA
//     contracts the stream's sums with the one-hot sel_a / sel_b over every
//     channel, so a non-finite channel still reaches every pair (0 * NaN),
//     and on finite data the contraction adds exact zeros.
//   * The per-chunk lowpass and K-meter walks run on two warps, one lane a
//     channel; each chunk's sums are reduced by warp butterflies in a fixed
//     order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

namespace cg = cooperative_groups;

constexpr int kBlk = 128;               // samples a block
constexpr int kSeg = 8;                 // samples of each block a stage
constexpr int kQ = kSeg / 4;            // float4s of each block a stage
constexpr int kSegs = kBlk / kSeg;      // stages a chunk
constexpr int kMaxSplit = 8;            // cluster size (portable)
constexpr int kMaxDevices = 64;

template <int C>
struct Dims {
  static constexpr int kRows = C + 1;               // the channels and wv
  static constexpr int kNm = C * (C + 1) / 2;       // S_ij, i <= j
  static constexpr int kNs = kNm + C + 1;           // S, U (or R), V (or Q)
  // threads a CTA, one a block of the chunk, and the ring's depth: at the
  // widths whose stages are larger, smaller CTAs and a shallower ring, so
  // that more CTAs share an SM (tools/surround_probe.py's sweep)
  static constexpr int kThreads = C == 3 ? 192 : C == 4 ? 128 : 64;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kStride = kThreads + 1;  // conflict-free column walks
  static constexpr int kTile = kRows * kQ * kThreads;  // float4s a stage
  static constexpr int kStages = C == 3 ? 4 : C == 4 ? 3 : 2;
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
  float e[C][Dims<C>::kStride];  // each block's zero-state lowpass end value
  float gin[C][2][Dims<C>::kStride];  // and its x^2 against G's columns
  float zin[C][Dims<C>::kStride];  // the lowpass state entering it, from the CTA's zero state
  float ai[Dims<C>::kThreads];  // a128^i, i the block's index in the CTA's range
  float acc[Dims<C>::kWarps][Dims<C>::kNs];
  float pkw[Dims<C>::kWarps][C];
  float zent[kMaxSplit][C];  // (first CTA) the lowpass state entering each CTA
  float mtot[Dims<C>::kNm];
  Summary<C> sums[kMaxSplit];  // (first CTA) every CTA's sums

  // the cp.async ring, after this struct in the dynamic shared memory
  __device__ float4* ring_base();
};

// the ring starts at the first float4 after Smem<C>
template <int C>
__host__ __device__ constexpr size_t ring_offset() {
  return (sizeof(Smem<C>) + sizeof(float4) - 1) / sizeof(float4);
}

template <int C>
constexpr size_t smem_bytes() {
  return (ring_offset<C>() + (size_t)Dims<C>::kStages * Dims<C>::kTile) * sizeof(float4);
}

template <int C>
__device__ __forceinline__ float4* Smem<C>::ring_base() {
  return reinterpret_cast<float4*>(this) + ring_offset<C>();
}

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
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
__global__ void __launch_bounds__(Dims<C>::kThreads)
surround_fused_kernel(const float* __restrict__ x, const float* __restrict__ km_z,
                      const float* __restrict__ zl0, const float* __restrict__ sel_a,
                      const float* __restrict__ sel_b, const float* __restrict__ wv,
                      const float* __restrict__ km_at, const float* __restrict__ km_g,
                      const float* __restrict__ lp_at, const float* __restrict__ lp_sy,
                      float w1, float om1, float eps, int T, int split,
                      float* __restrict__ kmz_out, float* __restrict__ zl_out,
                      float* __restrict__ pk_out, float* __restrict__ pacc_out) {
  using D = Dims<C>;
  constexpr int NM = D::kNm, NS = D::kNs, kStages = D::kStages;
  constexpr int kThreads = D::kThreads, kWarps = D::kWarps;
  extern __shared__ float4 dyn[];
  Smem<C>& sm = *reinterpret_cast<Smem<C>*>(dyn);
  float4* ring = sm.ring_base();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x % split;
  const int b = blockIdx.x / split;
  const int nblk = T / kBlk;
  const int per = (nblk + split - 1) / split;
  const int first = rank * per;
  const int n = min(per, nblk - first);  // >= 1: the launcher's split
  const int nchunks = (n + kThreads - 1) / kThreads;
  const int total = nchunks * kSegs;
  cluster_arrive_relaxed();  // waited on before the first push into the first CTA

  if (tid < kBlk / 4) {
    sm.g4[0][tid] = make_float4(km_g[8 * tid], km_g[8 * tid + 2], km_g[8 * tid + 4],
                                km_g[8 * tid + 6]);
    sm.g4[1][tid] = make_float4(km_g[8 * tid + 1], km_g[8 * tid + 3], km_g[8 * tid + 5],
                                km_g[8 * tid + 7]);
    sm.sy4[tid] = reinterpret_cast<const float4*>(lp_sy)[tid];
  }
  for (int i = tid; i < kWarps * NS; i += kThreads) (&sm.acc[0][0])[i] = 0.f;

  // the copies of stage `s` (chunk s / kSegs, samples kSeg (s % kSegs) on of
  // each block): thread tid moves float4 tid % kQ of blocks tid / kQ + h
  // kThreads / kQ of every row, so a warp's copy is whole 32-byte sectors
  const float* xb = x + (size_t)b * C * T;
  auto issue = [&](int s) {
    if (s < total) {
      const int chunk = s / kSegs;
      const int blk0 = first + chunk * kThreads;
      const int nb = min(kThreads, n - chunk * kThreads);
      const int part = tid % kQ;
      const int t0 = (s % kSegs) * kSeg + 4 * part;
      float4* dst = ring + (s % kStages) * D::kTile + part * kThreads;
#pragma unroll
      for (int h = 0; h < kQ; ++h) {
        const int i = tid / kQ + h * (kThreads / kQ);
        if (i < nb) {
          const size_t off = (size_t)(blk0 + i) * kBlk + t0;
#pragma unroll
          for (int r = 0; r < C; ++r)
            cp_async16(dst + r * kQ * kThreads + i, xb + (size_t)r * T + off);
          cp_async16(dst + C * kQ * kThreads + i, wv + off);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  const float at00 = km_at[0], at01 = km_at[1], at10 = km_at[2], at11 = km_at[3];
  const float a128 = lp_at[0];
  // the walkers: on warp 0 the lowpass from the CTA's zero state (wz, for
  // the sums) and, in the first CTA, from the stream's entry state (wx);
  // lane C keeps a128^i; on warp 1 the first CTA's K-meter state
  float wz = 0.f, wx = 0.f, wa = 1.f, ws0 = 0.f, ws1 = 0.f;
  if (rank == 0 && lane < C) {
    const size_t o = (size_t)b * C + lane;
    wx = zl0[o];
    ws0 = km_z[2 * o];
    ws1 = km_z[2 * o + 1];
  }
  float pk[C];
#pragma unroll
  for (int c = 0; c < C; ++c) pk[c] = 0.f;
  // this thread's block: per-channel zero-state sums, then the channel sums
  float z[C], g0[C], g1[C], S[NS];

  for (int s = 0; s < total; ++s) {
    const int chunk = s / kSegs, seg = s % kSegs;
    const int nb = min(kThreads, n - chunk * kThreads);
    if (seg == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) z[c] = g0[c] = g1[c] = 0.f;
#pragma unroll
      for (int k = 0; k < NS; ++k) S[k] = 0.f;
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s has landed; every thread is done with stage s - 1
    issue(s + kStages - 1);
    if (tid < nb) {
      const float4* tile = ring + (s % kStages) * D::kTile + tid;
#pragma unroll
      for (int hj = 0; hj < kQ; ++hj) {
        float4 xv[C + 1];
#pragma unroll
        for (int r = 0; r <= C; ++r) xv[r] = tile[(kQ * r + hj) * kThreads];
        const int q4 = seg * kQ + hj;
        const float4 G0 = sm.g4[0][q4], G1 = sm.g4[1][q4], SY = sm.sy4[q4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          // -- one sample of every channel --
          const float gk0 = lane4(G0, u), gk1 = lane4(G1, u), r = lane4(SY, u);
          const float wt = lane4(xv[C], u), wr = wt * r;
          float wy[C];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float v = lane4(xv[c], u);
            const float q = v * v;
            pk[c] = fmaxf(pk[c], q);
            g0[c] = fmaf(q, gk0, g0[c]);
            g1[c] = fmaf(q, gk1, g1[c]);
            z[c] = fmaf(om1, z[c], w1 * (v + eps));
            wy[c] = wt * z[c];
          }
#pragma unroll
          for (int i = 0; i < C; ++i) {
#pragma unroll
            for (int j = i; j < C; ++j) S[tri<C>(i, j)] = fmaf(wy[i], z[j], S[tri<C>(i, j)]);
            S[NM + i] = fmaf(wr, z[i], S[NM + i]);
          }
          S[NS - 1] = fmaf(wr, r, S[NS - 1]);
          // -- end of the sample --
        }
      }
    }
    if (seg != kSegs - 1) continue;

    // the chunk's end: its blocks' entry states, in order
    if (tid < nb) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        sm.e[c][tid] = z[c];
        sm.gin[c][0][tid] = g0[c];
        sm.gin[c][1][tid] = g1[c];
      }
    }
    __syncthreads();
    if (warp == 0 && lane < C) {
#pragma unroll 4
      for (int i = 0; i < nb; ++i) {
        const float e = sm.e[lane][i];
        sm.zin[lane][i] = wz;
        wz = fmaf(a128, wz, e);
        wx = fmaf(a128, wx, e);
      }
    } else if (warp == 0 && lane == C) {
      for (int i = 0; i < nb; ++i) {
        sm.ai[i] = wa;
        wa *= a128;
      }
    } else if (warp == 1 && lane < C && rank == 0) {
#pragma unroll 4
      for (int i = 0; i < nb; ++i) {
        km_step(ws0, ws1, at00, at01, at10, at11);
        ws0 += sm.gin[lane][0][i];
        ws1 += sm.gin[lane][1][i];
      }
    }
    __syncthreads();
    // the block's sums with its entry state z (from the CTA's zero state):
    // S_ij + z_i R_j + z_j R_i + z_i z_j Q; the CTA's own entry state Z adds
    // Z_i U_j + Z_j U_i + Z_i Z_j V with U_c = a^i (R_c + z_c Q), V = a^2i Q
    if (tid < nb) {
      float zi[C];
#pragma unroll
      for (int c = 0; c < C; ++c) zi[c] = sm.zin[c][tid];
      const float a = sm.ai[tid], Q = S[NS - 1];
#pragma unroll
      for (int i = 0; i < C; ++i) {
#pragma unroll
        for (int j = i; j < C; ++j) {
          const int k = tri<C>(i, j);
          S[k] = fmaf(zi[i] * zi[j], Q, fmaf(zi[j], S[NM + i], fmaf(zi[i], S[NM + j], S[k])));
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) S[NM + c] = a * fmaf(zi[c], Q, S[NM + c]);
      S[NS - 1] = a * a * Q;
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const float v = warp_sum(S[k]);
      if (lane == 0) sm.acc[warp][k] += v;
    }
  }

  // the CTA's sums, pushed into the first CTA (its own shared memory for it)
  cg::cluster_group cluster = cg::this_cluster();
  Smem<C>* lead = cluster.map_shared_rank(&sm, 0);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float m = warp_max(pk[c]);
    if (lane == 0) sm.pkw[warp][c] = m;
  }
  cluster_wait();  // every CTA of the cluster has started
  __syncthreads();
  for (int k = tid; k < NS; k += kThreads) {
    float v = sm.acc[0][k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += sm.acc[w][k];
    lead->sums[rank].s[k] = v;
  }
  if (tid < C) {
    float m = sm.pkw[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, sm.pkw[w][tid]);
    lead->sums[rank].pk[tid] = m;
  }
  cluster.sync();  // every CTA's sums are in; the first CTA's ring is idle
  // the other CTAs' blocks (one chunk each): their end values and x^2
  // against G, from the registers that hold them, into the first CTA's ring
  const int rest = nblk - (split > 1 ? per : nblk);
  float* gath = reinterpret_cast<float*>(lead->ring_base());  // [3][rest][C]
  if (rank > 0 && tid < n) {
    const int f = (first - per + tid) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gath[f + c] = z[c];
      gath[rest * C + f + c] = g0[c];
      gath[2 * rest * C + f + c] = g1[c];
    }
  }
  cluster.sync();  // pushed; only the first CTA goes on, on its own memory
  if (rank == 0) {
    // the stream's carries, stepped block by block from the entry state as
    // the plain walk steps them: its own range walked (wx, ws), then the
    // gathered blocks
    gath = reinterpret_cast<float*>(ring);
    const size_t o = (size_t)b * C + lane;
    if (warp == 0 && lane < C) {
      sm.zent[0][lane] = zl0[o];
      for (int q = 1, f = 0; q < split; ++q) {
        sm.zent[q][lane] = wx;  // the lowpass state entering CTA q
#pragma unroll 8
        for (const int end = min(nblk, (q + 1) * per) - per; f < end; ++f)
          wx = fmaf(a128, wx, gath[f * C + lane]);
      }
      zl_out[o] = wx;
    } else if (warp == 1 && lane < C) {
#pragma unroll 8
      for (int f = 0; f < rest; ++f) {
        km_step(ws0, ws1, at00, at01, at10, at11);
        ws0 += gath[(rest + f) * C + lane];
        ws1 += gath[(2 * rest + f) * C + lane];
      }
      kmz_out[2 * o] = ws0;
      kmz_out[2 * o + 1] = ws1;
    } else if (warp == 0 && lane >= 16 && lane < 16 + C) {
      float m = 0.f;
      for (int q = 0; q < split; ++q) m = fmaxf(m, sm.sums[q].pk[lane - 16]);
      pk_out[(size_t)b * C + lane - 16] = m;
    }
    __syncthreads();
    if (tid < NM) {
      int i = 0;
      while (tid >= tri<C>(i, C - 1) + 1) ++i;
      const int j = i + (tid - tri<C>(i, i));
      float v = 0.f;
      for (int q = 0; q < split; ++q) {
        const Summary<C>* R = &sm.sums[q];
        const float Zi = sm.zent[q][i], Zj = sm.zent[q][j];
        v += fmaf(Zi * Zj, R->s[NS - 1],
                  fmaf(Zj, R->s[NM + i], fmaf(Zi, R->s[NM + j], R->s[tid])));
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
}

// CTAs (one cluster) a stream.  One where the streams alone give an SM a
// CTA each; else enough for an SM each in all, at most kMaxSplit, each range
// one chunk (the first CTA gathers the others' blocks at the end), as even
// as the blocks allow, and the gathered blocks within the ring's `cap` floats.
int choose_split(int B, int nblk, int C, int threads, int sms, int cap) {
  const int want = std::min({kMaxSplit, (sms + B - 1) / B, nblk});
  if (want <= 1) return 1;
  const int per = std::min(threads, (nblk + want - 1) / want);
  const int split = (nblk + per - 1) / per;
  return split <= kMaxSplit && (nblk - per) * 3 * C <= cap ? split : 1;
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
    e = cudaFuncSetAttribute(surround_fused_kernel<C, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = true;
  }
  const int nblk = T / kBlk;
  const int split = choose_split(B, nblk, C, Dims<C>::kThreads, sms,
                                 Dims<C>::kStages * Dims<C>::kTile * 4);
  if ((long long)B * split > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
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
  e = cudaLaunchKernelEx(&cfg, surround_fused_kernel<C, P>, x, km_z, zl, sel_a, sel_b, wv,
                         km_at, km_g, lp_at, lp_sy, w1, om1, eps, T, split, kmz, zlo, pk, pacc);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// All pointers are device pointers: x [B, C, T], km_z [B, C, 2], zl [B, C, 1],
// sel_a, sel_b [P, C], wv [T], the K-meter block operator's at [2, 2] and
// g [128, 2], the lowpass operator's at [1, 1] and sy [1, 128]; outputs
// kmz [B, C, 2], zlo [B, C, 1], pk [B, C], pacc [B, P, 3].  C is 3..8 with
// P = 4 pairs (3 when C == 3); x and wv are 16-byte aligned.
int surround_fused_launch(const float* x, const float* km_z, const float* zl,
                          const float* sel_a, const float* sel_b, const float* wv,
                          const float* km_at, const float* km_g, const float* lp_at,
                          const float* lp_sy, float w1, float om1, float eps, int B, int C,
                          int T, float* kmz, float* zlo, float* pk, float* pacc,
                          void* stream) {
  if (B <= 0 || T < kBlk || T % kBlk != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SURROUND_CASE(NC, NP)                                                              \
  case NC:                                                                                 \
    return launch<NC, NP>(x, km_z, zl, sel_a, sel_b, wv, km_at, km_g, lp_at, lp_sy, w1,   \
                          om1, eps, B, T, kmz, zlo, pk, pacc, s);
  switch (C) {
    SURROUND_CASE(3, 3)
    SURROUND_CASE(4, 4)
    SURROUND_CASE(5, 4)
    SURROUND_CASE(6, 4)
    SURROUND_CASE(7, 4)
    SURROUND_CASE(8, 4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SURROUND_CASE
}

}  // extern "C"
