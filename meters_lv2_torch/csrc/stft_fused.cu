// STFT display analyzers for NVIDIA Hopper (sm_90a): framing, window, a
// real DFT per channel and the per-bin analysis of the phase wheel and the
// stereoscope, in one pass over the sample stream.
//
// Replaces meters_lv2_tpu/ops/pallas_stft.py::_frames (the Pallas TPU kernel
// behind analyzer_frames).  For each stream b and frame f < F of
// ext[b, c, 0:L] (c = 0 left, 1 right), frame f is
// ext[b, c, hop*(f+1) + n] * win[n], n < W, and its real DFT X_c[k],
// k < N = W/2, gives per mode:
//   raw          out_a[b, c, f, k] = Re X_c[k], out_b = Im X_c[k];
//   phasewheel   P_c = |X_c|^2 with P_c[N-1] = 0 (fft.c:166-178),
//                phi_c = atan2(Im, Re) with phi_c[0] = phi_c[N-1] = 0;
//                ok = P_L >= thr && P_R >= thr; out_a[b, f, k] =
//                ok ? phi_R - phi_L : 0, out_b = ok ? max(P_L, P_R) : -100;
//   stereoscope  ok = P_L >= thr || P_R >= thr, lv = max(P_L, P_R) with NaN
//                propagated (jnp.maximum / torch.maximum: fmaxf would drop
//                it); out_a = ok ? 0.5 + 0.5 (sqrt P_R - sqrt P_L) /
//                sqrt(max(lv, 1e-30)) : 0.5, out_b = ok ? lv : 0.
// Outputs are written in bin order.
//
// Arithmetic: IEEE fp32, no tensor cores, no fast math (sqrtf and the
// divisions are the correctly rounded forms).  The twiddles are host tables
// built in float64 (ops/stft_fused.py twiddles, pass_twiddles).  nvcc
// contracts the butterflies and re*re + im*im into FMAs, so the kernel
// agrees with the plain version (torch.fft.rfft) to float32 FFT rounding,
// about 1e-7 of the frame's peak magnitude, not bit for bit.
//
// Why not the TPU's design: the Pallas kernel was a two-stage 64 x 128 DFT
// as matrix products with 6-pass bf16 splits, for the MXU.  On this card an
// FFT in shared memory does about 25x less arithmetic, and tensor cores
// would put TF32 where the -60 dB display bins need fp32.
//
// What bounds it: at the main-path shape (B = 256 streams, W = 8192,
// hop 1920, F = 25) the function reads ext once (111 MB) and writes two
// [B, F, W/2] outputs (210 MB): 0.096 ms at 3.35 TB/s, against 0.073 ms of
// fp32 operations.  It is bound by bytes.  Neither body gets near it: the
// generic body by the L1 wavefronts of its twiddle loads, the Hopper body by
// the instructions of its FFT passes (about 60 % of its time) and of the
// phase (tools/stft_probe.py).
//
// Two bodies, both one CTA per (stream, frame) holding both channels, so
// frames are independent and B*F CTAs fill the card.  Each channel goes
// through the standard real-FFT packing z[m] = x[2m] + i x[2m+1] into a
// W/2-point complex FFT held in shared memory (2 x N x 8 B = 64 KB at W =
// 8192), a Stockham autosort FFT of radix-16 passes: each thread holds one
// 16-point DFT in registers, so N = 4096 takes three passes over shared
// memory.  The first pass reads the windowed samples straight from device
// memory (frames overlap W/hop times; L2 serves the re-reads), and
// shared-memory indices are XOR-swizzled within rows of 16 so that the
// strided stores of the early passes do not fall on one bank.
// stft_fused_body(W) says which body a window runs.
//
// The Hopper body (W = 8192, the analyzers' window).  The first body loaded
// each pass's twiddles from one table e^{-i pi k / N} at k = r (j mod Ns)
// 2N / (16 Ns), folded past N: lanes strided by up to 240 bytes, so each
// load touched up to 32 L1 lines, and those loads alone took 0.21 of its
// 0.58 ms (probe: the body with constant twiddles).  Here each pass has its
// own table laid out [r][j], so a warp's load of twiddle r is one
// contiguous 256-byte run at an immediate offset from one base.  The two
// channels' FFTs are independent until the epilogue, so each channel's
// threads synchronise with a named barrier of their own (bar.sync 1 + c),
// not the CTA's.  A thread untangles a pair of bins, X[k] = E + w O and
// X[N-k] = conj(E - w O) from the same two loads and one twiddle; then
// thread j of the left channel and thread j of the right swap halves of
// their bins through shared memory, with only their two warps meeting at a
// barrier (bar.sync 3 + warp, 64), and each computes and writes the outputs
// of one half from both channels' X.  The phase wheel's phase difference is
// one atan2f of X_R conj(X_L) with the multiple of 2 pi that the two
// quadrants fix (two atan2f where a part is zero, infinite or NaN or the
// product's range is unsafe), and a warp whose bins all fail the threshold
// test computes none.  A polynomial atan2 (one division, the Cephes atanf
// polynomial) in place of atan2f gained nothing here, so atan2f stays
// (tools/stft_probe.py, variant kernel-poly).  CTAs of 512 threads, two an
// SM (64 registers, 64 KB of shared memory each); two 16-point DFTs a
// thread at three CTAs an SM needed 80 registers, spilled, and ran 0.60 ms
// against 0.34 (H100, tools/stft_probe.py).
//
// The generic body (W = 256 .. 4096): the first design, as it was: one
// table e^{-i pi k / N} for the twiddles, CTA-wide barriers, the untangle
// one bin a thread-iteration and atan2f.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

enum Mode { kRaw = 0, kPhaseWheel = 1, kStereoscope = 2 };

// max that returns NaN when either operand is NaN (torch.maximum)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__host__ __device__ constexpr int brev_bits(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// shared-memory position of complex element i of a channel: i with its low
// four bits XORed by the next four (a bijection on each row of 16 float2)
__device__ __forceinline__ int sw(int i) { return i ^ ((i >> 4) & 15); }

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// d * e^{-2 pi i k / 16}, 0 <= k < 8; k is a constant after unrolling
__device__ __forceinline__ float2 rot16(float2 d, int k) {
  constexpr float a = 0.92387953251128674f;  // cos(pi/8)
  constexpr float b = 0.38268343236508977f;  // sin(pi/8)
  constexpr float h = 0.70710678118654752f;  // cos(pi/4)
  float c, s;
  switch (k) {
    case 0: return d;
    case 4: return make_float2(d.y, -d.x);
    case 1: c = a; s = b; break;
    case 2: c = h; s = h; break;
    case 3: c = b; s = a; break;
    case 5: c = -b; s = a; break;
    case 6: c = -h; s = h; break;
    default: c = -a; s = b; break;
  }
  return make_float2(d.x * c + d.y * s, d.y * c - d.x * s);
}

// in-register R-point DFT (R = 2, 4, 8, 16), radix-2 decimation in
// frequency: natural order in, output k at v[brev(k)]
template <int R>
__device__ __forceinline__ void dft_reg(float2 (&v)[R]) {
  constexpr int LR = R == 16 ? 4 : R == 8 ? 3 : R == 4 ? 2 : 1;
  // both loops have constant trip counts, so every index below is a
  // constant after unrolling and v stays in registers
#pragma unroll
  for (int s = 0; s < LR; ++s) {
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const int half = R >> (s + 1);
      const int p = i & (half - 1);
      const int lo = ((i - p) << 1) + p;
      const float2 a = v[lo], b = v[lo + half];
      v[lo] = make_float2(a.x + b.x, a.y + b.y);
      v[lo + half] = rot16(make_float2(a.x - b.x, a.y - b.y), p * (8 / half));
    }
  }
}

// ---------------------------------------------------------------------------
// The generic body (W = 256 .. 4096)

constexpr int kThreads = 512;

// one Stockham pass of radix R after passes whose radices multiply to Ns:
// thread (c, j), j < N/R, reads Z[j + r N/R], twiddles them by
// e^{-2 pi i r (j mod Ns) / (Ns R)}, takes their R-point DFT and writes
// output r to Z[(j - j mod Ns) R + j mod Ns + r Ns], in place (all reads
// before a barrier, all writes after it)
template <int LOG2N, int R>
__device__ __forceinline__ void stockham_pass(float2* z, const float2* __restrict__ tw, int tid,
                                              int Ns) {
  constexpr int N = 1 << LOG2N;
  constexpr int M = N / R;
  constexpr int LR = R == 16 ? 4 : R == 8 ? 3 : R == 4 ? 2 : 1;
  static_assert(2 * M <= kThreads, "one DFT per thread and pass");
  const bool act = tid < 2 * M;
  const int c = tid / M, j = tid % M;
  const int jm = j & (Ns - 1);
  float2 v[R];
  if (act) {
    float2* zc = z + c * N;
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = zc[sw(j + r * M)];
    // e^{-2 pi i r jm / (Ns R)} is tw[k] = e^{-i pi k / N} at k = r jm 2N / (Ns R),
    // and -tw[k - N] past N
    const int step = jm * ((2 * N / R) / Ns);
#pragma unroll
    for (int r = 1; r < R; ++r) {
      const int k = r * step;
      float2 w = tw[k < N ? k : k - N];
      if (k >= N) w = make_float2(-w.x, -w.y);
      v[r] = cmul(v[r], w);
    }
    dft_reg<R>(v);
  }
  __syncthreads();
  if (act) {
    float2* zc = z + c * N;
    const int base = (j - jm) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) zc[sw(base + r * Ns)] = v[brev_bits(r, LR)];
  }
  __syncthreads();
}

template <int LOG2N>
__global__ void __launch_bounds__(kThreads, 2)
stft_generic_kernel(const float* __restrict__ ext, const float* __restrict__ win,
                    const float2* __restrict__ tw, int L, int hop, int F, int mode, float thr,
                    float* __restrict__ out_a, float* __restrict__ out_b) {
  constexpr int N = 1 << LOG2N;  // complex points per channel = output bins
  constexpr int M = N / 16;      // 16-point DFTs per channel and pass
  extern __shared__ float2 z[];  // [2][N], swizzled
  const int tid = threadIdx.x;
  const int b = blockIdx.x / F;
  const int f = blockIdx.x - b * F;
  const float* x = ext + (size_t)b * 2 * L + (size_t)hop * (f + 1);

  // pass 1 (Ns = 1, no twiddles): thread (c, j) reads z[j + r N/16],
  // r < 16, straight from device memory, windowed on the load (float2
  // loads where the frame is 8-byte aligned: even L and hop)
  if (tid < 2 * M) {
    const int c = tid / M, j = tid % M;
    const float* xc = x + (size_t)c * L;
    const float2* w2 = reinterpret_cast<const float2*>(win);
    float2 v[16];
    if (((reinterpret_cast<uintptr_t>(xc)) & 7) == 0) {
      const float2* x2 = reinterpret_cast<const float2*>(xc);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float2 s = x2[j + r * M], w = w2[j + r * M];
        v[r] = make_float2(s.x * w.x, s.y * w.y);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int m = j + r * M;
        const float2 w = w2[m];
        v[r] = make_float2(xc[2 * m] * w.x, xc[2 * m + 1] * w.y);
      }
    }
    dft_reg<16>(v);
    float2* zc = z + c * N;
#pragma unroll
    for (int r = 0; r < 16; ++r) zc[sw(j * 16 + r)] = v[brev_bits(r, 4)];
  }
  __syncthreads();
  int Ns = 16;
#pragma unroll 1
  for (int p = 1; p < LOG2N / 4; ++p, Ns *= 16) stockham_pass<LOG2N, 16>(z, tw, tid, Ns);
  if constexpr (LOG2N % 4 != 0) stockham_pass<LOG2N, (1 << (LOG2N % 4))>(z, tw, tid, Ns);

  // untangle and the mode's epilogue, one bin per thread-iteration:
  // E = (Z[k] + conj Z[N-k]) / 2, O = (Z[k] - conj Z[N-k]) / 2i,
  // X[k] = E + e^{-i pi k / N} O
  for (int k = tid; k < N; k += kThreads) {
    const int kc = (N - k) & (N - 1);
    const float2 w = tw[k];
    float re[2], im[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float2 p = z[c * N + sw(k)];
      const float2 q = z[c * N + sw(kc)];
      const float er = 0.5f * (p.x + q.x), ei = 0.5f * (p.y - q.y);
      const float orr = 0.5f * (p.y + q.y), oi = 0.5f * (q.x - p.x);
      re[c] = er + w.x * orr - w.y * oi;
      im[c] = ei + w.x * oi + w.y * orr;
    }
    if (mode == kRaw) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const size_t o = (((size_t)b * 2 + c) * F + f) * N + k;
        out_a[o] = re[c];
        out_b[o] = im[c];
      }
      continue;
    }
    float pl = re[0] * re[0] + im[0] * im[0];
    float pr = re[1] * re[1] + im[1] * im[1];
    if (k == N - 1) pl = pr = 0.f;
    const size_t o = ((size_t)b * F + f) * N + k;
    if (mode == kPhaseWheel) {
      const bool edge = k == 0 || k == N - 1;
      const float phl = edge ? 0.f : atan2f(im[0], re[0]);
      const float phr = edge ? 0.f : atan2f(im[1], re[1]);
      const bool ok = pl >= thr && pr >= thr;  // neither is NaN where ok
      out_a[o] = ok ? phr - phl : 0.f;
      out_b[o] = ok ? fmaxf(pl, pr) : -100.f;
    } else {
      const float lv = nan_max(pl, pr);
      const bool ok = pl >= thr || pr >= thr;
      const float pos = 0.5f + 0.5f * (sqrtf(pr) - sqrtf(pl)) / sqrtf(nan_max(lv, 1e-30f));
      out_a[o] = ok ? pos : 0.5f;
      out_b[o] = ok ? lv : 0.f;
    }
  }
}

template <int LOG2N>
int launch_generic(const float* ext, const float* win, const float* tw, int B, int L, int hop,
                   int F, int mode, float thr, float* out_a, float* out_b, cudaStream_t stream) {
  constexpr int smem = 2 * (1 << LOG2N) * (int)sizeof(float2);
  // above 48 KB only as opted-in dynamic shared memory; set once
  static const cudaError_t attr = cudaFuncSetAttribute(
      stft_generic_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  stft_generic_kernel<LOG2N><<<B * F, kThreads, smem, stream>>>(
      ext, win, reinterpret_cast<const float2*>(tw), L, hop, F, mode, thr, out_a, out_b);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The Hopper body (W = 8192)

constexpr int kW = 8192;        // the window it is built for
constexpr int kN = kW / 2;      // complex points a channel = output bins
constexpr int kM = kN / 16;     // 16-point DFTs a channel and pass
constexpr int kTw3 = 15 * 16;   // pass 3's table starts here in ptw
constexpr int kT = 256;         // threads a channel: one 16-point DFT each a pass

// barrier `id` over the n threads (whole warps) that name it; id 0 is
// __syncthreads'
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// pass 1 (Ns = 1, no twiddles): DFT jj < 256 of a channel reads
// z[jj + 256 r], r < 16, straight from device memory, windowed on the load
// (float2 loads where the frame is 8-byte aligned), and writes output r to
// Z[16 jj + r], swizzled
__device__ __forceinline__ void first_pass(const float* x, const float* __restrict__ win,
                                           float2* z, int jj) {
  const float2* w2 = reinterpret_cast<const float2*>(win);
  float2 v[16];
  if ((reinterpret_cast<uintptr_t>(x) & 7) == 0) {
    const float2* x2 = reinterpret_cast<const float2*>(x) + jj;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float2 s = x2[kM * r], w = w2[jj + kM * r];
      v[r] = make_float2(s.x * w.x, s.y * w.y);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int m = jj + kM * r;
      const float2 w = w2[m];
      v[r] = make_float2(x[2 * m] * w.x, x[2 * m + 1] * w.y);
    }
  }
  dft_reg<16>(v);
  float2* row = z + 16 * jj;
  const int s = jj & 15;
#pragma unroll
  for (int r = 0; r < 16; ++r) row[r ^ s] = v[brev_bits(r, 4)];
}

// the Stockham pass after passes whose radices multiply to NS (16 or 256):
// DFT jj < 256 reads Z[jj + 256 r] (swizzled: sw(jj) + 256 r), twiddles
// them by e^{-2 pi i r (jj mod NS) / (16 NS)} = tab[NS (r - 1) + jj mod NS]
// and writes output r to Z[(jj - jj mod NS) 16 + jj mod NS + NS r]:
// swizzled after pass 2 (column (jj mod 16) ^ r of row 16 (jj / 16) + r),
// in natural order after pass 3 (Z[jj + 256 r], which the epilogue reads).
// In place: the reads before the channel's barrier, the writes after it.
template <int NS>
__device__ __forceinline__ void mid_pass(float2* z, const float2* __restrict__ tab, int jj,
                                         int bar) {
  float2 v[16];
  const float2* src = z + sw(jj);
  const float2* t = tab + (jj & (NS - 1));
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = src[kM * r];
#pragma unroll
  for (int r = 1; r < 16; ++r) v[r] = cmul(v[r], t[NS * (r - 1)]);
  dft_reg<16>(v);
  bar_sync(bar, kT);
  if (NS == 16) {
    const int jm = jj & 15;
    float2* dst = z + (jj - jm) * 16;
#pragma unroll
    for (int r = 0; r < 16; ++r) dst[16 * r + (jm ^ r)] = v[brev_bits(r, 4)];
  } else {
#pragma unroll
    for (int r = 0; r < 16; ++r) z[jj + kM * r] = v[brev_bits(r, 4)];
  }
  bar_sync(bar, kT);
}

// X[k] and X[N-k] of a channel's real DFT from its complex FFT Z, sharing
// both loads and the twiddle w = e^{-i pi k / N}: E = (Z[k] + conj Z[N-k])
// / 2, O = (Z[k] - conj Z[N-k]) / 2i, X[k] = E + w O, X[N-k] = conj(E - w O)
__device__ __forceinline__ void untangle(float2 p, float2 q, float2 w, float2& lo, float2& hi) {
  const float ex = p.x + q.x, ey = p.y - q.y;
  const float ox = p.y + q.y, oy = q.x - p.x;
  const float tx = w.x * ox - w.y * oy, ty = w.x * oy + w.y * ox;
  lo = make_float2(0.5f * (ex + tx), 0.5f * (ey + ty));
  hi = make_float2(0.5f * (ex - tx), 0.5f * (ty - ey));
}

// pair i of thread j: bins lo = k = j + 256 i and hi = N - k, but the pair
// of k = 0 holds X[0] and the Nyquist bin, so there hi is bin N/2, its own
// pair (Z[N - k] at z + N - j - 256 i: offsets from one base for i > 0)
__device__ __forceinline__ int bin_pair(const float2* z, const float2* __restrict__ tw, int j,
                                        int i, float2& lo, float2& hi) {
  const int k = j + kT * i;
  const bool nyq = i == 0 && j == 0;
  untangle(z[k], z[nyq ? 0 : kN - k], tw[k], lo, hi);
  if (nyq) {
    const float2 h = z[kN / 2];
    float2 unused;
    untangle(h, h, tw[kN / 2], hi, unused);
    return kN / 2;
  }
  return kN - k;
}

// the phase of r less the phase of l where r conj(l) could lose the angle:
// two atan2 (out of line: rare, and it keeps the unrolled epilogue small)
__device__ __noinline__ float phase_difference_apart(float2 l, float2 r) {
  return atan2f(r.y, r.x) - atan2f(l.y, l.x);
}

// atan2(r.y, r.x) - atan2(l.y, l.x), in [-2 pi, 2 pi]: one atan2 of
// r conj(l) gives it modulo 2 pi where |l| |r| lies in [2^-100, 2^100], and
// the multiple of 2 pi added is the one that brings it nearest the
// difference of the two quadrants' centres, which the sign bits give
// exactly (each phase lies within pi/4 of its centre, so the nearest is
// unique even where the product's angle rounds across +-pi).  As close to
// the difference in float64 as two atan2 are (tests/test_torch_stft_body.py).
// Zero, infinite or NaN parts, or |l| |r| outside that range: two atan2.
__device__ __forceinline__ float phase_difference(float2 l, float2 r) {
  constexpr float k2PiHi = 6.2831854820251465f, k2PiLo = -1.7484555314695172e-07f;
  const float m = fmaxf(fabsf(l.x), fabsf(l.y)) * fmaxf(fabsf(r.x), fabsf(r.y));
  if (!(m >= 0x1p-100f && m <= 0x1p100f)) return phase_difference_apart(l, r);
  const float w = atan2f(fmaf(r.y, l.x, -(r.x * l.y)), fmaf(r.x, l.x, r.y * l.y));
  // quadrant centres in units of pi/4: +-1 or +-3, the sign the imaginary part's
  const float ql = copysignf(__float_as_int(l.x) < 0 ? 3.f : 1.f, l.y);
  const float qr = copysignf(__float_as_int(r.x) < 0 ? 3.f : 1.f, r.y);
  const float k = rintf(fmaf(-w, 0.15915493667125702f, 0.125f * (qr - ql)));
  return fmaf(k, k2PiHi, fmaf(k, k2PiLo, w));
}

// the outputs of a bin from the left and right channels' X
template <int kMode>
__device__ __forceinline__ float2 combine(float2 l, float2 r, int bin, float thr) {
  const float pl = bin == kN - 1 ? 0.f : l.x * l.x + l.y * l.y;
  const float pr = bin == kN - 1 ? 0.f : r.x * r.x + r.y * r.y;
  if (kMode == kPhaseWheel) {
    const bool ok = pl >= thr && pr >= thr;  // neither is NaN where ok
    // a warp whose bins all fail the test computes no phase
    float d = 0.f;
    if (__any_sync(0xffffffffu, ok)) d = bin == 0 || bin == kN - 1 ? 0.f : phase_difference(l, r);
    return make_float2(ok ? d : 0.f, ok ? fmaxf(pl, pr) : -100.f);
  }
  // sqrt(max(lv, 1e-30)) = max(sqrt P_L, sqrt P_R, sqrt 1e-30) where no
  // power is NaN (a correctly rounded sqrt is monotone); where one is, so is
  // the numerator
  const float sl = sqrtf(pl), sr = sqrtf(pr);
  const float lv = nan_max(pl, pr);
  const bool ok = pl >= thr || pr >= thr;
  const float pos = 0.5f + 0.5f * (sr - sl) / fmaxf(fmaxf(sl, sr), sqrtf(1e-30f));
  return make_float2(ok ? pos : 0.5f, ok ? lv : 0.f);
}

// the epilogue of channel c's thread j: pairs k = j + 256 i, i < 8.  In raw
// mode it writes its channel's bins; else the left channel keeps the high
// bins and hands the low ones' X to the right channel's thread j through
// its own Z (slot k, which only this thread read), the right channel keeps
// the low bins and hands back the high ones (slot N - k), and each writes
// the outputs of the bins it kept
template <int kMode>
__device__ __forceinline__ void epilogue(float2* zs, const float2* __restrict__ tw, float thr,
                                         int c, int j, size_t frame, size_t chan_frame,
                                         float* __restrict__ out_a, float* __restrict__ out_b) {
  constexpr int NP = kN / 2 / kT;  // pairs a thread
  float2* z = zs + c * kN;
  if (kMode == kRaw) {
    float* oa = out_a + chan_frame * kN;
    float* ob = out_b + chan_frame * kN;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      float2 lo, hi;
      const int kh = bin_pair(z, tw, j, i, lo, hi);
      oa[j + kT * i] = lo.x;
      ob[j + kT * i] = lo.y;
      oa[kh] = hi.x;
      ob[kh] = hi.y;
    }
    return;
  }
  // selects, not branches, on the channel: one copy of the code for both
  const bool left = c == 0;
  float2 keep[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float2 lo, hi;
    const int kh = bin_pair(z, tw, j, i, lo, hi);
    z[left ? j + kT * i : kh] = left ? lo : hi;
    keep[i] = left ? hi : lo;
  }
  bar_sync(3 + j / 32, 64);  // warp j / 32 of each channel
  const float2* zo = zs + (1 - c) * kN;
  float* oa = out_a + frame * kN;
  float* ob = out_b + frame * kN;
  const int base = left ? kN - j : j, step = left ? -kT : kT;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int bin = left && i == 0 && j == 0 ? kN / 2 : base + step * i;
    const float2 o = zo[bin];
    const float2 r = combine<kMode>(left ? keep[i] : o, left ? o : keep[i], bin, thr);
    oa[bin] = r.x;
    ob[bin] = r.y;
  }
}

// one CTA per (stream, frame), kT threads a channel
template <int kMode>
__global__ void __launch_bounds__(2 * kT, 2)
stft_hopper_kernel(const float* __restrict__ ext, const float* __restrict__ win,
                   const float2* __restrict__ tw, const float2* __restrict__ ptw, int L, int hop,
                   int F, float thr, float* __restrict__ out_a, float* __restrict__ out_b) {
  extern __shared__ float2 zs[];   // [2][N]
  const int c = threadIdx.x / kT;  // warp-uniform
  const int j = threadIdx.x - c * kT;
  const int b = blockIdx.x / F;
  const int f = blockIdx.x - b * F;
  float2* z = zs + c * kN;
  const int bar = 1 + c;
  first_pass(ext + ((size_t)b * 2 + c) * L + (size_t)hop * (f + 1), win, z, j);
  bar_sync(bar, kT);
  mid_pass<16>(z, ptw, j, bar);
  mid_pass<256>(z, ptw + kTw3, j, bar);
  epilogue<kMode>(zs, tw, thr, c, j, blockIdx.x, ((size_t)b * 2 + c) * F + f, out_a, out_b);
}

template <int kMode>
int launch_hopper(const float* ext, const float* win, const float* tw, const float* ptw, int B,
                  int L, int hop, int F, float thr, float* out_a, float* out_b,
                  cudaStream_t stream) {
  constexpr int smem = 2 * kN * (int)sizeof(float2);
  static const cudaError_t attr = cudaFuncSetAttribute(
      stft_hopper_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  stft_hopper_kernel<kMode><<<B * F, 2 * kT, smem, stream>>>(
      ext, win, reinterpret_cast<const float2*>(tw), reinterpret_cast<const float2*>(ptw), L, hop,
      F, thr, out_a, out_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The body a window of W samples runs: 1 the Hopper body (W = 8192), 0 the
// generic body (W = 256 .. 4096, powers of two), -1 none.
int stft_fused_body(int W) {
  if (W == kW) return 1;
  return W >= 256 && W <= 4096 && (W & (W - 1)) == 0 ? 0 : -1;
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// All pointers are device pointers: ext [B, 2, L], win [W], tw [W/2, 2]
// (e^{-i pi k / (W/2)}), ptw the Hopper body's pass tables (pass_twiddles
// in ops/stft_fused.py; W = 8192 only, else unused); outputs out_a, out_b
// [B, F, W/2] (phasewheel, stereoscope) or [B, 2, F, W/2] (raw).  W is a
// power of two from 256 to 8192, hop >= 1, F >= 1 and hop * F + W <= L;
// mode 0 raw, 1 phasewheel, 2 stereoscope.
int stft_fused_launch(const float* ext, const float* win, const float* tw, const float* ptw,
                      int B, int L, int W, int hop, int F, int mode, float thr, float* out_a,
                      float* out_b, void* stream) {
  if (B <= 0 || hop <= 0 || F <= 0 || (long long)hop * F + W > L || mode < 0 || mode > 2 ||
      (long long)B * F > 0x7fffffffLL || stft_fused_body(W) < 0 ||
      (stft_fused_body(W) == 1 && ptw == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W == kW) {
    switch (mode) {
      case kRaw:
        return launch_hopper<kRaw>(ext, win, tw, ptw, B, L, hop, F, thr, out_a, out_b, s);
      case kPhaseWheel:
        return launch_hopper<kPhaseWheel>(ext, win, tw, ptw, B, L, hop, F, thr, out_a, out_b, s);
      default:
        return launch_hopper<kStereoscope>(ext, win, tw, ptw, B, L, hop, F, thr, out_a, out_b, s);
    }
  }
#define STFT_CASE(NW, LG)                                                                 \
  case NW:                                                                                \
    return launch_generic<LG>(ext, win, tw, B, L, hop, F, mode, thr, out_a, out_b, s);
  switch (W) {
    STFT_CASE(256, 7)
    STFT_CASE(512, 8)
    STFT_CASE(1024, 9)
    STFT_CASE(2048, 10)
    STFT_CASE(4096, 11)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef STFT_CASE
}

}  // extern "C"
