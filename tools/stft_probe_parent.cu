// The stft_fused body before its Hopper redesign, kept verbatim as the
// "parent" variant of tools/stft_probe.py; it is not part of the package.

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
//                phi_c = atan2f(Im, Re) with phi_c[0] = phi_c[N-1] = 0;
//                ok = P_L >= thr && P_R >= thr; out_a[b, f, k] =
//                ok ? phi_R - phi_L : 0, out_b = ok ? max(P_L, P_R) : -100;
//   stereoscope  ok = P_L >= thr || P_R >= thr, lv = max(P_L, P_R) with NaN
//                propagated (jnp.maximum / torch.maximum: fmaxf would drop
//                it); out_a = ok ? 0.5 + 0.5 (sqrt P_R - sqrt P_L) /
//                sqrt(max(lv, 1e-30)) : 0.5, out_b = ok ? lv : 0.
// Outputs are written in bin order.
//
// Arithmetic: IEEE fp32, no tensor cores, no fast math (atan2f, sqrtf and
// the division are the correctly rounded or full-precision library forms).
// The twiddles are a host table built in float64 (ops/stft_fused.py
// twiddles).  nvcc contracts the butterflies and re*re + im*im into FMAs, so
// the kernel agrees with the plain version (torch.fft.rfft) to float32 FFT
// rounding, about 1e-7 of the frame's peak magnitude, not bit for bit.
//
// Why not the TPU's design: the Pallas kernel was a two-stage 64 x 128 DFT
// as matrix products with 6-pass bf16 splits, for the MXU.  On this card an
// FFT in shared memory does about 25x less arithmetic, and tensor
// cores would put TF32 where the -60 dB display bins need fp32.
//
// What bounds it: at the main-path shape (B = 256 streams, W = 8192,
// hop 1920, F = 25) the function reads ext once (115 MB) and writes two
// [B, F, W/2] outputs (210 MB): 0.097 ms at 3.35 TB/s, against ~0.05 ms of
// fp32 operations (2.5 W log2 W a channel-frame).  It is bound by bytes.
//
// What the design does about it: one CTA per (stream, frame), both
// channels, so frames are independent and B*F CTAs fill the card.  Each
// channel goes through the standard real-FFT packing z[m] = x[2m] +
// i x[2m+1] into a W/2-point complex FFT held in shared memory (2 x N x 8 B
// = 64 KB at W = 8192), computed as a Stockham autosort FFT of radix-16
// passes (and one radix-2, -4 or -8 pass where log2 N is not a multiple of
// 4): each thread holds one 16-point DFT in registers, so N = 4096 takes
// three passes over shared memory and five barriers instead of twelve
// radix-2 stages.  The first pass reads the windowed samples straight from
// device memory (frames overlap W/hop times; L2 serves the re-reads), and
// shared-memory indices are XOR-swizzled within rows of 16 so that the
// strided stores of the early passes do not fall on one bank.  Then the
// untangle X[k] = E[k] + W^k O[k] from Z[k] and conj(Z[N-k]) and the mode's
// epilogue run in registers and are written straight to device memory.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
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
stft_fused_kernel(const float* __restrict__ ext, const float* __restrict__ win,
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
int launch(const float* ext, const float* win, const float* tw, int B, int L, int hop, int F,
           int mode, float thr, float* out_a, float* out_b, cudaStream_t stream) {
  constexpr int smem = 2 * (1 << LOG2N) * (int)sizeof(float2);
  // above 48 KB only as opted-in dynamic shared memory; set once
  static const cudaError_t attr = cudaFuncSetAttribute(
      stft_fused_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  stft_fused_kernel<LOG2N><<<B * F, kThreads, smem, stream>>>(
      ext, win, reinterpret_cast<const float2*>(tw), L, hop, F, mode, thr, out_a, out_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// All pointers are device pointers: ext [B, 2, L], win [W], tw [W/2, 2]
// (e^{-i pi k / (W/2)}); outputs out_a, out_b [B, F, W/2] (phasewheel,
// stereoscope) or [B, 2, F, W/2] (raw).  W is a power of two from 256 to
// 8192, hop >= 1, F >= 1 and hop * F + W <= L; mode 0 raw, 1 phasewheel,
// 2 stereoscope.
int stft_fused_launch(const float* ext, const float* win, const float* tw, int B, int L, int W,
                      int hop, int F, int mode, float thr, float* out_a, float* out_b,
                      void* stream) {
  if (B <= 0 || hop <= 0 || F <= 0 || (long long)hop * F + W > L || mode < 0 || mode > 2 ||
      (long long)B * F > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STFT_CASE(NW, LG)                                                             \
  case NW:                                                                            \
    return launch<LG>(ext, win, tw, B, L, hop, F, mode, thr, out_a, out_b, s);
  switch (W) {
    STFT_CASE(256, 7)
    STFT_CASE(512, 8)
    STFT_CASE(1024, 9)
    STFT_CASE(2048, 10)
    STFT_CASE(4096, 11)
    STFT_CASE(8192, 12)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef STFT_CASE
}

}  // extern "C"
