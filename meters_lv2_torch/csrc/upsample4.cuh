// 4x polyphase oversampling for true peak, shared by r128_fused.cu and
// truepeak_fused.cu: the direct 4-phase, 48-tap FIR of
// ops/resample.py (design.upsample4_kernel(24)) and the plain version's
// rule for non-finite inputs.
//
//   up[4t + ph] = sum_i taps[ph, i] * x[t - 47 + i],  i = 0 .. 47
//
// The plain version evaluates each 128-sample block as one frame of
// 47 + 128 inputs times a dense block matrix.  The matrix's zeros turn a
// non-finite input anywhere in the frame into NaN (x * 0) for every
// oversample that it does not feed; upsample4_frame_ok applies the same
// rule from the frame's first and last non-finite position.

#pragma once

namespace upsample4 {

constexpr int kNh = 47;     // history: 2*24 - 1 samples
constexpr int kTaps = 48;   // FIR taps per phase
constexpr int kPhases = 4;  // oversampling factor

// The four phases at one input sample: win[i] = x[t - 47 + i], taps
// [4 x 48] row-major.  fp32 FMA in ascending tap order.
__device__ __forceinline__ void fir(const float* taps, const float* win,
                                    float& u0, float& u1, float& u2,
                                    float& u3) {
  u0 = 0.f;
  u1 = 0.f;
  u2 = 0.f;
  u3 = 0.f;
#pragma unroll 8
  for (int i = 0; i < kTaps; ++i) {
    const float xi = win[i];
    u0 = fmaf(taps[i], xi, u0);
    u1 = fmaf(taps[kTaps + i], xi, u1);
    u2 = fmaf(taps[2 * kTaps + i], xi, u2);
    u3 = fmaf(taps[3 * kTaps + i], xi, u3);
  }
}

// Frame positions lo .. hi (-1 for hi: none) of the non-finite inputs of a
// frame; the window of an oversample starts at frame position `first` and
// spans kNh + 1 inputs.  True when the oversample is what the FIR gives;
// false when the plain version makes it NaN.
__device__ __forceinline__ bool frame_ok(int lo, int hi, int first) {
  return hi < 0 || (lo >= first && hi <= first + kNh);
}

}  // namespace upsample4
