// One 4-sample group of the PPM / true-peak attack-release recurrence,
// shared by ballistics.cu and truepeak_fused.cu so that both hold the one
// bit-exact form of it.
//
//   z1 *= w3, z2 *= w3; per sample t of the group:
//     z1 = t > z1 ? z1 + w1*(t - z1) : z1   (same for z2 with w2)
//     p  = t > p  ? t : p                   (kTrackPeak only)
//   m = max(m, z1 + z2), NaN-propagating like torch.maximum.
//
// Bit-exact to the plain PyTorch version (ops/ballistics_core.py::
// ballistics_reference), which is one torch op per step: nvcc would
// contract z + w*(t - z) into an FMA, so every step is written with
// __fsub_rn / __fmul_rn / __fadd_rn, which are never contracted.  A NaN
// sample compares false and is skipped.  The candidate is computed
// unconditionally, so each update is a select and not a branch.

#pragma once

namespace ballistics {

__device__ __forceinline__ float max_nan(float a, float b) {
  // torch.maximum: NaN if either operand is NaN (selects, no branch)
  float r = a > b ? a : b;
  r = b != b ? b : r;
  return a != a ? a : r;
}

__device__ __forceinline__ float attack(float z, float t, float w) {
  const float c = __fadd_rn(z, __fmul_rn(w, __fsub_rn(t, z)));
  return t > z ? c : z;
}

template <bool kTrackPeak>
__device__ __forceinline__ void group_step(float4 v, float w1, float w2,
                                           float w3, float& z1, float& z2,
                                           float& m, float& p) {
  z1 = __fmul_rn(z1, w3);
  z2 = __fmul_rn(z2, w3);
  const float s[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    z1 = attack(z1, s[i], w1);
    z2 = attack(z2, s[i], w2);
    if (kTrackPeak) p = s[i] > p ? s[i] : p;
  }
  m = max_nan(m, __fadd_rn(z1, z2));
}

}  // namespace ballistics
