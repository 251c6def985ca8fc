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

// The envelope body of one 4-sample group (the JAX kernel's group_env,
// pallas_ballistics.py:61-107), bit-exact to the plain PyTorch version
// (ops/ballistics_core.py::ballistics_envelope_reference).  Each sample
// step is z' = max(z, (1-w) z + w t), so with d = w3 z a group is exactly
//   z' = max(d, d + (b_k - d c_k)),  k = 1..4,  c_k = 1 - (1-w)^k,
// where b_k, the best result of k attacks on a zero state, comes from a
// max-plus DP over the group's samples that never reads z: it overlaps the
// carried chain, which shrinks to the multiply d, a multiply, two adds and
// a 4-deep max.  A DP attack is the serial step b + w (t - b), so the DP
// rounds as the serial chain does; c_k comes from the host, a float64
// value rounded once (a float32 a^k would bias the decay of every group by
// up to half an ulp, which the recurrence multiplies by about 1 / w).
// A NaN sample enters as -inf and cannot attack.  fmaxf drops a NaN
// candidate (-inf meeting +inf, either way round), so a NaN next to a
// +Inf, a +Inf after the group's first sample, or a +Inf state meeting a
// b_k of -inf all give the serial body's answer; a NaN z makes every
// candidate NaN and stays NaN.  Every step is written with __fmul_rn /
// __fadd_rn / __fsub_rn, so nothing is contracted into an FMA.

struct EnvCoeffs {
  float w, c1, c2, c3, c4;  // w and c_k = 1 - (1 - w)^k
};

// A sample as the envelope's DP takes it: NaN cannot attack, so it enters
// as -inf.
__device__ __forceinline__ float nan_to_ninf(float t) {
  return t == t ? t : -__int_as_float(0x7f800000);
}

__device__ __forceinline__ float env_attack(float b, float t, float w) {
  return __fadd_rn(b, __fmul_rn(__fsub_rn(t, b), w));
}

__device__ __forceinline__ float env_cand(float d, float b, float c) {
  return __fadd_rn(d, __fsub_rn(b, __fmul_rn(d, c)));
}

// The DP half of group_env: b_1..b_4 of one group from its samples ts (NaN
// already -inf) and w.  It never reads the carried state, so it may run
// anywhere ahead of the carried half (truepeak_fused.cu runs it on other
// warps than the chain).
__device__ __forceinline__ float4 env_intercepts(const float ts[4], float w) {
  const float ninf = -__int_as_float(0x7f800000);
  // the DP in the plain version's order; b3 and b4 before samples 2 and 3
  // can only be -inf and are not computed
  float b1 = __fmul_rn(ts[0], w);
  float b2 = fmaxf(ninf, env_attack(b1, ts[1], w));
  b1 = fmaxf(b1, __fmul_rn(ts[1], w));
  float b3 = fmaxf(ninf, env_attack(b2, ts[2], w));
  b2 = fmaxf(b2, env_attack(b1, ts[2], w));
  b1 = fmaxf(b1, __fmul_rn(ts[2], w));
  const float b4 = fmaxf(ninf, env_attack(b3, ts[3], w));
  b3 = fmaxf(b3, env_attack(b2, ts[3], w));
  b2 = fmaxf(b2, env_attack(b1, ts[3], w));
  b1 = fmaxf(b1, __fmul_rn(ts[3], w));
  return make_float4(b1, b2, b3, b4);
}

// The carried half of group_env: z' = max(d, d + (b_k - d c_k)), d = w3 z,
// the max taken in the plain version's order.
__device__ __forceinline__ float env_carry(float z, float w3, const EnvCoeffs& k,
                                           float4 b) {
  const float d = __fmul_rn(z, w3);
  float out = fmaxf(d, env_cand(d, b.x, k.c1));
  out = fmaxf(out, env_cand(d, b.y, k.c2));
  out = fmaxf(out, env_cand(d, b.z, k.c3));
  return fmaxf(out, env_cand(d, b.w, k.c4));
}

__device__ __forceinline__ float group_env(float z, float w3, const EnvCoeffs& k,
                                           const float ts[4]) {
  return env_carry(z, w3, k, env_intercepts(ts, k.w));
}

template <bool kTrackPeak>
__device__ __forceinline__ void group_env_step(float4 v, const EnvCoeffs& k1,
                                               const EnvCoeffs& k2, float w3,
                                               float& z1, float& z2, float& m,
                                               float& p) {
  const float ts[4] = {nan_to_ninf(v.x), nan_to_ninf(v.y), nan_to_ninf(v.z),
                       nan_to_ninf(v.w)};
  z1 = group_env(z1, w3, k1, ts);
  z2 = group_env(z2, w3, k2, ts);
  if (kTrackPeak) p = max_nan(p, fmaxf(fmaxf(ts[0], ts[1]), fmaxf(ts[2], ts[3])));
  m = max_nan(m, __fadd_rn(z1, z2));
}

}  // namespace ballistics
