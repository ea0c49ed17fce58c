// K0: shared Shiftmax building blocks for the fused attention kernels.
//
// Replaces ivit_tpu/kernels/_shiftmax_common.py (exp2i, shift_exp_rows,
// exact_rowsum_2limb, norm_factor), which the Pallas kernels inline. The
// plain torch twin is ivit_tpu_torch/kernels/_shiftmax_common.py.
//
// Every value here is an integer carried in float32, and the spec takes
// floors of float32 quotients, so the rounding points are the contract:
//   * the sources are compiled with -fmad=false (no a*b+c contraction)
//     and without fast-math, so `/` is the correctly rounded division;
//   * rintf (half to even), never roundf;
//   * 2^k comes from the exponent field, never exp2f (approximate).

#pragma once

#include <cstdint>

namespace ivit {

// float32(2^31 - 1) rounds to 2^31, as the JAX spec's I32_MAX constant does.
constexpr float kI32Max = 2147483648.0f;

// Exact 2^k for integer-valued k >= -126 (k truncated toward zero, as
// astype(int32)); the shift wraps in 32 bits like XLA's.
__device__ __forceinline__ float exp2i(float k) {
  const unsigned int field = static_cast<unsigned int>(static_cast<int>(k) + 127) << 23;
  return __uint_as_float(field);
}

// x0 = floor(-1/scale): the integer that represents -1 (negative).
__device__ __forceinline__ float shift_exp_x0(float scale) {
  return floorf(-1.0f / scale);
}

// The shift-exp chain for one row-max-subtracted score z <= 0 (every
// guard kept: the clamp to n*x0 and the clip to [0, 2^31-1]).
__device__ __forceinline__ float shift_exp(float z, float x0, float n) {
  z = z + floorf(z / 2.0f) - floorf(z / 16.0f);
  z = fmaxf(z, n * x0);
  const float qt = floorf(z / x0);
  const float r = z - x0 * qt;
  const float e = floorf((r - 2.0f * x0) * exp2i(n - 1.0f - qt));
  return fminf(fmaxf(e, 0.0f), kI32Max);
}

// Per-row normalization factor with the 2^-(32-out_bits) shift folded in
// (a power of two: exact). esum is the exact row sum rounded once to
// float32 -- the value the spec's base-2^16 two-limb sum produces for
// rows of <= 256 columns -- and is clipped to [1, 2^31-1] here.
__device__ __forceinline__ float norm_factor(float esum, int out_bits) {
  esum = fminf(fmaxf(esum, 1.0f), kI32Max);
  const float shift = __uint_as_float(static_cast<unsigned int>(127 - (32 - out_bits)) << 23);
  return floorf(kI32Max / esum) * shift;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned long long warp_sum_u64(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace ivit
