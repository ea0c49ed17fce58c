// The row-max ShiftGELU chain shared by K4 (linear_gelu_fused.cu) and K5
// (shiftgelu_fused.cu), for Hopper (sm_90a): ivit_gelu_table fills their
// (max q, q) table with it.
//
// Replaces the duplicated _shift_exp / _kernel bodies of
// ivit_tpu/kernels/linear_gelu_fused.py:33-62 and
// ivit_tpu/kernels/shiftgelu_fused.py:31-55. The plain torch twin is
// ivit_tpu_torch/kernels/_gelu_common.py. On a row of int8-valued GELU
// inputs q at scale s_in (the reference-spec form, n = 23, every guard
// kept):
//   x0      = floor(-1 / (s_in * 1.702))
//   e       = shift_exp(q - max q)             clipped to [0, 2^31-1]
//   e_max   = shift_exp(-max q)                saturates at 2^31-1 when
//                                              the whole row is negative
//   sigma   = floor(e * floor((2^31-1) / clip(e + e_max, 1, 2^31-1))
//                   / 2^24)                    (8-bit output: 2^(32-8))
//   out     = clip(rint(q * sigma * r2), -128, 127)  int8
// The scale product s_in * 1.702 and -1 / that product are float32, as
// in the XLA op (ops/shiftgelu.py); the Pallas kernels take them in
// float64 at trace time, and agree wherever the floor of the two
// quotients does. e * factor is a float32 product that rounds (up to
// 2^62), then the division by 2^24 is exact; it is never done in
// integers.

#pragma once

#include <cstdint>

#include "shiftmax_common.cuh"

namespace ivit {

// x0 of the sigmoid's shift-exp for GELU input scale s_in.
__device__ __forceinline__ float gelu_x0(float s_in) { return shift_exp_x0(s_in * 1.702f); }

// q * sigma for one element, given the row max and e_max = shift_exp(-qmax).
__device__ __forceinline__ float shiftgelu_rowmax(float q, float qmax, float exp_max, float x0,
                                                  float n) {
  const float e = shift_exp(q - qmax, x0, n);
  const float s = fminf(fmaxf(e + exp_max, 1.0f), kI32Max);
  const float factor = floorf(kI32Max / s);
  const float sigma = floorf(e * factor / 16777216.0f);  // 2^(32-8)
  return q * sigma;
}

// clip(rint(y * r), -128, 127) as int8.
__device__ __forceinline__ int8_t requant_i8(float y, float r) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(y * r), -128.0f), 127.0f));
}

}  // namespace ivit
