// K3: fused I-LayerNorm -> folded beta -> per-channel requant to int8,
// for Hopper (sm_90a).
//
// Replaces ivit_tpu/kernels/intnorm_fused.py:fused_layernorm_requant (the
// pl.pallas_call at :74, body :23-54). Per row of the (M, C) int16
// residual stream:
//   exact int32 sums of q, b*b and a*a*128 + a*b (C <= 1000) or a*a and
//   a*b (C > 1000), with a = q >> 8 and b = q & 255;
//   the fixed f32 recombine of sum q^2, mean = rint(sum q / C),
//   var = max(sum q^2 - 2*mean*sum q + C*mean*mean, 0);
//   ten Newton steps k = floor((k + floor(var / k)) / 2) from 2^16;
//   factor = floor((2^31-1) / max(k, 1));
//   y = floor((x - mean) * factor / 2) + bias_int;
//   out = clip(rint(y * ratio), -128, 127) as int8.
// Every f32 expression copies intnorm_fused.py:36-53 op for op; the file is
// compiled with -fmad=false and without fast-math, so there is no FMA
// contraction and `/` is the correctly rounded division.
//
// Bound on the H100: HBM bytes. Each element is read as int16 (2 B) and
// written as int8 (1 B) with a few dozen f32 and int ops between, far
// below the card's ops-per-byte balance. The design reads the int16 stream
// directly (no f32 carrier is ever materialized) and gives one warp to one
// row for any C: the integer sums are warp-shuffle reductions, which are
// exact in any order, and the second pass re-reads the row from L1/L2.

#include <cuda_runtime.h>

#include <cstdint>

#include "shiftmax_common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
fused_layernorm_requant_kernel(const int16_t* __restrict__ x, const float* __restrict__ bias_int,
                               const float* __restrict__ ratio, int8_t* __restrict__ out, int M,
                               int C) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= M) return;  // warp-uniform
  const int16_t* xr = x + row * C;
  const bool merged = C <= 1000;

  int s_q = 0, s_bb = 0, s_t = 0, s_aa = 0, s_ab = 0;
  for (int c = lane; c < C; c += 32) {
    const int qi = xr[c];
    const int a = qi >> 8;
    const int b = qi & 255;
    s_q += qi;
    s_bb += b * b;
    if (merged) {
      s_t += a * a * 128 + a * b;
    } else {
      s_aa += a * a;
      s_ab += a * b;
    }
  }
  s_q = ivit::warp_sum_i32(s_q);
  s_bb = ivit::warp_sum_i32(s_bb);
  float sq2;
  if (merged) {
    s_t = ivit::warp_sum_i32(s_t);
    sq2 = static_cast<float>(s_t) * 512.0f + static_cast<float>(s_bb);
  } else {
    s_aa = ivit::warp_sum_i32(s_aa);
    s_ab = ivit::warp_sum_i32(s_ab);
    sq2 = static_cast<float>(s_aa) * 65536.0f + static_cast<float>(s_ab) * 512.0f +
          static_cast<float>(s_bb);
  }
  const float sum_f = static_cast<float>(s_q);
  const float d = static_cast<float>(C);
  const float mean = rintf(sum_f / d);
  const float var = fmaxf(sq2 - 2.0f * mean * sum_f + d * mean * mean, 0.0f);

  float k = 65536.0f;
#pragma unroll
  for (int i = 0; i < 10; ++i) k = floorf((k + floorf(var / k)) / 2.0f);
  const float factor = floorf(ivit::kI32Max / fmaxf(k, 1.0f));

  int8_t* orow = out + row * C;
  for (int c = lane; c < C; c += 32) {
    const float y = floorf((static_cast<float>(xr[c]) - mean) * factor / 2.0f) + bias_int[c];
    orow[c] = static_cast<int8_t>(fminf(fmaxf(rintf(y * ratio[c]), -128.0f), 127.0f));
  }
}

}  // namespace

// Launches K3 on `stream`. Returns cudaGetLastError() (0 on success).
extern "C" int ivit_fused_layernorm_requant(const void* x, const void* bias_int, const void* ratio,
                                            void* out, int M, int C, void* stream) {
  if (M < 1 || C < 1 || C > 8192) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks = static_cast<unsigned int>((M + kWarps - 1) / kWarps);
  fused_layernorm_requant_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), static_cast<const float*>(bias_int),
      static_cast<const float*>(ratio), static_cast<int8_t*>(out), M, C);
  return static_cast<int>(cudaGetLastError());
}
