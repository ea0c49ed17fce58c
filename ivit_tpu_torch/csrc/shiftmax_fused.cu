// K6: fused requant -> masked Shiftmax -> base-256 (hi, lo) split, for
// Hopper (sm_90a).
//
// Replaces ivit_tpu/kernels/shiftmax_fused.py:fused_requant_shiftmax (the
// pl.pallas_call at :95, body _kernel :39-58). Per row of the (M, N) int32
// attention logits, with columns j >= n_valid masked:
//   z   = clip(rint(float(x) * r1), -128, 127)
//   e   = shift_exp(z - max over valid z)      (K0, every guard kept)
//   sm  = floor(e * norm_factor(sum of e, out_bits)); 0 on masked columns
//   hi  = floor(sm / 256), lo = sm - 256*hi - 128, each as int8
// so that sm = 256*hi + lo + 128 feeds two int8 @V products. The
// conversions to int8 saturate, as XLA's do (sm = 2^15, reachable only on
// a degenerate row, gives hi = 127). The row sum is the exact 64-bit
// integer sum rounded once, equal to the spec's two-limb f32 sum for
// rows of at most 256 columns, which bounds N.
//
// Layout: x is (M, N) unpadded (the Pallas kernel pads N to a lane
// multiple of 128, and pad columns come out as probability 0; leaving
// them out is value-identical); hi and lo are (M, N).
//
// Bound on the H100: HBM bytes: 4 B read and 2 B written per element
// (179 MB per launch at DeiT-S batch 128) against a few dozen f32 ops.
// One warp owns one row: the row is read once, coalesced, into registers
// (8 values a lane), and the max, the sum and the split never leave them.

#include <cuda_runtime.h>

#include <cstdint>

#include "shiftmax_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxN = 256;
constexpr int kColsPerLane = kMaxN / 32;

__device__ __forceinline__ int8_t saturate_i8(float v) {
  return static_cast<int8_t>(fminf(fmaxf(v, -128.0f), 127.0f));
}

__global__ void __launch_bounds__(kWarps * 32)
fused_requant_shiftmax_kernel(const int* __restrict__ x, int8_t* __restrict__ hi,
                              int8_t* __restrict__ lo, int M, int N, int n_valid, float r1,
                              float scale, float n, int out_bits) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= M) return;  // warp-uniform
  const int* xr = x + row * N;

  float z[kColsPerLane];
  float zmax = -128.0f;  // the requantized scores lie in [-128, 127]
#pragma unroll
  for (int t = 0; t < kColsPerLane; ++t) {
    const int j = lane + 32 * t;
    z[t] = 0.0f;
    if (j < n_valid) {
      z[t] = fminf(fmaxf(rintf(static_cast<float>(xr[j]) * r1), -128.0f), 127.0f);
      zmax = fmaxf(zmax, z[t]);
    }
  }
  zmax = ivit::warp_max(zmax);

  const float x0 = ivit::shift_exp_x0(scale);
  unsigned long long esum = 0;
#pragma unroll
  for (int t = 0; t < kColsPerLane; ++t) {
    if (lane + 32 * t < n_valid) {
      z[t] = ivit::shift_exp(z[t] - zmax, x0, n);
      esum += static_cast<unsigned long long>(z[t]);
    }
  }
  const float factor = ivit::norm_factor(__ull2float_rn(ivit::warp_sum_u64(esum)), out_bits);

  int8_t* hr = hi + row * N;
  int8_t* lr = lo + row * N;
#pragma unroll
  for (int t = 0; t < kColsPerLane; ++t) {
    const int j = lane + 32 * t;
    if (j < N) {
      const float sm = j < n_valid ? floorf(z[t] * factor) : 0.0f;
      const float h = floorf(sm / 256.0f);
      hr[j] = saturate_i8(h);
      lr[j] = saturate_i8(sm - h * 256.0f - 128.0f);
    }
  }
}

}  // namespace

// Launches K6 on `stream`. Returns cudaGetLastError() (0 on success).
extern "C" int ivit_fused_requant_shiftmax(const void* x, void* hi, void* lo, int M, int N,
                                           int n_valid, float r1, float scale, int n,
                                           int out_bits, void* stream) {
  if (M < 1 || N < 1 || N > kMaxN || n_valid < 1 || n_valid > N ||
      (out_bits != 8 && out_bits != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned int blocks = static_cast<unsigned int>((M + kWarps - 1) / kWarps);
  fused_requant_shiftmax_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int8_t*>(hi), static_cast<int8_t*>(lo), M, N,
      n_valid, r1, scale, static_cast<float>(n), out_bits);
  return static_cast<int>(cudaGetLastError());
}
