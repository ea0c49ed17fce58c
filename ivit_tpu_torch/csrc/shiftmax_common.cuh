// K0: shared Shiftmax building blocks for the fused attention and softmax
// kernels (K1, K2, K6, K7) and the shift-exp of the GELU kernels (K4, K5);
// also the exact integer <-> float32 steps (kMagic, floor_bits) of K1-K7,
// and the one-wave grid size of the grid-stride kernels K3, K5 and K6.
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

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace ivit {

// float32(2^31 - 1) rounds to 2^31, as the JAX spec's I32_MAX constant does.
constexpr float kI32Max = 2147483648.0f;

// Integer <-> float32 steps without the conversion unit (a quarter of the
// rate of the float32 lanes on Hopper), each exact on its stated range.
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23: its ulp is 1
constexpr int kMagicBits = 0x4B400000;

// float(s) for |s| <= 2^22.
__device__ __forceinline__ float int_to_float(int s) {
  return __int_as_float(s + kMagicBits) - kMagic;
}

// kMagicBits + clip(rint(y), -128, 127): rint is monotone and the bounds
// are integers, so clipping first gives the same value, and adding
// 1.5 * 2^23 rounds half to even, as rintf. The low byte is the int8.
__device__ __forceinline__ int requant_bits(float y) {
  return __float_as_int(fminf(fmaxf(y, -128.0f), 127.0f) + kMagic);
}

// clip(rint(y), -128, 127) as an int.
__device__ __forceinline__ int requant_i8(float y) { return requant_bits(y) - kMagicBits; }

// The bits of 2^23 + floor(w) for 0 <= w < 2^23 (the add rounds toward
// zero): the low 23 bits are floor(w).
__device__ __forceinline__ int floor_bits(float w) { return __float_as_int(__fadd_rz(w, 8388608.0f)); }

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

// The shift-exp chain for one integer score z, usually row-max-subtracted
// (z <= 0), with every guard kept: the clamp to n*x0 and the clip to
// [0, 2^31-1]. kClip=false elides the clip, which is value-identical only
// where the caller proves p*2^n <= 2^31-1 with p = -x0 (K2's gate).
template <bool kClip = true>
__device__ __forceinline__ float shift_exp(float z, float x0, float n) {
  z = z + floorf(z / 2.0f) - floorf(z / 16.0f);
  z = fmaxf(z, n * x0);
  const float qt = floorf(z / x0);
  const float r = z - x0 * qt;
  const float e = floorf((r - 2.0f * x0) * exp2i(n - 1.0f - qt));
  return kClip ? fminf(fmaxf(e, 0.0f), kI32Max) : e;
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

// The exact warp sum of per-lane values below 2^35 (K6's lanes hold at
// most 8 shift-exps of at most 2^31 each): two 32-bit warp reductions of
// 24-bit limbs, neither of which can overflow (32 * 2^24 and 32 * 2^11).
__device__ __forceinline__ unsigned long long warp_sum_u64(unsigned long long v) {
  const unsigned lo = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(v) & 0xffffffu);
  const unsigned hi = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(v >> 24));
  return (static_cast<unsigned long long>(hi) << 24) + lo;
}

constexpr int kMaxDevices = 64;

// The grid of a grid-stride kernel: `need` blocks, at most one resident
// wave of `kernel` at `threads` threads a block on the current device.
// The wave is queried once per device into the caller's `wave` (one
// static array per kernel; every thread that races to fill an entry
// stores the same value). Returns 0 or the CUDA error.
inline int one_wave_blocks(const void* kernel, int threads, long long need, std::atomic<int>* wave,
                           unsigned* blocks) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess && (device < 0 || device >= kMaxDevices)) e = cudaErrorInvalidDevice;
  if (e != cudaSuccess) return static_cast<int>(e);
  int w = wave[device].load(std::memory_order_relaxed);
  if (w == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    w = sms * (per_sm > 0 ? per_sm : 1);
    wave[device].store(w, std::memory_order_relaxed);
  }
  *blocks = static_cast<unsigned>(need < w ? need : w);
  return 0;
}

}  // namespace ivit
