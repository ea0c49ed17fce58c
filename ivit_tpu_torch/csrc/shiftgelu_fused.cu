// K5: fused per-channel requant -> row-max ShiftGELU -> requant to int8,
// for Hopper (sm_90a).
//
// Replaces ivit_tpu/kernels/shiftgelu_fused.py:fused_requant_shiftgelu
// (the pl.pallas_call at :79, body :39-55). Per row of the (M, C) int32
// fc1 accumulator:
//   q   = clip(rint(float(x) * r1[c]), -128, 127)
//   out = the row-max ShiftGELU chain of gelu_common.cuh, then the r2
//         requant to int8.
//
// Bound on the H100: HBM bytes. Each element is read as int32 (4 B) and
// written as int8 (1 B) with a few dozen f32 ops between, far below the
// card's ops-per-byte balance (194 MB per launch at DeiT-S batch 128).
// One warp owns one row, because the row max spans all C channels: a
// first pass finds the max of q, a second recomputes q from the row, now
// warm in L1, and writes the output. Loads are 16-byte vectors (four
// channels a lane), stores 4-byte vectors; the int32 accumulator is read
// from HBM once.

#include <cuda_runtime.h>

#include <cstdint>

#include "gelu_common.cuh"

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float requant_q(int acc, float r) {
  return fminf(fmaxf(rintf(static_cast<float>(acc) * r), -128.0f), 127.0f);
}

__global__ void __launch_bounds__(kWarps * 32)
fused_requant_shiftgelu_kernel(const int* __restrict__ x, const float* __restrict__ r1,
                               int8_t* __restrict__ out, int M, int C, float s_in, float r2,
                               float n) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= M) return;  // warp-uniform
  const int4* x4 = reinterpret_cast<const int4*>(x + row * C);
  const float4* r4 = reinterpret_cast<const float4*>(r1);
  const int words = C / 4;

  float qmax = -128.0f;  // q lies in [-128, 127]
  for (int i = lane; i < words; i += 32) {
    const int4 a = x4[i];
    const float4 r = r4[i];
    qmax = fmaxf(qmax, fmaxf(fmaxf(requant_q(a.x, r.x), requant_q(a.y, r.y)),
                             fmaxf(requant_q(a.z, r.z), requant_q(a.w, r.w))));
  }
  qmax = ivit::warp_max(qmax);

  const float x0 = ivit::gelu_x0(s_in);
  const float exp_max = ivit::shift_exp(-qmax, x0, n);
  char4* o4 = reinterpret_cast<char4*>(out + row * C);
  for (int i = lane; i < words; i += 32) {
    const int4 a = x4[i];
    const float4 r = r4[i];
    char4 o;
    o.x = ivit::requant_i8(ivit::shiftgelu_rowmax(requant_q(a.x, r.x), qmax, exp_max, x0, n), r2);
    o.y = ivit::requant_i8(ivit::shiftgelu_rowmax(requant_q(a.y, r.y), qmax, exp_max, x0, n), r2);
    o.z = ivit::requant_i8(ivit::shiftgelu_rowmax(requant_q(a.z, r.z), qmax, exp_max, x0, n), r2);
    o.w = ivit::requant_i8(ivit::shiftgelu_rowmax(requant_q(a.w, r.w), qmax, exp_max, x0, n), r2);
    o4[i] = o;
  }
}

}  // namespace

// Launches K5 on `stream`. Returns cudaGetLastError() (0 on success).
extern "C" int ivit_fused_requant_shiftgelu(const void* x, const void* r1, void* out, int M, int C,
                                            float s_in, float r2, int n, void* stream) {
  if (M < 1 || C < 4 || C % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned int blocks = static_cast<unsigned int>((M + kWarps - 1) / kWarps);
  fused_requant_shiftgelu_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const float*>(r1), static_cast<int8_t*>(out), M, C,
      s_in, r2, static_cast<float>(n));
  return static_cast<int>(cudaGetLastError());
}
