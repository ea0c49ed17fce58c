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
// Bound on the H100: HBM bytes (4 B in, 1 B out an element; 194 MB a
// launch at DeiT-S batch 128). Run element by element, the chain (two
// shift-exps of correctly rounded divisions, two more divisions) made the
// kernel bound by instruction issue instead. It depends only on q, the
// row's max q and the launch's (s_in, r2), so it is read from K4's
// 256 x 256 int8 table of (max q, q), filled on the card by
// ivit_gelu_table (linear_gelu_fused.cu) from the unchanged chain of
// gelu_common.cuh; the wrapper passes it in.
//
// One warp owns one row (the max spans all C channels), rows in a
// grid-stride loop. The warp reads the int32 row once with 16-byte loads,
// requantizes it (the rint to int8 as an exact magic-number add,
// ivit::requant_bits of shiftmax_common.cuh),
// keeps q packed as int8 in registers (kSlots words a lane: C <= 1536
// entirely) and folds in the max; the 256-byte table row of that max is
// staged in the warp's slice of shared memory, and every element is one
// byte lookup, stored four to a word. Words past the slots (C > 1536) are
// read and requantized again for the output.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "shiftmax_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kSlots = 12;  // 4-channel words of a row a lane keeps, packed as int8

// The q of four channels, packed as int8 bytes; folds kMagicBits + their
// max into qmax (requant_bits is monotone in its float).
__device__ __forceinline__ unsigned requant4(int4 a, float4 r, int& qmax) {
  const int q0 = ivit::requant_bits(static_cast<float>(a.x) * r.x);
  const int q1 = ivit::requant_bits(static_cast<float>(a.y) * r.y);
  const int q2 = ivit::requant_bits(static_cast<float>(a.z) * r.z);
  const int q3 = ivit::requant_bits(static_cast<float>(a.w) * r.w);
  qmax = max(qmax, max(max(q0, q1), max(q2, q3)));
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040), 0x5410);
}

// The table row's outputs of four packed q.
__device__ __forceinline__ unsigned lookup4(const uint8_t* row, unsigned q) {
  return static_cast<unsigned>(row[q & 0xffu]) | (static_cast<unsigned>(row[(q >> 8) & 0xffu]) << 8) |
         (static_cast<unsigned>(row[(q >> 16) & 0xffu]) << 16) | (static_cast<unsigned>(row[q >> 24]) << 24);
}

__global__ void __launch_bounds__(kWarps * 32)
fused_requant_shiftgelu_kernel(const int* __restrict__ x, const float* __restrict__ r1,
                               const uint8_t* __restrict__ table, int8_t* __restrict__ out, int M,
                               int C) {
  __shared__ __align__(16) uint8_t rows[kWarps][256];
  const int lane = threadIdx.x % 32;
  uint8_t* trow = rows[threadIdx.x / 32];
  const float4* r4 = reinterpret_cast<const float4*>(r1);
  const int words = C / 4;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  // the loop bound is warp-uniform, so every lane reaches the vote
  for (long long row = first; row < M; row += stride) {
    const int4* x4 = reinterpret_cast<const int4*>(x + row * C);
    unsigned q[kSlots];
    int bits = ivit::kMagicBits - 128;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int i = lane + 32 * k;
      if (i < words) q[k] = requant4(x4[i], r4[i], bits);
    }
    for (int i = lane + 32 * kSlots; i < words; i += 32) requant4(x4[i], r4[i], bits);
    const int qmax = __reduce_max_sync(0xffffffffu, bits) - ivit::kMagicBits;

    __syncwarp();  // every lane is done with the previous row's table row
    reinterpret_cast<uint2*>(trow)[lane] =
        reinterpret_cast<const uint2*>(table + (static_cast<unsigned>(qmax) & 0xffu) * 256)[lane];
    __syncwarp();

    unsigned* o4 = reinterpret_cast<unsigned*>(out + row * C);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int i = lane + 32 * k;
      if (i < words) o4[i] = lookup4(trow, q[k]);
    }
    for (int i = lane + 32 * kSlots; i < words; i += 32) {
      int unused = 0;
      o4[i] = lookup4(trow, requant4(x4[i], r4[i], unused));
    }
  }
}

}  // namespace

// Launches K5 on `stream` with the GELU table of its (s_in, r2). Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue outside the
// domain: M >= 1, C >= 4 a multiple of 4, x, r1 and table 16-byte aligned.
extern "C" int ivit_fused_requant_shiftgelu(const void* x, const void* r1, const void* table, void* out,
                                            int M, int C, void* stream) {
  const uintptr_t in16 = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r1) |
                         reinterpret_cast<uintptr_t>(table);
  if (M < 1 || C < 4 || C % 4 != 0 || (in16 & 15) != 0 || (reinterpret_cast<uintptr_t>(out) & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a warp a row, at most one resident wave of blocks
  static std::atomic<int> wave[ivit::kMaxDevices];
  unsigned blocks = 0;
  const int e = ivit::one_wave_blocks(reinterpret_cast<const void*>(fused_requant_shiftgelu_kernel), kWarps * 32,
                                      (static_cast<long long>(M) + kWarps - 1) / kWarps, wave, &blocks);
  if (e != 0) return e;
  fused_requant_shiftgelu_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const float*>(r1), static_cast<const uint8_t*>(table),
      static_cast<int8_t*>(out), M, C);
  return static_cast<int>(cudaGetLastError());
}
