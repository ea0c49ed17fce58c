// K9: fc1's int32 bias add -> per-channel requant -> stable ShiftGELU ->
// requant to int8, as one table lookup an element, for Hopper (sm_90a).
//
// The port's own kernel (the JAX engine runs this chain as XLA ops,
// ivit_tpu/deploy/engine.py's fc1 epilogue under gelu_stable). For each
// element of the (M, C) int32 fc1 accumulator:
//   q   = clip(rint(float(x + b[c]) * r1[c]), -128, 127)
//   out = table[q + 128]
// The stable ShiftGELU reads the element alone (no row max), so the chain
// after the requant, with its r2 requant to int8, depends only on q and on
// the block's two scalars: a 256-entry int8 table, filled on the card by
// the plain torch chain itself (kernels/stable_gelu_fused.py:
// stable_gelu_table). The arithmetic here is the plain ops': an int32 add
// that wraps, a round-to-nearest conversion to float32, a float32 multiply
// (-fmad=false), rint half to even (ivit::requant_bits) and the clip.
//
// Bound on the H100: HBM bytes (4 B in, 1 B out an element; 194 MB a
// launch at DeiT-S batch 128). Each thread owns one 4-channel word of a
// row for the whole launch, with that word's b and r1 in registers, and
// walks the rows in a grid-stride loop, kRows rows an iteration so that
// kRows 16-byte loads are in flight; the table sits in shared memory,
// indexed by q's two's-complement byte, and four outputs go out as one
// 4-byte store (a warp stores 128 contiguous bytes). A C that is not a
// multiple of 4, or a base off a 16-byte boundary, takes the same walk one
// channel a thread.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "shiftmax_common.cuh"

namespace {

constexpr int kThreads = 256;  // a block: kThreads / width rows of `width` words
constexpr int kRows = 4;       // rows a thread has in flight

template <int V>
struct Word;

template <>
struct Word<4> {
  using Int = int4;
  using Float = float4;
  using Out = unsigned;
};

template <>
struct Word<1> {
  using Int = int;
  using Float = float;
  using Out = uint8_t;
};

// The table entry of one channel: q's two's-complement byte indexes it.
__device__ __forceinline__ unsigned lookup(const uint8_t* table, int acc, int b, float r) {
  const int sum = static_cast<int>(static_cast<unsigned>(acc) + static_cast<unsigned>(b));  // wraps as int32
  return table[ivit::requant_bits(__fmul_rn(static_cast<float>(sum), r)) & 0xff];
}

__device__ __forceinline__ unsigned lookup_word(const uint8_t* table, int4 a, int4 b, float4 r) {
  return lookup(table, a.x, b.x, r.x) | (lookup(table, a.y, b.y, r.y) << 8) |
         (lookup(table, a.z, b.z, r.z) << 16) | (lookup(table, a.w, b.w, r.w) << 24);
}

__device__ __forceinline__ uint8_t lookup_word(const uint8_t* table, int a, int b, float r) {
  return static_cast<uint8_t>(lookup(table, a, b, r));
}

// blockDim = (width, kThreads / width): threadIdx.x picks the word of the
// block's column tile, threadIdx.y the row within the block's rows.
template <int V>
__global__ void __launch_bounds__(kThreads)
stable_gelu_table_kernel(const int* __restrict__ x, const int* __restrict__ b, const float* __restrict__ r1,
                         const int8_t* __restrict__ table, int8_t* __restrict__ out, int M, int C) {
  using Int = typename Word<V>::Int;
  using Float = typename Word<V>::Float;
  using Out = typename Word<V>::Out;
  __shared__ __align__(16) uint8_t t[256];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  // t[byte] = table[byte ^ 0x80]: entry i of the table is q = i - 128
  if (tid < 64) {
    reinterpret_cast<unsigned*>(t)[tid ^ 32] = reinterpret_cast<const unsigned*>(table)[tid];
  }
  __syncthreads();

  const int words = C / V;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= words) return;
  const Float r = reinterpret_cast<const Float*>(r1)[w];
  const Int bias = reinterpret_cast<const Int*>(b)[w];
  const Int* xw = reinterpret_cast<const Int*>(x) + w;
  Out* ow = reinterpret_cast<Out*>(out) + w;
  const long long step = static_cast<long long>(gridDim.y) * blockDim.y;
  for (long long row = static_cast<long long>(blockIdx.y) * blockDim.y + threadIdx.y; row < M;
       row += kRows * step) {
    Int a[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const long long rk = row + k * step;
      if (rk < M) a[k] = __ldcs(xw + rk * words);  // read once: stream it past the caches
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const long long rk = row + k * step;
      if (rk < M) ow[rk * words] = lookup_word(t, a[k], bias, r);
    }
  }
}

template <int V>
int launch(const void* x, const void* b, const void* r1, const void* table, void* out, int M, int C,
           cudaStream_t stream) {
  const int words = C / V;
  // column tiles of at most 128 words, each as even as whole warps allow
  const int tiles = (words + 127) / 128;
  const int width = 32 * (((words + tiles - 1) / tiles + 31) / 32);
  const dim3 block(width, kThreads / width);
  static std::atomic<int> wave[ivit::kMaxDevices];
  unsigned blocks = 0;
  const long long row_blocks = (static_cast<long long>(M) + block.y * kRows - 1) / (block.y * kRows);
  const int e = ivit::one_wave_blocks(reinterpret_cast<const void*>(stable_gelu_table_kernel<V>),
                                      block.x * block.y, row_blocks * tiles, wave, &blocks);
  if (e != 0) return e;
  const unsigned rows = blocks / tiles > 0 ? blocks / tiles : 1;
  stable_gelu_table_kernel<V><<<dim3(tiles, rows), block, 0, stream>>>(
      static_cast<const int*>(x), static_cast<const int*>(b), static_cast<const float*>(r1),
      static_cast<const int8_t*>(table), static_cast<int8_t*>(out), M, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K9 on `stream`: out (M, C) int8 from x (M, C) int32, the int32
// bias b (C,), the float32 ratios r1 (C,) and the (256,) int8 table.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// outside the domain: M, C >= 1, b given, table 4-byte aligned.
extern "C" int ivit_fused_requant_stable_gelu(const void* x, const void* b, const void* r1, const void* table,
                                              void* out, int M, int C, void* stream) {
  if (M < 1 || C < 1 || b == nullptr || (reinterpret_cast<uintptr_t>(table) & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 16-byte loads of x, b and r1, 4-byte stores of out
  const uintptr_t in16 = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(r1);
  const bool vec = C % 4 == 0 && (in16 & 15) == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<4>(x, b, r1, table, out, M, C, s) : launch<1>(x, b, r1, table, out, M, C, s);
}
