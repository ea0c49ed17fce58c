// K6: fused requant -> masked Shiftmax -> base-256 (hi, lo) split, for
// Hopper (sm_90a).
//
// Replaces ivit_tpu/kernels/shiftmax_fused.py:fused_requant_shiftmax (the
// pl.pallas_call at :95, body _kernel :41-60). Per row of the (M, N) int32
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
// Bound on the H100: HBM bytes, 4 B read and 2 B written per score (179
// MB a launch at DeiT-S batch 128). What the design does about it:
//   * z - zmax is an integer in [-255, 0], so the shift-exp chain (three
//     correctly rounded divisions a score) is one lookup in a 256-entry
//     table each block fills with the unchanged chain (K1's fill, clip
//     on), as the u32 the exact sum adds; float(e) is that u32 converted
//     back (exact: e is an integer float32 of at most 2^31). The split is
//     integer: sm is an integer in [0, 2^15], so hi = min(sm >> 8, 127)
//     and lo = (sm & 255) - 128.
//   * A tile is kRows rows, a multiple of 16, so its input span (kRows*N
//     int32) and its two output spans (kRows*N bytes) are multiples of 16
//     bytes whatever N is, and so are their offsets from the tensors'
//     starts. The input span is copied flat into shared memory by 16-byte
//     cp.async (4-byte where x is not 16-byte aligned, as from a
//     row-slice view), double-buffered across the tiles a block strides
//     over. A warp then takes a row out of shared memory, lanes on
//     consecutive words, and writes each score's (hi, lo) as one 16-bit
//     pair; the block splits the pairs with byte permutes and stores each
//     output span with 16-byte stores.
//   * Measured on the card, the per-score instructions, not the bytes,
//     set the time (the same kernel without its global loads ran as long).
//     So a lane runs its columns without a branch (a masked column reads
//     a 0 table entry), four warps a block take four rows each (faster
//     than eight of two), the row sum is two 32-bit warp reductions
//     (warp_sum_u64) and not ten shuffles, and one 16-bit store a score
//     replaces two byte stores.
//   * The grid is one resident wave (ivit::one_wave_blocks); the shared
//     arrays are static, sized for N = 256, so the occupancy query counts
//     them.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "shiftmax_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 256;
constexpr int kSlots = kMaxN / 32;  // columns a lane takes in a row
constexpr int kRows = 16;           // rows a tile
constexpr int kTable = 256;         // z - zmax = -i for i in [0, 255]
// a masked column's bits: below every requantized score's by kTable or more
constexpr int kMasked = ivit::kMagicBits - 128 - kTable;
constexpr unsigned kTileBytes = kRows * kMaxN * 4;

// Issues the cp.async copies of `bytes` (a multiple of 4) from global `src`
// to shared `dst`, kBytes each (the last one short where bytes is not a
// multiple of kBytes: the rest of its chunk is zero-filled, the source
// read only up to `bytes`), and commits them as one group.
template <int kBytes>
__device__ __forceinline__ void stage_span(unsigned dst, const char* src, int bytes) {
  for (int c = threadIdx.x * kBytes; c < bytes; c += kThreads * kBytes) {
    const int valid = min(kBytes, bytes - c);
    if constexpr (kBytes == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst + c), "l"(src + c), "r"(valid));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst + c), "l"(src + c), "n"(kBytes),
                   "r"(valid));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Stores the `count` (hi, lo) pairs at shared `pairs` (hi the low byte) as
// hi[0, count) and lo[0, count) in global memory, all 16-byte aligned: 16
// of each a thread, split by byte permutes, then the last ones of a short
// span one at a time.
__device__ __forceinline__ void store_pairs(int8_t* hi, int8_t* lo, const uint16_t* pairs, int count) {
  const int vecs = count / 16;
  const uint4* p4 = reinterpret_cast<const uint4*>(pairs);
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
    const uint4 a = p4[2 * i];
    const uint4 b = p4[2 * i + 1];
    reinterpret_cast<uint4*>(hi)[i] = make_uint4(__byte_perm(a.x, a.y, 0x6420), __byte_perm(a.z, a.w, 0x6420),
                                                 __byte_perm(b.x, b.y, 0x6420), __byte_perm(b.z, b.w, 0x6420));
    reinterpret_cast<uint4*>(lo)[i] = make_uint4(__byte_perm(a.x, a.y, 0x7531), __byte_perm(a.z, a.w, 0x7531),
                                                 __byte_perm(b.x, b.y, 0x7531), __byte_perm(b.z, b.w, 0x7531));
  }
  for (int i = 16 * vecs + threadIdx.x; i < count; i += kThreads) {
    hi[i] = static_cast<int8_t>(pairs[i] & 0xffu);
    lo[i] = static_cast<int8_t>(pairs[i] >> 8);
  }
}

template <int kBytes>
__global__ void __launch_bounds__(kThreads)
fused_requant_shiftmax_kernel(const int* __restrict__ x, int8_t* __restrict__ hi, int8_t* __restrict__ lo,
                              int M, int N, int n_valid, float r1, float scale, float n, int out_bits) {
  __shared__ __align__(16) int tiles[2][kRows * kMaxN];
  __shared__ __align__(16) uint16_t pair_tile[kRows * kMaxN];
  // the shift-exp of z - zmax = -i, as the integer the row sum adds, and
  // a 0 entry for masked columns
  __shared__ unsigned table[kTable + 1];

  const int n_tiles = (M + kRows - 1) / kRows;
  const long long tile_words = static_cast<long long>(kRows) * N;
  const char* xb = reinterpret_cast<const char*>(x);
  const unsigned s_tiles = static_cast<unsigned>(__cvta_generic_to_shared(&tiles[0][0]));
  auto span_bytes = [&](int t) { return min(kRows, M - t * kRows) * N * 4; };

  // the block's first tile, then the table while it lands (the grid has
  // at most n_tiles blocks)
  int tile = blockIdx.x;
  stage_span<kBytes>(s_tiles, xb + tile * tile_words * 4, span_bytes(tile));
  const float x0 = ivit::shift_exp_x0(scale);
  for (int i = threadIdx.x; i < kTable; i += kThreads) {
    // 0 - i, as z - zmax is formed (+0 where z == zmax)
    table[i] = static_cast<unsigned>(ivit::shift_exp<true>(0.0f - static_cast<float>(i), x0, n));
  }
  if (threadIdx.x == 0) table[kTable] = 0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      stage_span<kBytes>(s_tiles + (buf ^ 1) * kTileBytes, xb + next * tile_words * 4, span_bytes(next));
    } else {
      asm volatile("cp.async.commit_group;\n" ::);  // an empty group keeps the count
    }
    asm volatile("cp.async.wait_group 1;\n" ::);  // this tile's copies have landed
    __syncthreads();

    const int rows = min(kRows, M - tile * kRows);
    // a warp a row; the loop bound is warp-uniform, so every lane reaches
    // the reductions. Every lane runs all kSlots columns without a branch:
    // a column past N reads a word of the tile's shared array (the row's
    // successor or unused space) and is not stored, and a masked one
    // (j >= n_valid) takes kMasked, which cannot win the max and indexes
    // the table's 0 entry, so it adds nothing and its sm is 0.
    for (int r = warp; r < rows; r += kWarps) {
      const int* xr = tiles[buf] + r * N;
      int bits[kSlots];
      int zmax = kMasked;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int j = lane + 32 * k;
        // kMagicBits + z; __int2float_rn takes any int32
        const int b = ivit::requant_bits(static_cast<float>(xr[j]) * r1);
        bits[k] = j < n_valid ? b : kMasked;
        zmax = max(zmax, bits[k]);
      }
      zmax = __reduce_max_sync(0xffffffffu, zmax);

      unsigned e[kSlots];
      unsigned long long esum = 0;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        e[k] = table[min(zmax - bits[k], kTable)];
        esum += e[k];
      }
      const float factor = ivit::norm_factor(__ull2float_rn(ivit::warp_sum_u64(esum)), out_bits);

      uint16_t* pr = pair_tile + r * N;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int j = lane + 32 * k;
        // sm in [0, 2^15]; lo + 128 = sm & 255, so lo's byte is (sm & 255) ^ 128
        const int sm = ivit::floor_bits(__uint2float_rn(e[k]) * factor) & 0x7fffff;
        const unsigned pair = min(sm >> 8, 127) | (((sm & 255) ^ 128) << 8);
        if (j < N) pr[j] = static_cast<uint16_t>(pair);
      }
    }
    __syncthreads();

    const long long out0 = tile * tile_words;
    store_pairs(hi + out0, lo + out0, pair_tile, rows * N);
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

template <int kBytes>
int launch(const void* x, void* hi, void* lo, int M, int N, int n_valid, float r1, float scale, int n,
           int out_bits, cudaStream_t stream) {
  static std::atomic<int> wave[ivit::kMaxDevices];
  unsigned blocks = 0;
  const int e = ivit::one_wave_blocks(reinterpret_cast<const void*>(fused_requant_shiftmax_kernel<kBytes>), kThreads,
                                      (static_cast<long long>(M) + kRows - 1) / kRows, wave, &blocks);
  if (e != 0) return e;
  fused_requant_shiftmax_kernel<kBytes><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(x), static_cast<int8_t*>(hi), static_cast<int8_t*>(lo), M, N, n_valid, r1, scale,
      static_cast<float>(n), out_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K6 on `stream`. Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue outside the domain: M >= 1, 1 <= N <= 256,
// 1 <= n_valid <= N, out_bits 8 or 16, x 4-byte and hi, lo 16-byte
// aligned. x is copied by 16-byte chunks where it is 16-byte aligned, else
// by 4-byte ones.
extern "C" int ivit_fused_requant_shiftmax(const void* x, void* hi, void* lo, int M, int N, int n_valid, float r1,
                                           float scale, int n, int out_bits, void* stream) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t out16 = reinterpret_cast<uintptr_t>(hi) | reinterpret_cast<uintptr_t>(lo);
  if (M < 1 || N < 1 || N > kMaxN || n_valid < 1 || n_valid > N || (out_bits != 8 && out_bits != 16) ||
      (xa & 3) != 0 || (out16 & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return (xa & 15) == 0 ? launch<16>(x, hi, lo, M, N, n_valid, r1, scale, n, out_bits, s)
                        : launch<4>(x, hi, lo, M, N, n_valid, r1, scale, n, out_bits, s);
}
