// K4: int8 fc1 GEMM with the requant -> row-max ShiftGELU -> requant
// chain as its epilogue, for Hopper (sm_90a).
//
// Replaces ivit_tpu/kernels/linear_gelu_fused.py:fused_linear_shiftgelu
// (the pl.pallas_call at :87, body _kernel :43-62). For x (M, K) int8,
// w (K, C) int8 held K-contiguous as w_t (C, K), b (C,) int32:
//   acc = x @ w + b                               exact int32
//   q   = clip(rint(float(acc) * r1[c]), -128, 127)
//   out = the row-max ShiftGELU chain of gelu_common.cuh over the whole
//         row of C outputs, then the r2 requant to int8.
// The (M, C) int32 accumulator and the int8 GELU input never reach HBM.
//
// Design. The row max spans all C outputs (1536 at DeiT-S), so a block
// owns whole rows: 32 rows (two 16-row tiles of the tensor-core MMA) by
// all C columns. The TPU kernel keeps the whole (K, C) weight and 256
// rows in VMEM; here the int8 rows of x (32 x K, 12.5 KB at K = 384) sit
// in shared memory, the weight streams from L2 through each warp's
// registers, and each 32 x 32 output tile is requantized to int8 as soon
// as it is computed and parked in shared memory (32 x C bytes, 48 KB at
// C = 1536), not the 32 x C int32 accumulator. The product runs on the
// tensor cores with mma.sync.m16n8k32 s8 x s8 -> s32, written in the
// kernel (no cuBLAS, no torch._int_mm). After a barrier, one warp per
// row takes the row max and writes the GELU output.
//
// Bound on the H100: at DeiT-S batch 128 (M = 25216, K = 384,
// C = 1536) the int8 products (29.7 GOP, 15 us at 1,979 TOP/s) and the
// float32 GELU chain (~39M elements x a few dozen ops, ~15 us at
// 67 TFLOP/s) outweigh the 49 MB of HBM traffic (15 us), so it is bound
// by operations. This first version feeds mma.sync from plain loads with
// no pipelining; wgmma with TMA-fed shared-memory stages is later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "gelu_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMTiles = 2;                        // 16-row MMA tiles per block
constexpr int kRows = 16 * kMTiles;               // rows per block
constexpr int kNTiles = 4;                        // 8-column MMA tiles per warp step
constexpr int kWarpCols = 8 * kNTiles;            // columns per warp step
constexpr int kBlockCols = kWarps * kWarpCols;    // columns per block step
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Words of one x row in shared memory: K padded to the MMA depth of 32.
__host__ __device__ __forceinline__ int padded_words(int K) { return (K + 31) / 32 * 8; }

__global__ void __launch_bounds__(kWarps * 32)
fused_linear_shiftgelu_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w_t,
                              const int* __restrict__ b, const float* __restrict__ r1,
                              int8_t* __restrict__ out, int M, int K, int C, float s_in,
                              float r2, float n) {
  extern __shared__ int smem[];
  const int kw = padded_words(K);
  const int kw_real = K / 4;
  // row stride kw + 4 words: the 8 rows a fragment load touches start 4,
  // 12, 20 or 28 banks apart, so its 32 lanes hit 32 banks
  const int xs = kw + 4;
  int* sx = smem;                                                  // kRows x xs words
  int8_t* sq = reinterpret_cast<int8_t*>(sx + kRows * xs);        // kRows x C int8

  const long long m0 = static_cast<long long>(blockIdx.x) * kRows;
  const int* x32 = reinterpret_cast<const int*>(x);
  for (int i = threadIdx.x; i < kRows * kw; i += blockDim.x) {
    const int r = i / kw;
    const int wd = i - r * kw;
    const long long m = m0 + r;
    sx[r * xs + wd] = (m < M && wd < kw_real) ? x32[m * kw_real + wd] : 0;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // the MMA fragments' group (row / column) index
  const int t = lane & 3;   // the thread's index within its group
  const int* w32 = reinterpret_cast<const int*>(w_t);

  for (int c0 = warp * kWarpCols; c0 < C; c0 += kBlockCols) {
    int acc[kMTiles][kNTiles][4] = {};
    for (int kb = 0; kb < kw; kb += 8) {  // 32 int8 of depth per step
      int a[kMTiles][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        const int* r0 = sx + (mt * 16 + g) * xs + kb + t;
        const int* r8 = r0 + 8 * xs;
        a[mt][0] = r0[0];
        a[mt][1] = r8[0];
        a[mt][2] = r0[4];
        a[mt][3] = r8[4];
      }
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const int col = c0 + nt * 8 + g;
        int b0 = 0, b1 = 0;
        if (col < C) {
          const int* wr = w32 + static_cast<long long>(col) * kw_real + kb + t;
          if (kb + t < kw_real) b0 = wr[0];
          if (kb + 4 + t < kw_real) b1 = wr[4];
        }
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
      }
    }
    // + bias, requant by r1 into the int8 GELU input, parked in shared memory
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + nt * 8 + 2 * t + e;
        if (col >= C) continue;
        const int bias = b[col];
        const float r = r1[col];
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = mt * 16 + g + 8 * h;
            const float q = rintf(static_cast<float>(acc[mt][nt][2 * h + e] + bias) * r);
            sq[row * C + col] = static_cast<int8_t>(fminf(fmaxf(q, -128.0f), 127.0f));
          }
        }
      }
    }
  }
  __syncthreads();

  // the row-max ShiftGELU, one warp per row
  const float x0 = ivit::gelu_x0(s_in);
  for (int r = warp; r < kRows && m0 + r < M; r += kWarps) {
    const int8_t* qr = sq + r * C;
    float qmax = -128.0f;
    for (int c = lane; c < C; c += 32) qmax = fmaxf(qmax, static_cast<float>(qr[c]));
    qmax = ivit::warp_max(qmax);
    const float exp_max = ivit::shift_exp(-qmax, x0, n);
    int8_t* orow = out + (m0 + r) * C;
    for (int c = lane; c < C; c += 32) {
      orow[c] = ivit::requant_i8(
          ivit::shiftgelu_rowmax(static_cast<float>(qr[c]), qmax, exp_max, x0, n), r2);
    }
  }
}

}  // namespace

// Launches K4 on `stream`. Returns cudaGetLastError() (0 on success).
extern "C" int ivit_fused_linear_shiftgelu(const void* x, const void* w_t, const void* b,
                                           const void* r1, void* out, int M, int K, int C,
                                           float s_in, float r2, int n, void* stream) {
  if (M < 1 || K < 4 || K % 4 != 0 || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(int) * kRows * (padded_words(K) + 4) + static_cast<size_t>(kRows) * C;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_linear_shiftgelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned int blocks = static_cast<unsigned int>((M + kRows - 1) / kRows);
  fused_linear_shiftgelu_kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w_t), static_cast<const int*>(b),
      static_cast<const float*>(r1), static_cast<int8_t*>(out), M, K, C, s_in, r2,
      static_cast<float>(n));
  return static_cast<int>(cudaGetLastError());
}
