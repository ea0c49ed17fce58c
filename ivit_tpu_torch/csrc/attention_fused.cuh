// The fused integer window attention kernel of K7
// (window_attention_fused.cu), on the CUDA cores. K1 and K2 have their
// own kernel, on the int8 tensor cores (attention_mma.cuh).
//
// Per cell g (batch*window*head) and query row i:
//   s_ij  = q_i . k_j                        int8 x int8 -> int32 (__dp4a)
//   z_ij  = clip(rint(float(s_ij) * r1), -128, 127)
//   z_ij  = clip(rint(z_ij * rb) + bias_ij, -128, 127) [+ mask_ij]
//   e_ij  = shift_exp(z_ij - max_j z_ij)     (K0, shiftmax_common.cuh)
//   sm_ij = floor(e_ij * norm_factor(sum_j e_ij, 8))
//   c_id  = sum_j sm_ij * v_jd
//   out   = clip(rint(float(c_id) * r_out), -128, 127)  int8
// The (N, N) scores never leave the SM.
//
// K7 (ivit_tpu/kernels/window_attention_fused.py) is K1's exact chain
// (every shift-exp guard kept, the row sum an exact 64-bit integer sum
// rounded once, the @V sum exact in int32) at 8-bit probabilities, with
// Swin's relative-position bias merge between the requant and the
// Shiftmax. Cell g reads bias head g % heads and, for a shifted window,
// mask window (g / heads) % n_windows. The mask addend (-100/s_bias) is
// non-integral and far below -128, and it is added in f32 after the int8
// clip, so the row max starts at -inf and the shift-exp sees non-integral
// values, as in the spec (which is why K1's shift-exp table does not
// serve here).
//
// Layout: q, k, v, out are (G, N, hd) int8, contiguous and unpadded. The
// Pallas kernel pads N to 128 lanes and masks pad columns to probability
// 0; leaving them out is value-identical. The probabilities are at most
// 2^7 = 128 (a one-token row whose 1/scale is a power of two), and they
// are held in int, so the exact sum sm.v needs no split. The f32
// conversion of the context happens once, before the r_out multiply, as
// in the spec.
//
// Bound on the H100: N <= 256 (the same bound as the JAX kernels: the
// exact row sum there is a two-limb f32 sum, equal to an exact integer
// sum rounded once up to 256 columns). HBM traffic is only q, k, v in and
// the context out, plus the bias and mask planes, which stay in L2; the
// bound is on-chip work, 2*N*hd integer MACs per row. K and V of one cell
// are staged once per block in shared memory and reused by every row the
// block owns; Q.K^T uses __dp4a (4 MACs per instruction) on 4-byte words,
// with the K rows padded by one word so 32 lanes reading 32 different rows
// hit 32 different banks. One warp owns one query row at a time: its
// scores sit in registers (8 per lane), its probabilities in a per-warp
// shared row. The @V loop issues two shared-memory loads per MAC and is
// what limits it; packing several 49-token cells into the int8 MMA tiles
// of attention_mma.cuh is later work.

#pragma once

#include <cuda_runtime.h>

#include <math_constants.h>

#include <cstdint>

#include "shiftmax_common.cuh"

namespace ivit {

constexpr int kAttnWarps = 8;
constexpr int kAttnMaxN = 256;

// K7's extra operands: the relative-position bias and the shifted-window mask.
struct WindowArgs {
  const float* bias = nullptr;  // (heads, N, N) integer-valued f32
  const float* mask = nullptr;  // (n_windows, N, N) f32, or nullptr
  int heads = 1;
  int n_windows = 1;
  float rb = 0.0f;  // the merge ratio s_attn1 / s_bias
};

__global__ void __launch_bounds__(kAttnWarps * 32)
fused_window_attention_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                              const int8_t* __restrict__ v, int8_t* __restrict__ out, int N,
                              int hd, int rows_per_block, float r1, float scale, float r_out,
                              float n, WindowArgs win) {
  constexpr int kColsPerLane = kAttnMaxN / 32;
  extern __shared__ int smem[];
  const int words = hd / 4;
  const int kstride = words + 1;
  int* sK = smem;                            // N x kstride words
  int* sV = sK + N * kstride;                // N x words (int8 x hd)
  int* sP = sV + N * words;                  // kAttnWarps x kAttnMaxN probabilities
  int* sQ = sP + kAttnWarps * kAttnMaxN;     // kAttnWarps x words
  const int8_t* sV8 = reinterpret_cast<const int8_t*>(sV);

  const size_t head = static_cast<size_t>(blockIdx.x) * N * hd;
  const int* k32 = reinterpret_cast<const int*>(k + head);
  const int* v32 = reinterpret_cast<const int*>(v + head);
  for (int i = threadIdx.x; i < N * words; i += blockDim.x) {
    const int row = i / words;
    sK[row * kstride + (i - row * words)] = k32[i];
    sV[i] = v32[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float x0 = shift_exp_x0(scale);
  int* myP = sP + warp * kAttnMaxN;
  int* myQ = sQ + warp * words;
  const int row_begin = static_cast<int>(blockIdx.y) * rows_per_block;
  const int row_end = min(N, row_begin + rows_per_block);
  const size_t plane = static_cast<size_t>(N) * N;
  const float* bias = win.bias + (blockIdx.x % win.heads) * plane;
  const float* mask = nullptr;
  if (win.mask != nullptr) mask = win.mask + ((blockIdx.x / win.heads) % win.n_windows) * plane;

  for (int row = row_begin + warp; row < row_end; row += kAttnWarps) {
    const int* q32 = reinterpret_cast<const int*>(q + head + static_cast<size_t>(row) * hd);
    for (int w = lane; w < words; w += 32) myQ[w] = q32[w];
    __syncwarp();

    // scores -> requant to the int8 softmax input -> bias merge -> row max
    float z[kColsPerLane];
    // the merged scores lie in [-128, 127], the masked ones far below
    float zmax = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
      const int j = lane + 32 * t;
      z[t] = 0.0f;
      if (j < N) {
        const int* kr = sK + j * kstride;
        int acc = 0;
        for (int w = 0; w < words; ++w) acc = __dp4a(myQ[w], kr[w], acc);
        float zz = fminf(fmaxf(rintf(static_cast<float>(acc) * r1), -128.0f), 127.0f);
        const size_t at = static_cast<size_t>(row) * N + j;
        zz = fminf(fmaxf(rintf(zz * win.rb) + bias[at], -128.0f), 127.0f);
        if (mask != nullptr) zz = zz + mask[at];
        z[t] = zz;
        zmax = fmaxf(zmax, zz);
      }
    }
    zmax = warp_max(zmax);

    // shift-exp and its row sum, rounded once to f32
    unsigned long long esum = 0;
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
      if (lane + 32 * t < N) {
        z[t] = shift_exp(z[t] - zmax, x0, n);
        esum += static_cast<unsigned long long>(z[t]);
      }
    }
    const float esum_f = __ull2float_rn(warp_sum_u64(esum));
    const float factor = norm_factor(esum_f, 8);
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < N) myP[j] = static_cast<int>(floorf(z[t] * factor));
    }
    __syncwarp();

    // probabilities @ V, then requant to the int8 context
    int8_t* orow = out + head + static_cast<size_t>(row) * hd;
    for (int d = lane; d < hd; d += 32) {
      int acc = 0;
      for (int j = 0; j < N; ++j) acc += myP[j] * static_cast<int>(sV8[j * hd + d]);
      const float c = static_cast<float>(acc);
      orow[d] = static_cast<int8_t>(fminf(fmaxf(rintf(c * r_out), -128.0f), 127.0f));
    }
    __syncwarp();  // myQ / myP are rewritten by the warp's next row
  }
}

// Launches K7 on `stream`. Returns cudaGetLastError() (0 on success).
inline int launch_window_attention(const void* q, const void* k, const void* v, void* out, int G,
                                   int N, int hd, float r1, float scale, float r_out, int n,
                                   void* stream, const WindowArgs& win) {
  if (G < 1 || N < 1 || N > kAttnMaxN || hd < 4 || hd % 4 != 0 || hd > 256 ||
      win.bias == nullptr || win.heads < 1 || win.n_windows < 1 || G % win.heads != 0 ||
      (win.mask != nullptr && G % (win.heads * win.n_windows) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // enough blocks to cover the SMs at small batch: split each head's rows
  int rows_per_block = 32;
  while (rows_per_block > kAttnWarps &&
         static_cast<long long>(G) * ((N + rows_per_block - 1) / rows_per_block) < 264) {
    rows_per_block /= 2;
  }
  const int words = hd / 4;
  const size_t smem =
      sizeof(int) * (static_cast<size_t>(N) * (words + 1) + static_cast<size_t>(N) * words +
                     kAttnWarps * kAttnMaxN + kAttnWarps * words);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_window_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(G, (N + rows_per_block - 1) / rows_per_block);
  fused_window_attention_kernel<<<grid, kAttnWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<int8_t*>(out), N, hd, rows_per_block, r1, scale, r_out, static_cast<float>(n),
      win);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ivit
