// K1: fully fused integer attention for Hopper (sm_90a).
//
// Replaces ivit_tpu/kernels/attention_fused.py:fused_int8_attention (the
// pl.pallas_call at :126, body _one_head :29-63). Per batch*head g and
// query row i:
//   s_ij  = q_i . k_j                        int8 x int8 -> int32 (__dp4a)
//   z_ij  = clip(rint(float(s_ij) * r1), -128, 127)
//   e_ij  = shift_exp(z_ij - max_j z_ij)     (K0, shiftmax_common.cuh)
//   sm_ij = floor(e_ij * norm_factor(sum_j e_ij, out_bits))
//   c_id  = sum_j sm_ij * v_jd               exact int32
//   out   = clip(rint(float(c_id) * r_out), -128, 127)  int8
// The (N, N) scores never leave the SM.
//
// Layout: q, k, v, out are (G, N, hd) int8, contiguous and unpadded. The
// Pallas kernel pads N to 128 lanes and masks pad columns to probability
// 0; leaving them out is value-identical. At out_bits=8 the
// probabilities are <= 127 and at 16 <= 2^15, and the exact int32 sum
// sm.v equals the JAX kernel's base-256 split (256*hi@V + lo@V +
// 128*sum v), so one integer loop serves both widths. The int32 -> f32
// conversion happens once, before the r_out multiply, as in the spec.
//
// Bound on the H100: N <= 256 (the same bound as the JAX kernel: the
// exact row sum there is a two-limb f32 sum; here it is a 64-bit integer
// sum rounded once, equal to it up to 256 columns). HBM traffic is only
// q, k, v in and the context out; the bound is on-chip work, 2*N*hd
// integer MACs per row. K and V of one head (2*N*hd bytes, 25 KB for
// DeiT-S) are staged once per block in shared memory and reused by every
// row the block owns; Q.K^T uses __dp4a (4 MACs per instruction) on
// 4-byte words, with the K rows padded by one word so 32 lanes reading 32
// different rows hit 32 different banks. One warp owns one query row at
// a time: its scores sit in registers (8 per lane), its probabilities in
// a per-warp shared row. The @V loop issues two shared-memory loads per
// MAC and is what limits this first version; int8 tensor-core MMA
// (mma.sync / wgmma) for both products is later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "shiftmax_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxN = 256;
constexpr int kColsPerLane = kMaxN / 32;

__global__ void __launch_bounds__(kWarps * 32)
fused_int8_attention_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                            const int8_t* __restrict__ v, int8_t* __restrict__ out, int N,
                            int hd, int rows_per_block, float r1, float scale, float r_out,
                            float n, int out_bits) {
  extern __shared__ int smem[];
  const int words = hd / 4;
  const int kstride = words + 1;
  int* sK = smem;                            // N x kstride words
  int* sV = sK + N * kstride;                // N x words (int8 x hd)
  int* sP = sV + N * words;                  // kWarps x kMaxN probabilities
  int* sQ = sP + kWarps * kMaxN;             // kWarps x words
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
  const float x0 = ivit::shift_exp_x0(scale);
  int* myP = sP + warp * kMaxN;
  int* myQ = sQ + warp * words;
  const int row_begin = static_cast<int>(blockIdx.y) * rows_per_block;
  const int row_end = min(N, row_begin + rows_per_block);

  for (int row = row_begin + warp; row < row_end; row += kWarps) {
    const int* q32 = reinterpret_cast<const int*>(q + head + static_cast<size_t>(row) * hd);
    for (int w = lane; w < words; w += 32) myQ[w] = q32[w];
    __syncwarp();

    // scores -> requant to the int8 softmax input -> row max
    float z[kColsPerLane];
    float zmax = -128.0f;  // the requantized scores lie in [-128, 127]
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
      const int j = lane + 32 * t;
      z[t] = 0.0f;
      if (j < N) {
        const int* kr = sK + j * kstride;
        int acc = 0;
        for (int w = 0; w < words; ++w) acc = __dp4a(myQ[w], kr[w], acc);
        const float zz = fminf(fmaxf(rintf(static_cast<float>(acc) * r1), -128.0f), 127.0f);
        z[t] = zz;
        zmax = fmaxf(zmax, zz);
      }
    }
    zmax = ivit::warp_max(zmax);

    // shift-exp and its exact row sum
    unsigned long long esum = 0;
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
      if (lane + 32 * t < N) {
        z[t] = ivit::shift_exp(z[t] - zmax, x0, n);
        esum += static_cast<unsigned long long>(z[t]);
      }
    }
    esum = ivit::warp_sum_u64(esum);
    const float factor = ivit::norm_factor(__ull2float_rn(esum), out_bits);
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < N) myP[j] = static_cast<int>(floorf(z[t] * factor));
    }
    __syncwarp();

    // probabilities @ V, exact in int32, then requant to the int8 context
    int8_t* orow = out + head + static_cast<size_t>(row) * hd;
    for (int d = lane; d < hd; d += 32) {
      int acc = 0;
      for (int j = 0; j < N; ++j) acc += myP[j] * static_cast<int>(sV8[j * hd + d]);
      const float c = fminf(fmaxf(rintf(static_cast<float>(acc) * r_out), -128.0f), 127.0f);
      orow[d] = static_cast<int8_t>(c);
    }
    __syncwarp();  // myQ / myP are rewritten by the warp's next row
  }
}

}  // namespace

// Launches K1 on `stream`. Returns cudaGetLastError() (0 on success).
extern "C" int ivit_fused_int8_attention(const void* q, const void* k, const void* v, void* out,
                                         int G, int N, int hd, float r1, float scale,
                                         float r_out, int n, int out_bits, void* stream) {
  if (G < 1 || N < 1 || N > kMaxN || hd < 4 || hd % 4 != 0 || hd > 256 ||
      (out_bits != 8 && out_bits != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // enough blocks to cover the SMs at small batch: split each head's rows
  int rows_per_block = 32;
  while (rows_per_block > kWarps &&
         static_cast<long long>(G) * ((N + rows_per_block - 1) / rows_per_block) < 264) {
    rows_per_block /= 2;
  }
  const int words = hd / 4;
  const size_t smem =
      sizeof(int) * (static_cast<size_t>(N) * (words + 1) + static_cast<size_t>(N) * words +
                     kWarps * kMaxN + kWarps * words);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_int8_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(G, (N + rows_per_block - 1) / rows_per_block);
  fused_int8_attention_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<int8_t*>(out), N, hd, rows_per_block, r1, scale, r_out, static_cast<float>(n),
      out_bits);
  return static_cast<int>(cudaGetLastError());
}
