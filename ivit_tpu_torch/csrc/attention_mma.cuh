// The fused integer attention kernel of K1 (attention_fused.cu) and K2
// (attention_fused_v2.cu), on Hopper's int8 tensor cores. Its fragment
// helpers (ldmatrix_x4, mma_s8s8, mma_u8s8, stage_rows, stage_vt, sigma)
// also build K7 (window_attention_fused.cu) and K4 (linear_gelu_fused.cu);
// its exact integer <-> float steps (int_to_float, requant_bits,
// floor_bits) come from shiftmax_common.cuh.
//
// Per cell g (batch*head) and query row i:
//   s_ij  = q_i . k_j                        int8 x int8 -> int32 (MMA)
//   z_ij  = clip(rint(float(s_ij) * r1), -128, 127)
//   e_ij  = shift_exp(z_ij - max_j z_ij)     (K0, shiftmax_common.cuh)
//   sm_ij = floor(e_ij * norm_factor(sum_j e_ij, out_bits))
//   c_id  = sum_j sm_ij * v_jd               exact int32 (MMA)
//   out   = clip(rint(float(c_id) * r_out), -128, 127)  int8
// The (N, N) scores never leave the SM.
//
// kV2=false is K1 (ivit_tpu/kernels/attention_fused.py): every shift-exp
// guard kept and the row sum an exact 64-bit integer sum rounded once.
// kV2=true is K2 (ivit_tpu/kernels/attention_fused_v2.py): the shift-exp
// clip elided and the row sum accumulated in int32, both exact under v2's
// gate n_valid * ceil(1/scale) * 2^n < 2^31, which its wrapper enforces.
// K2's float32 @V is exact (a row's probabilities sum to < 2^15 and
// |v| <= 128, so every partial sum stays below 2^22), so both modes run
// the same integer product and give the same integers under the gate.
//
// Layout: q, k, v, out are (G, N, hd) int8, contiguous and unpadded, with
// N <= 256 (the exact row-sum bound of the JAX kernels) and hd a multiple
// of 4 up to 256. The Pallas kernels pad N to 128 lanes and mask the pad
// columns to probability 0; the pads here are zero rows of K and V in
// shared memory and columns excluded from the max and the sum.
//
// What bounds it on the H100: at DeiT-S batch 128 (768, 197, 64) the
// products are 7.6 G int8 operations at 8 bits and 11.4 G at 16 (4-6 us
// at the tensor cores' peak), the per-score work is a requant, a max, a
// subtract, a lookup, a multiply, a floor and a sum (about 10
// instructions over 29.8 M scores, 6 us on the float32 lanes), and HBM
// moves q, k, v in and the context out (38.7 MB, 11.6 us): bytes bound it.
// The design:
//   * one warp owns 16 query rows against all N keys; a block holds up to
//     8 warps of one cell and stages that cell's K (row-major, as stored)
//     and the block's Q rows with cp.async and V transposed, once, with N
//     padded to a multiple of 32 and hd to 32, 64, 128 or 256 by zeros
//     (exact: zero padding of a reduction dimension adds nothing);
//   * Q.K^T runs on mma.sync.m16n8k32 s8 x s8 -> s32 (A = Q and B = K
//     through ldmatrix: K-major rows are the .col B layout), with the depth
//     a template parameter so no MMA waits on a padded step; |s| <= 2^22;
//   * the int8 scores stay in registers, packed 4 to a word (one MMA C
//     fragment), and the row max takes two quad shuffles, since a row of
//     a C fragment lives in 4 lanes; one __vsub4 a word then turns them
//     into the table indices zmax - z;
//   * shift_exp depends only on the integer z - zmax in [-255, 0] and on
//     launch constants, so each block fills a 256-entry table with the
//     unchanged K0 chain (and its integer for the row sum) and every score
//     does one lookup a pass (bit-identical by construction; the
//     ~20-instruction chain with its three divisions was the next limit
//     once the products left the CUDA cores);
//   * the integer <-> float steps (float(s), rint, floor) go through the
//     float32 adder with 1.5 * 2^23 or 2^23 (round toward zero), exactly,
//     not through the conversion unit, which runs at a quarter of the rate;
//   * the probabilities go from the score C fragments to the @V A
//     fragments in registers (FlashAttention-2's reuse): a lane holds keys
//     8j + 2t + {0, 1} of its rows, so the @V product takes the keys of
//     each 32-key chunk in the order sigma(p) below, and V^T is staged in
//     that order. V^T is transposed in registers with byte permutes while
//     it is staged (ldmatrix.trans moves 16-bit elements, not bytes); its
//     pad keys are zero rows, so pad columns need no mask in that product;
//   * @V runs on mma.sync.m16n8k32 u8 x s8 -> s32 with B = V^T. The
//     probabilities reach 2^(out_bits-1) (128 at 8 bits, 2^15 at 16, in a
//     one-token row whose 1/scale is a power of two), so A is unsigned: at
//     8 bits sm itself, at 16 bits sm = 256 hi + lo with hi in [0, 128]
//     and lo in [0, 255], two products and c = 256 c_hi + c_lo, exact in
//     int32 (no offset and no saturation, unlike the Pallas kernel's
//     signed split);
//   * mma.sync, not wgmma: the tensor-core work is a small share of the
//     bound, so wgmma's 64-row warpgroup tile buys nothing here;
//   * 128 registers a thread (two blocks an SM): the score words and the
//     @V accumulators are most of them.
// Head dims past 64 are taken in passes of 64 to bound the accumulators.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "shiftmax_common.cuh"

namespace ivit {
namespace attn_mma {

constexpr int kMaxN = 256;
constexpr int kMaxWarps = 8;
constexpr int kRows = 16;                  // query rows per warp (the MMA's M)
constexpr int kMaxKeyTiles = kMaxN / 8;    // score C fragments of 8 keys per row pair
constexpr int kDimTiles = 8;               // 8-wide head-dim tiles per @V pass
constexpr int kTable = 256;                // shift_exp of z - zmax in [-255, 0]

// Dynamic shared memory of a block: K (np x hdp, row stride ks), V^T
// (hdp x np in the permuted key order, row stride vs) and the block's Q
// rows (row stride ks). The strides are 16 bytes past a multiple of 32, so
// the 8 rows an ldmatrix phase reads fall in 8 different bank quads.
struct Layout {
  int np, hdp, ks, vs;
  size_t vt, q, bytes;
};

// hd is padded to 32 * depth, depth = 1, 2, 4 or 8 steps of the Q.K^T MMA.
__host__ __device__ constexpr int depth_steps(int hd) {
  return hd <= 32 ? 1 : hd <= 64 ? 2 : hd <= 128 ? 4 : 8;
}

__host__ __device__ inline Layout layout(int N, int hd, int rows) {
  Layout L;
  L.np = (N + 31) / 32 * 32;
  L.hdp = 32 * depth_steps(hd);
  L.ks = L.hdp + 16;
  L.vs = L.np + 16;
  L.vt = static_cast<size_t>(L.np) * L.ks;
  L.q = L.vt + static_cast<size_t>(L.hdp) * L.vs;
  L.bytes = L.q + static_cast<size_t>(rows) * L.ks;
  return L;
}

// Four 8x16-byte matrices at shared-memory address `addr`; lanes
// 8m..8m+7 give the row addresses of matrix m, and lane l receives bytes
// 4(l%4)..4(l%4)+3 of row l/4 of each.
__device__ __forceinline__ void ldmatrix_x4(int (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 32, row) . b (32 x 8, col): s8 x s8 or u8 x s8 -> s32.
__device__ __forceinline__ void mma_s8s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_u8s8(int (&c)[4], const unsigned (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [0, rows) of hdp bytes into shared memory at `dst` (an address),
// row stride `stride`, from `valid` rows of hd bytes in global memory, by
// cp.async of kBytes; the rest is zero-filled (the source is then not read).
template <int kBytes>
__device__ __forceinline__ void stage_rows(unsigned dst, int stride, const int8_t* src, int valid,
                                           int rows, int hd, int hdp) {
  const int per_row = hdp / kBytes;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kBytes;
    const bool ok = r < valid && c < hd;
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst + r * stride + c),
                 "l"(ok ? src + static_cast<size_t>(r) * hd + c : src), "n"(kBytes),
                 "r"(ok ? kBytes : 0));
  }
}

// Byte kByte of each of a, b, c, d, packed little-endian into one word.
template <int kByte>
__device__ __forceinline__ unsigned pack_bytes(int a, int b, int c, int d) {
  constexpr unsigned kSel = kByte | ((4 + kByte) << 4);
  return __byte_perm(__byte_perm(a, b, kSel), __byte_perm(c, d, kSel), 0x5410);
}

// The key the @V product takes at position p of a 32-key chunk: lane
// (g, t) holds the probabilities of keys 8j + 2t + e (j < 4, e < 2) of its
// rows, and the A fragment wants positions 4t..4t+3 and 16+4t..16+4t+3,
// so position 16h + 4t + i holds key 16h + 8(i/2) + 2t + i%2.
__host__ __device__ constexpr int sigma(int p) {
  return (p & 16) + 8 * ((p & 3) >> 1) + 2 * ((p >> 2) & 3) + (p & 1);
}

// V^T of one cell into shared memory at `vt` (hdp rows of np keys in the
// sigma order, row stride vs bytes) from the (N, hd) int8 rows at `v`
// (4-byte aligned; in global memory, or kShared: a copy in shared memory),
// transposed in registers with byte permutes; the pad keys and dims are
// zero. Each thread's loads are in flight together.
template <bool kShared = false>
__device__ __forceinline__ void stage_vt(unsigned char* vt, const int8_t* v, int N, int hd,
                                         const Layout& L) {
  constexpr int kBatch = 4;     // V^T words a thread loads before it stores
  const int groups = L.np / 4;  // 4 keys (one V^T word) each
  const int items = groups * (L.hdp / 4);
  const int hw = hd / 4;
  const int vsw = L.vs / 4;
  const int* v32 = reinterpret_cast<const int*>(v);
  int* vt32 = reinterpret_cast<int*>(vt);
  for (int i0 = threadIdx.x; i0 < items; i0 += kBatch * blockDim.x) {
    unsigned x[kBatch][4];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      const int w = (i >> 2) / groups * 4 + (i & 3);  // 4 dims: 4w..4w+3
      const int pg = (i >> 2) % groups;               // positions 4pg..4pg+3
      const int key = (pg >> 3) * 32 + sigma(4 * (pg & 7));  // keys key, +1, +8, +9
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = key + (j >> 1) * 8 + (j & 1);
        const bool ok = i < items && kj < N && w < hw;
        if constexpr (kShared) {
          x[b][j] = ok ? static_cast<unsigned>(v32[kj * hw + w]) : 0u;
        } else {
          x[b][j] = ok ? static_cast<unsigned>(__ldg(v32 + kj * hw + w)) : 0u;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i >= items) break;
      const int w = (i >> 2) / groups * 4 + (i & 3);
      const int pg = (i >> 2) % groups;
      const unsigned lo01 = __byte_perm(x[b][0], x[b][1], 0x5140);
      const unsigned lo23 = __byte_perm(x[b][2], x[b][3], 0x5140);
      const unsigned hi01 = __byte_perm(x[b][0], x[b][1], 0x7362);
      const unsigned hi23 = __byte_perm(x[b][2], x[b][3], 0x7362);
      int* col = vt32 + 4 * w * vsw + pg;
      col[0] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
      col[vsw] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
      col[2 * vsw] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
      col[3 * vsw] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
    }
  }
}

template <bool kV2, bool kWide, int kDepth>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
attention_mma_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                     const int8_t* __restrict__ v, int8_t* __restrict__ out, int N, int hd,
                     float r1, float scale, float r_out, float n) {
  using Sum = std::conditional_t<kV2, int, unsigned long long>;
  using Term = std::conditional_t<kV2, int, unsigned>;
  constexpr int kBits = kWide ? 16 : 8;
  // the shift-exp of z - zmax = -i: f32 for the probabilities, and the
  // integer the row sum adds (K1: e <= 2^31 as u32; K2: int32, as v2)
  __shared__ float table[kTable];
  __shared__ Term table_int[kTable];
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const Layout L = layout(N, hd, warps * kRows);
  const unsigned sK = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned sVt = sK + static_cast<unsigned>(L.vt);
  const unsigned sQ = sK + static_cast<unsigned>(L.q);

  // stage K and the block's Q rows (cp.async) and V^T (transposed in
  // registers, each thread's loads in flight together), then fill the
  // tables while the copies land
  const size_t head = static_cast<size_t>(blockIdx.x) * N * hd;
  const int row_base = static_cast<int>(blockIdx.y) * warps * kRows;
  const int8_t* qb = q + head + static_cast<size_t>(row_base) * hd;
  if (hd % 16 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)) & 15) == 0) {
    stage_rows<16>(sK, L.ks, k + head, N, L.np, hd, L.hdp);
    stage_rows<16>(sQ, L.ks, qb, N - row_base, warps * kRows, hd, L.hdp);
  } else {
    stage_rows<4>(sK, L.ks, k + head, N, L.np, hd, L.hdp);
    stage_rows<4>(sQ, L.ks, qb, N - row_base, warps * kRows, hd, L.hdp);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  stage_vt(smem + L.vt, v + head, N, hd, L);
  const float x0 = shift_exp_x0(scale);
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) {
    // 0 - i, as z - zmax is formed (+0 where z == zmax)
    const float e = shift_exp<!kV2>(0.0f - static_cast<float>(i), x0, n);
    table[i] = e;
    table_int[i] = static_cast<Term>(e);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // the fragments' row (A, C) or column (B) in its group of 8
  const int t = lane & 3;
  const int row0 = row_base + warp * kRows;
  if (row0 >= N) return;  // no barrier follows
  const int key_tiles = L.np / 8;
  const int lim = N - 2 * t;  // key 8nt + 2t + e is a column where 8nt + e < lim
  // ldmatrix row addresses: Q as the A fragment (matrices rows 0-7 and
  // 8-15 x bytes 0-15 and 16-31); K and V^T as two B fragments (matrices
  // bytes 0-15 and 16-31 x rows 0-7 and 8-15 of two 8-row tiles)
  const unsigned qa_row = sQ + (warp * kRows + (lane & 7) + 8 * ((lane >> 3) & 1)) * L.ks + 16 * (lane >> 4);
  const int b_off = (lane & 7) + 8 * (lane >> 4);
  const unsigned k_row = sK + b_off * L.ks + 16 * ((lane >> 3) & 1);
  const unsigned vt_row = sVt + b_off * L.vs + 16 * ((lane >> 3) & 1);

  int qa[kDepth][4];
#pragma unroll
  for (int c = 0; c < kDepth; ++c) ldmatrix_x4(qa[c], qa_row + 32 * c);

  // scores -> requant -> packed int8 (C fragment order: rows g, g, g+8,
  // g+8 x keys 2t, 2t+1) and the row maxima of rows g and g+8
  unsigned packed[kMaxKeyTiles];
  int zmax[2] = {kMagicBits - 128, kMagicBits - 128};
#pragma unroll
  for (int nt = 0; nt < kMaxKeyTiles; nt += 2) {
    if (nt < key_tiles) {
      int acc[2][4] = {};
#pragma unroll
      for (int c = 0; c < kDepth; ++c) {
        int b[4];
        ldmatrix_x4(b, k_row + nt * 8 * L.ks + 32 * c);
        mma_s8s8(acc[0], qa[c], b[0], b[1]);
        mma_s8s8(acc[1], qa[c], b[2], b[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int z[4];  // kMagicBits + the int8 score: its low byte is the score
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          z[e] = requant_bits(int_to_float(acc[h][e]) * r1);  // |s| <= 256 * 2^14
          if ((nt + h) * 8 + (e & 1) < lim) {
            zmax[e >> 1] = max(zmax[e >> 1], z[e]);
          } else {
            z[e] = kMagicBits - 128;  // a pad column: zmax - z stays in [0, 255]
          }
        }
        packed[nt + h] = pack_bytes<0>(z[0], z[1], z[2], z[3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    zmax[r] = max(zmax[r], __shfl_xor_sync(0xffffffffu, zmax[r], 1));
    zmax[r] = max(zmax[r], __shfl_xor_sync(0xffffffffu, zmax[r], 2));
  }
  // the scores become table indices zmax - z in [0, 255], byte by byte
  {
    const unsigned zm = __byte_perm(zmax[0], zmax[1], 0x4400);
#pragma unroll
    for (int nt = 0; nt < kMaxKeyTiles; ++nt) {
      if (nt < key_tiles) packed[nt] = __vsub4(zm, packed[nt]);
    }
  }

  // the exact row sums of the table's integers, rounded once to f32 (pad
  // columns read an entry and add 0)
  Sum esum[2] = {0, 0};
#pragma unroll
  for (int nt = 0; nt < kMaxKeyTiles; ++nt) {
    if (nt < key_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Term te = table_int[(packed[nt] >> (8 * e)) & 0xffu];
        esum[e >> 1] += nt * 8 + (e & 1) < lim ? te : 0;
      }
    }
  }
  float factor[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    esum[r] += __shfl_xor_sync(0xffffffffu, esum[r], 1);
    esum[r] += __shfl_xor_sync(0xffffffffu, esum[r], 2);
    float esum_f;
    if constexpr (kV2) {
      esum_f = static_cast<float>(esum[r]);
    } else {
      esum_f = __ull2float_rn(esum[r]);
    }
    factor[r] = norm_factor(esum_f, kBits);
  }

  // probabilities @ V^T in passes of up to 64 head dims, then the requant
  constexpr int kPassTiles = 4 * kDepth < kDimTiles ? 4 * kDepth : kDimTiles;
#pragma unroll 1
  for (int d0 = 0; d0 < 4 * kDepth; d0 += kPassTiles) {
    int acc_lo[kPassTiles][4] = {};
    int acc_hi[kWide ? kPassTiles : 1][4] = {};
#pragma unroll
    for (int kc = 0; kc < kMaxKeyTiles / 4; ++kc) {
      if (kc < key_tiles / 4) {
        // sm of C fragment j of keys 32kc..32kc+31, as the bits of
        // 2^23 + sm (pad columns need no mask: their rows of V^T are 0)
        int sm[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float w = table[(packed[4 * kc + j] >> (8 * e)) & 0xffu] * factor[e >> 1];
            sm[j][e] = floor_bits(w);
          }
        }
        // the A fragments: fragment j fills bytes 2(j%2), 2(j%2)+1 of
        // registers 2(j/2) (row g) and 2(j/2)+1 (row g+8); sm <= 2^15, and
        // at 16 bits lo is its low byte and hi its second
        unsigned lo[4], hi[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 2 * (r >> 1);
          const int e = 2 * (r & 1);
          lo[r] = pack_bytes<0>(sm[j][e], sm[j][e + 1], sm[j + 1][e], sm[j + 1][e + 1]);
          if constexpr (kWide) hi[r] = pack_bytes<1>(sm[j][e], sm[j][e + 1], sm[j + 1][e], sm[j + 1][e + 1]);
        }
#pragma unroll
        for (int dt = 0; dt < kPassTiles; dt += 2) {
          int b[4];
          ldmatrix_x4(b, vt_row + (d0 + dt) * 8 * L.vs + 32 * kc);
          mma_u8s8(acc_lo[dt], lo, b[0], b[1]);
          mma_u8s8(acc_lo[dt + 1], lo, b[2], b[3]);
          if constexpr (kWide) {
            mma_u8s8(acc_hi[dt], hi, b[0], b[1]);
            mma_u8s8(acc_hi[dt + 1], hi, b[2], b[3]);
          }
        }
      }
    }
#pragma unroll
    for (int dt = 0; dt < kPassTiles; ++dt) {
      const int d = (d0 + dt) * 8 + 2 * t;  // d and d + 1: hd is a multiple of 4
      if (d >= hd) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + g + 8 * h;
        if (row >= N) continue;
        int o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int c = acc_lo[dt][2 * h + e];
          if constexpr (kWide) c += 256 * acc_hi[dt][2 * h + e];
          o[e] = requant_i8(int_to_float(c) * r_out);  // |c| <= 2^15 * 128
        }
        *reinterpret_cast<uint16_t*>(out + head + static_cast<size_t>(row) * hd + d) =
            static_cast<uint16_t>(__byte_perm(o[0], o[1], 0x0040));
      }
    }
  }
}

// Warps per block: the 16-row tiles of a cell split evenly over blocks of
// at most kMaxWarps, then fewer warps a block while the grid has under two
// blocks per SM (batch 1: G = 6).
inline int warps_per_block(int G, int N) {
  const int tiles = (N + kRows - 1) / kRows;
  const int blocks = (tiles + kMaxWarps - 1) / kMaxWarps;
  int warps = (tiles + blocks - 1) / blocks;
  while (warps > 1 && static_cast<long long>(G) * ((tiles + warps - 1) / warps) < 264) {
    warps = (warps + 1) / 2;
  }
  return warps;
}

template <bool kV2, bool kWide, int kDepth>
int launch(const void* q, const void* k, const void* v, void* out, int G, int N, int hd, float r1,
           float scale, float r_out, int n, cudaStream_t stream) {
  const int warps = warps_per_block(G, N);
  const size_t smem = layout(N, hd, warps * kRows).bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(attention_mma_kernel<kV2, kWide, kDepth>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = (N + kRows - 1) / kRows;
  const dim3 grid(G, (tiles + warps - 1) / warps);
  attention_mma_kernel<kV2, kWide, kDepth><<<grid, warps * 32, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<int8_t*>(out), N, hd, r1, scale, r_out, static_cast<float>(n));
  return static_cast<int>(cudaGetLastError());
}

template <bool kV2, bool kWide>
int launch_depth(const void* q, const void* k, const void* v, void* out, int G, int N, int hd,
                 float r1, float scale, float r_out, int n, cudaStream_t stream) {
  switch (depth_steps(hd)) {
    case 1: return launch<kV2, kWide, 1>(q, k, v, out, G, N, hd, r1, scale, r_out, n, stream);
    case 2: return launch<kV2, kWide, 2>(q, k, v, out, G, N, hd, r1, scale, r_out, n, stream);
    case 4: return launch<kV2, kWide, 4>(q, k, v, out, G, N, hd, r1, scale, r_out, n, stream);
    default: return launch<kV2, kWide, 8>(q, k, v, out, G, N, hd, r1, scale, r_out, n, stream);
  }
}

}  // namespace attn_mma

// Launches K1 (kV2=false) or K2 (kV2=true) on `stream`. Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue outside the
// domain: G >= 1, N in [1, 256], hd a multiple of 4 in [4, 256], out_bits
// 8 or 16, and q, k, v, out 4-byte aligned.
template <bool kV2>
int launch_attention_mma(const void* q, const void* k, const void* v, void* out, int G, int N,
                         int hd, float r1, float scale, float r_out, int n, int out_bits,
                         void* stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (G < 1 || N < 1 || N > attn_mma::kMaxN || hd < 4 || hd % 4 != 0 || hd > 256 ||
      (out_bits != 8 && out_bits != 16) || (any & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bits == 16
             ? attn_mma::launch_depth<kV2, true>(q, k, v, out, G, N, hd, r1, scale, r_out, n, s)
             : attn_mma::launch_depth<kV2, false>(q, k, v, out, G, N, hd, r1, scale, r_out, n, s);
}

}  // namespace ivit
