// K10: fused integer attention over long rows (256 < N <= 1024), for
// Hopper (sm_90a).
//
// The port's own kernel: the JAX engine has none for these rows. Above
// 256 tokens its Pallas kernels' two-limb row sum stops being exact, so
// it runs the chain as XLA ops with the spec's three-limb row sum
// (ivit_tpu/deploy/engine.py:227-237, ivit_tpu/ops/shiftmax.py:
// _exact_sum_lastdim). K10 computes that chain, per cell g and row i:
//   s_ij  = q_i . k_j                        int8 x int8 -> int32 (MMA)
//   z_ij  = clip(rint(float(s_ij) * r1), -128, 127)
//   e_ij  = shift_exp(z_ij - max_j z_ij)     (K0, a 256-entry table)
//   S_i   = (S2 * 2^12 + S1) * 2^12 + S0    in float32, the limb sums
//           Sk = sum_j of limb k of e_ij, e = l2 2^24 + l1 2^12 + l0
//   sm_ij = floor(e_ij * norm_factor(S_i, out_bits))
//   out   = clip(rint(float(sum_j sm_ij v_jd) * r_out), -128, 127)  int8
// The tree rounds at its two adds exactly as the spec's float32 tree
// does: every limb sum is below 2^22 for N <= 1024, so it is exact, and
// the adds are __fadd_rn in the spec's order.
//
// What differs from K1 (attention_mma.cuh, whose helpers this builds on):
// K1 keeps a warp's scores in registers, 16 rows x 256 keys; 577 keys do
// not fit. Here each warp stages its 16 rows' requanted int8 scores in
// shared memory in the C-fragment order, one word a lane a key tile (16
// x np bytes: 9.7 KB at N = 577), and makes three passes over them:
//   1. Q.K^T on the int8 tensor cores, the requant, the row max, the
//      packed scores into shared memory;
//   2. the table indices zmax - z (one __vsub4 a word) and the row sum,
//      from a second table holding each entry's three limbs packed into
//      one 64-bit word (l0 | l1 << 22 | l2 << 44: no field carries into
//      the next for up to 1024 terms), so a score costs one 64-bit add;
//   3. the probabilities from the table times the row's factor, packed
//      into the @V A fragments, and @V on the tensor cores against V^T.
// K, V^T and the block's Q rows are staged as K1 stages them, once for
// several 16-row tiles a warp (one block a cell when the grid has enough
// blocks), so the staging, which no second block hides at this shared
// memory, is paid once a cell. Words are read back by the lane that
// wrote them, so the score staging is conflict-free.
//
// Bound at ViT-L/16 at 384^2, batch 128, (2048, 577, 64): bytes 302.5 MB
// (0.090 ms at 3.35 TB/s) and the two products 174.6 G int8 operations
// (0.088 ms at 1,979 TOP/s); the per-score work of the three passes
// (about 20 instructions over 682 M scores) lies above both.

#include "attention_mma.cuh"

namespace ivit {
namespace attn_long {

using attn_mma::kRows;
constexpr int kMinN = 257;
constexpr int kMaxN = 1024;
constexpr int kMaxHd = 64;
constexpr int kMaxWarps = 8;
constexpr int kTable = 256;
// dynamic shared memory of a block, below the opt-in limit less the tables
constexpr size_t kMaxSmem = 220 * 1024;

// K, V^T and the Q rows as K1 lays them (attention_mma.cuh: layout), then
// each warp's staged scores: key_tiles words of 32 lanes.
struct Layout {
  attn_mma::Layout base;
  size_t scores, bytes;
};

__host__ __device__ inline Layout layout(int N, int hd, int warps, int tiles_per_warp) {
  Layout L;
  L.base = attn_mma::layout(N, hd, warps * tiles_per_warp * kRows);
  L.scores = L.base.bytes;
  L.bytes = L.scores + static_cast<size_t>(warps) * kRows * L.base.np;
  return L;
}

// The three limbs of a shift-exp e <= 2^31, one field each.
__device__ __forceinline__ unsigned long long limbs(unsigned e) {
  return static_cast<unsigned long long>(e & 0xfffu) |
         (static_cast<unsigned long long>((e >> 12) & 0xfffu) << 22) |
         (static_cast<unsigned long long>(e >> 24) << 44);
}

// The spec's long-row tree on the limb sums packed in `packed`.
__device__ __forceinline__ float limb_tree(unsigned long long packed) {
  const float s0 = __uint2float_rn(static_cast<unsigned>(packed & 0x3fffffu));
  const float s1 = __uint2float_rn(static_cast<unsigned>((packed >> 22) & 0x3fffffu));
  const float s2 = __uint2float_rn(static_cast<unsigned>(packed >> 44));
  return __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(s2, 4096.0f), s1), 4096.0f), s0);
}

template <bool kWide, int kDepth>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_long_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                      const int8_t* __restrict__ v, int8_t* __restrict__ out, int N, int hd,
                      int tiles_per_warp, float r1, float scale, float r_out, float n) {
  using attn_mma::ldmatrix_x4;
  using attn_mma::mma_s8s8;
  using attn_mma::mma_u8s8;
  using attn_mma::pack_bytes;
  constexpr int kBits = kWide ? 16 : 8;
  __shared__ float table[kTable];
  __shared__ unsigned long long table_limbs[kTable];
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int block_rows = warps * tiles_per_warp * kRows;
  const Layout L = layout(N, hd, warps, tiles_per_warp);
  const attn_mma::Layout& B = L.base;
  const unsigned sK = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned sVt = sK + static_cast<unsigned>(B.vt);
  const unsigned sQ = sK + static_cast<unsigned>(B.q);

  const size_t head = static_cast<size_t>(blockIdx.x) * N * hd;
  const int row_base = static_cast<int>(blockIdx.y) * block_rows;
  const int8_t* qb = q + head + static_cast<size_t>(row_base) * hd;
  if (hd % 16 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)) & 15) == 0) {
    attn_mma::stage_rows<16>(sK, B.ks, k + head, N, B.np, hd, B.hdp);
    attn_mma::stage_rows<16>(sQ, B.ks, qb, N - row_base, block_rows, hd, B.hdp);
  } else {
    attn_mma::stage_rows<4>(sK, B.ks, k + head, N, B.np, hd, B.hdp);
    attn_mma::stage_rows<4>(sQ, B.ks, qb, N - row_base, block_rows, hd, B.hdp);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  attn_mma::stage_vt(smem + B.vt, v + head, N, hd, B);
  const float x0 = shift_exp_x0(scale);
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) {
    const float e = shift_exp<true>(0.0f - static_cast<float>(i), x0, n);
    table[i] = e;
    table_limbs[i] = limbs(static_cast<unsigned>(e));
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key_tiles = B.np / 8;
  const int lim = N - 2 * t;  // key 8nt + 2t + e is a column where 8nt + e < lim
  const int b_off = (lane & 7) + 8 * (lane >> 4);
  const unsigned k_row = sK + b_off * B.ks + 16 * ((lane >> 3) & 1);
  const unsigned vt_row = sVt + b_off * B.vs + 16 * ((lane >> 3) & 1);
  // this warp's staged scores: word nt * 32 + lane is lane's C fragment of key tile nt
  unsigned* staged = reinterpret_cast<unsigned*>(smem + L.scores) + static_cast<size_t>(warp) * key_tiles * 32 + lane;

#pragma unroll 1
  for (int tile = warp; tile < warps * tiles_per_warp; tile += warps) {
    const int row0 = row_base + tile * kRows;
    if (row0 >= N) return;  // no barrier follows
    const unsigned qa_row = sQ + (tile * kRows + (lane & 7) + 8 * ((lane >> 3) & 1)) * B.ks + 16 * (lane >> 4);
    int qa[kDepth][4];
#pragma unroll
    for (int c = 0; c < kDepth; ++c) ldmatrix_x4(qa[c], qa_row + 32 * c);

    // pass 1: scores -> requant -> packed int8 in shared memory, row maxima
    int zmax[2] = {kMagicBits - 128, kMagicBits - 128};
#pragma unroll 2
    for (int nt = 0; nt < key_tiles; nt += 2) {
      int acc[2][4] = {};
#pragma unroll
      for (int c = 0; c < kDepth; ++c) {
        int b[4];
        ldmatrix_x4(b, k_row + nt * 8 * B.ks + 32 * c);
        mma_s8s8(acc[0], qa[c], b[0], b[1]);
        mma_s8s8(acc[1], qa[c], b[2], b[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int z[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          z[e] = requant_bits(int_to_float(acc[h][e]) * r1);  // |s| <= 128 * 128 * 64
          if ((nt + h) * 8 + (e & 1) < lim) {
            zmax[e >> 1] = max(zmax[e >> 1], z[e]);
          } else {
            z[e] = kMagicBits - 128;  // a pad column: zmax - z stays in [0, 255]
          }
        }
        staged[(nt + h) * 32] = pack_bytes<0>(z[0], z[1], z[2], z[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      zmax[r] = max(zmax[r], __shfl_xor_sync(0xffffffffu, zmax[r], 1));
      zmax[r] = max(zmax[r], __shfl_xor_sync(0xffffffffu, zmax[r], 2));
    }
    const unsigned zm = __byte_perm(zmax[0], zmax[1], 0x4400);

    // pass 2: the limb sums of each row (pad columns add 0), then the tree
    unsigned long long lsum[2] = {0ull, 0ull};
#pragma unroll 8
    for (int nt = 0; nt < key_tiles; ++nt) {
      const unsigned idx = __vsub4(zm, staged[nt * 32]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned long long term = table_limbs[(idx >> (8 * e)) & 0xffu];
        lsum[e >> 1] += nt * 8 + (e & 1) < lim ? term : 0ull;
      }
    }
    float factor[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
      factor[r] = norm_factor(limb_tree(lsum[r]), kBits);
    }

    // pass 3: probabilities @ V^T in passes of up to 64 head dims, then the requant
    constexpr int kPassTiles = 4 * kDepth < attn_mma::kDimTiles ? 4 * kDepth : attn_mma::kDimTiles;
#pragma unroll 1
    for (int d0 = 0; d0 < 4 * kDepth; d0 += kPassTiles) {
      int acc_lo[kPassTiles][4] = {};
      int acc_hi[kWide ? kPassTiles : 1][4] = {};
#pragma unroll 2
      for (int kc = 0; kc < key_tiles / 4; ++kc) {
        int sm[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned idx = __vsub4(zm, staged[(4 * kc + j) * 32]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sm[j][e] = floor_bits(table[(idx >> (8 * e)) & 0xffu] * factor[e >> 1]);
          }
        }
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
          ldmatrix_x4(b, vt_row + (d0 + dt) * 8 * B.vs + 32 * kc);
          mma_u8s8(acc_lo[dt], lo, b[0], b[1]);
          mma_u8s8(acc_lo[dt + 1], lo, b[2], b[3]);
          if constexpr (kWide) {
            mma_u8s8(acc_hi[dt], hi, b[0], b[1]);
            mma_u8s8(acc_hi[dt + 1], hi, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int dt = 0; dt < kPassTiles; ++dt) {
        const int d = (d0 + dt) * 8 + 2 * t;
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
}

// The shape of a launch: warps a block and 16-row tiles a warp. As many
// warps as shared memory holds with one tile each, at most kMaxWarps;
// then as many tiles a warp as keep at least kMinBlocks blocks in the
// grid, up to a whole cell a block; then the cell's tiles spread evenly.
constexpr long long kMinBlocks = 264;  // two waves of the H100's 132 SMs at a block an SM

struct Shape {
  int warps, tiles_per_warp, blocks_per_cell;
};

inline Shape launch_shape(int G, int N, int hd) {
  const int tiles = (N + kRows - 1) / kRows;
  int most = kMaxWarps;
  while (most > 1 && layout(N, hd, most, 1).bytes > kMaxSmem) --most;
  int per_warp = (tiles + most - 1) / most;
  while (per_warp > 1 && (layout(N, hd, most, per_warp).bytes > kMaxSmem ||
                          static_cast<long long>(G) * ((tiles + most * per_warp - 1) / (most * per_warp)) <
                              kMinBlocks)) {
    --per_warp;
  }
  const int blocks = (tiles + most * per_warp - 1) / (most * per_warp);
  const int warps = (tiles + blocks * per_warp - 1) / (blocks * per_warp);
  return {warps, per_warp, blocks};
}

template <bool kWide, int kDepth>
int launch(const void* q, const void* k, const void* v, void* out, int G, int N, int hd, float r1,
           float scale, float r_out, int n, cudaStream_t stream) {
  const Shape sh = launch_shape(G, N, hd);
  const size_t smem = layout(N, hd, sh.warps, sh.tiles_per_warp).bytes;
  const cudaError_t e = cudaFuncSetAttribute(attention_long_kernel<kWide, kDepth>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(G, sh.blocks_per_cell);
  attention_long_kernel<kWide, kDepth><<<grid, sh.warps * 32, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<int8_t*>(out), N, hd, sh.tiles_per_warp, r1, scale, r_out, static_cast<float>(n));
  return static_cast<int>(cudaGetLastError());
}

template <bool kWide>
int launch_depth(const void* q, const void* k, const void* v, void* out, int G, int N, int hd,
                 float r1, float scale, float r_out, int n, cudaStream_t stream) {
  return attn_mma::depth_steps(hd) == 1
             ? launch<kWide, 1>(q, k, v, out, G, N, hd, r1, scale, r_out, n, stream)
             : launch<kWide, 2>(q, k, v, out, G, N, hd, r1, scale, r_out, n, stream);
}

}  // namespace attn_long
}  // namespace ivit

// Launches K10 on `stream`. Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue outside the domain: G >= 1, N in [257, 1024], hd
// a multiple of 4 in [4, 64], out_bits 8 or 16, and q, k, v, out 4-byte
// aligned.
extern "C" int ivit_fused_int8_attention_long(const void* q, const void* k, const void* v, void* out,
                                              int G, int N, int hd, float r1, float scale,
                                              float r_out, int n, int out_bits, void* stream) {
  using namespace ivit::attn_long;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (G < 1 || N < kMinN || N > kMaxN || hd < 4 || hd % 4 != 0 || hd > kMaxHd ||
      (out_bits != 8 && out_bits != 16) || (any & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bits == 16 ? launch_depth<true>(q, k, v, out, G, N, hd, r1, scale, r_out, n, s)
                        : launch_depth<false>(q, k, v, out, G, N, hd, r1, scale, r_out, n, s);
}
