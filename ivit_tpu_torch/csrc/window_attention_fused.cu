// K7: fully fused integer Swin window attention for Hopper (sm_90a).
//
// Replaces ivit_tpu/kernels/window_attention_fused.py:
// fused_int8_window_attention (the pl.pallas_call at :132, body _one_cell
// :32-61). Per cell g (batch*window*head) and query row i:
//   s_ij  = q_i . k_j                        int8 x int8 -> int32 (MMA)
//   a_ij  = clip(rint(float(s_ij) * r1), -128, 127)
//   z_ij  = clip(rint(a_ij * rb) + bias_ij, -128, 127) [+ mask_ij]
//   e_ij  = shift_exp(z_ij - max_j z_ij)     (K0, every guard kept)
//   sm_ij = floor(e_ij * norm_factor(sum_j e_ij, 8))
//   c_id  = sum_j sm_ij * v_jd               exact int32 (MMA)
//   out   = clip(rint(float(c_id) * r_out), -128, 127)  int8
// The (N, N) scores never leave the SM. Cell g reads bias head g % heads
// and, for a shifted window, mask window (g / heads) % n_windows.
//
// Layout: q, k, v, out are unpadded (G, N, hd) int8 with G = B*nW*heads
// and the head innermost, N <= 256 and hd a multiple of 4 up to 256; bias
// is (heads, N, N) and mask (nW, N, N) float32. The Pallas kernel's
// 128-lane padding and n_valid column mask are TPU tiling, value-identical
// to leaving the pads out.
//
// What bounds it on the H100: bytes. At Swin-T stage 1, batch 128
// ((24576, 49, 32), masked) q, k, v in and the context out are 154 MB
// (0.046 ms at 3.35 TB/s); the int8 products (0.24 G operations) and the
// per-score requant, lookups, bias add, clip, max, multiply and floor need
// less. The design, on the helpers of attention_mma.cuh (K1's kernel):
//   * both products on int8 tensor cores: Q.K^T on mma.sync.m16n8k32
//     s8 x s8 (N = 49 padded to 64 keys and 4 row tiles of 16; hd = 32 is
//     one MMA depth), the probabilities passed in registers as the u8 A
//     fragments of the @V product against V^T staged in K1's permuted
//     key order;
//   * one warp owns a 16-row tile of a cell, and a block holds as many
//     cells as keep its 8 warps busy (two at N = 49). A block takes cells
//     that share their bias head and mask window, in up to eight rounds,
//     so the two float32 planes (and the tables below) are set up once
//     per up to sixteen cells instead of read per score from L2; the
//     next round's K, Q and V rows are in flight (cp.async into a second
//     buffer) while the warps compute a round, so staging hides behind
//     the compute;
//   * two per-launch tables, each filled by the block with the unchanged
//     float32 ops: rint(a8 * rb) for the 256 values of a8, and shift_exp
//     of the integral arguments z - zmax = -i, i in [0, 255] (the K1
//     table) with its integers for the exact row sum, plus a 257th entry
//     at the chain's clamp n * x0, which every argument at or below the
//     clamp shares (shift_exp_clamps);
//   * the integral path: a block whose planes pass integral_planes (an
//     integral bias; with a mask, an unmasked column in every row and
//     every masked value -100/s_bias far enough below the clamp, as at
//     Swin's scales) merges four scores at a time on int16 halves
//     (saturating add, clamp) against per-block fragment words of the
//     bias and of the pad and masked positions, keeps the merged scores
//     packed as int8 in registers (4 to a word, one MMA C fragment),
//     takes the row max with a byte max, and reads every shift-exp as
//     exp[zmax - z] (one __vsub4 a word) as K1 does; a masked score
//     enters the row sum as the clamp entry by its count and the @V
//     operand as that entry's probability by a byte select;
//   * the general path, for any other bias or mask (a non-integral bias,
//     a mask addend above the clamp, a row whose max is a masked score)
//     and above N = 64: a8 stays packed instead, and the row-sum and @V
//     passes recompute each merged score and take its shift-exp from the
//     tables where the argument is integral in [-255, 0] or at or below
//     the clamp, and from the K0 chain elsewhere (run by the whole warp
//     when any lane needs it);
//   * rint, floor and int -> float are exact magic-number adds, as in K1.
// Up to N = 64 the planes sit in shared memory; above, each score reads
// them from L2: the large windows are in the domain but not tuned.

#include <math_constants.h>

#include "attention_mma.cuh"

namespace ivit {
namespace win_mma {

using namespace attn_mma;

constexpr int kWarps = 8;
constexpr int kMaxRounds = 8;       // rounds of cells a block takes in turn
constexpr int kTargetBlocks = 792;  // two waves of three blocks an SM on 132 SMs before rounds merge
constexpr int kStagedKeys = 64;     // the planes are staged in shared memory up to this N
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kStaticSmem = 4 * 1024;  // the kernel's tables (4,112 bytes at most)
constexpr unsigned kClampEntry = kTable;  // the shift-exp of every argument <= n * x0

// shift_exp(d) = shift_exp(n * x0) for every float32 d <= n * x0: the
// chain's d + floor(d/2) - floor(d/16) is at most 1.4375 d + 1 before
// rounding, which is <= d for d <= -3, and rounding to nearest is
// monotone, so the clamp max(., n * x0) returns n * x0 (n * x0 <= -15 at
// n = 15 and x0 <= -1), after which nothing depends on d.
__device__ __forceinline__ float shift_exp_clamps(float x0, float n) { return n * x0; }

// The shared memory of a block: the bias and mask planes (N x N f32, as
// stored) and the integral path's fragment words, then one or two
// buffers of per_round cells (K, V^T, Q as attention_mma.cuh's Layout)
// and, with two, the raw V rows of the next round's cells.
struct Plan {
  Layout L;
  int per_round, buffers;
  size_t planes, frag, cells, raw, bytes;
};

__host__ __device__ inline Plan plan(int N, int hd, bool staged, bool masked) {
  Plan P;
  P.L = layout(N, hd, (N + 31) / 32 * 32);
  const int tiles = (N + kRows - 1) / kRows;
  P.planes = staged ? (masked ? 2 : 1) * static_cast<size_t>(N) * N * sizeof(float) : 0;
  P.planes = (P.planes + 15) / 16 * 16;
  P.frag = staged ? static_cast<size_t>(tiles) * (kStagedKeys / 8) * 32 * (sizeof(uint2) + sizeof(unsigned)) : 0;
  const size_t raw_cell = (static_cast<size_t>(N) * hd + 15) / 16 * 16;
  const size_t budget = kMaxSmem - kStaticSmem - P.planes - P.frag;
  // the most cells that fit with two buffers, else with one (a launch
  // whose single cell does not fit fails at cudaFuncSetAttribute)
  const int most = tiles <= kWarps ? kWarps / tiles : 1;
  P.buffers = 2;
  for (P.per_round = most;; --P.per_round) {
    const size_t need = P.per_round * (P.buffers * P.L.bytes + (P.buffers == 2 ? raw_cell : 0));
    if (need <= budget || (P.per_round == 1 && P.buffers == 1)) break;
    if (P.per_round == 1) {
      P.buffers = 1;
      P.per_round = most + 1;
    }
  }
  P.cells = P.per_round * P.L.bytes;
  P.raw = P.buffers == 2 ? P.per_round * raw_cell : 0;
  P.bytes = P.planes + P.frag + P.buffers * P.cells + P.raw;
  return P;
}

// One value of a plane (row stride N), in shared or in global memory.
template <bool kStaged>
__device__ __forceinline__ float plane_at(const float* p, int row, int col, int N) {
  if constexpr (kStaged) {
    return p[row * N + col];
  } else {
    return __ldg(p + static_cast<size_t>(row) * N + col);
  }
}

// The K0 chain, out of line: it runs only where some lane of the warp has
// an argument that neither table holds.
__device__ __noinline__ float shift_exp_chain(float d, float x0, float n) { return shift_exp(d, x0, n); }

// shift_exp(d) of a row-max-subtracted merged score, from the tables
// where they hold it and from the K0 chain elsewhere (the general path).
// The whole warp calls it together, and the chain runs for every lane
// when any lane needs it: no lane branches away from the others, since
// the ldmatrix and mma.sync around it need the whole warp at once.
__device__ __forceinline__ float table_or_chain(float d, const float* exp_f, float x0, float n) {
  const float mg = d + kMagic;  // rint(d) + 1.5 * 2^23 while |d| < 2^22
  const unsigned idx = static_cast<unsigned>(kMagicBits - __float_as_int(mg));
  const bool hit = idx < kTable && mg - kMagic == d;
  const bool tabled = hit || d <= shift_exp_clamps(x0, n);
  float e = exp_f[hit ? idx : kClampEntry];
  if (__any_sync(0xffffffffu, !tabled)) {
    const float chain = shift_exp_chain(d, x0, n);
    e = tabled ? e : chain;
  }
  return e;
}

// The tables and planes a tile reads.
struct Tables {
  const float* bias;      // (N, N) plane of the cell's head, shared or global
  const float* mask;      // (N, N) plane of its window, or null
  const uint2* frag_bias;  // integral path: [tile][key tile][lane] int16 pairs (rows g, g + 8)
  const unsigned* frag_out;  // the same, byte masks of the pad and masked scores
  const float* rb_table;  // rint(a8 * rb), by the byte of a8
  const int* rb_int;      // the same as integers
  const float* exp_f;     // shift_exp(-i), i < 256; entry 256 at the clamp
  const unsigned* exp_i;  // the same as integers
};

// One warp: the 16 query rows from row0 of the cell staged at sK / sVt /
// sQ against all N keys, written to `out` (the cell's (N, hd) context).
//
// kIntegral is the path of a block whose planes passed integral_planes:
// every unmasked merged score is an integer in [-128, 127] and the row
// max is one of them, and every masked argument lies at or below the
// clamp. The merged scores stay packed as int8 in registers (4 to a
// word, one MMA C fragment, as in K1), merged four at a time against
// the block's fragment words (int16 bias pairs, byte masks of the pad
// and masked scores); the row max is a byte max; every shift-exp is
// exp_*[zmax - z] (one __vsub4 a word), with the pad and masked scores
// at index 255 and set right by their counts in the row sum and by a
// byte select (the clamp entry's probability) in the @V operand. The
// general path keeps the requantized a8 packed instead, and recomputes
// each merged score and its shift-exp (table_or_chain) in the row-sum
// and @V passes.
template <int kDepth, int kKeyTiles, bool kMasked, bool kStaged, bool kIntegral>
__device__ __forceinline__ void attend_tile(unsigned sK, unsigned sVt, unsigned sQ, const Layout& L,
                                            int N, int hd, int row0, const Tables& T, float r1,
                                            float x0, float n, float r_out, int8_t* out) {
  static_assert(!kIntegral || kStaged, "the fragment words are built from the staged planes");
  // only the integral path unrolls its tile loops; the general path keeps
  // them rolled (its score words in local memory), which keeps the build
  // short: it serves the planes and windows the integral path cannot
  constexpr int kUnroll = kIntegral ? kKeyTiles : 1;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // the fragments' row (A, C) or column (B) in its group of 8
  const int t = lane & 3;
  const int lim = N - 2 * t;  // key 8nt + 2t + e is a column where 8nt + e < lim
  const int key_pairs = (N + 15) / 16 * 2;  // 8-key tiles computed (pairs of one ldmatrix)
  const int rows[2] = {min(row0 + g, N - 1), min(row0 + g + 8, N - 1)};  // pad rows read row N-1
  const unsigned qa_row = sQ + (row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * L.ks + 16 * (lane >> 4);
  const int b_off = (lane & 7) + 8 * (lane >> 4);
  const unsigned k_row = sK + b_off * L.ks + 16 * ((lane >> 3) & 1);
  const unsigned vt_row = sVt + b_off * L.vs + 16 * ((lane >> 3) & 1);
  const int fr = row0 / kRows * kKeyTiles * 32 + lane;  // this tile's fragment words

  // ldmatrix and mma.sync need the whole warp at the same instruction:
  // the warp is reconverged after the per-lane stores of the last tile
  __syncwarp();
  int qa[kDepth][4];
#pragma unroll
  for (int c = 0; c < kDepth; ++c) ldmatrix_x4(qa[c], qa_row + 32 * c);

  // the merged score of score e of tile nt from its a8 (general path;
  // a pad column reads column N - 1, so every lane may compute one)
  auto merged = [&](int nt, int e, unsigned a8) {
    const int col = min(nt * 8 + 2 * t + (e & 1), N - 1);
    float zz = fminf(fmaxf(T.rb_table[a8] + plane_at<kStaged>(T.bias, rows[e >> 1], col, N), -128.0f), 127.0f);
    if constexpr (kMasked) zz = zz + plane_at<kStaged>(T.mask, rows[e >> 1], col, N);
    return zz;
  };
  // the pad positions (0xff bytes) of tile nt, in C fragment order
  auto pad_bytes = [&](int nt) {
    unsigned m = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) m |= (nt * 8 + (e & 1) < lim ? 0u : 0xffu) << (8 * e);
    return m;
  };

  // scores -> requant -> bias merge, packed in C fragment order (rows g,
  // g, g+8, g+8 x keys 2t, 2t+1), and the row maxima. Integral path: the
  // merge on halfword pairs, clip(rint(a8 * rb) + bias) by a saturating
  // add and a clamp, then the bytes; the row max of the unmasked bytes
  // (the others forced to -128) by a byte max
  unsigned packed[kKeyTiles];
  unsigned zmax4 = 0x80808080u;
  float zmax_f[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll kUnroll
  for (int nt = 0; nt < kKeyTiles; nt += 2) {
    if (nt < key_pairs) {
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
        int a8[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) a8[e] = requant_bits(int_to_float(acc[h][e]) * r1) & 0xff;  // |s| <= 2^22
        if constexpr (kIntegral) {
          const uint2 fb = T.frag_bias[fr + (nt + h) * 32];
          const unsigned t01 = __byte_perm(T.rb_int[a8[0]], T.rb_int[a8[1]], 0x5410);
          const unsigned t23 = __byte_perm(T.rb_int[a8[2]], T.rb_int[a8[3]], 0x5410);
          const unsigned z01 = __vmins2(__vmaxs2(__vaddss2(t01, fb.x), 0xff80ff80u), 0x007f007fu);
          const unsigned z23 = __vmins2(__vmaxs2(__vaddss2(t23, fb.y), 0xff80ff80u), 0x007f007fu);
          const unsigned out_bytes = T.frag_out[fr + (nt + h) * 32];
          packed[nt + h] = __byte_perm(z01, z23, 0x6420);
          zmax4 = __vmaxs4(zmax4, (packed[nt + h] & ~out_bytes) | (0x80808080u & out_bytes));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float z = merged(nt + h, e, a8[e]);
            zmax_f[e >> 1] = (nt + h) * 8 + (e & 1) < lim ? fmaxf(zmax_f[e >> 1], z) : zmax_f[e >> 1];
          }
          packed[nt + h] = pack_bytes<0>(a8[0], a8[1], a8[2], a8[3]);
        }
      }
    } else {
      packed[nt] = packed[nt + 1] = 0;
    }
  }
  int zmax_i[2];  // the integral row maxima
  if constexpr (kIntegral) {
    const unsigned zr = __vmaxs4(zmax4, zmax4 >> 8);  // byte 0: row g, byte 2: row g + 8
    zmax_i[0] = static_cast<int8_t>(zr & 0xffu);
    zmax_i[1] = static_cast<int8_t>((zr >> 16) & 0xffu);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (kIntegral) {
      zmax_i[r] = max(zmax_i[r], __shfl_xor_sync(0xffffffffu, zmax_i[r], 1));
      zmax_i[r] = max(zmax_i[r], __shfl_xor_sync(0xffffffffu, zmax_i[r], 2));
    } else {
      zmax_f[r] = fmaxf(zmax_f[r], __shfl_xor_sync(0xffffffffu, zmax_f[r], 1));
      zmax_f[r] = fmaxf(zmax_f[r], __shfl_xor_sync(0xffffffffu, zmax_f[r], 2));
    }
  }

  // the exact row sums of the shift-exp integers, rounded once to f32
  unsigned long long esum[2] = {0, 0};
  if constexpr (kIntegral) {
    // the table indices zmax - z, and 255 for the pad and masked scores:
    // their entries leave the sum again, and each masked one adds the
    // clamp entry instead
    const unsigned zm = __byte_perm(zmax_i[0], zmax_i[1], 0x4400);
    int excluded[2] = {0, 0}, masked[2] = {0, 0};  // bits: 8 a score
#pragma unroll kUnroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
      if (nt < key_pairs) {
        const unsigned out_bytes = T.frag_out[fr + nt * 32];
        packed[nt] = __vsub4(zm, packed[nt]) | out_bytes;
        excluded[0] += __popc(out_bytes & 0xffffu);
        excluded[1] += __popc(out_bytes >> 16);
        if constexpr (kMasked) {
          const unsigned m = out_bytes & ~pad_bytes(nt);
          masked[0] += __popc(m & 0xffffu);
          masked[1] += __popc(m >> 16);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) esum[e >> 1] += T.exp_i[(packed[nt] >> (8 * e)) & 0xffu];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      esum[r] += static_cast<unsigned long long>(masked[r] / 8) * T.exp_i[kClampEntry];
      esum[r] -= static_cast<unsigned long long>(excluded[r] / 8) * T.exp_i[kTable - 1];
    }
  } else {
#pragma unroll kUnroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
      if (nt < key_pairs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = merged(nt, e, (packed[nt] >> (8 * e)) & 0xffu) - zmax_f[e >> 1];
          const unsigned ex = static_cast<unsigned>(table_or_chain(d, T.exp_f, x0, n));
          esum[e >> 1] += nt * 8 + (e & 1) < lim ? ex : 0u;
        }
      }
    }
  }
  float factor[2];
  unsigned clamp_prob[2];  // floor(exp_f[clamp] * factor) in each byte (integral path)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    esum[r] += __shfl_xor_sync(0xffffffffu, esum[r], 1);
    esum[r] += __shfl_xor_sync(0xffffffffu, esum[r], 2);
    factor[r] = norm_factor(__ull2float_rn(esum[r]), 8);
    clamp_prob[r] = (floor_bits(T.exp_f[kClampEntry] * factor[r]) & 0xffu) * 0x01010101u;
  }

  // probabilities @ V^T in passes of up to 64 head dims, then the requant
  // (pad keys need no mask: their rows of V^T are 0)
  constexpr int kPassTiles = 4 * kDepth < kDimTiles ? 4 * kDepth : kDimTiles;
  const int chunks = L.np / 32;
#pragma unroll 1
  for (int d0 = 0; d0 < 4 * kDepth; d0 += kPassTiles) {
    int acc[kPassTiles][4] = {};
#pragma unroll kUnroll
    for (int kc = 0; kc < kKeyTiles / 4; ++kc) {
      if (kc < chunks) {
        int sm[4][4];  // the bits of 2^23 + sm, sm <= 128
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nt = 4 * kc + j;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float ex = 0.0f;
            if constexpr (kIntegral) {
              ex = T.exp_f[(packed[nt] >> (8 * e)) & 0xffu];  // masked ones replaced below
            } else if (nt < key_pairs) {
              const float e_any = table_or_chain(merged(nt, e, (packed[nt] >> (8 * e)) & 0xffu) - zmax_f[e >> 1],
                                                 T.exp_f, x0, n);
              ex = nt * 8 + (e & 1) < lim ? e_any : 0.0f;
            }
            sm[j][e] = floor_bits(ex * factor[e >> 1]);
          }
        }
        unsigned a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 2 * (r >> 1);
          const int e = 2 * (r & 1);
          a[r] = pack_bytes<0>(sm[j][e], sm[j][e + 1], sm[j + 1][e], sm[j + 1][e + 1]);
        }
        if constexpr (kIntegral && kMasked) {
          // a masked score's probability is its row's floor(clamp entry * factor)
          unsigned mw[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int nt = 4 * kc + j;
            mw[j] = nt < key_pairs ? T.frag_out[fr + nt * 32] & ~pad_bytes(nt) : 0u;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = 2 * (r >> 1);
            const unsigned m = __byte_perm(mw[j], mw[j + 1], r & 1 ? 0x7632u : 0x5410u);
            a[r] = (a[r] & ~m) | (clamp_prob[r & 1] & m);
          }
        }
#pragma unroll
        for (int dt = 0; dt < kPassTiles; dt += 2) {
          int b[4];
          ldmatrix_x4(b, vt_row + (d0 + dt) * 8 * L.vs + 32 * kc);
          mma_u8s8(acc[dt], a, b[0], b[1]);
          mma_u8s8(acc[dt + 1], a, b[2], b[3]);
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
        for (int e = 0; e < 2; ++e) o[e] = requant_i8(int_to_float(acc[dt][2 * h + e]) * r_out);  // |c| <= 2^14
        *reinterpret_cast<uint16_t*>(out + static_cast<size_t>(row) * hd + d) =
            static_cast<uint16_t>(__byte_perm(o[0], o[1], 0x0040));
      }
    }
  }
}

// Whether a block's staged planes take the integral path: every bias is
// an integer, it and every rint(a8 * rb) fit int16, and (with a mask)
// every row has an unmasked column (mask 0) and every masked value m puts
// the largest masked argument, (127 + m) - (-128), at or below the
// clamp. Then an unmasked merged score is an integer in [-128, 127],
// every masked one lies below -128, so the row max is unmasked and
// integral, and every masked argument clamps. A warp takes a row at a
// time; every thread takes part (a barrier).
template <bool kMasked>
__device__ bool integral_planes(const float* sBias, const float* sMask, int N, float clamp,
                                const float* rb_table) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  bool ok = fabsf(rb_table[threadIdx.x % 256]) <= 32767.0f;  // the merge runs on int16 halves
  for (int r = warp; r < N; r += blockDim.x / 32) {
    bool unmasked = false;
    for (int c = lane; c < N; c += 32) {
      const float b = sBias[r * N + c];
      ok = ok && b == rintf(b) && fabsf(b) <= 32767.0f;
      if constexpr (kMasked) {
        const float m = sMask[r * N + c];
        unmasked = unmasked || m == 0.0f;
        ok = ok && (m == 0.0f || (127.0f + m) + 128.0f <= clamp);
      }
    }
    if constexpr (kMasked) {
      const bool row_unmasked = __any_sync(0xffffffffu, unmasked);  // every lane, whatever its ok
      ok = ok && row_unmasked;
    }
  }
  return __syncthreads_and(ok) != 0;
}

// The integral path's fragment words of a block, for row tile rt, key
// tile nt and lane (g, t), at [(rt * kKeyTiles + nt) * 32 + lane]: the
// bias of rows g and g + 8 x keys 2t, 2t + 1 of the tile as int16 pairs,
// and a byte mask in C fragment order of the scores that are pad
// columns or masked. A warp takes a (row tile, key tile) at a time.
template <int kKeyTiles, bool kMasked>
__device__ void fragment_words(uint2* frag_bias, unsigned* frag_out, const float* sBias,
                               const float* sMask, int N) {
  const int tiles = (N + kRows - 1) / kRows;
  const int key_pairs = (N + 15) / 16 * 2;
  const int lane = threadIdx.x % 32;
  for (int w = threadIdx.x / 32; w < tiles * key_pairs; w += blockDim.x / 32) {
    const int rt = w / key_pairs;
    const int nt = w - rt * key_pairs;
    unsigned half[4], out_bytes = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = min(rt * kRows + (lane >> 2) + 8 * (e >> 1), N - 1);
      const int c = nt * 8 + 2 * (lane & 3) + (e & 1);
      const bool pad = c >= N;
      const bool m = kMasked && !pad && sMask[r * N + c] != 0.0f;
      half[e] = static_cast<unsigned>(pad ? 0 : static_cast<int>(sBias[r * N + c])) & 0xffffu;
      out_bytes |= (pad || m ? 0xffu : 0u) << (8 * e);
    }
    const int at = (rt * kKeyTiles + nt) * 32 + lane;
    frag_bias[at] = make_uint2(half[0] | half[1] << 16, half[2] | half[3] << 16);
    frag_out[at] = out_bytes;
  }
}

// Block b takes the cells g = j * period + b % period, j from
// (b / period) * per_round * rounds on, per_round at a time: every cell of
// a block shares its bias plane (and mask plane), staged once. With two
// buffers, the next round's K, Q and raw V rows are in flight (cp.async)
// while the warps compute a round, and its V^T is transposed from shared
// memory after it.
template <int kDepth, int kKeyTiles, bool kMasked>
__global__ void __launch_bounds__(kWarps * 32, kKeyTiles <= 8 ? 3 : 1)
window_attention_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                        const int8_t* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ mask, int8_t* __restrict__ out, int N, int hd,
                        int heads, int period, int cells, int rounds, float r1, float rb,
                        float scale, float r_out, float n) {
  constexpr bool kStaged = kKeyTiles * 8 <= kStagedKeys;
  __shared__ float rb_table[256];         // rint(a8 * rb), by the byte of a8
  __shared__ int rb_int[256];             // the same as integers (integral path)
  __shared__ float exp_f[kTable + 1];     // shift_exp(-i); entry 256: at the clamp
  __shared__ unsigned exp_i[kTable + 1];  // the same as integers, for the row sum
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan P = plan(N, hd, kStaged, kMasked);
  const Layout& L = P.L;
  const int c = static_cast<int>(blockIdx.x) % period;
  const int j0 = static_cast<int>(blockIdx.x) / period * P.per_round * rounds;
  const float* bias_g = bias + static_cast<size_t>(c % heads) * N * N;
  const float* mask_g = kMasked ? mask + static_cast<size_t>(c / heads) * N * N : nullptr;
  float* sBias = reinterpret_cast<float*>(smem);
  float* sMask = sBias + N * N;
  const int frag_words = P.frag / (sizeof(uint2) + sizeof(unsigned));
  uint2* frag_bias = reinterpret_cast<uint2*>(smem + P.planes);
  unsigned* frag_out = reinterpret_cast<unsigned*>(frag_bias + frag_words);
  unsigned char* sCells = smem + P.planes + P.frag;
  const int8_t* sRaw = reinterpret_cast<const int8_t*>(sCells + P.buffers * P.cells);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool wide = hd % 16 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                      reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const size_t raw_cell = P.raw / P.per_round;

  // the cells of a round into buffer `buf`: K and Q rows (and with two
  // buffers the raw V rows) by cp.async; the caller commits
  auto load_round = [&](int round, int buf) {
    const int jr = j0 + round * P.per_round;
    for (int s = 0; s < P.per_round && jr + s < cells; ++s) {
      const size_t head = (static_cast<size_t>(jr + s) * period + c) * N * hd;
      const unsigned sK = static_cast<unsigned>(__cvta_generic_to_shared(sCells + buf * P.cells + s * L.bytes));
      const unsigned sV = static_cast<unsigned>(__cvta_generic_to_shared(sRaw + s * raw_cell));
      if (wide) {
        stage_rows<16>(sK, L.ks, k + head, N, L.np, hd, L.hdp);
        stage_rows<16>(sK + static_cast<unsigned>(L.q), L.ks, q + head, N, L.np, hd, L.hdp);
        if (P.buffers == 2) stage_rows<16>(sV, hd, v + head, N, N, hd, hd);
      } else {
        stage_rows<4>(sK, L.ks, k + head, N, L.np, hd, L.hdp);
        stage_rows<4>(sK + static_cast<unsigned>(L.q), L.ks, q + head, N, L.np, hd, L.hdp);
        if (P.buffers == 2) stage_rows<4>(sV, hd, v + head, N, N, hd, hd);
      }
    }
  };
  // V^T of a round's cells into buffer `buf`: from the raw rows (two
  // buffers, after they landed and a barrier) or from global memory
  auto transpose = [&](int round, int buf) {
    const int jr = j0 + round * P.per_round;
    for (int s = 0; s < P.per_round && jr + s < cells; ++s) {
      unsigned char* vt = sCells + buf * P.cells + s * L.bytes + L.vt;
      if (P.buffers == 2) {
        stage_vt<true>(vt, sRaw + s * raw_cell, N, hd, L);
      } else {
        stage_vt(vt, v + (static_cast<size_t>(jr + s) * period + c) * N * hd, N, hd, L);
      }
    }
  };

  // the planes, round 0's cells, and the tables while they land
  if constexpr (kStaged) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(sBias));
    for (int r = warp; r < (kMasked ? 2 : 1) * N; r += kWarps) {
      const float* src = (r < N ? bias_g + r * N : mask_g + (r - N) * N);
      for (int col = lane; col < N; col += 32) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst + 4 * (r * N + col)), "l"(src + col));
      }
    }
  }
  load_round(0, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  const float x0 = shift_exp_x0(scale);
  for (int i = threadIdx.x; i < kTable + 1; i += blockDim.x) {
    if (i < kTable) {
      rb_table[i] = rintf(static_cast<float>(static_cast<int8_t>(i)) * rb);
      rb_int[i] = static_cast<int>(rb_table[i]);
    }
    // 0 - i, as z - zmax is formed (+0 where z == zmax); entry 256 at the clamp
    const float e = shift_exp(i < kTable ? 0.0f - static_cast<float>(i) : shift_exp_clamps(x0, n), x0, n);
    exp_f[i] = e;
    exp_i[i] = static_cast<unsigned>(e);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  transpose(0, 0);
  bool integral = false;
  if constexpr (kStaged) {
    integral = integral_planes<kMasked>(sBias, sMask, N, shift_exp_clamps(x0, n), rb_table);
    if (integral) fragment_words<kKeyTiles, kMasked>(frag_bias, frag_out, sBias, sMask, N);
  }
  __syncthreads();

  const int tiles = (N + kRows - 1) / kRows;
  const int warps_per_cell = min(tiles, kWarps);
  const int slot = warp / warps_per_cell;
  const Tables T{kStaged ? sBias : bias_g, kStaged ? sMask : mask_g, frag_bias, frag_out,
                 rb_table, rb_int, exp_f, exp_i};
  for (int round = 0; round < rounds; ++round) {
    const int jr = j0 + round * P.per_round;
    if (jr >= cells) break;
    const int buf = P.buffers == 2 ? round & 1 : 0;
    const bool next = round + 1 < rounds && jr + P.per_round < cells;
    if (next && P.buffers == 2) load_round(round + 1, buf ^ 1);
    asm volatile("cp.async.commit_group;\n" ::);

    const int j = jr + slot;
    if (slot < P.per_round && j < cells) {
      const unsigned sK = static_cast<unsigned>(__cvta_generic_to_shared(sCells + buf * P.cells + slot * L.bytes));
      const unsigned sVt = sK + static_cast<unsigned>(L.vt);
      const unsigned sQ = sK + static_cast<unsigned>(L.q);
      int8_t* out_cell = out + (static_cast<size_t>(j) * period + c) * N * hd;
      for (int tile = warp % warps_per_cell; tile < tiles; tile += warps_per_cell) {
        if constexpr (kStaged) {
          if (integral) {
            attend_tile<kDepth, kKeyTiles, kMasked, true, true>(sK, sVt, sQ, L, N, hd, tile * kRows, T, r1, x0, n,
                                                                r_out, out_cell);
          } else {
            attend_tile<kDepth, kKeyTiles, kMasked, true, false>(sK, sVt, sQ, L, N, hd, tile * kRows, T, r1, x0, n,
                                                                 r_out, out_cell);
          }
        } else {
          attend_tile<kDepth, kKeyTiles, kMasked, false, false>(sK, sVt, sQ, L, N, hd, tile * kRows, T, r1, x0, n,
                                                                r_out, out_cell);
        }
      }
    }
    if (next) {
      if (P.buffers == 1) {
        __syncthreads();  // every warp is done with the buffer
        load_round(round + 1, 0);
        asm volatile("cp.async.commit_group;\n" ::);
      }
      asm volatile("cp.async.wait_all;\n" ::);
      __syncthreads();
      transpose(round + 1, buf ^ (P.buffers - 1));
      __syncthreads();
    }
  }
}

template <int kDepth, int kKeyTiles, bool kMasked>
int launch(const void* q, const void* k, const void* v, const float* bias, const float* mask,
           void* out, int G, int N, int hd, int heads, int period, float r1, float rb, float scale,
           float r_out, float n, cudaStream_t stream) {
  const Plan P = plan(N, hd, kKeyTiles * 8 <= kStagedKeys, kMasked);
  // rounds: as many as leave the grid two waves of three blocks an SM
  const int cells = G / period;
  int rounds = kMaxRounds;
  while (rounds > 1 &&
         static_cast<long long>(period) * ((cells + P.per_round * rounds - 1) / (P.per_round * rounds)) < kTargetBlocks) {
    rounds /= 2;
  }
  // with the static tables (4 KB) past 48 KB a block needs the opt-in
  const cudaError_t e = cudaFuncSetAttribute(window_attention_kernel<kDepth, kKeyTiles, kMasked>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(P.bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = static_cast<long long>(period) * ((cells + P.per_round * rounds - 1) / (P.per_round * rounds));
  window_attention_kernel<kDepth, kKeyTiles, kMasked><<<static_cast<unsigned>(blocks), kWarps * 32, P.bytes, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), static_cast<const int8_t*>(v), bias, mask,
      static_cast<int8_t*>(out), N, hd, heads, period, cells, rounds, r1, rb, scale, r_out, n);
  return static_cast<int>(cudaGetLastError());
}

template <int kKeyTiles, bool kMasked>
int launch_depth(const void* q, const void* k, const void* v, const float* bias, const float* mask,
                 void* out, int G, int N, int hd, int heads, int period, float r1, float rb,
                 float scale, float r_out, float n, cudaStream_t s) {
  switch (depth_steps(hd)) {
    case 1: return launch<1, kKeyTiles, kMasked>(q, k, v, bias, mask, out, G, N, hd, heads, period, r1, rb, scale, r_out, n, s);
    case 2: return launch<2, kKeyTiles, kMasked>(q, k, v, bias, mask, out, G, N, hd, heads, period, r1, rb, scale, r_out, n, s);
    case 4: return launch<4, kKeyTiles, kMasked>(q, k, v, bias, mask, out, G, N, hd, heads, period, r1, rb, scale, r_out, n, s);
    default: return launch<8, kKeyTiles, kMasked>(q, k, v, bias, mask, out, G, N, hd, heads, period, r1, rb, scale, r_out, n, s);
  }
}

template <bool kMasked>
int launch_keys(const void* q, const void* k, const void* v, const float* bias, const float* mask,
                void* out, int G, int N, int hd, int heads, int period, float r1, float rb, float scale,
                float r_out, float n, cudaStream_t s) {
  return N <= kStagedKeys
             ? launch_depth<kStagedKeys / 8, kMasked>(q, k, v, bias, mask, out, G, N, hd, heads, period, r1, rb, scale, r_out, n, s)
             : launch_depth<kMaxN / 8, kMasked>(q, k, v, bias, mask, out, G, N, hd, heads, period, r1, rb, scale, r_out, n, s);
}

}  // namespace win_mma
}  // namespace ivit

// Launches K7 on `stream`; `mask` may be null (an unshifted block).
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// outside the domain: N in [1, 256], hd a multiple of 4 in [4, 256], G a
// whole number of heads (and of n_windows x heads with a mask), and q, k,
// v, out 4-byte aligned.
extern "C" int ivit_fused_int8_window_attention(const void* q, const void* k, const void* v,
                                                const void* bias, const void* mask, void* out,
                                                int G, int N, int hd, int heads, int n_windows,
                                                float r1, float rb, float scale, float r_out,
                                                int n, void* stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (G < 1 || N < 1 || N > ivit::attn_mma::kMaxN || hd < 4 || hd % 4 != 0 || hd > 256 ||
      bias == nullptr || heads < 1 || n_windows < 1 || G % heads != 0 ||
      (mask != nullptr && G % (heads * n_windows) != 0) || (any & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* b = static_cast<const float*>(bias);
  const auto* m = static_cast<const float*>(mask);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float nf = static_cast<float>(n);
  return m != nullptr
             ? ivit::win_mma::launch_keys<true>(q, k, v, b, m, out, G, N, hd, heads, heads * n_windows, r1, rb, scale, r_out, nf, s)
             : ivit::win_mma::launch_keys<false>(q, k, v, b, m, out, G, N, hd, heads, heads, r1, rb, scale, r_out, nf, s);
}
