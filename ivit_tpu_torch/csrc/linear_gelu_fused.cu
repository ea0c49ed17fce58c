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
// What bounds it on the H100: at DeiT-S batch 128 (M = 25216, K = 384,
// C = 1536) the int8 products, 29.7 G operations, 15 us at 1,979 TOP/s;
// the 49 MB of HBM traffic take 14.6 us. The design:
//   * a block owns 64 whole rows (32 where the 64-row buffers do not fit
//     or the grid would not cover the SMs, as at batch 1), since the GELU's
//     row max spans all C outputs; its x rows stay in shared memory, and
//     the weight streams through a 3-stage cp.async ring of 256-column x
//     64-deep tiles that all 8 warps share;
//   * the product runs on mma.sync.m16n8k32 s8 x s8 -> s32 with every
//     fragment loaded by ldmatrix: a warp owns all 64 rows x 32 columns of
//     a 256-column chunk, so each B fragment feeds four MMAs and each A
//     fragment four. mma.sync, not wgmma: at this size the products are
//     about a third of the time, the epilogue the rest, and mma.sync
//     shares K1's fragment helpers (attention_mma.cuh);
//   * each chunk's accumulators take the bias, the r1 requant (int ->
//     float by an exact magic-number add where every value of the warp
//     lies within 2^22, else by the conversion unit) and go as int8 into a
//     (rows x C) shared-memory buffer, the row max folded into that step;
//   * the ShiftGELU output depends only on (q, max q) and the launch
//     constants s_in, r2 and n, so the whole chain is a 256 x 256 int8
//     table, filled once per (s_in, r2) by ivit_gelu_table below from the
//     unchanged gelu_common.cuh chain and cached by the wrapper: after the
//     last chunk the block copies the 256-byte table row of each of its
//     rows' maxima into shared memory and every output is one lookup.

#include <cuda_runtime.h>

#include <cstdint>

#include "attention_mma.cuh"
#include "gelu_common.cuh"

namespace {

using namespace ivit::attn_mma;
using ivit::int_to_float;
using ivit::kMagicBits;
using ivit::requant_bits;

constexpr int kWarps = 8;
constexpr int kChunk = 256;                  // output columns a block takes per pass
constexpr int kDepthBytes = 64;              // K bytes a weight stage holds
constexpr int kStages = 3;                   // weight stages in flight
constexpr int kWs = kDepthBytes + 16;        // weight tile row stride (16 past a multiple of 32)
constexpr int kStageBytes = kChunk * kWs;
constexpr int kSms = 132;
constexpr size_t kMaxSmem = 227 * 1024;

// The shared-memory plan of a block of 16 * kMTiles rows.
struct Plan {
  int kp, xs, qs;      // K padded to 32; x and q buffer row strides (bytes)
  size_t w, q, rowmax, bytes;
};

__host__ __device__ inline Plan plan(int m_tiles, int K, int C) {
  Plan p;
  const int rows = 16 * m_tiles;
  p.kp = (K + 31) / 32 * 32;
  p.xs = p.kp + 16;
  p.qs = (C + 127) / 128 * 128 + 16;  // the 8 rows of a C fragment start 4 banks apart
  p.w = static_cast<size_t>(rows) * p.xs;
  p.q = p.w + static_cast<size_t>(kStages) * kStageBytes;
  p.rowmax = p.q + static_cast<size_t>(rows) * p.qs;
  p.bytes = p.rowmax + sizeof(int) * rows;
  return p;
}

// Rows [0, rows) x bytes [0, width) at shared address dst (row stride
// `stride`) from src (row stride ld); only rows < valid_rows and bytes <
// valid_bytes are read, the rest is zero.
template <int kBytes>
__device__ __forceinline__ void stage_tile(unsigned dst, int stride, const int8_t* src, long long ld,
                                           int valid_rows, int rows, int valid_bytes, int width) {
  const int per_row = width / kBytes;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kBytes;
    const bool ok = r < valid_rows && c < valid_bytes;
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst + r * stride + c),
                 "l"(ok ? src + r * ld + c : src), "n"(kBytes), "r"(ok ? kBytes : 0));
  }
}

template <int kMTiles>
__global__ void __launch_bounds__(kWarps * 32, 1)
fused_linear_shiftgelu_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w_t,
                              const int* __restrict__ b, const float* __restrict__ r1,
                              const uint8_t* __restrict__ table, int8_t* __restrict__ out, int M,
                              int K, int C) {
  constexpr int kRows = 16 * kMTiles;
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan P = plan(kMTiles, K, C);
  const unsigned sX = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned sW = sX + static_cast<unsigned>(P.w);
  unsigned char* sq = smem + P.q;
  int* rowmax = reinterpret_cast<int*>(smem + P.rowmax);

  const long long m0 = static_cast<long long>(blockIdx.x) * kRows;
  const int valid_rows = static_cast<int>(min(static_cast<long long>(kRows), M - m0));
  const bool wide = K % 16 == 0 && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_t)) & 15) == 0;
  const int slices = (P.kp + kDepthBytes - 1) / kDepthBytes;
  const int total = (C + kChunk - 1) / kChunk * slices;
  auto load_stage = [&](int it) {
    const int c0 = it / slices * kChunk;
    const int k0 = it % slices * kDepthBytes;
    const unsigned dst = sW + static_cast<unsigned>(it % kStages) * kStageBytes;
    const int8_t* src = w_t + static_cast<long long>(c0) * K + k0;
    if (wide) {
      stage_tile<16>(dst, kWs, src, K, C - c0, kChunk, K - k0, kDepthBytes);
    } else {
      stage_tile<4>(dst, kWs, src, K, C - c0, kChunk, K - k0, kDepthBytes);
    }
  };

  if (wide) {
    stage_tile<16>(sX, P.xs, x + m0 * K, K, valid_rows, kRows, K, P.kp);
  } else {
    stage_tile<4>(sX, P.xs, x + m0 * K, K, valid_rows, kRows, K, P.kp);
  }
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_stage(s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) rowmax[r] = kMagicBits - 128;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  // ldmatrix row addresses: x as the A fragments (rows 0-7 / 8-15 x
  // bytes 0-15 / 16-31 of a 16-row tile), the weight tile as two B
  // fragments (bytes 0-15 / 16-31 x columns 0-7 / 8-15 of 16 columns)
  const unsigned xa_row = sX + ((lane & 7) + 8 * ((lane >> 3) & 1)) * P.xs + 16 * (lane >> 4);
  const unsigned wb_row = (warp * 32 + (lane & 7) + 8 * (lane >> 4)) * kWs + 16 * ((lane >> 3) & 1);

  int acc[kMTiles][4][4] = {};
  int qmax[kMTiles][2];  // kMagicBits + the running row maxima of rows g, g + 8 of each tile
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) qmax[mt][0] = qmax[mt][1] = kMagicBits - 128;

  for (int it = 0; it < total; ++it) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();
    if (it + kStages - 1 < total) load_stage(it + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::);

    const int k0 = it % slices * kDepthBytes;
    const unsigned wb = sW + static_cast<unsigned>(it % kStages) * kStageBytes + wb_row;
    const int steps = min(kDepthBytes, P.kp - k0) / 32;
#pragma unroll
    for (int ks = 0; ks < kDepthBytes / 32; ++ks) {
      if (ks < steps) {
        int bf[2][4];
        ldmatrix_x4(bf[0], wb + 32 * ks);
        ldmatrix_x4(bf[1], wb + 16 * kWs + 32 * ks);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          int a[4];
          ldmatrix_x4(a, xa_row + mt * 16 * P.xs + k0 + 32 * ks);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_s8s8(acc[mt][nt], a, bf[nt >> 1][2 * (nt & 1)], bf[nt >> 1][2 * (nt & 1) + 1]);
        }
      }
    }
    if (it % slices != slices - 1) continue;

    // the chunk's epilogue: + bias, requant by r1 into the int8 GELU
    // input in shared memory, and the running row maxima
    const int c0 = it / slices * kChunk + warp * 32;
    bool small = true;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + nt * 8 + 2 * t + e;
        const int bias = col < C ? b[col] : 0;
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int v = acc[mt][nt][2 * h + e] + bias;
            acc[mt][nt][2 * h + e] = v;
            small = small && static_cast<unsigned>(v) + (1u << 22) < (1u << 23);
          }
        }
      }
    }
    const bool exact_add = __all_sync(0xffffffffu, small);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = c0 + nt * 8 + 2 * t;
      const float ra = col < C ? r1[col] : 0.0f;
      const float rb = col + 1 < C ? r1[col + 1] : 0.0f;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int qb[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = acc[mt][nt][2 * h + e];
            const float f = exact_add ? int_to_float(v) : __int2float_rn(v);
            qb[e] = requant_bits(f * (e ? rb : ra));
            if (col + e < C) qmax[mt][h] = max(qmax[mt][h], qb[e]);
            acc[mt][nt][2 * h + e] = 0;
          }
          if (col < C) {
            *reinterpret_cast<uint16_t*>(sq + (mt * 16 + g + 8 * h) * P.qs + col) =
                static_cast<uint16_t>(__byte_perm(qb[0], qb[1], 0x0040));
          }
        }
      }
    }
  }

  // the row maxima: a quad holds a row's columns of a warp, then across warps
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int m = qmax[mt][h];
      m = max(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = max(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (t == 0) atomicMax(rowmax + mt * 16 + g + 8 * h, m);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // each row's 256-byte table row (its max's), into the free weight stages
  unsigned char* slices_s = smem + P.w;
  for (int i = threadIdx.x; i < kRows * 16; i += blockDim.x) {
    const int r = i / 16;
    const int qm = (rowmax[r] - kMagicBits) & 0xff;
    reinterpret_cast<uint4*>(slices_s + r * 256)[i % 16] = __ldg(reinterpret_cast<const uint4*>(table + qm * 256) + i % 16);
  }
  __syncthreads();

  // out = table[max q][q], 16 bytes a thread where the rows allow it
  if (C % 16 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const int per_row = C / 16;
    for (int i = threadIdx.x; i < valid_rows * per_row; i += blockDim.x) {
      const int r = i / per_row;
      const int c = (i - r * per_row) * 16;
      const uint4 qv = *reinterpret_cast<const uint4*>(sq + r * P.qs + c);
      const unsigned char* sl = slices_s + r * 256;
      const unsigned in[4] = {qv.x, qv.y, qv.z, qv.w};
      unsigned o[4];
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        o[wd] = sl[in[wd] & 0xff] | (sl[(in[wd] >> 8) & 0xff] << 8) | (sl[(in[wd] >> 16) & 0xff] << 16) |
                (static_cast<unsigned>(sl[in[wd] >> 24]) << 24);
      }
      *reinterpret_cast<uint4*>(out + (m0 + r) * C + c) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  } else {
    for (int i = threadIdx.x; i < valid_rows * C; i += blockDim.x) {
      const int r = i / C;
      const int c = i - r * C;
      out[(m0 + r) * C + c] = static_cast<int8_t>(slices_s[r * 256 + sq[r * P.qs + c]]);
    }
  }
}

// Entry [i][j] of the table: the GELU output of q = int8(j) in a row
// whose max is int8(i), for q <= max; 0 where q > max (never read).
__global__ void gelu_table_kernel(int8_t* __restrict__ table, float s_in, float r2, float n) {
  const int i = blockIdx.x;
  const int j = threadIdx.x;
  const float qmax = static_cast<float>(static_cast<int8_t>(i));
  const float q = static_cast<float>(static_cast<int8_t>(j));
  const float x0 = ivit::gelu_x0(s_in);
  const float exp_max = ivit::shift_exp(-qmax, x0, n);
  table[i * 256 + j] = q <= qmax ? ivit::requant_i8(ivit::shiftgelu_rowmax(q, qmax, exp_max, x0, n), r2) : 0;
}

template <int kMTiles>
int launch_rows(const void* x, const void* w_t, const void* b, const void* r1, const void* table, void* out,
           int M, int K, int C, cudaStream_t stream) {
  const size_t smem = plan(kMTiles, K, C).bytes;
  const cudaError_t e = cudaFuncSetAttribute(fused_linear_shiftgelu_kernel<kMTiles>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((M + 16 * kMTiles - 1) / (16 * kMTiles));
  fused_linear_shiftgelu_kernel<kMTiles><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w_t), static_cast<const int*>(b),
      static_cast<const float*>(r1), static_cast<const uint8_t*>(table), static_cast<int8_t*>(out), M, K, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Fills the (256, 256) int8 GELU table of (s_in, r2) on `stream`.
extern "C" int ivit_gelu_table(void* table, float s_in, float r2, int n, void* stream) {
  gelu_table_kernel<<<256, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<int8_t*>(table), s_in,
                                                                          r2, static_cast<float>(n));
  return static_cast<int>(cudaGetLastError());
}

// Launches K4 on `stream` with the table of its (s_in, r2). Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue outside the
// domain: M, C >= 1, K >= 4 a multiple of 4, 32 rows' buffers within the
// shared memory of a block, x and w_t 4-byte aligned, table 16-byte
// aligned.
extern "C" int ivit_fused_linear_shiftgelu(const void* x, const void* w_t, const void* b,
                                           const void* r1, const void* table, void* out, int M,
                                           int K, int C, void* stream) {
  const uintptr_t words = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_t);
  if (M < 1 || K < 4 || K % 4 != 0 || C < 1 || (words & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0 || plan(2, K, C).bytes > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 64-row blocks where they fit and still cover the SMs, else 32
  if (plan(4, K, C).bytes <= kMaxSmem && (M + 63) / 64 >= kSms) {
    return launch_rows<4>(x, w_t, b, r1, table, out, M, K, C, s);
  }
  return launch_rows<2>(x, w_t, b, r1, table, out, M, K, C, s);
}
