// K3: fused I-LayerNorm -> folded beta -> per-channel requant to int8,
// for Hopper (sm_90a).
//
// Replaces ivit_tpu/kernels/intnorm_fused.py:fused_layernorm_requant (the
// pl.pallas_call at :74, body :23-54). Per row of the (M, C) int16
// residual stream:
//   exact int32 sums of q, b*b and a*a*128 + a*b (C <= 1000) or a*a and
//   a*b (C > 1000), with a = q >> 8 and b = q & 255;
//   the fixed f32 recombine of sum q^2, mean = rint(sum q / C),
//   var = max(sum q^2 - 2*mean*sum q + C*mean*mean, 0);
//   ten Newton steps k = floor((k + floor(var / k)) / 2) from 2^16;
//   factor = floor((2^31-1) / max(k, 1));
//   y = floor((x - mean) * factor / 2) + bias_int;
//   out = clip(rint(y * ratio), -128, 127) as int8.
// Every f32 expression copies intnorm_fused.py:36-53 op for op; the file is
// compiled with -fmad=false and without fast-math, so there is no FMA
// contraction and `/` is the correctly rounded division.
//
// Bound on the H100: HBM bytes (2 B in, 1 B out an element). Three costs
// stand between a row and that bound, and the design cuts each:
//   * the scalar chain of a row (the mean's division, ten Newton steps of
//     two correctly rounded divisions, the factor's division: about 300
//     instructions) runs once per row group of G lanes, so a warp holds
//     32/G rows and pays the chain once for all of them. The entry point
//     picks G from C (the fewest lanes whose register slots cover the row)
//     and the group's sums are width-G xor shuffles: exact int32 sums, in
//     any order;
//   * the element work: 16-byte loads of 8 int16 and 8-byte stores of 8
//     int8 where C % 8 == 0 and the bases are 16-byte aligned (every path
//     width: 96, 192, 384, 768, 1536), one-element loads otherwise (the
//     scalar instantiation of the same kernel). The sums take a dp2a and
//     three dp4a a pair of int16 (the bytes a and b of both lie in place in
//     the word), and int16 -> float and the final rint -> int8 are exact
//     magic-number adds (kMagic, shiftmax_common.cuh) instead of the
//     quarter-rate conversion unit, which leaves one floor an element on it;
//   * memory latency: a lane keeps its first kSlots chunks of a row in
//     registers between the statistics and the output, with their bias_int
//     and ratio, loaded once per warp (the rows run in a grid-stride loop
//     over row groups, so a lane serves the same channels in every row),
//     and loads the next row group's chunks before it works on this one.
//     Chunks past the slots (C > 768 with 16-byte loads, C > 256 with
//     scalar ones) are read again from L1/L2.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "shiftmax_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kVecSlots = 3;     // 16-byte chunks (8 channels) a lane keeps
constexpr int kScalarSlots = 8;  // channels a lane keeps with scalar loads
using ivit::kMagic;
using ivit::kMagicBits;

// d = a . b + c over four byte pairs, a's bytes signed and b's unsigned.
__device__ __forceinline__ int dp4a_su(int a, unsigned b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// A lane's exact int32 partial sums of a row: q, b*b, a*a and a*b with
// a = q >> 8 and b = q & 255 (the merged statistic is 128*aa + ab).
struct Sums {
  int q = 0, bb = 0, aa = 0, ab = 0;

  __device__ __forceinline__ void add(int qi) {
    const int a = qi >> 8;
    const int b = qi & 255;
    q += qi;
    bb += b * b;
    aa += a * a;
    ab += a * b;
  }

  // two int16 packed in a word: bytes b0, a0, b1, a1
  __device__ __forceinline__ void add2(unsigned w) {
    const unsigned b = w & 0x00ff00ffu;
    const int a = static_cast<int>(w & 0xff00ff00u);
    q = __dp2a_lo(static_cast<int>(w), 0x0101, q);
    bb = static_cast<int>(__dp4a(b, b, static_cast<unsigned>(bb)));
    aa = __dp4a(a, a, aa);
    ab = dp4a_su(a, b << 8, ab);
  }
};

template <int G>
__device__ __forceinline__ int group_sum(int v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The int16 pair packed in a 32-bit word: the low and the high half.
__device__ __forceinline__ int lo16(unsigned w) { return static_cast<int16_t>(w & 0xffffu); }
__device__ __forceinline__ int hi16(unsigned w) { return static_cast<int>(w) >> 16; }

// One output element, in the low byte of the returned word. x - mean is
// (x + kMagic) - (kMagic + mean), both terms exact (|x| < 2^15), and the
// requant is ivit::requant_bits.
__device__ __forceinline__ unsigned out_word(int xi, float base, float factor, float b, float r) {
  const float y = floorf((__int_as_float(kMagicBits + xi) - base) * factor * 0.5f) + b;
  return static_cast<unsigned>(ivit::requant_bits(y * r));
}

// The low bytes of four words, in order, as one word.
__device__ __forceinline__ unsigned low_bytes(unsigned a, unsigned b, unsigned c, unsigned d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// The eight outputs of a 16-byte chunk of x, packed.
__device__ __forceinline__ uint2 out_chunk(uint4 c, float base, float factor, const float* b, const float* r) {
  const unsigned w[4] = {c.x, c.y, c.z, c.w};
  unsigned o[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    o[2 * e] = out_word(lo16(w[e]), base, factor, b[2 * e], r[2 * e]);
    o[2 * e + 1] = out_word(hi16(w[e]), base, factor, b[2 * e + 1], r[2 * e + 1]);
  }
  return make_uint2(low_bytes(o[0], o[1], o[2], o[3]), low_bytes(o[4], o[5], o[6], o[7]));
}

__device__ __forceinline__ void load8(const float* p, float* dst) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 v = reinterpret_cast<const float4*>(p)[1];
  dst[0] = u.x; dst[1] = u.y; dst[2] = u.z; dst[3] = u.w;
  dst[4] = v.x; dst[5] = v.y; dst[6] = v.z; dst[7] = v.w;
}

template <int G, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
fused_layernorm_requant_kernel(const int16_t* __restrict__ x, const float* __restrict__ bias_int,
                         const float* __restrict__ ratio, int8_t* __restrict__ out, int M, int C) {
  constexpr int W = kVec ? 8 : 1;  // channels a chunk
  constexpr int S = kVec ? kVecSlots : kScalarSlots;
  constexpr int R = 32 / G;  // rows a warp
  using Chunk = typename std::conditional<kVec, uint4, int>::type;
  const int lane = threadIdx.x % 32;
  const int j0 = lane % G;  // the lane's first chunk of a row; then every G-th
  const int chunks = C / W;
  const bool merged = C <= 1000;
  const float d = static_cast<float>(C);

  float kb[S][W], kr[S][W];  // bias_int and ratio of the lane's slots
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int j = j0 + G * i;
    if (j < chunks) {
      if constexpr (kVec) {
        load8(bias_int + j * W, kb[i]);
        load8(ratio + j * W, kr[i]);
      } else {
        kb[i][0] = bias_int[j];
        kr[i][0] = ratio[j];
      }
    }
  }

  // the lane's slots of a row, loaded ahead of the row's turn
  Chunk next[S];
  const auto load_slots = [&](long long row) {
    const Chunk* xc = reinterpret_cast<const Chunk*>(x + row * C);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int j = j0 + G * i;
      if (row < M && j < chunks) {
        if constexpr (kVec) {
          next[i] = xc[j];
        } else {
          next[i] = x[row * C + j];
        }
      }
    }
  };

  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * R;
  long long row = warp * R + lane / G;
  load_slots(row);
  // the loop bound is warp-uniform, so every lane reaches the shuffles
  for (long long r0 = warp * R; r0 < M; r0 += stride, row += stride) {
    const bool live = row < M;
    Chunk data[S];
#pragma unroll
    for (int i = 0; i < S; ++i) data[i] = next[i];
    load_slots(row + stride);

    Sums s;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (live && j0 + G * i < chunks) {
        if constexpr (kVec) {
          s.add2(data[i].x);
          s.add2(data[i].y);
          s.add2(data[i].z);
          s.add2(data[i].w);
        } else {
          s.add(data[i]);
        }
      }
    }
    const int16_t* xr = x + row * C;
    for (int j = j0 + G * S; live && j < chunks; j += G) {  // past the slots
      if constexpr (kVec) {
        const uint4 c = reinterpret_cast<const uint4*>(xr)[j];
        s.add2(c.x);
        s.add2(c.y);
        s.add2(c.z);
        s.add2(c.w);
      } else {
        s.add(xr[j]);
      }
    }

    const int s_q = group_sum<G>(s.q);
    const int s_bb = group_sum<G>(s.bb);
    const int s_aa = group_sum<G>(s.aa);
    const int s_ab = group_sum<G>(s.ab);
    float sq2;
    if (merged) {
      sq2 = static_cast<float>(128 * s_aa + s_ab) * 512.0f + static_cast<float>(s_bb);
    } else {
      sq2 = static_cast<float>(s_aa) * 65536.0f + static_cast<float>(s_ab) * 512.0f +
            static_cast<float>(s_bb);
    }
    const float sum_f = static_cast<float>(s_q);
    const float mean = rintf(sum_f / d);
    const float var = fmaxf(sq2 - 2.0f * mean * sum_f + d * mean * mean, 0.0f);
    float k = 65536.0f;
#pragma unroll
    for (int i = 0; i < 10; ++i) k = floorf((k + floorf(var / k)) * 0.5f);
    const float factor = floorf(ivit::kI32Max / fmaxf(k, 1.0f));
    if (!live) continue;

    const float base = kMagic + mean;
    int8_t* orow = out + row * C;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int j = j0 + G * i;
      if (j < chunks) {
        if constexpr (kVec) {
          reinterpret_cast<uint2*>(orow)[j] = out_chunk(data[i], base, factor, kb[i], kr[i]);
        } else {
          orow[j] = static_cast<int8_t>(out_word(data[i], base, factor, kb[i][0], kr[i][0]) & 0xffu);
        }
      }
    }
    for (int j = j0 + G * S; j < chunks; j += G) {  // past the slots: read again
      if constexpr (kVec) {
        float b[8], r[8];
        load8(bias_int + j * W, b);
        load8(ratio + j * W, r);
        reinterpret_cast<uint2*>(orow)[j] = out_chunk(reinterpret_cast<const uint4*>(xr)[j], base, factor, b, r);
      } else {
        orow[j] = static_cast<int8_t>(out_word(xr[j], base, factor, bias_int[j], ratio[j]) & 0xffu);
      }
    }
  }
}

template <int G, bool kVec>
int launch(const void* x, const void* bias_int, const void* ratio, void* out, int M, int C,
           cudaStream_t stream) {
  const auto kernel = fused_layernorm_requant_kernel<G, kVec>;
  static std::atomic<int> wave[ivit::kMaxDevices];
  // enough blocks for every row group, at most one resident wave
  const long long groups = (static_cast<long long>(M) + 32 / G - 1) / (32 / G);
  unsigned blocks = 0;
  const int e = ivit::one_wave_blocks(reinterpret_cast<const void*>(kernel), kWarps * 32,
                                      (groups + kWarps - 1) / kWarps, wave, &blocks);
  if (e != 0) return e;
  kernel<<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const int16_t*>(x), static_cast<const float*>(bias_int), static_cast<const float*>(ratio),
      static_cast<int8_t*>(out), M, C);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_group(int g, const void* x, const void* bias_int, const void* ratio, void* out, int M, int C,
                 cudaStream_t s) {
  switch (g) {
    case 1: return launch<1, kVec>(x, bias_int, ratio, out, M, C, s);
    case 2: return launch<2, kVec>(x, bias_int, ratio, out, M, C, s);
    case 4: return launch<4, kVec>(x, bias_int, ratio, out, M, C, s);
    case 8: return launch<8, kVec>(x, bias_int, ratio, out, M, C, s);
    case 16: return launch<16, kVec>(x, bias_int, ratio, out, M, C, s);
    case 32: return launch<32, kVec>(x, bias_int, ratio, out, M, C, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The lanes of a row group: the least power of two up to 32 whose `slots`
// register slots a lane hold the row's `chunks` (past 32 lanes the rest
// of the row is read again from L1/L2).
int group_lanes(int chunks, int slots) {
  int g = 1;
  while (g < 32 && g * slots < chunks) g *= 2;
  return g;
}

}  // namespace

// Launches K3 on `stream`: 16-byte loads where C % 8 == 0, x, bias_int and
// ratio are 16-byte aligned and out 8-byte aligned, one-element loads
// otherwise, and row groups of group_lanes lanes. Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue outside
// M >= 1, 1 <= C <= 8192.
extern "C" int ivit_fused_layernorm_requant(const void* x, const void* bias_int, const void* ratio,
                                            void* out, int M, int C, void* stream) {
  if (M < 1 || C < 1 || C > 8192) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t in16 = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bias_int) |
                         reinterpret_cast<uintptr_t>(ratio);
  if (C % 8 == 0 && (in16 & 15) == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0) {
    return launch_group<true>(group_lanes(C / 8, kVecSlots), x, bias_int, ratio, out, M, C, s);
  }
  return launch_group<false>(group_lanes(C, kScalarSlots), x, bias_int, ratio, out, M, C, s);
}
