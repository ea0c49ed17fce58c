// K7: fully fused integer Swin window attention for Hopper (sm_90a).
//
// Replaces ivit_tpu/kernels/window_attention_fused.py:
// fused_int8_window_attention (the pl.pallas_call at :132, body _one_cell
// :32-61). The kernel is in attention_fused.cuh: K1's exact chain (every
// shift-exp guard, a 64-bit row sum rounded once, an exact int32 @V) at
// 8-bit probabilities, with the relative-position bias merge clip(rint(a8 * rb) + bias) and the
// optional shifted-window mask addend between the score requant and the
// Shiftmax.
//
// Layout: q, k, v, out are unpadded (G, N, hd) int8 with G = B*nW*heads
// and the head innermost; bias is (heads, N, N) and mask (nW, N, N) f32.
// The Pallas kernel's 128-lane padding and n_valid column mask are TPU
// tiling, value-identical to leaving the pads out.
//
// Bound on the H100: on-chip work. A cell is tiny (N = 49, hd = 32 on every
// Swin-T stage: 2*49*49*32 MACs and 2401 Shiftmax chains), and HBM traffic
// is q, k, v in and the context out, plus the bias and mask planes, which
// stay in L2 (at most 64 windows x 9.6 KB). The grid is cell x row tiles,
// one warp per query row, so at N = 49 a warp fills 49 of its 64 score
// slots and one @V lane per head dimension; a mapping that packs several
// cells per block and uses int8 tensor-core MMA is later work.

#include "attention_fused.cuh"

// Launches K7 on `stream`; `mask` may be null (an unshifted block).
// Returns cudaGetLastError() (0 on success).
extern "C" int ivit_fused_int8_window_attention(const void* q, const void* k, const void* v,
                                                const void* bias, const void* mask, void* out,
                                                int G, int N, int hd, int heads, int n_windows,
                                                float r1, float rb, float scale, float r_out,
                                                int n, void* stream) {
  ivit::WindowArgs win;
  win.bias = static_cast<const float*>(bias);
  win.mask = static_cast<const float*>(mask);
  win.heads = heads;
  win.n_windows = n_windows;
  win.rb = rb;
  return ivit::launch_window_attention(q, k, v, out, G, N, hd, r1, scale, r_out, n, stream, win);
}
