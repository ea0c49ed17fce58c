// K2: fused integer attention, v2 value semantics, for Hopper (sm_90a).
//
// Replaces ivit_tpu/kernels/attention_fused_v2.py:fused_int8_attention_v2
// (the pl.pallas_call at :140, body _kernel :49-94). The kernel is the K2
// mode of attention_mma.cuh: the per-element shift-exp clip elided (in
// its table) and the row sum accumulated in int32 and rounded once to f32.
// The wrapper (kernels/attention_fused_v2.py) refuses a scale that fails
// v2's gate n_valid * ceil(1/scale) * 2^n < 2^31, under which each
// shortcut is exact; v2's f32 @V is exact at any scale (every partial sum
// < 2^22), so it runs as K1's integer product and the result equals K1's.
//
// The TPU kernel runs one image per grid step with all heads' scores in
// a (H, Mpad, Npad) f32 VMEM scratch (1.4 MB at DeiT-S). A Hopper block
// has 227 KB, so the grid is batch*head x row tiles on the unpadded
// (B*H, N, hd) layout, as K1's. Bound and design are K1's
// (attention_fused.cu): bytes bound it at (768, 197, 64), 0.0116 ms; both
// products run on int8 tensor cores (at 16 bits the probabilities go in as
// two u8 halves), the shift-exp is a per-launch table.

#include "attention_mma.cuh"

// Launches K2 on `stream`. Returns cudaGetLastError() (0 on success).
extern "C" int ivit_fused_int8_attention_v2(const void* q, const void* k, const void* v,
                                            void* out, int G, int N, int hd, float r1,
                                            float scale, float r_out, int n, int out_bits,
                                            void* stream) {
  return ivit::launch_attention_mma<true>(q, k, v, out, G, N, hd, r1, scale, r_out, n, out_bits,
                                          stream);
}
