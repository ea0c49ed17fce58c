// K2: fused integer attention, v2 value semantics, for Hopper (sm_90a).
//
// Replaces ivit_tpu/kernels/attention_fused_v2.py:fused_int8_attention_v2
// (the pl.pallas_call at :140, body _kernel :49-94). The kernel is the K2
// mode of the template in attention_fused.cuh: the per-element shift-exp
// clip elided, the row sum accumulated in int32 and rounded once to f32,
// and the @V accumulated in f32. The wrapper
// (kernels/attention_fused_v2.py) refuses a scale that fails v2's gate
// n_valid * ceil(1/scale) * 2^n < 2^31, under which each of those is
// exact and the result equals K1's.
//
// The TPU kernel runs one image per grid step with all heads' scores in
// a (H, Mpad, Npad) f32 VMEM scratch (1.4 MB at DeiT-S). A Hopper block
// has 227 KB, so this grid is batch*head x row tiles on the unpadded
// (B*H, N, hd) layout, the same as K1's; the bound is the same too:
// on-chip integer work, with HBM traffic only q, k, v in and the context
// out.

#include "attention_fused.cuh"

// Launches K2 on `stream`. Returns cudaGetLastError() (0 on success).
extern "C" int ivit_fused_int8_attention_v2(const void* q, const void* k, const void* v,
                                            void* out, int G, int N, int hd, float r1,
                                            float scale, float r_out, int n, int out_bits,
                                            void* stream) {
  return ivit::launch_fused_attention<ivit::AttnMode::kK2>(q, k, v, out, G, N, hd, r1, scale, r_out, n,
                                            out_bits, stream);
}
