// K1: fully fused integer attention for Hopper (sm_90a).
//
// Replaces ivit_tpu/kernels/attention_fused.py:fused_int8_attention (the
// pl.pallas_call at :126, body _one_head :29-63). The kernel is the K1
// mode of the template in attention_fused.cuh, which states the chain,
// the layout and what bounds it: every shift-exp guard kept, an exact
// 64-bit row sum rounded once, and an exact int32 @V.

#include "attention_fused.cuh"

// Launches K1 on `stream`. Returns cudaGetLastError() (0 on success).
extern "C" int ivit_fused_int8_attention(const void* q, const void* k, const void* v, void* out,
                                         int G, int N, int hd, float r1, float scale,
                                         float r_out, int n, int out_bits, void* stream) {
  return ivit::launch_fused_attention<ivit::AttnMode::kK1>(q, k, v, out, G, N, hd, r1, scale, r_out, n,
                                             out_bits, stream);
}
