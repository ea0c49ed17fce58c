// K1: fully fused integer attention for Hopper (sm_90a).
//
// Replaces ivit_tpu/kernels/attention_fused.py:fused_int8_attention (the
// pl.pallas_call at :126, body _one_head :29-63). The kernel is the K1
// mode of attention_mma.cuh: every shift-exp guard kept, an exact 64-bit
// row sum rounded once, and an exact int32 @V.
//
// Bound on the H100 at DeiT-S batch 128, (768, 197, 64): bytes, q, k, v
// in and the context out (38.7 MB, 0.0116 ms at 3.35 TB/s); the int8
// products (7.6 G operations) and the per-score requant, max, lookup,
// multiply and floor each need less. Design: both products on int8
// tensor cores (mma.sync.m16n8k32, s8 x s8 for Q.K^T and u8 x s8 for @V,
// the probabilities passed between them in registers), one warp per 16
// query rows, K and V^T staged once per block in shared memory, and the
// shift-exp a 256-entry table per launch (attention_mma.cuh).

#include "attention_mma.cuh"

// Launches K1 on `stream`. Returns cudaGetLastError() (0 on success).
extern "C" int ivit_fused_int8_attention(const void* q, const void* k, const void* v, void* out,
                                         int G, int N, int hd, float r1, float scale,
                                         float r_out, int n, int out_bits, void* stream) {
  return ivit::launch_attention_mma<false>(q, k, v, out, G, N, hd, r1, scale, r_out, n, out_bits,
                                           stream);
}
