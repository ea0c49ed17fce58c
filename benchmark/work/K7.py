"""K7, the fused Swin window attention: int8 q, k, v (B·nW·H, N, hd), the
float32 bias (H, N, N) and, in a shifted block, the float32 mask
(nW, N, N) in, the int8 context out; 2 × the Q·Kᵀ and @V multiply-adds."""

import re

NAME = re.compile(r"window_attention_kernel")


def launches(model: dict, batch: int) -> list:
    """(bytes, operations) of each K7 launch of one forward, one a block."""
    out = []
    for i, (depth, heads) in enumerate(zip(model["depths"], model["num_heads"])):
        res = model["img_size"] // model["patch_size"] // 2**i
        ws = min(model["window_size"], res)
        dim, N, nW = model["embed_dim"] * 2**i, ws * ws, (res // ws) ** 2
        G, hd = batch * nW * heads, dim // heads
        for j in range(depth):
            shifted = j % 2 == 1 and res > model["window_size"]
            nbytes = 4 * G * N * hd + heads * N * N * 4 + (nW * N * N * 4 if shifted else 0)
            out.append((nbytes, 2 * 2 * G * N * N * hd))
    return out
