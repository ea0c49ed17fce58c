"""K1, the fused integer attention of the ViT engine: int8 q, k, v
(G, N, hd) in, the int8 context out; 2 × the Q·Kᵀ and @V multiply-adds."""

import re

NAME = re.compile(r"attention_mma_kernel<false")  # K2 is the same template with kV2 = true


def launches(model: dict, batch: int) -> list:
    """(bytes, operations) of each K1 launch of one forward."""
    D, H = model["embed_dim"], model["num_heads"]
    N = (model["img_size"] // model["patch_size"]) ** 2 + 1
    G, hd = batch * H, D // H
    return [(4 * G * N * hd, 2 * 2 * G * N * N * hd)] * model["depth"]
