"""K10, the fused integer attention over rows of 257 to 1,024 tokens:
int8 q, k, v (G, N, hd) in, the int8 context out; 2 × the Q·Kᵀ and @V
multiply-adds. What the maths needs, not what the kernel's passes over
its staged scores recompute."""

import re

NAME = re.compile(r"attention_long_kernel")


def launches(model: dict, batch: int) -> list:
    """(bytes, operations) of each K10 launch of one forward, one a block."""
    D, H = model["embed_dim"], model["num_heads"]
    N = (model["img_size"] // model["patch_size"]) ** 2 + 1
    G, hd = batch * H, D // H
    return [(4 * G * N * hd, 2 * 2 * G * N * N * hd)] * model["depth"]
