"""K3, the fused I-LayerNorm → requant: an int16 (M, C) stream and the
float32 β and ratio (C,) in, int8 (M, C) out; no multiply-adds."""

import re

NAME = re.compile(r"fused_layernorm_requant_kernel")


def _launch(m: int, c: int) -> tuple:
    return (m * c * 2 + m * c + 2 * c * 4, 0)


def launches(model: dict, batch: int) -> list:
    """(bytes, operations) of each K3 launch of one forward: the ViT's two
    a block and the final norm on the class rows; Swin's two a block, one
    a patch merging and the final norm (its patch norm stays plain)."""
    if "depths" not in model:
        D = model["embed_dim"]
        N = (model["img_size"] // model["patch_size"]) ** 2 + 1
        return [_launch(batch * N, D)] * (2 * model["depth"]) + [_launch(batch, D)]
    out = []
    res, dim = model["img_size"] // model["patch_size"], model["embed_dim"]
    for i, depth in enumerate(model["depths"]):
        out += [_launch(batch * res * res, dim)] * (2 * depth)
        if i < len(model["depths"]) - 1:
            out.append(_launch(batch * res * res // 4, 4 * dim))
            res, dim = res // 2, dim * 2
    return out + [_launch(batch * res * res, dim)]
