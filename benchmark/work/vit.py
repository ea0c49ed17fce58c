"""Operations an image of the ViT/DeiT: 2 × the multiply-adds of every
GEMM (patch embed, qkv, proj, fc1, fc2, the head on the class token) and
of attention's Q·Kᵀ and @V."""


def forward_ops(model: dict) -> int:
    D, H = model["embed_dim"], model["num_heads"]
    p = model["patch_size"]
    P = (model["img_size"] // p) ** 2
    N, hidden = P + 1, int(D * model["mlp_ratio"])
    block = N * D * 3 * D + 2 * N * N * D + N * D * D + 2 * N * D * hidden
    return 2 * (P * p * p * 3 * D + model["depth"] * block + D * model["num_classes"])
