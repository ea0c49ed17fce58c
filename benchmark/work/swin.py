"""Operations an image of the Swin Transformer: 2 × the multiply-adds of
every GEMM (patch embed, qkv, proj, fc1, fc2, the patch mergings'
reductions, the head) and of window attention's Q·Kᵀ and @V."""


def forward_ops(model: dict) -> int:
    p, C = model["patch_size"], model["embed_dim"]
    res = model["img_size"] // p
    macs = res * res * p * p * 3 * C
    for i, depth in enumerate(model["depths"]):
        L, N = res * res, min(model["window_size"], res) ** 2
        hidden = int(C * model["mlp_ratio"])
        macs += depth * (L * C * 3 * C + 2 * L * N * C + L * C * C + 2 * L * C * hidden)
        if i < len(model["depths"]) - 1:
            macs += (L // 4) * 4 * C * 2 * C
            res, C = res // 2, C * 2
    return 2 * (macs + C * model["num_classes"])
