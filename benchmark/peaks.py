"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at the
card's full 700 W power limit (NVIDIA's H100 data sheet)."""

INT8_OPS = 1.979e15  # int8 tensor-core operations a second
FP32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES = 3.35e12  # device-memory bytes a second
