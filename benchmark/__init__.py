"""The benchmark of the PyTorch and CUDA port, ``ivit_tpu_torch``, on one
NVIDIA H100 (``python -m benchmark.run``; see ``benchmark/README.md``)."""
