import torch


def pytest_configure(config):
    """One intra-op thread a worker: the tests run in several processes."""
    torch.set_num_threads(1)
