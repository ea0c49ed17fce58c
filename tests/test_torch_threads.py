"""The port's tests run torch at one intra-op thread
(``tests/torch_threads.py``)."""

import ast
import glob
import os

import torch

from tests.torch_threads import one_torch_thread  # noqa: F401

# files whose torch runs only on the card, where the CPU side of a test
# may use every core
ON_THE_CARD = {"test_torch_cuda.py", "test_torch_cuda_ranks.py"}


def test_a_port_test_runs_at_one_torch_thread():
    assert torch.get_num_threads() == 1


def _imports(path):
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
            names.add(node.module.split(".")[0])
    return names


def test_every_port_test_file_that_runs_torch_takes_the_fixture():
    """A port test file that imports torch or the port itself runs at one
    thread, so that a new file does not bring the contention back."""
    here = os.path.dirname(os.path.abspath(__file__))
    missing = []
    for path in sorted(glob.glob(os.path.join(here, "test_torch_*.py"))):
        names = _imports(path)
        if os.path.basename(path) in ON_THE_CARD or not names & {"torch", "ivit_tpu_torch"}:
            continue
        if "tests.torch_threads" not in names:
            missing.append(os.path.basename(path))
    assert not missing
