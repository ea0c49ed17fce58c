"""Deploy-artifact persistence: a pickled nested dict of numpy arrays.

Counterpart of ``ivit_tpu/utils/checkpoint.py:save_artifact`` /
``load_artifact``; the file format is the same, so either package reads
the other's files. Unpickling runs code from the file: load only
artifacts this project wrote.
"""

from __future__ import annotations

import os
import pickle


def save_artifact(path: str, artifact: dict) -> None:
    """Write ``artifact`` to ``path`` (pickle protocol 4)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(artifact, f, protocol=4)


def load_artifact(path: str) -> dict:
    """Read an artifact written by either package's ``save_artifact``."""
    with open(path, "rb") as f:
        return pickle.load(f)
