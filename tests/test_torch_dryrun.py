"""``python -m torch.distributed.run -m ivit_tpu_torch.dryrun_multichip
--device cpu``: the port's side of ``__graft_entry__.py``'s
``dryrun_multichip``, launched as a user launches it, at 4 ranks (a
``(2, 2)`` mesh with sequence parallelism, then a ``(2, 2)`` pipeline)
and, ``slow`` as JAX's 8-device run in ``tests/test_train_parallel.py``,
at 8. Rank 0 prints one line a phase, in JAX's words; a phase that fails
raises and the launch exits non-zero."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS = r"loss=(\d+\.\d+)->(\d+\.\d+)"


def _dryrun(n: int) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={n}",
                           "-m", "ivit_tpu_torch.dryrun_multichip", "--device", "cpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return [line for line in proc.stdout.splitlines() if line.startswith("dryrun_multichip")]


def _assert_phases(lines: list, n: int, data: int, model: int) -> None:
    mesh = re.escape(str({"data": data, "model": model}))
    patterns = [rf"dryrun_multichip\({n}\): mesh={mesh} zero1 opt/EMA sharding, {LOSS}",
                r"dryrun_multichip eval: acc1=\d+\.\d\d acc5=\d+\.\d\d",
                rf"dryrun_multichip engine: DP\({n}\) and DPxTP{mesh} logits bit-identical to single-device",
                rf"dryrun_multichip swin: mesh={mesh} {LOSS}",
                rf"dryrun_multichip pipeline: mesh={re.escape(str({'data': n // 2, 'pipe': 2}))} forward "
                rf"bit-identical; {LOSS}"]
    assert len(lines) == len(patterns), lines
    for line, pattern in zip(lines, patterns):
        m = re.fullmatch(pattern, line)
        assert m is not None, (line, pattern)
        if m.groups():  # the training phases learn
            assert float(m.group(2)) < float(m.group(1)), line


def test_dryrun_multichip_four_ranks():
    _assert_phases(_dryrun(4), 4, 2, 2)


@pytest.mark.slow
def test_dryrun_multichip_eight_ranks():
    _assert_phases(_dryrun(8), 8, 4, 2)
