"""Readings that set a cell's limits: the program's numbers on sound runs,
the control's, and (for training) a planted fault's, on the card at the
cell's own size.

    python -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

Serving: each input of the cell's pool is served once through the timed
entry (the CUDA-graph replay at the cell's batch), then ``logit_gap`` is
read for the program and for the control, the reference with its
weights rounded to 4 bits (the precision below the configuration's
int8), both against the 8-bit reference. Training: ``loss_gap``,
``grad_gap`` and ``change_gap`` of the program's checked steps, of the
control (the reference with TF32 in its backward GEMMs, the precision
below the configuration's float32 with TF32 off) and of the fault that
leaves half of the batch out. One JSON line a seed. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import spec
from .trace import Spans


def serving(cell, seed: int, device) -> dict:
    from .serving import Served

    served = Served(cell, seed, device)
    pool = served.pool(int(cell.traffic["pool"]), int(cell.traffic["batch"]))
    replay = served.capture(int(cell.traffic["batch"]))
    answers = {k: replay(pool[k].to(device)).cpu() for k in range(pool.shape[0])}
    del replay
    served.release()
    t = served.family.carry(served.artifact, device)
    control = {k: served.family.forward(t, pool[k].to(device), weight_bits=4).cpu() for k in range(pool.shape[0])}
    return {"program": {"logit_gap": served.logit_gap(answers, pool)},
            "control_int4": {"logit_gap": served.logit_gap(control, pool)}}


def training(cell, seed: int, device) -> dict:
    from .training import Job, Program, checked_steps, compare, run_reference

    job = Job(cell, seed, device)
    checked = int(cell.traffic["checked_steps"])
    state = checked_steps(Program(job), checked, Spans(False))
    torch.cuda.empty_cache()
    ref = run_reference(job, checked)
    return {"program": compare(state, ref, job.weights),
            "control_tf32": compare(run_reference(job, checked, tf32=True), ref, job.weights),
            "fault_half_batch": compare(run_reference(job, checked, half_batch=True), ref, job.weights)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    read = training if cell.traffic["loop"] == "train" else serving
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed, **read(cell, seed, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
