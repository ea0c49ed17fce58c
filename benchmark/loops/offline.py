"""Offline batch serving: batches of seeded images start in pinned host
memory; each is uploaded, run through a CUDA-graph replay of the engine,
and its logits are read back, with at most ``in_flight`` batches queued
on the device.

Traffic keys: ``batch`` (images a batch), ``in_flight``, ``pool``
(distinct batches, served in a seeded cyclic order), ``warmup`` (batches
served through the whole loop during set-up) and ``trace_units`` (the
batches of a traced window).

End-to-end: ``images_per_s``, the images of the batches sent within
``--seconds``, over the time from the first upload to the last of their
logits on the host (``stats``).
"""

from __future__ import annotations

import collections
import time

import torch

from .. import stats
from ..serving import Served, run_loop


class Loop:
    def __init__(self, run, served: Served, traffic: dict):
        self.run, self.served = run, served
        self.batch, self.depth = int(traffic["batch"]), int(traffic["in_flight"])
        n = int(traffic["pool"])
        self.pool = served.pool(n, self.batch)
        cpu = torch.Generator().manual_seed(run.seed % 2**63)
        self.order = torch.randperm(n, generator=cpu).tolist()
        run.mark("pool")
        self.replay = served.capture(self.batch)
        dev, pin = served.device, served.device.type == "cuda"
        classes = served.model["num_classes"]
        self.dev_in = [torch.empty(self.pool.shape[1:], device=dev) for _ in range(self.depth)]
        self.host_out = [torch.empty((self.batch, classes), pin_memory=pin) for _ in range(self.depth)]
        self.done_events = [torch.cuda.Event() if pin else None for _ in range(self.depth)]
        self.first: dict = {}  # pool index -> the first logits served for it
        self.issued = self.differing = 0

    def pump(self, units: int | None = None, deadline: float | None = None) -> list:
        """Serve batches until ``units`` are issued or the clock passes
        ``deadline``; wait for every one issued. Returns the completion
        times (perf_counter) of the batches, in order."""
        span = self.run.spans
        inflight: collections.deque = collections.deque()
        done, i = [], 0
        while True:
            if (units is None or i < units) and (deadline is None or time.perf_counter() < deadline) \
                    and len(inflight) < self.depth:
                slot, k = self.issued % self.depth, self.order[self.issued % len(self.order)]
                with span("upload"):
                    self.dev_in[slot].copy_(self.pool[k], non_blocking=True)
                with span("replay"):
                    logits = self.replay(self.dev_in[slot])
                with span("readback"):
                    self.host_out[slot].copy_(logits, non_blocking=True)
                    if self.done_events[slot] is not None:
                        self.done_events[slot].record()
                inflight.append((slot, k))
                self.issued += 1
                i += 1
                continue
            if not inflight:
                return done
            slot, k = inflight.popleft()
            with span("wait"):
                if self.done_events[slot] is not None:
                    self.done_events[slot].synchronize()
            done.append(time.perf_counter())
            with span("check"):
                if k not in self.first:
                    self.first[k] = self.host_out[slot].clone()
                elif not torch.equal(self.host_out[slot], self.first[k]):
                    self.differing += 1


def run(run, cell) -> dict:
    batch = int(cell.traffic["batch"])
    return run_loop(run, cell, Loop, lambda done, start: {"images_per_s": stats.rate(done, start, batch)})
