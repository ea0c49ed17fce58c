"""Closed-loop serving: ``clients`` = 1 client sends a request, waits for
its logits, then sends the next. Each request is a fresh seeded image (a
batch of ``batch``) taken in a seeded order from a pinned pool: it is
uploaded, replayed through a CUDA-graph capture at that batch, and its
logits are read back to the host before the next request is sent.

Traffic keys: ``batch``, ``pool`` (distinct inputs), ``warmup``
(requests served during set-up) and ``trace_units`` (the requests of a
traced window).

End-to-end: ``latency_p95_ms`` over every request sent within
``--seconds``, each timed from the start of its upload to its logits on
the host.
"""

from __future__ import annotations

import time

import torch

from .. import stats
from ..serving import Served, run_loop


class Loop:
    def __init__(self, run, served: Served, traffic: dict):
        if int(traffic.get("clients", 1)) != 1:
            raise ValueError("closed_loop drives one client")
        self.run, self.served = run, served
        self.batch = int(traffic["batch"])
        n = int(traffic["pool"])
        self.pool = served.pool(n, self.batch)
        cpu = torch.Generator().manual_seed(run.seed % 2**63)
        self.order = torch.randperm(n, generator=cpu).tolist()
        run.mark("pool")
        self.replay = served.capture(self.batch)
        dev, pin = served.device, served.device.type == "cuda"
        self.dev_in = torch.empty(self.pool.shape[1:], device=dev)
        self.host_out = torch.empty((self.batch, served.model["num_classes"]), pin_memory=pin)
        self.done_event = torch.cuda.Event() if pin else None
        self.first: dict = {}
        self.issued = self.differing = 0

    def pump(self, units: int | None = None, deadline: float | None = None) -> list:
        """Serve requests one after another until ``units`` are done or the
        clock passes ``deadline``. Returns (start, end) perf_counter times
        of each request."""
        span = self.run.spans
        times = []
        while (units is None or len(times) < units) and (deadline is None or time.perf_counter() < deadline):
            k = self.order[self.issued % len(self.order)]
            t0 = time.perf_counter()
            with span("upload"):
                self.dev_in.copy_(self.pool[k], non_blocking=True)
            with span("replay"):
                logits = self.replay(self.dev_in)
            with span("readback"):
                self.host_out.copy_(logits, non_blocking=True)
                if self.done_event is not None:
                    self.done_event.record()
            with span("wait"):
                if self.done_event is not None:
                    self.done_event.synchronize()
            times.append((t0, time.perf_counter()))
            self.issued += 1
            with span("check"):
                if k not in self.first:
                    self.first[k] = self.host_out.clone()
                elif not torch.equal(self.host_out, self.first[k]):
                    self.differing += 1
        return times


def run(run, cell) -> dict:
    return run_loop(run, cell, Loop, lambda spans, start: {"latency_p95_ms": stats.latency_ms(spans, 95)})
