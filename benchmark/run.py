"""Run one cell of the benchmark of ``ivit_tpu_torch`` on the card.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names its
configuration and traffic mix; the mix names its loop
(``benchmark/loops/<kind>.py``). The loop sets up the model from the
seed, warms up every shape it uses, then measures for ``--seconds``.
With ``--trace 1`` a traced window (``torch.profiler``) comes first and
the result holds the cell's per-layer metrics; otherwise its end-to-end
metrics. After the window the program's outputs are held against the
plain reference; each number compared is printed beside its limit, last
on standard error and last in the result. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and ``breakdown`` when traced), then ``checks``.

Exits nonzero, with no result, without a card or with fewer cards than
the cell asks for, and when ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``ivit_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import spec  # noqa: E402
from .imports import forbidden_modules  # noqa: E402
from .trace import WINDOW, Spans, TraceView, reduce_trace, write_summary  # noqa: E402

@dataclasses.dataclass
class Run:
    """One run of a cell: its arguments, the device, the host spans and
    the start of the process (``setup_s`` counts from there)."""

    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    spans: Spans = dataclasses.field(default_factory=lambda: Spans(False))

    def traced(self, work, units: int, images: int) -> TraceView:
        """Run ``work`` (which completes ``units`` units holding
        ``images`` images) under the profiler as the traced window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.spans.enabled = True
        with profile(activities=acts) as prof:
            with self.spans(WINDOW):
                work()
                if cuda:
                    torch.cuda.synchronize(self.device)
        self.spans.enabled = False
        view = reduce_trace(prof.events(), {name for name, _, _ in self.spans.records}, units, images, self.cell)
        print(f"trace summary: {write_summary(view, self.spans, self.cell.name)}", file=sys.stderr)
        return view

    def mark(self, what: str) -> None:
        """Note on standard error how far set-up has come."""
        print(f"setup: {what} at {time.perf_counter() - self.t_start:.3f} s", file=sys.stderr)

    def memory_peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout: PyTorch's runtime
    kernel cache here (the port's nvcc libraries go to ``build/`` there by
    themselves)."""
    path = os.path.join(spec.ROOT, "build", "torch_kernels")
    os.makedirs(path, exist_ok=True)
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = path


def execute(run: Run) -> dict:
    """Drive the cell's loop and judge it: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``checks`` (each number compared with its
    limit), ``memory_peak_bytes`` and, when traced, ``trace`` (the
    ``TraceView`` of the traced window)."""
    cell = run.cell
    out = spec.load_module("loops", cell.traffic["loop"], cell.root).run(run, cell)
    limits = cell.config["checks"][cell.traffic["checks"]]
    checks = {name: {"value": float(out["checks"][name]), "limit": float(limit)} for name, limit in limits.items()}
    metrics = {}
    if run.trace:
        for m in cell.per_layer:
            value = spec.load_module("metrics", m["name"], cell.root).read(out["view"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]} for m in cell.end_to_end}
    return {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": int(out["attempted"]), "failed": int(out["failed"]), "metrics": metrics,
            "checks": checks, "memory_peak_bytes": int(out["memory_peak_bytes"]), "trace": out["view"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load(args.workload)
    _cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = Run(cell, args.seed % 2**64, args.seconds, bool(args.trace), device, T_START)
    torch.empty(1, device=device)
    run.mark("torch and the CUDA context")
    r = execute(run)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    line = {k: r[k] for k in ("correct", "attempted", "failed", "metrics")}
    line["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
                      "memory_peak_bytes": r["memory_peak_bytes"]}
    view = r["trace"]
    if view is not None:
        line["device"].update(busy_s=view.busy_s, window_s=view.window_s)
        line["breakdown"] = view.breakdown
    line["checks"] = r["checks"]
    for name, c in r["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
