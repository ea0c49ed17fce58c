"""What ``BENCHMARK.json`` names, found as files by name.

A cell names a configuration and a traffic mix; each is a file of its
own (``configs/<name>.json``, ``traffic/<name>.json``). A traffic mix
names its loop (``loops/<kind>.py``), a configuration its model family
(``reference/<family>.py``, ``work/<family>.py``), and each per-layer
metric is read by ``metrics/<name>.py``. A later change adds a cell,
configuration, mix, metric or kernel count as new files and entries, and
edits none of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: str = ROOT) -> types.ModuleType:
    """``<root>/benchmark/<kind>/<name>.py`` as a module (names may hold
    dots)."""
    path = os.path.join(root, "benchmark", kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    key = f"benchmark.{kind}.{name}"
    module = sys.modules.get(key)
    if module is not None and os.path.samefile(module.__file__, path):
        return module
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One workload: its configuration, its traffic mix and the metrics
    ``BENCHMARK.json`` asks of it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: str = ROOT

    @property
    def model(self) -> dict:
        """The model's configuration as the program takes it (lists of
        sizes as tuples)."""
        return {k: tuple(v) if isinstance(v, list) else v for k, v in self.config["model"].items()}


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` with its files read."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(root, "benchmark", "traffic", f"{w['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, e2e_names)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer, root)
