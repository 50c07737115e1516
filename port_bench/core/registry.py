"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything that belongs to one of them sits in files of its own, found by
name, so that a later change adds a cell, a configuration, a mix or a
per-layer metric as new files and new entries, without editing a file that
is there:

* ``configs/<config>.json``: the model, its ``Config`` fields as run, the
  source, ``reduced`` and ``assumed``;
* ``traffic/<mix>.json``: the mix's parameters; its ``kind`` names the
  driver ``drivers/<kind>.py``;
* ``limits/<cell>.json``: the limits of the numbers that decide ``correct``;
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``reference/fusion/<model>.py``: the plain reference of the model's
  fusion and its operation count.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(BENCH_DIR)

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class UnknownName(LookupError):
    """A name that ``BENCHMARK.json`` or a file under the benchmark does not define."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise UnknownName(f"{what} {name!r} is not a valid name")
    return name


def load_json(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise UnknownName(f"no file {os.path.relpath(path, REPO_ROOT)}") from None


def load_module(path: str, label: str) -> ModuleType:
    """The Python file ``path`` as a module of its own (file names may hold
    dots, so they are not imported by name)."""
    if not os.path.isfile(path):
        raise UnknownName(f"no file {os.path.relpath(path, REPO_ROOT)}")
    mod_name = "port_bench_loaded_" + re.sub(r"[^A-Za-z0-9_]", "_", label)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]]  # the cells that report it; None: every cell

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names resolved."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]
    bench_dir: str

    def driver(self) -> ModuleType:
        kind = check_name(self.traffic.get("kind", ""), "traffic kind")
        return load_module(os.path.join(self.bench_dir, "drivers", f"{kind}.py"), f"driver_{kind}")

    def reader(self, metric: str) -> ModuleType:
        check_name(metric, "metric")
        return load_module(os.path.join(self.bench_dir, "metrics", f"{metric}.py"), f"metric_{metric}")

    def fusion_reference(self) -> ModuleType:
        model = check_name(self.config["model"], "model")
        return load_module(os.path.join(self.bench_dir, "reference", "fusion", f"{model}.py"), f"fusion_{model}")


def _metrics(entries) -> List[Metric]:
    return [Metric(name=e["name"], unit=e["unit"], workloads=e.get("workloads")) for e in entries]


def load_cell(name: str, root: str = REPO_ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its
    configuration, traffic, limits and metrics read from the files under
    ``root/port_bench``."""
    check_name(name, "workload")
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise UnknownName(f"no workload {name!r} in BENCHMARK.json (known: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_name = check_name(w["config"], "config")
    if cfg_name not in configs:
        raise UnknownName(f"workload {name!r} names config {cfg_name!r}, which BENCHMARK.json does not list")
    cfg_file = os.path.join(root, configs[cfg_name]["file"])
    traffic_name = check_name(w["traffic"], "traffic")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=cfg_name,
        traffic_name=traffic_name,
        config=load_json(cfg_file),
        traffic=load_json(os.path.join(bench_dir, "traffic", f"{traffic_name}.json")),
        limits=load_json(os.path.join(bench_dir, "limits", f"{name}.json")),
        end_to_end=[m for m in _metrics(spec["end_to_end"]) if m.applies_to(name)],
        per_layer=[m for m in _metrics(spec["per_layer"]) if m.applies_to(name)],
        bench_dir=bench_dir,
    )
