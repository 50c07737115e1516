"""One run of one cell: set-up, the measured window, the per-layer readers,
the check against the reference, and the result's last line."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from port_bench.core.registry import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "disconet_tpu")


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose whole top-level name is JAX's,
    flax's or the JAX package's (``disconet_tpu_torch`` is not
    ``disconet_tpu``)."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


class SmiSampler:
    """Reads the card's name, SM clock, temperature, power draw and power
    limit with ``nvidia-smi`` at the start and at the end of the window."""

    def __init__(self, index: int = 0):
        self.index = index
        self.samples: List[str] = []

    def _read(self) -> str:
        try:
            out = subprocess.run(["nvidia-smi", "--query-gpu=name,clocks.sm,temperature.gpu,power.draw,power.limit",
                                  "--format=csv,noheader", "-i", str(self.index)],
                                 capture_output=True, text=True, timeout=10)
            return out.stdout.strip() or out.stderr.strip()
        except (OSError, subprocess.SubprocessError) as e:
            return f"nvidia-smi not available ({type(e).__name__})"

    def _sample(self):
        self.samples.append(f"{time.strftime('%H:%M:%S')} {self._read()}")

    def __enter__(self):
        self._sample()
        return self

    def __exit__(self, *exc):
        self._sample()
        return False


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between the order statistics."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             options: Optional[Dict] = None, log=print) -> Dict:
    """Runs ``cell`` once and returns the result object (the last line)."""
    device = torch.device(device)
    out = cell.driver().run(cell, seed, seconds, trace, device, t_start, options or {}, log=log)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m.name).read(out["readings"])
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m.name not in out["end_to_end"]:
                raise KeyError(f"the {cell.traffic['kind']} driver gives no {m.name}")
            metrics[m.name] = {"value": out["end_to_end"][m.name], "unit": m.unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": None, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": dev}
    if trace:
        # busy and window from the phase traced without host operations;
        # the breakdown from the phase that records them
        summary = out["readings"].get("trace")
        quiet = out["readings"].get("device_trace") or summary
        dev["busy_s"] = quiet.busy_s if quiet is not None else 0.0
        dev["window_s"] = quiet.window_s if quiet is not None else 0.0
        if summary is not None:
            result["breakdown"] = summary.breakdown()
    # the mix's numbers that have a limit decide; the others are readings
    checks = {name: {"value": v, "limit": cell.limits[name]} for name, v in out["checks"].items()
              if name in cell.limits}
    result_readings = {name: v for name, v in out["checks"].items() if name not in cell.limits}
    missing = set(cell.limits) - set(checks)
    result["correct"] = bool(checks) and not missing and all(c["value"] <= c["limit"] for c in checks.values())
    result["readings"] = result_readings
    result["checks"] = checks
    return result


def main(argv: List[str], t_start: float) -> int:
    import argparse

    from port_bench.core.registry import UnknownName, load_cell

    p = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell = load_cell(args.workload)
    except UnknownName as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
