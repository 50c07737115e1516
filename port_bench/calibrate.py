"""The readings behind a cell's limits, in one process.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--faults half_batch control_fusion] \
        [--program-faults reversed_ranking] [--seconds 3]

For each of ``--seeds``, one run of the cell with a short window (set-up,
the window at the cell's own load, the check) prints the numbers that
decide ``correct``; for each of ``--control-seeds``, the control's numbers:
the reference put in the program's place in the precision below the
configuration's (``reference/precision.py``); for each fault of
``--faults`` and each control seed, the numbers of the reference with that
fault planted or that second control (training cells: ``half_batch``,
``control_fusion``); for each of ``--program-faults`` and each control
seed, a run of the program with that fault planted under it (the drivers'
``_faulty``). One JSON line each; the
limits in ``limits/<cell>.json`` lie between the program's largest reading
and the control's (or a fault's) smallest. Runs on the card only.
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def main(argv) -> int:
    import torch

    from port_bench.core.harness import run_cell
    from port_bench.core.registry import load_cell

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--program-faults", nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=_ROOT)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload, args.root)
    device = torch.device(args.device)
    runs = [(seed, "") for seed in args.seeds]
    runs += [(seed, f) for f in args.program_faults for seed in args.control_seeds]
    for seed, fault in runs:
        t = time.perf_counter()
        r = run_cell(cell, seed, args.seconds, False, device, t, {"faults": (fault,) if fault else ()},
                     log=lambda *a: None)
        print(json.dumps({"cell": cell.name, "kind": fault or "program", "seed": seed, "s": time.perf_counter() - t,
                          "correct": r["correct"],
                          "checks": {**{k: v["value"] for k, v in r["checks"].items()}, **r["readings"]},
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()}}), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    driver = cell.driver()
    for fault in [""] + list(args.faults):
        for seed in args.control_seeds:
            t = time.perf_counter()
            got = driver.control(cell, seed, device, fault=fault) if fault else driver.control(cell, seed, device)
            print(json.dumps({"cell": cell.name, "kind": fault or "control", "seed": seed,
                              "s": time.perf_counter() - t, "checks": got}), flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
