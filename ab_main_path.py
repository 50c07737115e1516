#!/usr/bin/env python
"""Alternating timing of DiscoNet's main path in two checkouts of the port, on one GPU.

    python3 ab_main_path.py PARENT_ROOT CHANGE_ROOT [--rounds 2]

Each round runs, in fresh processes, PARENT CHANGE CHANGE PARENT. A process
imports ``disconet_tpu_torch`` from its root (building that root's kernels)
and times, at the full ``Config()`` width with seeded random weights, the
same work as ``chip_smoke.py`` phases 5-7: ``predict`` of DiscoNet, batch 4 x
6 agents x 16384 points with agent (1, 5) absent (CUDA events, the median of
5 windows of 60 calls), the summed CUDA time of one ``predict`` (torch.profiler,
over 20 calls) and the KD train step with the teacher re-forward on one
device batch (3 warm-up steps, the median of 5 windows of 5 steps). The
training batch is built once (host target assignment takes seconds) and
shared through ``build/``. Prints one JSON line per process, then the
readings of each root in order with their medians.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

BATCH, AGENTS, POINTS = 4, 6, 16384


def _child(root: str, batch_file: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from disconet_tpu_torch import Config, build_model, example_batch, example_train_batch, make_anchors, predict
    from disconet_tpu_torch import _build
    from disconet_tpu_torch.training import batch_to_device, create_train_state, make_train_step

    _build.build_all()
    cfg = Config()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    (x_lo, x_hi), (y_lo, y_hi), (z_lo, z_hi) = cfg.area_extents
    pts = rng.uniform([x_lo, y_lo, z_lo], [x_hi, y_hi, z_hi], (BATCH, AGENTS, POINTS, 3)).astype(np.float32)
    _, trans, amask = example_batch(cfg, BATCH, AGENTS, seed=0)
    amask[1, AGENTS - 1] = False
    pts[1, AGENTS - 1] = np.nan
    args = [torch.from_numpy(x).to(dev) for x in (pts, trans, amask)] + [torch.from_numpy(make_anchors(cfg)).to(dev)]
    model = build_model("disco", cfg, seed=0)

    def windows(fn, n_windows, per_window, warmup):
        for _ in range(warmup):
            fn()
        out = []
        for _ in range(n_windows):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_window):
                fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / per_window)
        return out

    pw = windows(lambda: predict(model, *args, cfg), 5, 60, 3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            predict(model, *args, cfg)
        torch.cuda.synchronize()
    device_ms = sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA) / 1e3 / 20

    if os.path.isfile(batch_file):
        host = dict(np.load(batch_file))
    else:
        host = example_train_batch(cfg, BATCH, AGENTS, seed=2)
        np.savez(batch_file + ".tmp.npz", **host)
        os.replace(batch_file + ".tmp.npz", batch_file)
    tb = batch_to_device(host)
    student = build_model("disco", cfg, seed=0, kd_flag=True)
    teacher = build_model("teacher", cfg, seed=1)
    step = make_train_step(student, cfg, create_train_state(student), teacher=teacher, kd_flag=True)
    kw = windows(lambda: step(tb), 5, 5, 3)
    return {"root": root, "predict_ms": sorted(pw)[2], "predict_windows": pw, "predict_device_ms": device_ms,
            "kd_step_ms": sorted(kw)[2], "kd_windows": kw}


def main(argv) -> int:
    if argv and argv[0] == "--child":
        print(json.dumps(_child(argv[1], argv[2])), flush=True)
        return 0
    rounds = 2
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = argv
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    batch_file = os.path.join(here, "build", "ab_train_batch.npz")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    results = {parent: [], change: []}
    for _ in range(rounds):
        for root in (parent, change, change, parent):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root, batch_file],
                                 capture_output=True, text=True, cwd=here)
            if out.returncode != 0:
                print(out.stdout, out.stderr, file=sys.stderr)
                return 1
            line = out.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            results[root].append(json.loads(line))
    for root, runs in results.items():
        for key in ("predict_ms", "predict_device_ms", "kd_step_ms"):
            vals = [r[key] for r in runs]
            print(f"{root}: {key} " + ", ".join(f"{v:.3f}" for v in vals) + f" (median {statistics.median(vals):.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
