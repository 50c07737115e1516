"""A throwaway benchmark root at a tiny size, for the CPU tests: the
repository's ``port_bench`` copied beside a ``BENCHMARK.json`` whose cells
run the same configurations and mixes at a 32-cell grid, with their own
limits files."""

from __future__ import annotations

import copy
import json
import os
import shutil

from port_bench.core.registry import BENCH_DIR, REPO_ROOT

TINY_EXTENTS = [[-4.0, 4.0], [-4.0, 4.0], [-3.0, 2.0]]


def tiny_config(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["config"].update(area_extents=TINY_EXTENTS, nms_top_k=32)
    cfg["reduced"] = ["area_extents", "nms_top_k"]
    return cfg


TINY_MIX = {
    "predict_b4": {"batch": 2, "agents": 3, "points_per_agent": 512, "absent": [[1, 2]], "pool": 2,
                   "calls_compared": 3, "profile_calls": 2, "warm_calls": 1},
    "predict_b16": {"batch": 4, "agents": 3, "points_per_agent": 512, "absent": [[1, 2], [3, 2]], "pool": 2,
                    "calls_compared": 2, "profile_calls": 2, "warm_calls": 1},
    "train_kd_b4": {"batch": 2, "agents": 3, "absent": [[1, 2]], "pool": 3, "warm_steps": 1, "profile_steps": 2},
    "train_b4": {"batch": 2, "agents": 3, "absent": [[1, 2]], "pool": 3, "warm_steps": 1, "profile_steps": 2},
}

# limits of the tiny cells, between the CPU readings of the program's plain
# path and of the control or a planted fault over seeds 1-3 (the card's
# limits, at the cells' own sizes, are in limits/): box_gap 0.12-0.23
# against 1.3-1.7; score_gap (logits) 0.33-0.51 against 1.9-2.4 (wrong
# frame's scores 2.9-4.1); rank_gap 0.26-0.31 against 2.0-3.6 (ranking
# reversed 2.1-3.6); loss_gap 0.0003-0.001 against 0.010-0.020 (DiscoNet);
# loss_terms_gap 0.0001-0.0011 against 0.003-0.010 (V2VNet); change_gap
# 0.009-0.034 against 1 (a state or the fusion left unmoved)
PREDICT_LIMITS = {"box_gap": 0.5, "score_gap": 0.1, "rank_gap": 0.08, "keep_gap": 0.0}
TINY_LIMITS = {
    "disconet.predict.b4": PREDICT_LIMITS,
    "disconet.predict.b16": PREDICT_LIMITS,
    "v2vnet.predict.b4": PREDICT_LIMITS,
    "disconet.train_kd.b4": {"loss_gap": 0.004, "loss_terms_gap": 0.004, "fusion_grad_gap": 0.1, "change_gap": 0.3},
    "v2vnet.train.b4": {"loss_terms_gap": 0.002, "grad_gap_median": 0.015, "fusion_grad_gap": 0.1, "change_gap": 0.3},
}


def make_root(tmp: str) -> str:
    """A root with BENCHMARK.json and a copy of port_bench at the tiny size."""
    bench = os.path.join(tmp, os.path.basename(BENCH_DIR))
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    with open(os.path.join(REPO_ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in spec["configs"]:
        with open(os.path.join(tmp, c["file"]), "w") as f:
            json.dump(tiny_config(c["name"]), f)
    for mix, over in TINY_MIX.items():
        path = os.path.join(bench, "traffic", f"{mix}.json")
        with open(path) as f:
            m = json.load(f)
        m.update(over)
        with open(path, "w") as f:
            json.dump(m, f)
    for w in spec["workloads"]:
        with open(os.path.join(bench, "limits", f"{w['name']}.json"), "w") as f:
            json.dump(TINY_LIMITS[w["name"]], f)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(copy.deepcopy(spec), f)
    return tmp
