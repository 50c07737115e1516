"""The plain reference against the program's plain path at a tiny size on
the CPU, both configurations, predict and train, in float32 (the program's
``compute_dtype`` "float32", its exact mode): what the reference computes
is what the program computes, so that the card's gaps are arithmetic."""

import json
import os
import time

import pytest

from port_bench.core.harness import run_cell
from port_bench.core.registry import load_cell
from port_bench.tests.tiny import make_root

# float32 on the CPU, both sides: orders of magnitude under the card's
# bf16 readings. The KD cell's gradients carry the program's bf16 KD tables
# (``precompute_teacher_feats`` stores the teacher's taps in bf16 in every
# mode), and the later steps' losses Adam's amplification of round-off.
BOUNDS = {
    "predict": {"score_gap": 1e-5, "rank_gap": 1e-5, "box_gap": 1e-4, "keep_gap": 0.0},
    "disconet.train_kd.b4": {"loss_gap_step1": 1e-4, "grad_gap": 3e-2, "grad_gap_median": 3e-3,
                             "fusion_grad_gap": 1e-2, "change_gap": 1e-2},
    "v2vnet.train.b4": {"loss_gap_step1": 1e-4, "grad_gap": 3e-3, "grad_gap_median": 1e-4,
                        "fusion_grad_gap": 1e-4, "change_gap": 1e-2},
}


@pytest.fixture(scope="module")
def root32(tmp_path_factory):
    root = make_root(str(tmp_path_factory.mktemp("root32")))
    for name in ("disconet", "v2vnet"):
        path = os.path.join(root, "port_bench", "configs", f"{name}.json")
        with open(path) as f:
            cfg = json.load(f)
        cfg["config"].update(compute_dtype="float32", head_raw_dtype="float32", warp_dtype="float32")
        with open(path, "w") as f:
            json.dump(cfg, f)
    return root


@pytest.mark.parametrize("cell", ["disconet.predict.b4", "v2vnet.predict.b4", "disconet.train_kd.b4",
                                  "v2vnet.train.b4"])
def test_reference_matches_the_program_in_float32(root32, cell):
    import torch

    torch.manual_seed(0)
    r = run_cell(load_cell(cell, root32), 3, 0.2, False, "cpu", time.perf_counter(), log=lambda *a: None)
    got = {**{k: v["value"] for k, v in r["checks"].items()}, **r["readings"]}
    bounds = BOUNDS["predict" if "predict" in cell else cell]
    print(cell, {k: got[k] for k in bounds})
    for k, bound in bounds.items():
        assert got[k] <= bound, (k, got[k], bound)
