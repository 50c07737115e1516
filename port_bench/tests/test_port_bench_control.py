"""``correct`` separates the program from its control and from planted
faults, at a tiny size on the CPU (the card's readings at the cells' own
sizes are in PERF.md; ``calibrate.py`` takes them).

* the program, through the whole run, reads correct;
* the control (the reference in the program's place, one precision below
  the configuration's: fp8 for its bf16 convs, bf16 for its fp32 ones)
  reads not correct, on three seeds;
* with the timed path broken underneath, the run reads not correct: an
  answer altered where it is produced, half of the batch left out, a keep
  flag flipped, each frame served with another frame's scores, the
  candidates ranked lowest first (predict); a step that leaves its state
  unchanged, one that leaves the fusion's parameters unmoved, half of the
  batch left out with the mean over the rest, a loss altered (train).
"""

import time

import pytest

from port_bench.core.harness import run_cell
from port_bench.core.registry import load_cell
from port_bench.tests.tiny import make_root

CELLS = ["disconet.predict.b4", "disconet.predict.b16", "v2vnet.predict.b4", "disconet.train_kd.b4", "v2vnet.train.b4"]
FAULTS = {"predict": ["alter_answer", "half_batch", "flip_keep", "wrong_frame_scores", "reversed_ranking"],
          "train": ["unchanged_state", "fusion_unmoved", "half_batch", "alter_answer"]}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("root")))


def _run(root, cell, faults=()):
    return run_cell(load_cell(cell, root), 1, 0.2, False, "cpu", time.perf_counter(), {"faults": faults},
                    log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_reads_correct(root, cell):
    r = _run(root, cell)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_not_correct(root, cell, seed):
    c = load_cell(cell, root)
    got = c.driver().control(c, seed, "cpu")
    assert any(got[k] > limit for k, limit in c.limits.items()), got


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[load_cell(c).traffic["kind"]]])
def test_a_planted_fault_reads_not_correct(root, cell, fault):
    r = _run(root, cell, (fault,))
    assert not r["correct"], (fault, r["checks"])
