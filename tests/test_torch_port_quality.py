"""The port's quality protocol, ``disconet_tpu_torch/tools/bench_quality.py``,
at a tiny size on the CPU.

32-grid, 1 scene x 2 frames per split, 1 epoch, ``lowerbound`` and
``disco`` with the ``disco`` tracking row, the CLIs in-process: the cells
carry the JAX matrix's keys and fields plus the stamp, a rerun skips the
done keys, and the summary sets each config beside the JAX cells. The
epoch-loss parser and the summary's verdicts are checked on made-up input.
The chip runs of the real protocol are in ``results/port_occluded_matrix.json``.
"""

import json
import os

import pytest
import torch

from disconet_tpu_torch.tools import bench_quality

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_tiny_protocol_writes_resumes_and_summarizes(tmp_path, capsys):
    out = str(tmp_path / "cells.json")
    common = ["--root", str(tmp_path / "q"), "--out", out, "--seeds", "0", "--nepoch", "1", "--grid", "32",
              "--train_scenes", "1", "--val_scenes", "1", "--frames", "2", "--batch", "2", "--device", "cpu",
              "--inprocess", "--commit", "abc1234"]
    bench_quality.main([*common, "--configs", "lowerbound", "disco"])
    argv = [*common, "--configs", "disco", "--track_evals"]  # disco is done: only its tracking row runs
    rows = bench_quality.main(argv)
    with open(out) as f:
        cells = json.load(f)
    assert sorted(cells) == ["disco+track/seed0", "disco/seed0", "lowerbound/seed0"]
    with open(os.path.join(ROOT, "results", "occluded_matrix.json")) as f:
        jax_cells = json.load(f)
    for key in ("disco/seed0", "lowerbound/seed0"):
        assert set(jax_cells[key]) - {"train_s"} <= set(cells[key])
        assert cells[key]["n_gt"] > 0 and cells[key]["final_epoch_loss"] == cells[key]["min_epoch_loss"]
        prov = cells[key]["prov"]
        assert prov["card"] == "cpu" and prov["sha"] == "abc1234" and len(prov["source_sha1"]) == 12
        assert prov["nepoch"] == 1 and prov["ckpt"] == "final" and prov["train_s"] > 0 and prov["wall_s"] > 0
        assert prov["steps_per_dispatch"] == 8  # the JAX matrix's
    assert cells["disco/seed0"]["prov"]["layer"] == 3
    assert set(cells["disco+track/seed0"]) == set(jax_cells["disco+track/seed0"]) | {"prov"}
    assert {(r["config"], r["metric"]) for r in rows} >= {("disco", "mAP@0.7"), ("disco+track", "MOTA")}
    assert all(r["jax"] for r in rows)

    capsys.readouterr()
    bench_quality.main(argv)  # every key done: nothing runs again
    printed = capsys.readouterr().out
    assert printed.count("[skip]") == 2 and "[done]" not in printed
    with open(out) as f:
        assert json.load(f) == cells
    capsys.readouterr()
    bench_quality.main(["--out", out, "--summarize"])
    assert "disco+track        MOTA" in capsys.readouterr().out


def test_epoch_loss_stats_reads_the_last_train_run(tmp_path):
    log = tmp_path / "cell.log"
    log.write_text("\n$ python -m disconet_tpu_torch.tools.det.train_codet --nepoch 2\n"
                   "epoch 1 done step 1: cls_loss=9.0  loss=9.00000\n"
                   "\n$ python -m disconet_tpu_torch.tools.det.train_codet --nepoch 3\n"
                   "epoch 1 done step 1: cls_loss=0.5  loss=2.00000\n"
                   "epoch 2 done step 2: cls_loss=0.4  loss=nan\n"
                   "epoch 3 done step 3: cls_loss=0.3  loss=1.50000\n")
    assert bench_quality.epoch_loss_stats(str(log)) == {"final_epoch_loss": 1.5, "min_epoch_loss": 1.5}
    log.write_text(log.read_text() + "epoch 4 done step 4: loss=-inf\n")
    assert bench_quality.epoch_loss_stats(str(log))["final_epoch_loss"] == bench_quality.NONFINITE_LOSS


@pytest.mark.parametrize("values,verdict", [
    ([0.22], "inside the range"),
    ([0.20], "outside by 0.0191 (width 0.0249)"),
    ([0.25, 0.30], "outside by 0.0560 (width 0.0249) FAULT"),
])
def test_summary_verdicts(values, verdict, capsys):
    reference = {f"disco/seed{s}": {"mAP@0.5": 0.3, "mAP@0.7": v} for s, v in enumerate([0.2191, 0.2440, 0.2416])}
    results = {f"disco/seed{s}": {"mAP@0.5": 0.3, "mAP@0.7": v} for s, v in enumerate(values)}
    rows = {r["metric"]: r for r in bench_quality.summarize(results, reference)}
    assert rows["mAP@0.7"]["verdict"] == verdict
    assert rows["mAP@0.5"]["verdict"] == "inside the range"
