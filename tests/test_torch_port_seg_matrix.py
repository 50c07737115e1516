"""The port's segmentation-quality protocol,
``disconet_tpu_torch/tools/bench_seg_matrix.py``, at a tiny size on the CPU.

32-grid, 1 scene x 2 frames per split, 1 epoch, ``disco``, the seg CLIs
in-process: the cell carries the JAX matrix's keys and fields plus
``bench_quality``'s stamp, a rerun skips the done key, and ``--summarize``
prints the port beside the JAX cells. The summary's verdicts are checked on
made-up cells. The chip runs of the real protocol are in
``results/port_seg_matrix.json``.
"""

import json
import os

import pytest
import torch

from disconet_tpu_torch.tools import bench_seg_matrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_tiny_seg_protocol_writes_resumes_and_summarizes(tmp_path, capsys):
    out = str(tmp_path / "cells.json")
    argv = ["--root", str(tmp_path / "q"), "--out", out, "--seeds", "0", "--configs", "disco", "--nepoch", "1",
            "--grid", "32", "--scenes", "1", "--frames", "2", "--batch", "2", "--device", "cpu", "--inprocess",
            "--commit", "abc1234"]
    summary = bench_seg_matrix.main(argv)
    with open(out) as f:
        cells = json.load(f)
    assert sorted(cells) == ["disco/seed0"]
    with open(os.path.join(ROOT, "results", "seg_matrix.json")) as f:
        jax_cell = json.load(f)["disco/seed0"]
    cell = cells["disco/seed0"]
    assert set(jax_cell) - {"train_s"} <= set(cell)
    # the classes that occur (an untrained model also predicts background)
    assert set(jax_cell["iou"]) <= set(cell["iou"]) and 0.0 <= cell["mIoU"] <= 1.0
    assert cell["final_epoch_loss"] == cell["min_epoch_loss"] > 0
    prov = cell["prov"]
    assert prov["card"] == "cpu" and prov["sha"] == "abc1234" and len(prov["source_sha1"]) == 12
    assert prov["layer"] == 2 and prov["nepoch"] == 1 and prov["steps_per_dispatch"] == 8
    assert prov["train_s"] > 0 and prov["eval_s"] > 0 and prov["wall_s"] >= prov["train_s"]
    assert [r["config"] for r in summary["rows"]] == ["disco"] and summary["rows"][0]["jax"]

    capsys.readouterr()
    bench_seg_matrix.main(argv)  # the key is done: nothing runs again
    printed = capsys.readouterr().out
    assert printed.count("[skip]") == 1 and "[done]" not in printed
    with open(out) as f:
        assert json.load(f) == cells
    bench_seg_matrix.main(["--out", out, "--summarize"])
    assert "disco              mIoU" in capsys.readouterr().out


def _cells(values: dict) -> dict:
    return {f"{name}/seed{s}": {"mIoU": v} for name, vals in values.items() for s, v in enumerate(vals)}


def test_seg_summary_against_the_jax_cells(capsys):
    """JAX's seg matrix (``results/seg_matrix.json``) beside made-up port
    cells: the range rule per config, the port's mean against JAX's, and
    the JAX tool's orderings on each package's seeds."""
    with open(os.path.join(ROOT, "results", "seg_matrix.json")) as f:
        reference = json.load(f)
    results = _cells({"disco": [0.74, 0.75, 0.73], "lowerbound": [0.55, 0.56, 0.57],
                      "upperbound": [0.40, 0.41, 0.39]})
    summary = bench_seg_matrix.summarize(results, reference)
    rows = {r["config"]: r for r in summary["rows"]}
    assert rows["disco"]["verdict"] == "inside the range"
    assert rows["lowerbound"]["verdict"] == "inside the range"  # JAX's seed 2 (0.3105) widens it
    assert rows["upperbound"]["verdict"] == "outside by 0.2983 (width 0.0617) FAULT"
    assert rows["disco"]["ordering"]["verdict"] == "within noise"
    assert rows["upperbound"]["ordering"]["verdict"] == "SIGNIFICANT"
    orderings = {(hi, lo): (port, ref) for hi, lo, port, ref in summary["orderings"]}
    assert set(orderings) == {("upperbound", "lowerbound"), ("disco", "lowerbound"), ("upperbound", "disco")}
    port, ref = orderings[("upperbound", "lowerbound")]
    assert port["verdict"] == "SIGNIFICANT" and port["gap"] < 0
    assert ref["verdict"] == "SIGNIFICANT"  # 0.2422 against a noise of 0.1280
    printed = capsys.readouterr().out
    assert "upperbound > lowerbound" in printed and "no cells" not in printed
