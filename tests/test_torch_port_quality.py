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


@pytest.mark.parametrize("hi,lo,verdict", [
    ([0.5], [0.3], "no verdict (n<2)"),
    ([0.5, 0.6], [0.3], "no verdict (n<2)"),
    ([0.5], [0.3, 0.2], "no verdict (n<2)"),
    ([0.50, 0.51], [0.30, 0.31], "SIGNIFICANT"),
    ([0.45, 0.55], [0.44, 0.54], "within noise"),
])
def test_ordering_stats_matches_the_jax_harness(hi, lo, verdict):
    """The port's copy of the JAX harness's statistic, on that harness's
    own cases (``tests/test_bench_harness.py``), value for value."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from _bench_harness import ordering_stats as jax_ordering_stats

    got, want = bench_quality.ordering_stats(hi, lo), jax_ordering_stats(hi, lo)
    assert got["verdict"] == want["verdict"] == verdict
    assert got == pytest.approx(want) if want["noise"] is not None else got == want


@pytest.mark.parametrize("hi,lo,verdict", [
    ([0.5], [0.3, 0.2], "no verdict (n<2)"),
    ([0.50, 0.51, 0.52], [0.30, 0.31, 0.33], "SIGNIFICANT"),
    ([0.45, 0.55, 0.50], [0.44, 0.54, 0.47], "not significant"),
    ([0.2815, 0.2854, 0.2713, 0.2968, 0.3190, 0.2932, 0.2834, 0.2649, 0.2846, 0.2874], [0.2919, 0.3019, 0.2941],
     "not significant"),
])
def test_welch_test_matches_scipy(hi, lo, verdict):
    """The gap's t over its standard error (sample stds), Welch's degrees
    of freedom and the two-sided p, as scipy's unequal-variance t-test
    gives them; the last case is DiscoNet's ten bf16 seeds against JAX's
    three (t -1.66, p 0.128)."""
    from scipy import stats

    got = bench_quality.welch_test(hi, lo)
    assert got["verdict"] == verdict and got["gap"] == pytest.approx(sum(hi) / len(hi) - sum(lo) / len(lo))
    if len(hi) > 1:
        want = stats.ttest_ind(hi, lo, equal_var=False)
        assert (got["t"], got["p"], got["df"]) == pytest.approx((want.statistic, want.pvalue, want.df))


def test_welch_test_of_constant_samples():
    assert bench_quality.welch_test([0.3, 0.3], [0.3, 0.3])["verdict"] == "not significant"
    got = bench_quality.welch_test([0.4, 0.4], [0.3, 0.3])
    assert got["verdict"] == "SIGNIFICANT" and got["t"] == float("inf") and got["p"] == 0.0


def test_summary_orders_the_port_against_jax(capsys):
    """The DiscoNet fault's readings: JAX's seeds 0-2 against the port's
    first three bf16 seeds read SIGNIFICANT (gap 0.0166, noise 0.0073), and
    by Welch's test too (p 0.038)."""
    reference = {f"disco/seed{s}": {"mAP@0.5": v, "mAP@0.7": 0.2} for s, v in enumerate([0.2919, 0.3019, 0.2941])}
    results = {f"disco/seed{s}": {"mAP@0.5": v, "mAP@0.7": 0.2} for s, v in enumerate([0.2815, 0.2854, 0.2713])}
    rows = {r["metric"]: r for r in bench_quality.summarize(results, reference)}
    st = rows["mAP@0.5"]["ordering"]
    assert st["verdict"] == "SIGNIFICANT" and st["n_hi"] == st["n_lo"] == 3
    assert st["gap"] == pytest.approx(-0.0166, abs=1e-4) and st["noise"] == pytest.approx(0.0073, abs=1e-4)
    assert rows["mAP@0.5"]["welch"]["verdict"] == "SIGNIFICANT"
    assert ("port 0.2794 +/- 0.0059 (n=3), JAX 0.2960 +/- 0.0043 (n=3): gap -0.0166, noise 0.0073 -> SIGNIFICANT; "
            "Welch t -3.20 (df 3.6), p 0.038 -> SIGNIFICANT") in capsys.readouterr().out
