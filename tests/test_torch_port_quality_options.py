"""The quality tools' options that follow the JAX harness: the eval-only
robustness rows (``--extra_evals``), the best-of-epoch checkpoint
(``--save_best``), ``--max_pos``, the ordering claims of ``--summarize``, the
seg tool's ``--backbone`` and cells added by processes that share an
``--out``. At a tiny size on the CPU (32-grid, 1 scene x 2 frames per
split, 1-2 epochs, the CLIs in-process), as ``test_torch_port_quality.py``.
"""

import json
import os
import threading

import pytest
import torch

from disconet_tpu_torch.tools import bench_quality, bench_seg_matrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(ROOT, "tools", "bench_quality.py")


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _common(tmp_path, out):
    return ["--root", str(tmp_path / "q"), "--out", out, "--seeds", "0", "--nepoch", "1", "--grid", "32",
            "--train_scenes", "1", "--val_scenes", "1", "--frames", "2", "--batch", "2", "--device", "cpu",
            "--inprocess", "--commit", "abc1234"]


def _jax_names(name: str):
    """The value of the module-level assignment ``name`` in the JAX tool,
    read from its source (it imports JAX-side helpers at import time)."""
    import ast

    with open(JAX_TOOL) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["CONFIGS", "MODE_DIR", "ORDERINGS", "TRACK_ORDERINGS"])
def test_tables_equal_the_jax_harness(name):
    want = _jax_names(name)
    got = getattr(bench_quality, name)
    if name == "CONFIGS":
        assert set(got) == set(want) and all(got[k] == want[k] for k in want)
    elif name == "MODE_DIR":
        assert got == want
    else:
        assert [tuple(p) for p in got] == [tuple(p) for p in want]


def test_extra_evals_train_the_bases_and_write_the_rows(tmp_path, capsys):
    """``--extra_evals`` on a root without checkpoints trains ``disco``,
    the teacher ``upperbound`` and ``disco_kd`` (no cells for them), then
    evaluates the three rows with their flags; ``--max_pos`` reaches
    ``train_codet``."""
    out = str(tmp_path / "cells.json")
    bench_quality.main([*_common(tmp_path, out), "--extra_evals", "--max_pos", "64"])
    with open(out) as f:
        cells = json.load(f)
    assert sorted(cells) == sorted(f"{n}/seed0" for n in bench_quality.EXTRA_EVALS)
    for name, (base, flags) in bench_quality.EXTRA_EVALS.items():
        cell = cells[f"{name}/seed0"]
        assert cell["prov"]["base"] == base and cell["prov"]["ckpt"] == "final" and cell["n_gt"] > 0
        with open(tmp_path / "q" / "logs" / "seed0" / f"{name}.log") as f:
            assert " ".join(flags) in f.read()
    with open(tmp_path / "q" / "logs" / "seed0" / "disco.log") as f:
        assert "--max_pos 64" in f.read()
    assert cells["disco+noise/seed0"]["prov"]["train_s"] > 0
    capsys.readouterr()
    bench_quality.main([*_common(tmp_path, out), "--extra_evals"])  # every row done
    assert capsys.readouterr().out.count("[skip]") == 3


def test_save_best_measures_both_checkpoints(tmp_path):
    """``--save_best 1``: the cell reads ``best.pth`` and carries the final
    checkpoint's numbers beside it; its tracking row the same."""
    out = str(tmp_path / "cells.json")
    argv = [*_common(tmp_path, out), "--configs", "lowerbound", "--save_best", "1", "--track_evals"]
    argv[argv.index("--nepoch") + 1] = "2"
    bench_quality.main(argv)
    with open(out) as f:
        cells = json.load(f)
    cell, trk = cells["lowerbound/seed0"], cells["lowerbound+track/seed0"]
    assert cell["prov"]["ckpt"] == trk["prov"]["ckpt"] == "best"
    assert cell["best_epoch"] in (1, 2) and cell["best_epoch_loss"] == cell["min_epoch_loss"]
    assert set(cell["final"]) == {"mAP@0.5", "mAP@0.7", "n_gt", "n_det"}
    assert set(trk["final"]) == {"MOTA", "MOTP"}
    assert os.path.exists(tmp_path / "q" / "logs" / "seed0" / "lowerbound" / "best.pth")


def test_summary_prints_the_orderings(capsys):
    """The JAX harness's orderings between the port's configs whose cells
    exist, with both statistics and each side's seeds."""
    results = {f"upperbound/seed{s}": {"mAP@0.5": v, "mAP@0.7": v} for s, v in enumerate([0.46, 0.47, 0.45])}
    results.update({f"lowerbound/seed{s}": {"mAP@0.5": v, "mAP@0.7": v} for s, v in enumerate([0.26, 0.28])})
    results.update({f"disco/seed0": {"mAP@0.5": 0.27, "mAP@0.7": 0.2}})
    results.update({f"{c}+track/seed{s}": {"MOTA": v, "MOTP": 0.7}
                    for c, vals in (("disco", [0.2, 0.1]), ("lowerbound", [0.15, 0.12])) for s, v in enumerate(vals)})
    rows = bench_quality.summarize_orderings(results)
    printed = capsys.readouterr().out
    got = {(r["hi"], r["lo"], r["metric"]): r for r in rows}
    up = got[("upperbound", "lowerbound", "mAP@0.5")]
    assert (up["n_hi"], up["n_lo"]) == (3, 2) and up["ordering"]["verdict"] == "SIGNIFICANT"
    assert up["welch"]["verdict"] == "SIGNIFICANT"
    assert got[("disco", "lowerbound", "mAP@0.5")]["welch"]["verdict"] == "no verdict (n<2)"
    assert ("disco+track", "lowerbound+track", "MOTA") in got
    assert ("disco_kd", "disco", "mAP@0.5") not in got  # no disco_kd cells
    assert "upperbound > lowerbound" in printed and "(n=3) vs" in printed


def _add_cells(out, seeds):
    results = {}
    for s in seeds:
        bench_quality.record(out, f"disco/seed{s}", {"mAP@0.5": s / 10}, results)


def test_writers_sharing_an_out_keep_every_cell(tmp_path):
    """Sixteen writers, each opening the lock file on its own (as processes
    do), add 160 cells in turns: none is lost."""
    out = str(tmp_path / "cells.json")
    writers = [threading.Thread(target=_add_cells, args=(out, range(i, 160, 16))) for i in range(16)]
    for w in writers:
        w.start()
    for w in writers:
        w.join(timeout=60)
    assert not any(w.is_alive() for w in writers)
    with open(out) as f:
        assert sorted(json.load(f)) == sorted(f"disco/seed{s}" for s in range(160))


def test_seg_backbone_stpn(tmp_path):
    out = str(tmp_path / "cells.json")
    argv = ["--root", str(tmp_path / "q"), "--out", out, "--seeds", "0", "--configs", "lowerbound", "--nepoch",
            "1", "--grid", "32", "--scenes", "1", "--frames", "2", "--batch", "2", "--device", "cpu",
            "--inprocess", "--commit", "abc1234", "--backbone", "stpn"]
    bench_seg_matrix.main(argv)
    with open(out) as f:
        cell = json.load(f)["lowerbound/seed0"]
    assert cell["prov"]["backbone"] == "stpn" and 0.0 <= cell["mIoU"] <= 1.0
    log = tmp_path / "q" / "logs" / "stpn" / "seed0" / "lowerbound_seg.log"
    assert log.read_text().count("--seg_backbone stpn") == 2  # train and test
