"""The harness finds a cell's pieces by name, refuses unknown names, and
takes a new cell as new files and new entries only."""

import hashlib
import json
import os
import re
import shutil

import pytest

from port_bench.core.registry import BENCH_DIR, REPO_ROOT, UnknownName, load_cell

with open(os.path.join(REPO_ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    cell = load_cell(name)
    assert cell.config["name"] == cell.config_name
    assert hasattr(cell.driver(), "run") and hasattr(cell.driver(), "control")
    assert hasattr(cell.fusion_reference(), "fuse") and hasattr(cell.fusion_reference(), "flops")
    for m in cell.per_layer:
        assert callable(cell.reader(m.name).read)
    assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())
    assert {m.name for m in cell.end_to_end} >= {"setup_s"}


def test_unknown_names_fail(tmp_path):
    with pytest.raises(UnknownName):
        load_cell("no.such.cell")
    with pytest.raises(UnknownName):
        load_cell("bad name/with slash")
    cell = load_cell(CELLS[0])
    with pytest.raises(UnknownName):
        cell.reader("no_such_metric")
    cell.traffic = dict(cell.traffic, kind="no_such_kind")
    with pytest.raises(UnknownName):
        cell.driver()
    cell.config = dict(cell.config, model="no_such_model")
    with pytest.raises(UnknownName):
        cell.fusion_reference()
    root = tmp_path / "root"
    shutil.copytree(BENCH_DIR, root / "port_bench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "x.cell", "config": "missing", "traffic": "predict_b4", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(UnknownName):
        load_cell("x.cell", str(root))


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A throwaway configuration, mix, limits and per-layer metric, added
    beside the existing files: the cell resolves, and no existing file of
    the benchmark changed."""
    root = tmp_path / "root"
    shutil.copytree(BENCH_DIR, root / "port_bench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _digests(root / "port_bench")
    bench = root / "port_bench"
    cfg = json.loads((bench / "configs" / "disconet.json").read_text())
    cfg["name"] = "disconet_l2"
    cfg["layer"] = 2
    (bench / "configs" / "disconet_l2.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "predict_b4.json").read_text())
    mix["batch"] = 1
    (bench / "traffic" / "predict_b1.json").write_text(json.dumps(mix))
    (bench / "limits" / "disconet_l2.predict.b1.json").write_text(json.dumps({"score_gap": 0.1}))
    (bench / "metrics" / "calls.predict.py").write_text("def read(r):\n    return r.get('timed_calls')\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "disconet_l2", "source": "https://arxiv.org/abs/2111.00643",
                            "file": "port_bench/configs/disconet_l2.json", "reduced": [], "why": "layer 2"})
    spec["workloads"].append({"name": "disconet_l2.predict.b1", "config": "disconet_l2", "traffic": "predict_b1",
                              "chips": 1, "why": "one scene a call at layer 2"})
    spec["per_layer"].append({"name": "calls.predict", "unit": "calls", "better": "higher", "source": "host_clock",
                              "layer": "model step", "moves": "predict_scenes_per_s",
                              "workloads": ["disconet_l2.predict.b1"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and m["name"].startswith("predict"):
            m["workloads"].append("disconet_l2.predict.b1")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell("disconet_l2.predict.b1", str(root))
    assert cell.config["layer"] == 2 and cell.traffic["batch"] == 1
    assert [m.name for m in cell.per_layer] == ["calls.predict"]
    assert cell.reader("calls.predict").read({"timed_calls": 7}) == 7
    assert cell.driver().__name__.endswith("predict")
    after = _digests(root / "port_bench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["port_bench"] and 1 <= SPEC["run_seconds"] <= 51
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]] + CELLS + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in CELLS:
        reported = [m for m in SPEC["end_to_end"] if w in m.get("workloads", CELLS)]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in SPEC["per_layer"])
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
    for c in SPEC["configs"]:
        assert os.path.isfile(os.path.join(REPO_ROOT, c["file"])) and c["file"].startswith("port_bench/")
