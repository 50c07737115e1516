"""What a run may load and read, what its last line holds, and how it
fails without the card or without the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from port_bench.core.harness import FORBIDDEN, forbidden_modules, run_cell
from port_bench.core.registry import BENCH_DIR, REPO_ROOT, load_cell
from port_bench.tests.tiny import make_root


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert not forbidden_modules()
    for name in ("disconet_tpu_torch", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not forbidden_modules()
    for name in ("jax.numpy", "jaxlib", "flax.linen", "disconet_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, object())
    assert forbidden_modules() == ["disconet_tpu.ops", "flax.linen", "jax.numpy", "jaxlib"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_imports_jax_the_jax_package_or_the_root_tools():
    banned = set(FORBIDDEN) | {"chip_smoke", "ab_main_path", "bench", "tools"}
    for dirpath, _, files in os.walk(BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & banned, (path, tops & banned)
            if os.sep + "reference" in path:  # the reference takes nothing of the program
                assert "disconet_tpu_torch" not in tops, path


def test_last_line_keys_and_checks_last(tmp_path):
    root = make_root(str(tmp_path))
    r = run_cell(load_cell("disconet.predict.b4", root), 2**31 + 11, 0.2, False, "cpu", time.perf_counter(),
                 log=lambda *a: None)
    assert list(r)[-1] == "checks" and {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert set(r["metrics"]) == {"predict_scenes_per_s", "predict_p95_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} and r["device"]["count"] == 1
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_without_a_card_fails_and_prints_no_result():
    p = _run(["port_bench/run.py", "--workload", "disconet.predict.b4", "--seed", "1", "--seconds", "1",
              "--trace", "0"], REPO_ROOT)
    assert p.returncode != 0 and "no CUDA device" in p.stderr
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    """Only BENCHMARK.json and the files under paths: no program to run."""
    shutil.copy(os.path.join(REPO_ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = _run(["port_bench/run.py", "--workload", "disconet.predict.b4", "--seed", "1", "--seconds", "1",
              "--trace", "0"], tmp_path)
    assert p.returncode != 0 and not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    p = _run(["port_bench/calibrate.py", "--device", "cpu", "--workload", "disconet.predict.b4", "--seeds", "1"],
             tmp_path)
    assert p.returncode != 0 and "disconet_tpu_torch" in p.stderr


@pytest.mark.gpu
def test_a_tiny_cell_on_the_card(tmp_path):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = make_root(str(tmp_path))
    r = run_cell(load_cell("disconet.predict.b4", root), 5, 0.5, True, "cuda", time.perf_counter(),
                 log=lambda *a: None)
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0 and r["checks"]
