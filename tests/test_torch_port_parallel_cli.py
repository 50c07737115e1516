"""``train_codet`` under ``torchrun`` on the CPU: a gloo world of 2 ranks,
``--com disco --mesh_agent 2``, one epoch, then auto-resumed for a second;
rank 0 alone prints and writes; the first step's loss within 1e-3 of the
one-process run's (bf16, the CLI's compute mode: the sharded and the
one-process BatchNorm variances' formulas move roundings). The other
``--com`` train under the agent and the spatial axis too: ``sum`` under
``--mesh_agent 2`` and ``v2v`` under ``--mesh_spatial 2``, each one epoch
with finite losses and rank 0's checkpoint."""

import io
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from disconet_tpu_torch.tools.det import create_data_det, train_codet
from test_torch_port_parallel import SPAWN_TIMEOUT, _free_port


def _first_loss(out: str) -> float:
    return float(re.search(r"epoch 1 done .*?(?<![\w])loss=([\d.eE+-]+)", out).group(1))


def _torchrun(args, master_port: int):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([os.getcwd()] + [p for p in sys.path if p])}
    run = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "127.0.0.1", "--master_port", str(master_port),
           "-m", "disconet_tpu_torch.tools.det.train_codet", *args]
    return subprocess.run(run, env=env, capture_output=True, text=True, timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("com,mesh", [("sum", ["--mesh_agent", "2"]), ("v2v", ["--mesh_spatial", "2"])])
def test_other_coms_train_under_torchrun(tmp_path, com, mesh):
    data = str(tmp_path / "data")
    create_data_det.main(["--data", data, "--scenes", "1", "--frames", "2", "--grid", "32"])
    logs = str(tmp_path / "mesh")
    r = _torchrun(["--data", os.path.join(data, "train"), "--grid", "32", "--batch", "2", "--com", com,
                   "--device", "cpu", "--nworker", "1", *mesh, "--dist_backend", "gloo", "--logpath", logs,
                   "--nepoch", "1"], _free_port())
    assert r.returncode == 0, r.stderr[-3000:]
    shape = "{'data': 1, 'agent': 2}" if "--mesh_agent" in mesh else "{'data': 1, 'agent': 1, 'spatial': 2}"
    assert f"mesh: {shape} over 2 ranks (gloo, cpu)" in r.stdout
    assert r.stdout.count("epoch 1 done") == 1  # rank 0 alone prints
    assert np.isfinite(_first_loss(r.stdout))
    assert os.path.exists(os.path.join(logs, com, "epoch_1.pth"))


def test_train_codet_under_torchrun(tmp_path):
    """``train_codet --com disco --mesh_agent 2`` on 2 gloo ranks for one
    epoch, then auto-resumed for a second: rank 0 alone prints and writes;
    the first step's loss is the one-process run's (bf16: the two
    variances' formulas move roundings)."""
    data = str(tmp_path / "data")
    create_data_det.main(["--data", data, "--scenes", "1", "--frames", "3", "--grid", "32"])
    common = ["--data", os.path.join(data, "train"), "--grid", "32", "--batch", "2", "--com", "disco",
              "--device", "cpu", "--nworker", "1"]
    logs = str(tmp_path / "mesh")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([os.getcwd()] + [p for p in sys.path if p])}
    run = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
           "-m", "disconet_tpu_torch.tools.det.train_codet", *common,
           "--mesh_agent", "2", "--dist_backend", "gloo", "--logpath", logs]
    first = subprocess.run([*run, "--nepoch", "1"], env=env, capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert first.returncode == 0, first.stderr[-3000:]
    assert "mesh: {'data': 1, 'agent': 2} over 2 ranks (gloo, cpu)" in first.stdout
    assert first.stdout.count("epoch 1 done") == 1  # rank 0 alone prints
    assert os.path.exists(os.path.join(logs, "disco", "epoch_1.pth"))
    run[run.index("--master_port") + 1] = str(_free_port())
    second = subprocess.run([*run, "--nepoch", "2", "--auto_resume_path", logs], env=env,
                            capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert second.returncode == 0, second.stderr[-3000:]
    assert "auto-resumed from epoch 1" in second.stdout and "epoch 2 done" in second.stdout
    assert os.path.exists(os.path.join(logs, "disco", "epoch_2.pth"))

    buf = io.StringIO()
    with redirect_stdout(buf):
        train_codet.main([*common, "--nepoch", "1", "--logpath", str(tmp_path / "one")])
    np.testing.assert_allclose(_first_loss(first.stdout), _first_loss(buf.getvalue()), rtol=1e-3)
