"""Package rules of the PyTorch port, and its kernels on the card.

* importing the port pulls in no JAX and nothing of the JAX package;
* an entry point without ``device="cpu"`` raises when there is no GPU;
* on a GPU (marker ``gpu``, skipped without one), each CUDA kernel matches its
  plain PyTorch version. ``python3 chip_smoke.py`` runs the same checks at the
  main path's full shapes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from disconet_tpu_torch import build_model, tiny_config
from disconet_tpu_torch.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ISOLATION = r"""
import pkgutil, sys
def banned():
    return {m for m in sys.modules
            if m in ("jax", "jaxlib", "flax", "disconet_tpu")
            or m.startswith(("jax.", "jaxlib.", "flax.", "disconet_tpu."))}
before = banned()
import disconet_tpu_torch
for info in pkgutil.walk_packages(disconet_tpu_torch.__path__, "disconet_tpu_torch."):
    __import__(info.name)
print(sorted(banned() - before))
"""


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATION], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("disco", tiny_config(16))
    assert resolve_device("cpu").type == "cpu"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_voxelize_kernel_matches_plain(cuda):
    from disconet_tpu_torch.ops.voxelize import voxelize_occupy, voxelize_occupy_plain

    rng = np.random.default_rng(0)
    vs, ext = (0.25, 0.25, 0.4), ((-8.0, 8.0), (-8.0, 8.0), (-3.0, 2.0))
    pts = rng.uniform(-9, 9, (2, 3, 1000, 3)).astype(np.float32)
    pts[0, 0, 0] = np.nan
    pts[0, 0, 1] = [8.0, 0.0, 0.0]
    pts[0, 0, 2] = [-8.0, -8.0, -3.0]
    mask = torch.from_numpy(rng.random((2, 3, 1000)) < 0.8).to(cuda)
    p = torch.from_numpy(pts).to(cuda)
    before = voxelize_occupy.launches
    for m in (None, mask):
        assert torch.equal(voxelize_occupy(p, vs, ext, mask=m), voxelize_occupy_plain(p, vs, ext, mask=m))
    assert voxelize_occupy.launches == before + 2


@pytest.mark.gpu
def test_rotated_iou_kernel_matches_plain(cuda):
    from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix, rotated_iou_matrix_plain

    rng = np.random.default_rng(1)
    shape = (3, 37)
    a = np.stack([rng.uniform(-30, 30, shape), rng.uniform(-30, 30, shape),
                  rng.uniform(0.5, 4, shape), rng.uniform(0.5, 5, shape),
                  rng.uniform(-np.pi, np.pi, shape)], -1).astype(np.float32)
    a[:, -3:] = 0.0
    t = torch.from_numpy(a).to(cuda)
    got = rotated_iou_matrix(t, t[:, :29].contiguous())
    torch.testing.assert_close(got, rotated_iou_matrix_plain(t, t[:, :29].contiguous()), rtol=0, atol=1e-5)
    assert got[:, -3:].abs().max().item() == 0.0
