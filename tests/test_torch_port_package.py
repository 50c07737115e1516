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
    assert torch.equal(got, rotated_iou_matrix_plain(t, t[:, :29].contiguous()))
    assert got[:, -3:].abs().max().item() == 0.0


# The main path's geometry: 256-wide rows, so the kernel's bands are 16 rows
# (4 m of x) high.
_VS, _EXT = (0.25, 0.25, 0.4), ((-32.0, 32.0), (-32.0, 32.0), (-3.0, 2.0))


def _voxelize_case(case, rng):
    """(points, mask or None, voxel_size, extents) of one edge case."""
    vs, ext, mask = _VS, _EXT, None

    def points(shape):  # a few outside the extent on each axis
        return rng.uniform([-33, -33, -3.5], [33, 33, 2.5], shape + (3,)).astype(np.float32)

    if case == "band_edges":  # points on and just below every band boundary
        pts = points((2, 2, 4096))
        edges = np.arange(-28.0, 32.0, 4.0, dtype=np.float32)
        pts[..., :15, 0] = edges
        pts[..., 15:30, 0] = np.nextafter(edges, np.float32(-np.inf))
        pts[..., :30, 1:] = 0.0
    elif case == "empty_frame":  # frame 1 all padding, frame 2 all out of extent
        pts = points((3, 1000))
        pts[1] = np.nan
        pts[2, :, 0] = 40.0
    elif case == "mask_all_false":
        pts = points((2, 1000))
        mask = np.zeros((2, 1000), dtype=bool)
    elif case == "one_frame":
        pts = points((777,))
    elif case in ("z1", "z32"):
        vs = (0.25, 0.25, 5.0 if case == "z1" else 0.15625)
        pts = points((2, 3, 2048))
        mask = rng.random((2, 3, 2048)) < 0.8
    else:  # "ragged_n": N neither a multiple of the block size nor of 4
        pts = points((2, 3, 1001))
        mask = rng.random((2, 3, 1001)) < 0.8
    return pts, mask, vs, ext


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case", ["band_edges", "empty_frame", "mask_all_false", "one_frame", "z1", "z32", "ragged_n"]
)
def test_voxelize_kernel_edge_cases(cuda, case):
    from disconet_tpu_torch.ops.voxelize import voxelize_occupy, voxelize_occupy_plain

    pts, mask, vs, ext = _voxelize_case(case, np.random.default_rng(2))
    p = torch.from_numpy(pts).to(cuda)
    m = None if mask is None else torch.from_numpy(mask).to(cuda)
    got = voxelize_occupy(p, vs, ext, mask=m)
    assert torch.equal(got, voxelize_occupy_plain(p, vs, ext, mask=m))
    if case == "band_edges":  # rows 15 and 16 (x = -28 m) straddle the first band boundary
        assert got[..., 15, 128, :].sum().item() > 0 and got[..., 16, 128, :].sum().item() > 0
    if case == "empty_frame":
        assert got[1:].sum().item() == 0 and got[0].sum().item() > 0
    if case == "mask_all_false":
        assert got.sum().item() == 0
    if case in ("z1", "z32"):
        assert got.shape[-1] == (1 if case == "z1" else 32)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n,m,pad_frame", [(2, 45, 70, False), (1, 33, 33, False), (3, 40, 40, True)])
def test_rotated_iou_kernel_edge_cases(cuda, batch, n, m, pad_frame):
    """N != M off the 32-box tile, one frame, a frame of padding only; 0
    wherever ``chip_smoke.skipped_pairs`` holds."""
    from chip_smoke import skipped_pairs
    from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix, rotated_iou_matrix_plain

    rng = np.random.default_rng(batch * 100 + n)

    def boxes(k):
        shape = (batch, k)
        return np.stack([rng.uniform(-30, 30, shape), rng.uniform(-30, 30, shape),
                         rng.uniform(0.5, 4, shape), rng.uniform(0.5, 5, shape),
                         rng.uniform(-np.pi, np.pi, shape)], -1).astype(np.float32)

    a, b = boxes(n), boxes(m)
    b[:, : n // 2] = a[:, : n // 2]  # identical pairs
    if pad_frame:
        a[1] = 0.0
        b[1] = 0.0
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    got = rotated_iou_matrix(ta, tb)
    assert got.shape == (batch, n, m)
    assert torch.equal(got, rotated_iou_matrix_plain(ta, tb))
    assert (got[skipped_pairs(ta, tb)] == 0).all()
    if pad_frame:
        assert got[1].abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("gap", [0.0, 0.5, 0.999, 1.001, 2.0])
def test_rotated_iou_kernel_at_the_separation_slack(cuda, gap):
    """Corners pointing at each other, centres ``gap`` times the two boxes'
    slacks beyond their circumscribed circles: pairs on both sides of the
    kernel's skip test, bit-exact either way, and 0 wherever
    ``chip_smoke.skipped_pairs`` holds."""
    from chip_smoke import iou_reach, skipped_pairs
    from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix, rotated_iou_matrix_plain

    rng = np.random.default_rng(int(gap * 1000))
    n = 512
    a = np.stack([rng.uniform(-30, 30, n), rng.uniform(-30, 30, n), rng.uniform(0.5, 4, n),
                  rng.uniform(0.5, 5, n), np.zeros(n)], -1)
    b = np.stack([np.zeros(n), np.zeros(n), rng.uniform(0.5, 4, n), rng.uniform(0.5, 5, n), np.zeros(n)], -1)
    phi = rng.uniform(-np.pi, np.pi, n)
    a[:, 4] = phi - np.arctan2(a[:, 3], a[:, 2])
    b[:, 4] = phi + np.pi - np.arctan2(b[:, 3], b[:, 2])
    ra, rb = 0.5 * np.hypot(a[:, 2], a[:, 3]), 0.5 * np.hypot(b[:, 2], b[:, 3])

    def slack(boxes, r):  # the kernel's reach less the radius
        return iou_reach(torch.from_numpy(boxes.astype(np.float32)))[2].double().numpy() - r

    for _ in range(3):  # b's slack depends on b's centre: settle it
        dist = ra + rb + gap * (slack(a, ra) + slack(b, rb))
        b[:, 0], b[:, 1] = a[:, 0] + dist * np.cos(phi), a[:, 1] + dist * np.sin(phi)
    ta = torch.from_numpy(a.astype(np.float32)).reshape(4, n // 4, 5).to(cuda)
    tb = torch.from_numpy(b.astype(np.float32)).reshape(4, n // 4, 5).to(cuda)
    got = rotated_iou_matrix(ta, tb)
    assert torch.equal(got, rotated_iou_matrix_plain(ta, tb))
    skipped = skipped_pairs(ta, tb)
    assert (got[skipped] == 0).all()
    placed = skipped.diagonal(dim1=1, dim2=2).float().mean().item()  # the pairs set at the gap
    assert placed > 0.99 if gap > 1 else placed < 0.01
