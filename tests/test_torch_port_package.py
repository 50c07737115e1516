"""Package rules of the PyTorch port, and its kernels on the card.

* importing the port pulls in no JAX and nothing of the JAX package;
* an entry point without ``device="cpu"`` raises when there is no GPU;
* on a GPU (marker ``gpu``, skipped without one), each CUDA kernel matches its
  plain PyTorch version, a bf16 KD train step and a bf16 seg step run, and
  two other fusion models' ``predict`` launch both kernels. ``python3
  chip_smoke.py`` runs the same checks at the main path's full shapes.
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
ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax", "disconet_tpu")
def banned():
    return {m for m in sys.modules if m in ROOTS or m.startswith(tuple(r + "." for r in ROOTS))}
before = banned()
import disconet_tpu_torch
names = [info.name for info in pkgutil.walk_packages(disconet_tpu_torch.__path__, "disconet_tpu_torch.")]
for name in names:
    __import__(name)
print(sorted(names))
print(sorted(banned() - before))
"""


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATION], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert out.returncode == 0, out.stderr
    *_, names, leaked = out.stdout.strip().splitlines()
    assert leaked == "[]", out.stdout
    for name in ("data.dataset", "data.synthetic", "evaluation.mean_ap", "ops.late_fusion", "training.metrics",
                 "utils.pose_noise", "tools.det.create_data_det", "tools.det.train_codet", "tools.det.test_codet",
                 "models.naive_fusion", "models.v2v_net", "models.when2com", "models.unet",
                 "training.seg_module", "tools.seg.create_data_seg", "tools.seg.train_codet",
                 "tools.seg.test_codet"):
        assert f"'disconet_tpu_torch.{name}'" in names, name


def test_no_silent_cpu(monkeypatch):
    """Every entry point that picks a device raises without a GPU unless the
    caller asks for the CPU. The step builders run where ``build_model`` put
    the model and the batch where ``batch_to_device`` put it; the CLIs run on
    the card unless given ``--device cpu``."""
    from disconet_tpu_torch.tools.det import test_codet, train_codet
    from disconet_tpu_torch.tools.seg import test_codet as seg_test, train_codet as seg_train
    from disconet_tpu_torch.training import batch_to_device, prefetch_to_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    for com in ("disco", "teacher", "", "sum", "mean", "max", "cat", "agent", "v2v", "when2com", "who2com"):
        for task in ("det", "seg"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build_model(com, tiny_config(16), task=task)
    batch = {"agent_mask": np.ones((1, 2), bool), "bev": np.zeros((1, 2, 4, 4, 13), np.uint8)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_to_device(batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(prefetch_to_device(iter([batch])))
    for main in (train_codet.main, test_codet.main, seg_train.main, seg_test.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--data", "no/such/dir"])
    assert resolve_device("cpu").type == "cpu"
    assert batch_to_device(batch, "cpu")["bev_packed"].device.type == "cpu"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kd_train_step_on_the_card(cuda):
    """One bf16 KD step of DiscoNet at the 64-grid: finite metrics, the
    student's BatchNorm statistics moved, the teacher bit-identical."""
    from disconet_tpu_torch import example_train_batch
    from disconet_tpu_torch.training import batch_to_device, create_train_state, make_train_step

    cfg = tiny_config(64)
    batch = batch_to_device(example_train_batch(cfg, 2, 3, seed=0, occupancy=(0.05, 0.1), boxes_per_frame=2))
    model = build_model("disco", cfg, kd_flag=True)
    teacher = build_model("teacher", cfg, seed=1)
    t_state = {k: v.clone() for k, v in teacher.state_dict().items()}
    var0 = model.stpn.stages_0.ConvBNRelu_0.BatchNorm_0.running_var.clone()
    metrics = make_train_step(model, cfg, create_train_state(model), teacher=teacher, kd_flag=True)(batch)
    assert set(metrics) == {"loss", "cls_loss", "reg_loss", "kd_loss", "grad_norm"}
    assert all(torch.isfinite(v).item() for v in metrics.values()), metrics
    assert not torch.equal(model.stpn.stages_0.ConvBNRelu_0.BatchNorm_0.running_var, var0)
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, t_state[k]), k


@pytest.mark.gpu
def test_seg_train_step_on_the_card(cuda):
    """One bf16 seg step of DiscoNet on the UNet at the 64-grid: finite
    metrics, every parameter with a gradient, the BatchNorm statistics
    moved; the predict step's classes in range."""
    from disconet_tpu_torch import example_train_batch
    from disconet_tpu_torch.training import batch_to_device, make_seg_predict_step, make_seg_train_step
    from disconet_tpu_torch.training.seg_module import create_seg_train_state

    cfg = tiny_config(64)
    host = example_train_batch(cfg, 2, 3, seed=0, occupancy=(0.05, 0.1), boxes_per_frame=2)
    host["seg_label"] = np.random.default_rng(0).integers(0, cfg.num_seg_classes, (2, 3, 64, 64)).astype(np.int32)
    batch = batch_to_device(host)
    model = build_model("disco", cfg, layer=2, task="seg")
    var0 = model.stpn.stages_0.ConvBNRelu_0.BatchNorm_0.running_var.clone()
    metrics = make_seg_train_step(model, cfg, create_seg_train_state(model))(batch)
    assert set(metrics) == {"loss", "acc"} and all(torch.isfinite(v).item() for v in metrics.values())
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())
    assert not torch.equal(model.stpn.stages_0.ConvBNRelu_0.BatchNorm_0.running_var, var0)
    pred = make_seg_predict_step(model, cfg)(batch)
    assert pred.shape == (2, 3, 64, 64) and 0 <= pred.min().item() and pred.max().item() < cfg.num_seg_classes


@pytest.mark.gpu
@pytest.mark.parametrize("com", ["v2v", "cat"])
def test_fusion_predict_on_the_card(cuda, com):
    """``predict`` of another fusion model from points at the 64-grid: both
    kernels launched, the keep mask equal to the plain ops' pipeline."""
    from disconet_tpu_torch import example_batch, make_anchors, predict
    from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix, rotated_iou_matrix_plain
    from disconet_tpu_torch.ops.voxelize import voxelize_occupy, voxelize_occupy_plain

    cfg = tiny_config(64)
    _, trans, mask = example_batch(cfg, 2, cfg.max_agents, seed=0)
    mask[1, -1] = False
    pts = np.random.default_rng(0).uniform([-8, -8, -3], [8, 8, 2], (2, cfg.max_agents, 4096, 3)).astype(np.float32)
    model = build_model(com, cfg, layer=2, seed=1)
    before = (voxelize_occupy.launches, rotated_iou_matrix.launches)
    boxes, scores, keep = predict(model, pts, trans, mask, make_anchors(cfg), cfg)
    assert voxelize_occupy.launches > before[0] and rotated_iou_matrix.launches > before[1]
    _, _, plain_keep = predict(model, pts, trans, mask, make_anchors(cfg), cfg,
                               voxelize=voxelize_occupy_plain, iou=rotated_iou_matrix_plain)
    assert torch.equal(keep, plain_keep) and torch.isfinite(boxes).all()


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
