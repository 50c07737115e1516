"""The API pieces of the JAX package that the port took last, against the JAX
package on the CPU: ``rotated_iou_pairs``, ``affine_grid``/``grid_sample``,
``packed_width``, ``anchors_from_map``, ``Config.head_in_dtype``,
``ConfigGlobal``, the profiling helpers and the export lists; and the
gathered warp's backward (``ops/warp.py::_GatherTaps``), which adds in an
order the indices fix, against autograd's ``index_select`` backward.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import disconet_tpu
import disconet_tpu.models as jax_models
import disconet_tpu.ops as jax_ops
import disconet_tpu.training as jax_training
import disconet_tpu_torch
import disconet_tpu_torch.models as port_models
import disconet_tpu_torch.ops as port_ops
import disconet_tpu_torch.training as port_training
from chip_smoke import index_select_warp
from disconet_tpu.config import ConfigGlobal as JaxConfigGlobal
from disconet_tpu.data.targets import anchors_from_map as jax_anchors_from_map
from disconet_tpu.ops import bitpack as jax_bitpack
from disconet_tpu.ops import warp as jax_warp
from disconet_tpu.ops.pallas.rotated_iou_pallas import rotated_iou_matrix_pallas
from disconet_tpu.ops.rotated_iou import rotated_iou_pairs as jax_rotated_iou_pairs
from disconet_tpu_torch import ConfigGlobal, build_model, tiny_config
from disconet_tpu_torch.checkpoint import load_state_dict_strict, state_dict_from_flax
from disconet_tpu_torch.data.targets import anchors_from_map
from disconet_tpu_torch.models.base import warp_all_pairs
from disconet_tpu_torch.ops import bitpack, warp
from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix_plain, rotated_iou_pairs
from disconet_tpu_torch.training import batch_to_device, create_train_state, get_bev, make_train_step
from disconet_tpu_torch.utils import profiling
from test_torch_port_precision import KD_GROUP_LIMIT, KD_HEADS_LIMIT
from test_torch_port_training import GROUPS, _flat, _host_batch, _jax_batch

# ---------------------------------------------------------------------------
# ops


def _boxes(rng, n):
    """(n, 5) boxes of 0.5-5 m sides near each other, so most pairs meet."""
    return np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(0.5, 5, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], axis=1).astype(np.float32)


def test_rotated_iou_pairs_matches_jax():
    """The pairs by the plain matrix's arithmetic (its diagonal, bit for
    bit), which is the Pallas kernel's: within 1e-5 of JAX's IoU as the TPU
    computes it (the kernel in interpret mode). JAX's jnp
    ``rotated_iou_pairs`` clips with other tolerances (ROADMAP.md, Queue 3):
    the port sits as close to it as JAX's own kernel does (here 1.6e-4 on
    the worst of 192 pairs, both)."""
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 192), _boxes(rng, 192)
    b[:32] = a[:32]  # identical pairs: IoU 1
    got = rotated_iou_pairs(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (192,) and got.dtype == torch.float32
    assert (got > 0).float().mean() > 0.5
    diag = torch.diagonal(rotated_iou_matrix_plain(torch.from_numpy(a)[None], torch.from_numpy(b)[None])[0])
    assert torch.equal(got, diag)
    pallas = np.diagonal(np.asarray(rotated_iou_matrix_pallas(jnp.asarray(a)[None], jnp.asarray(b)[None],
                                                              interpret=True))[0])
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[:32].numpy(), 1.0, atol=1e-5)
    jnp_pairs = np.asarray(jax_rotated_iou_pairs(jnp.asarray(a), jnp.asarray(b)))
    assert np.abs(got.numpy() - jnp_pairs).max() <= np.abs(pallas - jnp_pairs).max() + 1e-5


def test_rotated_iou_pairs_refuses_unpaired_boxes():
    with pytest.raises(ValueError, match="paired boxes"):
        rotated_iou_pairs(torch.zeros(3, 5), torch.zeros(4, 5))


@pytest.mark.parametrize("align_corners", [False, True])
def test_affine_grid_and_grid_sample_match_jax(align_corners):
    rng = np.random.default_rng(1)
    theta = np.concatenate([rng.normal(size=(3, 2, 2)) * 0.3 + np.eye(2), rng.normal(size=(3, 2, 1)) * 0.3],
                           axis=2).astype(np.float32)
    size = (3, 5, 9, 11)
    want_grid = np.asarray(jax_warp.affine_grid(jnp.asarray(theta), size, align_corners))
    grid = warp.affine_grid(torch.from_numpy(theta), size, align_corners)
    np.testing.assert_allclose(grid.numpy(), want_grid, atol=1e-5, rtol=0)
    x = rng.normal(size=size).astype(np.float32)
    want = np.asarray(jax_warp.grid_sample(jnp.asarray(x), jnp.asarray(want_grid), align_corners))
    got = warp.grid_sample(torch.from_numpy(x), torch.from_numpy(want_grid), align_corners)
    assert got.shape == (3, 5, 9, 11)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_packed_width_and_anchors_from_map_equal_jax():
    assert [bitpack.packed_width(z) for z in range(40)] == [jax_bitpack.packed_width(z) for z in range(40)]
    rng = np.random.default_rng(2)
    theta = rng.uniform(-np.pi, np.pi, (4, 5, 6))
    amap = np.concatenate([rng.normal(size=(4, 5, 6, 4)), np.sin(theta)[..., None], np.cos(theta)[..., None]],
                          axis=-1).astype(np.float32)
    got = anchors_from_map(amap)
    assert np.array_equal(got, jax_anchors_from_map(amap)) and got.shape == (4, 5, 6, 5)


def test_config_global_equals_jax():
    port, jax_ = ConfigGlobal(), JaxConfigGlobal()
    assert isinstance(port, disconet_tpu_torch.Config) and port.split == "train"
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(jax_, f.name), f.name
    assert build_model("teacher", tiny_config(32), device="cpu").config == tiny_config(32)
    assert build_model("teacher", ConfigGlobal(), device="cpu").stpn.block_out


def test_profiling_trace_writes_an_annotated_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    profiling.snapshot()
    with profiling.trace(logdir) as d:
        with profiling.annotate("fuse_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
        # a span of the program's own: the warp's
        warp_all_pairs(torch.ones(1, 2, 4, 4, 3), torch.eye(4).expand(1, 2, 2, 4, 4), ((-8.0, 8.0), (-8.0, 8.0)))
    files = [os.path.join(d, f) for f in os.listdir(d)]
    assert files and any("fuse_region" in open(f).read() for f in files)
    assert any('"model/warp"' in open(f).read() for f in files)
    assert os.listdir(d) == ["trace.json"]
    assert {k: v["count"] for k, v in profiling.snapshot()["spans"].items()} == {"fuse_region": 1, "model/warp": 1}


# names of the JAX package's export lists whose counterparts are elsewhere
# or not needed (ROADMAP.md): numpy oracles, the JAX-only voxelizer and the
# functional train state; and ``late_fusion``, which the port's ``ops``
# keeps as the module (its function is ``ops.late_fusion.late_fusion``)
NO_PORT = {"encode_boxes_np", "voxelize_occupy_np", "voxelize_occupy_jax", "rotated_iou_np", "DetTrainState"}
ELSEWHERE = {"late_fusion": "late_fusion"}


@pytest.mark.parametrize("jax_mod,port_mod", [(jax_ops, port_ops), (jax_models, port_models),
                                              (jax_training, port_training), (disconet_tpu, disconet_tpu_torch)],
                         ids=["ops", "models", "training", "package"])
def test_export_lists_match_jax(jax_mod, port_mod):
    names = {n for n in vars(jax_mod) if not n.startswith("_") and callable(getattr(jax_mod, n))
             and getattr(getattr(jax_mod, n), "__module__", "").startswith("disconet_tpu.")}
    missing = sorted(n for n in names - NO_PORT
                     if not callable(getattr(getattr(port_mod, n, None), ELSEWHERE.get(n, "__call__"), None)))
    assert not missing, missing


# ---------------------------------------------------------------------------
# head_in_dtype


def _disco_pair(cfg, **over):
    a = build_model("disco", cfg, device="cpu", seed=0)
    b = build_model("disco", dataclasses.replace(cfg, **over), device="cpu", seed=0)
    b.load_state_dict(a.state_dict())
    return a, b


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_head_in_dtype_keeps_bf16_det_outputs(train):
    """The bf16 heads round their input anyway: cls, reg and head_raw are
    bit-identical with the head input stored in bf16 (JAX's
    ``test_head_in_dtype_bf16_det_outputs_identical``); the KD taps read
    the rounded map."""
    cfg = tiny_config(32)
    batch = batch_to_device(_host_batch(), "cpu")
    bev = get_bev(batch, "bev", cfg)
    a, b = _disco_pair(cfg, head_in_dtype="bfloat16")
    for m in (a, b):
        m.kd_flag = True
        m.train(train)
    with torch.no_grad():
        oa, ob = (m(bev, batch["trans"], batch["agent_mask"]) for m in (a, b))
    for k in ("cls", "reg", "head_raw", "head_raw_f32"):
        assert torch.equal(oa[k], ob[k]), k
    head_a, head_b = oa["kd_feats"][-1], ob["kd_feats"][-1]
    assert torch.equal(head_b, head_b.to(torch.bfloat16).float()) and not torch.equal(head_a, head_b)
    assert torch.equal(head_a.to(torch.bfloat16).float(), head_b)


def test_bf16_kd_step_with_head_in_bf16_tracks_jax():
    """DiscoNet's bf16 KD step with ``head_in_dtype`` bfloat16 in both
    packages, from JAX's weights: the metrics and each group's gradients
    at the bf16 KD bounds of ``test_torch_port_precision.py``."""
    from disconet_tpu.config import tiny_config as jax_tiny_config
    from disconet_tpu.models import TeacherNet as JaxTeacherNet
    from disconet_tpu.models import build_model as jax_build_model
    from disconet_tpu.training import det_module as jdet

    jcfg = jax_tiny_config(32, head_raw_dtype="float32", head_in_dtype="bfloat16")
    cfg = tiny_config(32, head_raw_dtype="float32", head_in_dtype="bfloat16")
    jstudent, jteacher = jax_build_model("disco", jcfg, kd_flag=True), JaxTeacherNet(config=jcfg)

    @jax.jit
    def jax_kd(params, stats, tv, jb):
        t_out = jteacher.apply(tv, jb["bev_teacher"], None, jb["agent_mask"], train=False)

        def loss_fn(p):
            out, _ = jstudent.apply({"params": p, "batch_stats": stats}, jb["bev"], jb["trans"], jb["agent_mask"],
                                    train=True, mutable=["batch_stats"])
            return jdet._losses(out, jb, jcfg, t_out)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    batch = _host_batch()
    jb = _jax_batch(batch)
    sv, tv = _jax_variables(jstudent, jb, 0), _jax_variables(jteacher, jb, 1)
    (_, j_metrics), j_grads = jax_kd(sv["params"], sv["batch_stats"], tv, jb)
    want = _flat(j_grads)
    model = load_state_dict_strict(build_model("disco", cfg, device="cpu", kd_flag=True),
                                   state_dict_from_flax(sv["params"], sv["batch_stats"]))
    teacher = load_state_dict_strict(build_model("teacher", cfg, device="cpu"),
                                     state_dict_from_flax(tv["params"], tv["batch_stats"]))
    metrics = make_train_step(model, cfg, create_train_state(model), teacher=teacher, kd_flag=True)(
        batch_to_device(batch, "cpu"))
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    groups = {}
    for g, prefixes in GROUPS.items():
        keys = [k for k in got if k.startswith(prefixes)]
        groups[g] = float(np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in keys))
                          / np.sqrt(sum(np.sum(want[k] ** 2) for k in keys)))
    print("bf16 KD step, head_in_dtype bfloat16, gradient distance from JAX's by group:",
          {k: f"{v:.3e}" for k, v in groups.items()})
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=5e-3, err_msg=k)
    assert max(groups.values()) < KD_GROUP_LIMIT, groups
    assert groups["heads"] < KD_HEADS_LIMIT, groups


def _jax_variables(module, jb, seed):
    import jax

    v = jax.jit(module.init, static_argnames="train")(jax.random.PRNGKey(seed), jb["bev"], jb["trans"],
                                                     jb["agent_mask"], train=False)
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


# ---------------------------------------------------------------------------
# the gathered warp's backward


def _warp_case(dtype):
    """40x40 maps (1600 cells, the gather's side of the dispatch), 4 agents
    whose poses send many taps off the map and fold several receiver cells
    onto one sender cell (a rotation and a 0.6 scale)."""
    g = torch.Generator().manual_seed(0)
    A, H, C = 4, 40, 6
    ext = ((-5.0, 5.0), (-5.0, 5.0))
    trans = torch.eye(4).repeat(2, A, A, 1, 1)
    for b in range(2):
        for i in range(A):
            for j in range(A):
                th = 0.3 * (i - j) + 0.2 * b
                s = 0.6 if (i + j) % 3 == 0 else 1.0
                trans[b, i, j, :2, :2] = s * torch.tensor([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
                trans[b, i, j, :2, 3] = torch.tensor([2.5 * (i - j), -1.5 * (j - i) + b])
    feats = torch.randn(2, A, H, H, C, generator=g, dtype=dtype)
    cot = torch.randn(2, A, A, H, H, C, generator=g, dtype=dtype)
    return feats, trans, ext, cot


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)], ids=["float64", "float32"])
def test_gathered_warp_backward_matches_index_select(dtype, tol):
    feats, trans, ext, cot = _warp_case(dtype)
    f1, f2 = feats.clone().requires_grad_(True), feats.clone().requires_grad_(True)
    out, ref = warp.warp_features(f1, trans, ext), index_select_warp(f2, trans, ext)
    assert torch.equal(out, ref)  # the same forward arithmetic
    assert (ref == 0).all(dim=-1).float().mean() > 0.2  # many receiver cells see no sender cell
    got, = torch.autograd.grad(out, f1, cot)
    want, = torch.autograd.grad(ref, f2, cot)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel < tol and (got - want).abs().max().item() < tol * want.abs().max().item() * 10, rel


def test_gathered_warp_spreads_the_off_map_taps():
    """The backward's rows: every in-map tap at its own cell, the off-map
    ones wrapped into the map, so no row collects more than a few dozen
    contributions (the clamped edge rows would collect thousands)."""
    feats, trans, ext, _ = _warp_case(torch.float32)
    saved = {}
    real = warp._GatherTaps.apply

    def spy(table, rows, spread, weights):
        saved.update(rows=rows, spread=spread, weights=weights)
        return real(table, rows, spread, weights)

    warp._GatherTaps.apply = spy
    try:
        warp.warp_features(feats, trans, ext)
    finally:
        warp._GatherTaps.apply = real
    inb = saved["weights"] != 0
    assert torch.equal(saved["rows"][inb], saved["spread"][inb])
    clamped = torch.bincount(saved["rows"].reshape(-1)).max().item()
    spread = torch.bincount(saved["spread"].reshape(-1)).max().item()
    assert spread <= 64 < 10 * 64 < clamped, (spread, clamped)
