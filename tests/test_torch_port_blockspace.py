"""The port's block-out layout (``ops/blockspace.py``) against the JAX package's
on the CPU.

The JAX package runs decoder stage 0 in the block-out layout by default
(``Config.block_out``): its kernels are transformed in fp32 (the up-conv sums
the taps that read one source pixel) before the bf16 rounding, so in bf16 it
computes another function than the natural conv of the upsampled concat.

* The kernel transforms equal JAX's bit for bit in fp32, and so do
  ``space_to_depth``/``depth_to_space``.
* ``conv_block_out`` and ``conv_up_block_out``, forward and gradients, in
  fp32 and with the port's bf16 operands (``conv2d_bf16_operands``) against
  JAX's bf16 convs.
* A bf16 decoder stage 0 in training mode against JAX's block-out stage
  (``STAGE_*`` bounds); the natural layout breaks the forward bound. The
  STPN's forward and the bf16 KD step of DiscoNet with ``block_out`` (and
  ``block_out_dec1``) against JAX's with the same layout.
* Under a ``spatial`` 2 mesh (a CPU gloo group), a float64 DiscoNet step
  with both block-out stages equals the one-process step; skipping the
  block-out convs' halo rows breaks it.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import P13_F64_REL, _float64, _group_distances
from disconet_tpu.config import tiny_config as jax_tiny_config
from disconet_tpu.models import TeacherNet as JaxTeacherNet
from disconet_tpu.models import build_model as jax_build_model
from disconet_tpu.models.backbone import _DecoderStage as JaxDecoderStage
from disconet_tpu.models.backbone import make_stpn as jax_make_stpn
from disconet_tpu.ops import blockspace as jbs
from disconet_tpu.training import det_module as jdet
from disconet_tpu_torch import build_model, example_train_batch, tiny_config
from disconet_tpu_torch.checkpoint import load_state_dict_strict, state_dict_from_flax
from disconet_tpu_torch.models import backbone
from disconet_tpu_torch.models.backbone import _DecoderStage, conv2d_bf16_operands, make_stpn
from disconet_tpu_torch.ops import blockspace
from disconet_tpu_torch.parallel import make_mesh, shard_batch
from disconet_tpu_torch.training import batch_to_device, create_train_state, make_train_step
from test_torch_port_parallel import _step_result, spawn
from test_torch_port_precision import CONV_FWD_LIMIT, CONV_GRAD_LIMIT, KD_GROUP_LIMIT, KD_HEADS_LIMIT
from test_torch_port_training import GROUPS, _flat, _host_batch, _jax_batch

# The bounds of one bf16 conv against JAX's (test_torch_port_precision.py),
# which each block-out conv meets (CPU readings: forward 7.2e-8 to 9.3e-8,
# gradients 6.5e-8 to 1.7e-7)
FWD_LIMIT = CONV_FWD_LIMIT
GRAD_LIMIT = CONV_GRAD_LIMIT
# A stage chains two convs through a BatchNorm, and XLA rounds each conv of
# the pair's sum to bf16: fp32-level differences (summation orders) flip a
# few bf16 roundings, one bf16 step each, and the backward carries them.
# CPU readings, seeds 0-5 of ``_stage_case``: forward 3.7e-7 to 7.2e-5 with
# at most 0.24% of the outputs off by more than 1e-4 of the largest,
# gradients 2.0e-5 to 8.2e-3; the natural stage against JAX's natural one
# reads 4.6e-6 and 8.2e-5 (forward, seeds 0-1) too. The natural layout against JAX's
# block-out stage: forward 3.8e-3 to 4.0e-3 with 45% of the outputs off,
# gradients 4.0e-2 to 8.3e-2.
STAGE_FWD_LIMIT = 2e-4
STAGE_OFF_SHARE = 0.01
STAGE_GRAD_LIMIT = 2e-2


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k, np.float32).transpose(3, 2, 0, 1)))


# ---------------------------------------------------------------------------
# the transforms and the two convs


@pytest.mark.parametrize("name", ["block_out_weights", "up_block_out_weights"])
@pytest.mark.parametrize("cin,cout", [(5, 7), (96, 32)])
def test_weight_transforms_equal_jax(name, cin, cout):
    w = np.random.default_rng(cin).normal(size=(3, 3, cin, cout)).astype(np.float32)
    want = np.asarray(getattr(jbs, name)(jnp.asarray(w)))
    got = getattr(blockspace, name)(_oihw(w)).permute(2, 3, 1, 0).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_space_to_depth_equals_jax():
    x = np.random.default_rng(0).normal(size=(2, 8, 6, 5)).astype(np.float32)
    s = blockspace.space_to_depth(_nchw(x))
    assert np.array_equal(_nhwc(s), np.asarray(jbs.space_to_depth(jnp.asarray(x))))
    assert torch.equal(blockspace.depth_to_space(s), _nchw(x))


def _jax_conv_case(name, x, w, r, bf16):
    """JAX's (out, d/dx, d/dw) of sum(conv(x, w) * r), the module's bf16
    casts when ``bf16``."""
    fn = getattr(jbs, name)

    def f(xx, ww):
        out = fn(xx.astype(jnp.bfloat16) if bf16 else xx, ww).astype(jnp.float32)
        return jnp.sum(out * r), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(out), np.asarray(grads[0]), np.asarray(grads[1])


# fp32 readings: forward 1.8e-7 to 2.3e-7, gradients 1.4e-7 to 3.6e-7
# (summation orders)
F32_LIMIT = 1e-6


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("name", ["conv_block_out", "conv_up_block_out"])
def test_block_out_convs_match_jax(name, bf16):
    rng = np.random.default_rng(1)
    N, H, C, Co = 2, 12, 24, 16
    x = rng.normal(size=(N, H, H, C)).astype(np.float32)
    w = (rng.normal(size=(3, 3, C, Co)) * 0.2).astype(np.float32)
    P = H // 2 if name == "conv_block_out" else H
    r = rng.normal(size=(N, P, P, 4 * Co)).astype(np.float32)
    want = _jax_conv_case(name, x, w, r, bf16)
    xt, wt = _nchw(x).requires_grad_(True), _oihw(w).requires_grad_(True)
    conv = conv2d_bf16_operands if bf16 else functools.partial(F.conv2d)
    out = getattr(blockspace, name)(xt, wt, conv)
    (out * _nchw(r)).sum().backward()
    got = (_nhwc(out), _nhwc(xt.grad), wt.grad.permute(2, 3, 1, 0).numpy())
    fwd, grad = (FWD_LIMIT, GRAD_LIMIT) if bf16 else (F32_LIMIT, F32_LIMIT)
    assert _rel(got[0], want[0]) < fwd, _rel(got[0], want[0])
    assert _rel(got[1], want[1]) < grad, _rel(got[1], want[1])
    assert _rel(got[2], want[2]) < grad, _rel(got[2], want[2])


# ---------------------------------------------------------------------------
# decoder stage 0 in bf16, training mode


def _stage_case(seed, block_out):
    """JAX's block-out decoder stage 0 at the full widths (64 -> 32 channels,
    skip 32, half-res 8x8) and the port's stage in ``block_out``'s layout,
    same weights: ((out, d/dx, d/dskip, {kernel: grad}) port, the same JAX)."""
    rng = np.random.default_rng(seed)
    N, P, Cd, Cs, Co = 4, 8, 64, 32, 32
    x = rng.normal(size=(N, P, P, Cd)).astype(np.float32)
    skip = rng.normal(size=(N, 2 * P, 2 * P, Cs)).astype(np.float32)
    r = rng.normal(size=(N, 2 * P, 2 * P, Co)).astype(np.float32)
    jm = JaxDecoderStage(Co, dtype="bfloat16")
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(skip), True, mode="block_out")

    def f(p, xx, ss):
        out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, xx, ss, True, mode="block_out",
                          mutable=["batch_stats"])
        return jnp.sum(out * r), out

    (_, j_out), (j_gp, j_gx, j_gs) = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        v["params"], jnp.asarray(x), jnp.asarray(skip))
    want = (np.asarray(j_out), np.asarray(j_gx), np.asarray(j_gs),
            {f"ConvBNRelu_{i}": np.asarray(j_gp[f"ConvBNRelu_{i}"]["kernel"]) for i in range(2)})

    m = _DecoderStage(Cd, Cs, Co, bf16=True).train()
    with torch.no_grad():
        for i in range(2):
            p = v["params"][f"ConvBNRelu_{i}"]
            layer = getattr(m, f"ConvBNRelu_{i}")
            layer.weight.copy_(_oihw(p["kernel"]))
            layer.BatchNorm_0.weight.copy_(torch.from_numpy(np.asarray(p["BatchNorm_0"]["scale"])))
            layer.BatchNorm_0.bias.copy_(torch.from_numpy(np.asarray(p["BatchNorm_0"]["bias"])))
    xt = _nchw(x).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    st = _nchw(skip).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    out = m(xt, st, block_out=block_out)
    (out * _nchw(r)).sum().backward()
    got = (_nhwc(out), _nhwc(xt.grad), _nhwc(st.grad),
           {f"ConvBNRelu_{i}": getattr(m, f"ConvBNRelu_{i}").weight.grad.permute(2, 3, 1, 0).numpy()
            for i in range(2)})
    return got, want


def _off_share(got, want):
    """The share of outputs off by more than 1e-4 of the largest."""
    return float(np.mean(np.abs(got - want) > 1e-4 * np.abs(want).max()))


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_decoder_stage0_matches_jax(seed):
    got, want = _stage_case(seed, block_out=True)
    dist = {"x": _rel(got[1], want[1]), "skip": _rel(got[2], want[2])}
    dist.update({k: _rel(got[3][k], want[3][k]) for k in want[3]})
    fwd, off = _rel(got[0], want[0]), _off_share(got[0], want[0])
    print(f"bf16 decoder stage 0, block-out: forward {fwd:.2e} ({off:.4f} off), gradients",
          {k: f"{v:.2e}" for k, v in dist.items()})
    assert fwd < STAGE_FWD_LIMIT and off < STAGE_OFF_SHARE
    assert max(dist.values()) < STAGE_GRAD_LIMIT, dist


def test_natural_layout_breaks_the_stage_bound():
    """The parent's layout (the natural conv of the upsampled concat, each
    tap rounded on its own) against JAX's block-out stage."""
    got, want = _stage_case(0, block_out=False)
    fwd, off = _rel(got[0], want[0]), _off_share(got[0], want[0])
    print(f"bf16 decoder stage 0, natural layout against JAX's block-out: forward {fwd:.2e} ({off:.4f} off)")
    assert fwd > 10 * STAGE_FWD_LIMIT and off > 30 * STAGE_OFF_SHARE


# ---------------------------------------------------------------------------
# the STPN and the KD step, bf16


JCFG = jax_tiny_config(32, head_raw_dtype="float32", block_out=True, block_out_dec1=True)
TCFG = tiny_config(32, head_raw_dtype="float32", block_out=True, block_out_dec1=True)


@pytest.mark.parametrize("block_out_dec1", [False, True])
def test_stpn_forward_with_block_out_matches_jax(block_out_dec1):
    """The STPN's head input and KD taps in training mode, float32, with the
    block-out stages the config names (``STPN.decode``'s dispatch: stage 0,
    and stage 1 under ``block_out_dec1``, each one up-conv and two block-out
    convs). In float32 the rewrite is exact, so the taps hold the repo's
    fp32 forward bound. (In bf16 the whole STPN does not resolve a layout:
    flipped bf16 roundings compound along its 22 convs, and the taps read
    1.2e-2 to 2.6e-2 from JAX's, the first of them before any block-out
    stage.)"""
    jcfg = jax_tiny_config(32, compute_dtype="float32", block_out=True, block_out_dec1=block_out_dec1)
    cfg = tiny_config(32, compute_dtype="float32", block_out=True, block_out_dec1=block_out_dec1)
    x = (np.random.default_rng(3).random((4,) + cfg.bev_shape) < 0.05).astype(np.float32)
    jm = jax_make_stpn(jcfg)
    v = jax.jit(jm.init, static_argnames="train")(jax.random.PRNGKey(3), jnp.asarray(x), train=False)
    (j_head, j_taps), _ = jax.jit(lambda vv, xx: jm.apply(vv, xx, True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    m = make_stpn(cfg).train()
    sd = {k[len("stpn."):]: t for k, t in state_dict_from_flax({"stpn": v["params"]},
                                                               {"stpn": v["batch_stats"]}).items()}
    load_state_dict_strict(m, sd)
    with torch.no_grad(), mock.patch.object(backbone, "conv_block_out", wraps=backbone.conv_block_out) as bo, \
            mock.patch.object(backbone, "conv_up_block_out", wraps=backbone.conv_up_block_out) as up:
        head, taps = m.decode(m.encode(_nchw(x).contiguous(memory_format=torch.channels_last)))
    stages = 2 if block_out_dec1 else 1
    assert (up.call_count, bo.call_count) == (stages, 2 * stages)
    dist = [_rel(_nhwc(t), np.asarray(j)) for t, j in zip(taps, j_taps)]
    print(f"STPN forward (block_out_dec1={block_out_dec1}), relative L2 of the taps from JAX's:",
          [f"{d:.2e}" for d in dist])
    assert _rel(_nhwc(head), np.asarray(j_head)) == dist[-1]
    assert max(dist) < STPN_FWD_LIMIT, dist


# float32 (CPU readings, seed 3): the taps 6.7e-6 to 1.35e-5 from JAX's (the
# BatchNorm's variance formula and summation orders along the chain)
STPN_FWD_LIMIT = 1e-4


JSTUDENT = jax_build_model("disco", JCFG, kd_flag=True)
JTEACHER = JaxTeacherNet(config=JCFG)
_JINIT = {m: jax.jit(m.init, static_argnames="train") for m in (JSTUDENT, JTEACHER)}


@jax.jit
def _jax_kd(params, stats, tv, jb):
    t_out = JTEACHER.apply(tv, jb["bev_teacher"], None, jb["agent_mask"], train=False)

    def loss_fn(p):
        out, _ = JSTUDENT.apply({"params": p, "batch_stats": stats}, jb["bev"], jb["trans"],
                                jb["agent_mask"], train=True, mutable=["batch_stats"])
        return jdet._losses(out, jb, JCFG, t_out)

    return jax.value_and_grad(loss_fn, has_aux=True)(params)


def _variables(model, jb, seed):
    v = _JINIT[model](jax.random.PRNGKey(seed), jb["bev"], jb["trans"], jb["agent_mask"], train=False)
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def test_bf16_kd_step_with_block_out_tracks_jax():
    """DiscoNet's bf16 KD step with both decoder stages in the block-out
    layout, from JAX's weights: the metrics and each group's gradients
    against JAX's. Both packages round every conv's
    cotangent to bf16, so the gradients are held to the KD bounds of
    ``test_torch_port_precision.py``. CPU reading: groups 0.134 to 0.231,
    heads 0.0187."""
    batch = _host_batch()
    jb = _jax_batch(batch)
    sv, tv = _variables(JSTUDENT, jb, 0), _variables(JTEACHER, jb, 1)
    (_, j_metrics), j_grads = _jax_kd(sv["params"], sv["batch_stats"], tv, jb)
    want = _flat(j_grads)
    model = load_state_dict_strict(build_model("disco", TCFG, device="cpu", kd_flag=True),
                                   state_dict_from_flax(sv["params"], sv["batch_stats"]))
    teacher = load_state_dict_strict(build_model("teacher", TCFG, device="cpu"),
                                     state_dict_from_flax(tv["params"], tv["batch_stats"]))
    assert model.stpn.block_out and model.stpn.block_out_dec1 and teacher.stpn.block_out
    metrics = make_train_step(model, TCFG, create_train_state(model), teacher=teacher, kd_flag=True)(
        batch_to_device(batch, "cpu"))
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    groups = {}
    for g, prefixes in GROUPS.items():
        keys = [k for k in got if k.startswith(prefixes)]
        groups[g] = float(np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in keys))
                          / np.sqrt(sum(np.sum(want[k] ** 2) for k in keys)))
    print("bf16 KD step, block-out, gradient distance from JAX's by group:", {k: f"{v:.3e}" for k, v in groups.items()})
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=5e-3, err_msg=k)
    assert max(groups.values()) < KD_GROUP_LIMIT, groups
    assert groups["heads"] < KD_HEADS_LIMIT, groups


# ---------------------------------------------------------------------------
# under a spatial mesh


SPATIAL_CFG = dict(compute_dtype="float32", head_raw_dtype="float32", max_agents=4, block_out_dec1=True)


@functools.lru_cache(maxsize=None)
def _spatial_host():
    cfg = tiny_config(64, **SPATIAL_CFG)
    host = example_train_batch(cfg, 1, 4, seed=5, occupancy=(0.05, 0.1), boxes_per_frame=4)
    host["agent_mask"][0, 3] = False
    return host


def _up_conv_without_halo(x_lo, w, conv):
    """A planted fault: the block-out up-conv pads a strip with zero rows
    where it reads its neighbours' rows."""
    return blockspace.conv_up_block_out(x_lo, w, lambda t, k, stride, padding: F.conv2d(t, k, stride=stride, padding=1))


def _spatial_step(mesh=None, fault=False):
    """A float64 DiscoNet train step from seed 0's weights on the 64-grid,
    both decoder stages in the block-out layout (this rank's rows under
    ``mesh``)."""
    cfg = tiny_config(64, **SPATIAL_CFG)
    model = build_model("disco", cfg, device="cpu", seed=0).to(torch.float64)
    with _float64():
        step = make_train_step(model, cfg, create_train_state(model), mesh=mesh)
        batch = batch_to_device(_spatial_host(), "cpu") if mesh is None else shard_batch(_spatial_host(), mesh)
        with mock.patch.object(backbone, "conv_up_block_out", _up_conv_without_halo) if fault else contextlib.nullcontext():
            return _step_result(model, step(batch))


def _spatial_task():
    mesh = make_mesh(n_data=1, n_spatial=2, device="cpu")
    return {"step": _spatial_step(mesh), "fault": _spatial_step(mesh, fault=True)}


@pytest.fixture(scope="module")
def spatial_ranks():
    return spawn(_spatial_task, 2), _spatial_step()


def test_block_out_under_spatial2_equals_one_process(spatial_ranks):
    ranks, want = spatial_ranks
    for res in ranks:
        got = res["step"]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=P13_F64_REL, err_msg=k)
        dist = _group_distances(got["grads"], want["grads"])
        assert max(dist.values()) < P13_F64_REL, dist


def test_skipped_halo_breaks_the_spatial_bound(spatial_ranks):
    ranks, want = spatial_ranks
    dist = _group_distances(ranks[0]["fault"]["grads"], want["grads"])
    assert max(dist.values()) > 1e-3, dist
