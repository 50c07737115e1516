"""The port's block-space layout (``Config.block_space``, ``STPN``'s
``block_out_encoder``) against the JAX package's on the CPU.

* ``block_weights_s1``/``block_weights_s2`` equal JAX's bit for bit; the two
  block convs equal JAX's in float32, forward and gradients, and equal the
  natural convs they rewrite (float64).
* In bf16 every block-kernel entry is one tap, so the forward is the natural
  conv's; the kernel's cotangent is where the layouts part: JAX rounds the
  kernel to bf16 before it places the taps, so XLA rounds each place's
  cotangent to bf16 and adds a tap's four places in bf16. A bf16 encoder
  stage 0 in block space holds JAX's kernel gradients at a bound that the
  port's natural stage (an fp32 kernel gradient) breaks.
* ``STPN(block_space=True)`` and ``block_out_encoder`` against JAX's, forward
  and gradients, float32, with carried weights.
* ``make_stpn``'s gate: fusion at layer 0 keeps the natural layout, the
  teacher does not; ``block_space`` turns the block-out modes off and
  refuses to run beside them.
* Under a ``spatial`` 2 mesh (a CPU gloo group), DiscoNet's float32 KD step
  in block space and with ``block_out_encoder`` equals the one-process step,
  and ``train_remat`` on and off give the same sharded step.

``python tests/test_torch_port_block_space.py [seeds]`` prints the bf16 stage
readings behind the ``STAGE_*`` bounds.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import _float64
from disconet_tpu.config import tiny_config as jax_tiny_config
from disconet_tpu.models.backbone import _EncoderStage as JaxEncoderStage
from disconet_tpu.models.backbone import make_stpn as jax_make_stpn
from disconet_tpu.ops import blockspace as jbs
from disconet_tpu_torch import build_model, tiny_config
from disconet_tpu_torch.checkpoint import load_state_dict_strict, state_dict_from_flax
from disconet_tpu_torch.models.backbone import STPN, _EncoderStage, conv2d_bf16_operands, make_stpn
from disconet_tpu_torch.ops import blockspace
from disconet_tpu_torch.parallel import make_mesh, shard_batch
from disconet_tpu_torch.training import batch_to_device, create_train_state, make_train_step
from test_torch_port_blockspace import (
    FWD_LIMIT,
    GRAD_LIMIT,
    STAGE_FWD_LIMIT,
    STAGE_GRAD_LIMIT,
    _nchw,
    _nhwc,
    _oihw,
    _rel,
)
from test_torch_port_training import GROUP_LIMIT
from test_torch_port_parallel import (
    GRAD_NORM_RTOL,
    GRAD_REL_L2,
    METRIC_RTOL,
    STATS_ATOL,
    _group_distances,
    _step_result,
    _train_batch,
    spawn,
)

# float32 readings of the two block convs against JAX's: forward and
# gradients 1.5e-7 to 3.1e-7 (summation orders)
F32_LIMIT = 1e-5
# the STPN in float32 against JAX's: the taps (readings 5.7e-6 to 1.4e-5).
# Its gradients by stage read 4.5e-3 to 6.9e-3 in either layout: each
# batch-statistics BatchNorm's backward leaves a small residue whose fp32
# rounding moves (test_torch_port_training.py's GROUP_LIMIT, set by planted
# faults, holds them); in float64 the port's layouts equal its natural one
# to 1e-10.
STPN_LIMIT = 1e-4


# ---------------------------------------------------------------------------
# the transforms and the two convs


@pytest.mark.parametrize("name", ["block_weights_s1", "block_weights_s2"])
@pytest.mark.parametrize("cin,cout", [(5, 7), (13, 32)])
def test_block_weights_equal_jax(name, cin, cout):
    w = np.random.default_rng(cin).normal(size=(3, 3, cin, cout)).astype(np.float32)
    want = np.asarray(getattr(jbs, name)(jnp.asarray(w)))
    got = getattr(blockspace, name)(_oihw(w)).permute(2, 3, 1, 0).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


def _jax_block_conv(name, x, w, r, bf16):
    """JAX's (out, d/dx, d/dw) of sum(conv(x, w) * r), with the module's bf16
    casts of both operands (``ConvBNRelu``'s "block" modes) when ``bf16``."""
    fn = getattr(jbs, name)

    def f(xx, ww):
        if bf16:
            xx, ww = xx.astype(jnp.bfloat16), ww.astype(jnp.bfloat16)
        out = fn(xx, ww).astype(jnp.float32)
        return jnp.sum(out * r), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(out), np.asarray(grads[0]), np.asarray(grads[1])


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("name", ["conv_block_s1", "conv_block_s2"])
def test_block_convs_match_jax(name, bf16):
    rng = np.random.default_rng(2)
    N, P, C, Co = 2, 6, 12, 16
    x = rng.normal(size=(N, P, P, 4 * C)).astype(np.float32)
    w = (rng.normal(size=(3, 3, C, Co)) * 0.2).astype(np.float32)
    r = rng.normal(size=(N, P, P, 4 * Co if name == "conv_block_s1" else Co)).astype(np.float32)
    want = _jax_block_conv(name, x, w, r, bf16)
    xt, wt = _nchw(x).requires_grad_(True), _oihw(w).requires_grad_(True)
    conv = conv2d_bf16_operands if bf16 else functools.partial(F.conv2d)
    out = getattr(blockspace, name)(xt, wt, conv, bf16=bf16)
    (out * _nchw(r)).sum().backward()
    got = (_nhwc(out), _nhwc(xt.grad), wt.grad.permute(2, 3, 1, 0).numpy())
    fwd, grad = (FWD_LIMIT, GRAD_LIMIT) if bf16 else (F32_LIMIT, F32_LIMIT)
    dist = [_rel(g, w_) for g, w_ in zip(got, want)]
    print(f"{name} ({'bf16' if bf16 else 'float32'}) against JAX: forward, d/dx, d/dw", [f"{d:.2e}" for d in dist])
    assert dist[0] < fwd and dist[1] < grad and dist[2] < grad, dist


@pytest.mark.parametrize("name", ["conv_block_s1", "conv_block_s2"])
def test_block_convs_equal_the_natural_conv(name):
    """float64: the block conv of space_to_depth(x) against the natural
    conv of x (stride 1 in block space, stride 2 to the natural map)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 12, 10, generator=g, dtype=torch.float64)
    w = torch.randn(7, 5, 3, 3, generator=g, dtype=torch.float64, requires_grad=True)
    xs = blockspace.space_to_depth(x)
    if name == "conv_block_s1":
        got = blockspace.depth_to_space(blockspace.conv_block_s1(xs, w))
        want = F.conv2d(x, w, padding=1)
    else:
        got = blockspace.conv_block_s2(xs, w)
        want = F.conv2d(x, w, stride=2, padding=1)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    gw, = torch.autograd.grad((got * want.detach()).sum(), w)
    ww, = torch.autograd.grad((want * want.detach()).sum(), w)
    torch.testing.assert_close(gw, ww, rtol=1e-12, atol=1e-10)


# ---------------------------------------------------------------------------
# encoder stage 0 in bf16, training mode


def _stage_case(seed, mode):
    """JAX's bf16 encoder stage 0 in block space (13 -> 32 channels at the
    full widths, 16x16 -> 8x8 blocks) and the port's stage with the same
    weights in ``mode`` ("block", or "natural" on depth_to_space of the
    input): the output (block layout), d/dx and the two kernels' gradients,
    port and JAX."""
    rng = np.random.default_rng(seed)
    N, H, Cin, Co = 4, 16, 13, 32
    x = (rng.random((N, H, H, Cin)) < 0.3).astype(np.float32)
    xb = np.asarray(jbs.space_to_depth(jnp.asarray(x)))
    r = rng.normal(size=(N, H // 2, H // 2, 4 * Co)).astype(np.float32)
    jm = JaxEncoderStage(Co, stride=1, dtype="bfloat16")
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(xb), True, mode="block")

    def f(p, xx):
        out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, xx, True, mode="block",
                          mutable=["batch_stats"])
        return jnp.sum(out * r), out

    (_, j_out), (j_gp, j_gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        v["params"], jnp.asarray(xb))
    want = (np.asarray(j_out), np.asarray(j_gx),
            {i: np.asarray(j_gp[f"ConvBNRelu_{i}"]["kernel"]) for i in range(2)})

    m = _EncoderStage(Cin, Co, 1, bf16=True).train()
    with torch.no_grad():
        for i in range(2):
            p = v["params"][f"ConvBNRelu_{i}"]
            layer = getattr(m, f"ConvBNRelu_{i}")
            layer.weight.copy_(_oihw(p["kernel"]))
            layer.BatchNorm_0.weight.copy_(torch.from_numpy(np.asarray(p["BatchNorm_0"]["scale"])))
            layer.BatchNorm_0.bias.copy_(torch.from_numpy(np.asarray(p["BatchNorm_0"]["bias"])))
    xt = _nchw(xb).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    if mode == "block":
        out = m(xt, mode="block")
    else:
        out = blockspace.space_to_depth(m(blockspace.depth_to_space(xt)))
    (out * _nchw(r)).sum().backward()
    got = (_nhwc(out), _nhwc(xt.grad),
           {i: getattr(m, f"ConvBNRelu_{i}").weight.grad.permute(2, 3, 1, 0).numpy() for i in range(2)})
    return got, want


def _stage_distances(seed, mode):
    """Relative L2 of the output, d/dx and the kernels' gradients (the
    larger of the two), and the kernels' share of entries off by more than
    1e-3 of their own size."""
    got, want = _stage_case(seed, mode)
    return {"forward": _rel(got[0], want[0]), "x": _rel(got[1], want[1]),
            "kernels": max(_rel(got[2][i], want[2][i]) for i in range(2)),
            "kernels_off": max(float(np.mean(np.abs(got[2][i] - want[2][i]) > 1e-3 * np.abs(want[2][i])))
                               for i in range(2))}


# A single block conv's kernel gradient equals JAX's bit for bit in bf16
# (test_block_convs_match_jax). A stage chains two through a BatchNorm:
# fp32-level differences flip a few bf16 roundings of the second conv's
# operand, and the backward carries them, as in the block-out stage
# (test_torch_port_blockspace.py, whose STAGE_* bounds hold here). CPU
# readings, seeds 0-5 of ``_stage_case``, block space against JAX's block
# stage: forward 5.9e-6 to 8.8e-5, d/dx 2.6e-5 to 1.4e-2, kernels 1.7e-4
# to 1.6e-2 with 0.1% to 10.9% of their entries off by more than 1e-3 of
# their size (88% to 99.9% bit-equal). The natural stage against it: the
# same forward, kernels 3.3e-3 to 1.6e-2 with 80% to 82% of the entries
# off and none bit-equal: its kernel gradient is one fp32 sum, JAX's four
# bf16-rounded places added in bf16.
STAGE_KERNEL_OFF_SHARE = 0.2


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_block_stage_matches_jax(seed):
    d = _stage_distances(seed, "block")
    print(f"bf16 encoder stage 0 in block space against JAX's (seed {seed}):", {k: f"{v:.2e}" for k, v in d.items()})
    assert d["forward"] < STAGE_FWD_LIMIT, d
    assert max(d["x"], d["kernels"]) < STAGE_GRAD_LIMIT and d["kernels_off"] < STAGE_KERNEL_OFF_SHARE, d


def test_natural_stage_breaks_the_kernel_bound():
    d = _stage_distances(0, "natural")
    print("bf16 encoder stage 0, natural against JAX's block space:", {k: f"{v:.2e}" for k, v in d.items()})
    assert d["forward"] < STAGE_FWD_LIMIT  # the same forward: every block-kernel entry is one tap
    assert d["kernels_off"] > 3 * STAGE_KERNEL_OFF_SHARE, d


# ---------------------------------------------------------------------------
# the STPN, float32


def _jax_stpn(layout):
    jcfg = jax_tiny_config(32, compute_dtype="float32", block_space=layout == "block_space")
    jm = jax_make_stpn(jcfg)
    return jm.clone(block_out_encoder=True) if layout == "block_out_encoder" else jm


@pytest.mark.parametrize("layout", ["block_space", "block_out_encoder"])
def test_stpn_layout_matches_jax(layout):
    """Training-mode forward (the head input and the KD taps) and the
    gradients of every parameter by group, float32, from JAX's weights."""
    cfg = tiny_config(32, compute_dtype="float32", block_space=layout == "block_space")
    rng = np.random.default_rng(4)
    x = (rng.random((4,) + cfg.bev_shape) < 0.05).astype(np.float32)
    jm = _jax_stpn(layout)
    v = jax.jit(jm.init, static_argnames="train")(jax.random.PRNGKey(4), jnp.asarray(x), train=False)
    rs = [rng.normal(size=(4, 32 >> k, 32 >> k, c)).astype(np.float32)
          for k, c in ((3, 256), (2, 128), (1, 64), (0, 32), (0, 128))]

    def f(p):
        (_, taps), _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(x), True,
                                mutable=["batch_stats"])
        return sum(jnp.sum(t * r) for t, r in zip(taps, rs)), taps

    (_, j_taps), j_grads = jax.jit(jax.value_and_grad(f, has_aux=True))(v["params"])
    m = make_stpn(cfg).train()
    m.block_out_encoder = layout == "block_out_encoder"
    sd = {k[len("stpn."):]: t for k, t in state_dict_from_flax({"stpn": v["params"]},
                                                               {"stpn": v["batch_stats"]}).items()}
    load_state_dict_strict(m, sd)
    assert m.block_space == (layout == "block_space") and m.block_out != m.block_space
    _, taps = m.decode(m.encode(_nchw(x).contiguous(memory_format=torch.channels_last)))
    sum((t * _nchw(r)).sum() for t, r in zip(taps, rs)).backward()
    fwd = [_rel(_nhwc(t), np.asarray(j)) for t, j in zip(taps, j_taps)]
    want = {k[len("stpn."):]: t.numpy() for k, t in state_dict_from_flax({"stpn": j_grads}).items()}
    groups = {}
    for name, p in m.named_parameters():
        groups.setdefault(name.split(".")[0], []).append((p.grad.numpy(), want[name]))
    grads = {g: float(np.sqrt(sum(np.sum((a - b) ** 2) for a, b in v_)) / np.sqrt(sum(np.sum(b ** 2) for _, b in v_)))
             for g, v_ in groups.items()}
    print(f"STPN {layout} against JAX's, float32: taps", [f"{d:.2e}" for d in fwd],
          "gradients", {k: f"{v_:.2e}" for k, v_ in grads.items()})
    assert max(fwd) < STPN_LIMIT and max(grads.values()) < GROUP_LIMIT, (fwd, grads)


@pytest.mark.parametrize("layout", ["block_space", "block_out_encoder"])
def test_stpn_layout_equals_natural_in_float64(layout):
    """The rewrite is exact: in float64, the training-mode taps and every
    parameter's gradient of the layout equal the natural layout's, from the
    same weights, and so do the BatchNorm statistics."""
    cfg = tiny_config(32, compute_dtype="float32", block_out=False)
    nat = build_model("teacher", cfg, device="cpu", seed=5).stpn.double().train()
    alt = make_stpn(dataclasses.replace(cfg, block_space=layout == "block_space")).double().train()
    alt.block_out_encoder = layout == "block_out_encoder"
    alt.load_state_dict(nat.state_dict())
    x = (torch.rand((4, 13, 32, 32), generator=torch.Generator().manual_seed(5)) < 0.05).double()
    x = x.contiguous(memory_format=torch.channels_last)
    r = None
    out = {}
    for name, m in (("natural", nat), (layout, alt)):
        with _float64():
            _, taps = m.decode(m.encode(x))
        if r is None:
            r = [torch.randn(t.shape, generator=torch.Generator().manual_seed(i), dtype=torch.float64)
                 for i, t in enumerate(taps)]
        sum((t * rr).sum() for t, rr in zip(taps, r)).backward()
        out[name] = (taps, {k: p.grad for k, p in m.named_parameters()}, m.state_dict())
    (t0, g0, s0), (t1, g1, s1) = out["natural"], out[layout]
    for a, b in zip(t0, t1):
        torch.testing.assert_close(b, a, rtol=1e-10, atol=1e-10)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-10, atol=1e-10, msg=k)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-10, atol=1e-10, msg=k)


# ---------------------------------------------------------------------------
# the gate and the exclusion


def test_block_space_gate_and_exclusion():
    cfg = tiny_config(32, compute_dtype="float32", block_space=True)
    assert make_stpn(cfg).block_space and not make_stpn(cfg).block_out
    assert not make_stpn(cfg, allow_block=False).block_space and make_stpn(cfg, allow_block=False).block_out
    for layer, block in ((0, False), (1, True), (3, True)):
        assert build_model("disco", cfg, device="cpu", layer=layer).stpn.block_space is block
    assert build_model("teacher", cfg, device="cpu").stpn.block_space
    for kw in ({"block_out": True}, {"block_out_encoder": True}):
        with pytest.raises(ValueError, match="at most one"):
            STPN(13, cfg.backbone_channels, cfg.head_channels, bf16=False, block_space=True, **kw)


# ---------------------------------------------------------------------------
# under a spatial mesh, and remat under a mesh


SPATIAL_CFG = tiny_config(32, compute_dtype="float32", head_raw_dtype="float32", max_agents=4)
SPATIAL_LAYOUTS = {
    "block_space": (dataclasses.replace(SPATIAL_CFG, block_space=True), False),
    "block_out_encoder": (SPATIAL_CFG, True),
    "natural": (SPATIAL_CFG, False),
    "natural_remat": (dataclasses.replace(SPATIAL_CFG, train_remat=True), False),
}


def _kd_step(layout, mesh=None):
    """DiscoNet's float32 KD step from seed 0's weights in ``layout``
    (this rank's rows under ``mesh``)."""
    cfg, encoder = SPATIAL_LAYOUTS[layout]
    student = build_model("disco", cfg, device="cpu", seed=0, kd_flag=True)
    teacher = build_model("teacher", cfg, device="cpu", seed=1)
    student.stpn.block_out_encoder = encoder
    step = make_train_step(student, cfg, create_train_state(student), teacher=teacher, kd_flag=True, mesh=mesh)
    host = _train_batch()
    return _step_result(student, step(batch_to_device(host, "cpu") if mesh is None else shard_batch(host, mesh)))


def _spatial_task():
    mesh = make_mesh(n_data=1, n_spatial=2, device="cpu")
    return {layout: _kd_step(layout, mesh) for layout in SPATIAL_LAYOUTS}


@pytest.fixture(scope="module")
def spatial_ranks():
    return spawn(_spatial_task, 2)


@pytest.mark.parametrize("layout", ["block_space", "block_out_encoder"])
def test_layout_under_spatial2_equals_one_process(spatial_ranks, layout):
    want = _kd_step(layout)
    for res in spatial_ranks:
        got = res[layout]
        for k, v in want["metrics"].items():
            rtol = GRAD_NORM_RTOL if k == "grad_norm" else METRIC_RTOL
            np.testing.assert_allclose(got["metrics"][k], v, rtol=rtol, err_msg=k)
        dist = _group_distances(got["grads"], want["grads"])
        assert max(dist.values()) < GRAD_REL_L2, dist
        for k, v in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k].numpy(), v.numpy(), atol=STATS_ATOL, rtol=0, err_msg=k)


def test_remat_under_spatial2_gives_the_same_step(spatial_ranks):
    """``train_remat`` recomputes each stage in the backward from the same
    values, halo exchanges included, and updates the statistics once: the
    sharded step with it equals the sharded step without it."""
    for res in spatial_ranks:
        plain, remat = res["natural"], res["natural_remat"]
        for k, v in plain["metrics"].items():
            np.testing.assert_allclose(remat["metrics"][k], v, rtol=1e-6, err_msg=k)
        dist = _group_distances(remat["grads"], plain["grads"])
        assert max(dist.values()) < 1e-6, dist
        for k, v in plain["stats"].items():
            np.testing.assert_allclose(remat["stats"][k].numpy(), v.numpy(), atol=1e-7, rtol=0, err_msg=k)


if __name__ == "__main__":
    import sys

    for s in range(int(sys.argv[1]) if len(sys.argv) > 1 else 6):
        print(s, {m: {k: f"{v:.2e}" for k, v in _stage_distances(s, m).items()} for m in ("block", "natural")})
