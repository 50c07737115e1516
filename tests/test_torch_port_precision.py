"""The port's bf16 arithmetic against the JAX package's on the CPU.

The JAX package's bf16 conv (``x.astype(bf16)``, ``w.astype(bf16)``, then
``.astype(float32)``) compiles under XLA to a conv of bf16-rounded operands
with an fp32 result: ``xla_allow_excess_precision`` folds the convert after
it, and the transpose of that convert rounds the cotangent to bf16 as an
operand of the dgrad and wgrad, whose results stay fp32. The port computes
the same (``models/backbone.py::conv2d_bf16_operands``).

* One bf16 ConvBNRelu in training mode (stride 1 and 2): the forward, the
  input gradient and the weight gradient within fp32-level bounds of JAX's
  (``CONV_FWD_LIMIT``, ``CONV_GRAD_LIMIT``), and the parent's arithmetic,
  which rounded every conv result to bf16, breaks them by ~10x.
* The bf16 KD step of DiscoNet from JAX's weights: the per-group relative L2
  distances of its gradients from JAX's bf16 gradients are printed, and held
  to ``KD_GROUP_LIMIT`` (largest group) and ``KD_HEADS_LIMIT``, which the
  parent's result rounding breaks. Both packages round the cotangents of
  every conv to bf16, so the fp32-level differences of the two steps (the
  BatchNorm variance's formula, summation orders) move roundings and the
  distances stay far above fp32's. JAX runs its natural conv layout
  (``block_out=False``), the layout the port implements.
"""

import jax
import numpy as np
import pytest
import torch

from disconet_tpu.config import tiny_config as jax_tiny_config
from disconet_tpu.models import TeacherNet as JaxTeacherNet
from disconet_tpu.models import build_model as jax_build_model
from disconet_tpu.models.backbone import ConvBNRelu as JaxConvBNRelu
from disconet_tpu.training import det_module as jdet
from disconet_tpu_torch import build_model, tiny_config
from disconet_tpu_torch.checkpoint import load_state_dict_strict, state_dict_from_flax
from disconet_tpu_torch.models.backbone import ConvBNRelu
from disconet_tpu_torch.training import batch_to_device, create_train_state, make_train_step
from chip_smoke import _arithmetic  # "parent": the parent's bf16 arithmetic patched in
from test_torch_port_training import GROUPS, JSTUDENT, JTEACHER, _flat, _host_batch, _jax_batch, _jax_variables

# one ConvBNRelu (4 x 16 x 16 x 16 -> 32 channels), seeds 0-1, stride 1 and
# 2 (CPU readings): the port's forward within 2.5e-7 (relative L2) of JAX's,
# its gradients within 1e-6, except one seed at 3.3e-5 (a cotangent that
# rounds to the other bf16 neighbour); the parent's result rounding reads
# 1.6e-3 to 1.7e-3 (forward) and 1.8e-3 to 2.6e-3 (gradients).
CONV_FWD_LIMIT = 1e-5
CONV_GRAD_LIMIT = 2e-4
# the bf16 KD step, seeds 0-1, random and zero padding (CPU readings): the
# port's largest group 0.225-0.236, heads 0.012-0.020; the parent's result
# rounding 0.325-0.454 and 0.028-0.047
KD_GROUP_LIMIT = 0.28
KD_HEADS_LIMIT = 0.025


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _conv_case(stride, seed, arithmetic):
    """JAX's and the port's (forward, input gradient, weight gradient) of
    sum(ConvBNRelu(x) * r), bf16, training mode."""
    rng = np.random.default_rng(seed)
    N, H, C, Co = 4, 16, 16, 32
    x = rng.normal(size=(N, H, H, C)).astype(np.float32)
    r = rng.normal(size=(N, H // stride, H // stride, Co)).astype(np.float32)
    jm = JaxConvBNRelu(Co, stride=stride, dtype="bfloat16")
    v = jm.init(jax.random.PRNGKey(seed), jax.numpy.asarray(x), True)

    def f(p, xx):
        out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, xx, True, mutable=["batch_stats"])
        return jax.numpy.sum(out * r), out

    (_, j_out), (j_gp, j_gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        v["params"], jax.numpy.asarray(x))
    k = np.asarray(v["params"]["kernel"])
    m = ConvBNRelu(C, Co, 3, stride, bf16=True).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
        m.BatchNorm_0.weight.copy_(torch.from_numpy(np.asarray(v["params"]["BatchNorm_0"]["scale"])))
        m.BatchNorm_0.bias.copy_(torch.from_numpy(np.asarray(v["params"]["BatchNorm_0"]["bias"])))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    with _arithmetic(arithmetic):
        out = m(xt).permute(0, 2, 3, 1)
        (out * torch.from_numpy(r)).sum().backward()
    got = (out.detach().numpy(), xt.grad.permute(0, 2, 3, 1).numpy(), m.weight.grad.permute(2, 3, 1, 0).numpy())
    want = (np.asarray(j_out), np.asarray(j_gx), np.asarray(j_gp["kernel"]))
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_conv_bn_relu_matches_jax(stride, seed):
    (out, gx, gw), (j_out, j_gx, j_gw) = _conv_case(stride, seed, "repair")
    assert _rel(out, j_out) < CONV_FWD_LIMIT, _rel(out, j_out)
    assert np.abs(out - j_out).max() < CONV_FWD_LIMIT * np.abs(j_out).max()
    assert _rel(gx, j_gx) < CONV_GRAD_LIMIT, _rel(gx, j_gx)
    assert _rel(gw, j_gw) < CONV_GRAD_LIMIT, _rel(gw, j_gw)


@pytest.mark.parametrize("stride", [1, 2])
def test_result_rounding_breaks_the_conv_limits(stride):
    """The parent's arithmetic (every conv result rounded to bf16) is the
    divergence the limits are there to catch."""
    (out, gx, gw), (j_out, j_gx, j_gw) = _conv_case(stride, 0, "parent")
    assert _rel(out, j_out) > 10 * CONV_FWD_LIMIT
    assert min(_rel(gx, j_gx), _rel(gw, j_gw)) > 5 * CONV_GRAD_LIMIT


JCFG16 = jax_tiny_config(32, head_raw_dtype="float32", block_out=False)
TCFG16 = tiny_config(32, head_raw_dtype="float32")
JSTUDENT16 = jax_build_model("disco", JCFG16, kd_flag=True)
JTEACHER16 = JaxTeacherNet(config=JCFG16)


@jax.jit
def _jax_kd_grads16(params, stats, tv, jb):
    t_out = JTEACHER16.apply(tv, jb["bev_teacher"], None, jb["agent_mask"], train=False)

    def loss_fn(p):
        out, _ = JSTUDENT16.apply({"params": p, "batch_stats": stats}, jb["bev"], jb["trans"],
                                  jb["agent_mask"], train=True, mutable=["batch_stats"])
        return jdet._losses(out, jb, JCFG16, t_out)

    return jax.value_and_grad(loss_fn, has_aux=True)(params)


@pytest.fixture(scope="module")
def kd16():
    """JAX's bf16 KD step gradients and metrics on the training tests' batch
    and weights (seed 0, random padding)."""
    batch = _host_batch()
    sv = _jax_variables(JSTUDENT, batch, 0, random_stats=False)
    tv = _jax_variables(JTEACHER, batch, 1, random_stats=True)
    (_, metrics), grads = _jax_kd_grads16(sv["params"], sv["batch_stats"], tv, _jax_batch(batch))
    return batch, sv, tv, _flat(grads), {k: float(v) for k, v in metrics.items()}


def _port_kd16(kd16, arithmetic):
    batch, sv, tv, want, _ = kd16
    model = load_state_dict_strict(build_model("disco", TCFG16, device="cpu", kd_flag=True),
                                   state_dict_from_flax(sv["params"], sv["batch_stats"]))
    teacher = load_state_dict_strict(build_model("teacher", TCFG16, device="cpu"),
                                     state_dict_from_flax(tv["params"], tv["batch_stats"]))
    with _arithmetic(arithmetic):
        metrics = make_train_step(model, TCFG16, create_train_state(model), teacher=teacher, kd_flag=True)(
            batch_to_device(batch, "cpu"))
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    groups = {}
    for g, prefixes in GROUPS.items():
        keys = [k for k in got if k.startswith(prefixes)]
        groups[g] = float(np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in keys))
                          / np.sqrt(sum(np.sum(want[k] ** 2) for k in keys)))
    return groups, {k: float(v) for k, v in metrics.items()}


def test_bf16_kd_step_gradients_track_jax(kd16):
    groups, metrics = _port_kd16(kd16, "repair")
    print("bf16 KD step, gradient distance from JAX's by group:", {k: f"{v:.3e}" for k, v in groups.items()})
    for k, want in kd16[4].items():
        np.testing.assert_allclose(metrics[k], want, rtol=5e-3, err_msg=k)
    assert max(groups.values()) < KD_GROUP_LIMIT, groups
    assert groups["heads"] < KD_HEADS_LIMIT, groups


def test_result_rounding_breaks_the_kd_limits(kd16):
    groups, _ = _port_kd16(kd16, "parent")
    print("parent's result rounding, gradient distance from JAX's by group:",
          {k: f"{v:.3e}" for k, v in groups.items()})
    assert max(groups.values()) > KD_GROUP_LIMIT and groups["heads"] > KD_HEADS_LIMIT, groups
