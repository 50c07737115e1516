"""The port's training path against the JAX package's.

Tiny float32 configs (32-grid, batch 2 x 2 agents, one agent absent where
masks matter). JAX variables are carried into the port with
``state_dict_from_flax``; inputs are seeded numpy. Each case holds the port
against the JAX function: the BEV unpack exactly; the losses' values and
gradients at atol 1e-6 / rtol 1e-5; training-mode BatchNorm (plain and
masked) and its biased running-variance update at 1e-5; the train-mode
forwards with KD taps at 1e-4; one KD train step (metrics rtol 1e-4, batch
statistics 1e-4, the heads' gradients atol 1e-5 + rtol 1e-4, each group of
layers and each tensor by relative L2 distance within limits that planted
BatchNorm faults break, and the Adam update), also with the absent agent's
grids all zero; the target assignment's positive sets exactly; and a port
``save_pth`` export read by the JAX ``load_pth``. The bf16 mode's KD taps
are checked to be fp32 stores.

``python tests/test_torch_port_training.py [n_seeds]`` (with the repo on
``PYTHONPATH``) prints the gradient distances over seeds, for the port and
for each planted fault, that set the limits.
"""

import functools
import sys
import types
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from disconet_tpu.config import tiny_config as jax_tiny_config
from disconet_tpu.data.targets import assign_targets as jax_assign_targets
from disconet_tpu.models import TeacherNet as JaxTeacherNet
from disconet_tpu.models import build_model as jax_build_model
from disconet_tpu.models.backbone import ConvBNRelu as JaxConvBNRelu
from disconet_tpu.ops import bitpack as jbitpack
from disconet_tpu.ops import losses as jlosses
from disconet_tpu.training import checkpoint as jcheckpoint
from disconet_tpu.training import det_module as jdet
from disconet_tpu_torch import build_model, tiny_config
from disconet_tpu_torch.checkpoint import load_state_dict_strict, save_pth, state_dict_from_flax
from disconet_tpu_torch.data.targets import assign_targets, sparse_targets
from disconet_tpu_torch.models import backbone
from disconet_tpu_torch.models.backbone import ConvBNRelu
from disconet_tpu_torch.ops import bitpack, losses
from disconet_tpu_torch.training import (
    batch_to_device,
    create_train_state,
    get_bev,
    make_eval_step,
    make_predict_step,
    make_train_step,
)

B, A = 2, 2
OVERRIDES = dict(compute_dtype="float32", head_raw_dtype="float32")
JCFG = jax_tiny_config(32, **OVERRIDES)
TCFG = tiny_config(32, **OVERRIDES)
GT = np.array([[1.0, 1.5, 2.0, 4.0, 0.4], [-2.0, -2.5, 1.8, 4.2, -0.8]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Few torch threads: XLA's CPU pool keeps its own busy in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol, rtol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


# ---------------------------------------------------------------------------
# bit-packed transport


@pytest.mark.parametrize("z", [13, 8, 3, 16])
def test_unpack_bev_matches_jax(z):
    grid = (np.random.default_rng(z).random((2, 3, 7, z)) < 0.3).astype(np.uint8)
    packed = bitpack.pack_bev_np(grid)
    np.testing.assert_array_equal(packed, jbitpack.pack_bev_np(grid))
    got = bitpack.unpack_bev(_t(packed), z)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbitpack.unpack_bev(jnp.asarray(packed), z)))


def test_batch_to_device_packs_and_drops_dense_targets():
    batch = _host_batch(sparse=True)
    batch["label_one_hot"] = np.zeros((B, A, 32, 32, 6, 2), np.float32)
    dev = batch_to_device(batch, "cpu")
    assert "bev_packed" in dev and "bev" not in dev and "label_one_hot" not in dev
    assert dev["bev_packed"].shape[-1] == 2 and dev["agent_mask"].dtype == torch.bool
    floats = batch_to_device({**batch, "bev": batch["bev"].astype(np.float32)}, "cpu")
    assert "bev" in floats and "bev_packed" not in floats


# ---------------------------------------------------------------------------
# losses: values and gradients


def _value_and_grads(jax_fn, torch_fn, args, wrt):
    """(jax value, jax grads, torch value, torch grads) of ``fn(*args)`` with
    respect to the argument indices ``wrt``."""
    jargs = [jnp.asarray(a) if a is not None else None for a in args]
    jv, jg = jax.value_and_grad(lambda *w: jax_fn(*[w[wrt.index(i)] if i in wrt else a
                                                     for i, a in enumerate(jargs)]),
                                argnums=tuple(range(len(wrt))))(*[jargs[i] for i in wrt])
    targs = [_t(a) if a is not None else None for a in args]
    for i in wrt:
        targs[i].requires_grad_(True)
    tv = torch_fn(*targs)
    tg = torch.autograd.grad(tv, [targs[i] for i in wrt], allow_unused=True, materialize_grads=True)
    return jv, jg, tv.detach(), tg


def _packed_inputs(num_classes, all_sentinel, seed=0):
    rng = np.random.default_rng(seed)
    H = W = 8
    NA, code, P = 6, 6, 16
    n_flat = H * W * NA
    raw = rng.normal(0, 2, (B, A, H, W, NA * num_classes + NA * code)).astype(np.float32)
    idx = np.full((B, A, P), n_flat, np.int32)
    if not all_sentinel:
        for b in range(B):
            for a in range(A):
                n = rng.integers(1, P)
                idx[b, a, :n] = np.sort(rng.choice(n_flat, n, replace=False))
    target = rng.normal(0, 0.5, (B, A, P, code)).astype(np.float32)
    mask = np.array([[True, True], [True, False]])
    pos_cls = rng.integers(1, num_classes, (B, A, P)).astype(np.int32) if num_classes > 2 else None
    return raw, idx, target, mask, pos_cls


@pytest.mark.parametrize("case", ["binary", "multiclass", "all_sentinel"])
def test_packed_det_losses_match_jax(case):
    nc = 3 if case == "multiclass" else 2
    raw, idx, target, mask, pos_cls = _packed_inputs(nc, case == "all_sentinel")
    kw = dict(num_anchors=6, num_classes=nc, box_code_size=6, gamma=2.0, sigma=3.0)
    for part in (0, 1):  # cls, reg
        jv, jg, tv, tg = _value_and_grads(
            lambda r, t, *_: jlosses.packed_det_losses(
                r, jnp.asarray(idx), t, jnp.asarray(mask), pos_cls=None if pos_cls is None else jnp.asarray(pos_cls), **kw
            )[part],
            lambda r, t, *_: losses.packed_det_losses(
                r, _t(idx), t, _t(mask), pos_cls=None if pos_cls is None else _t(pos_cls), **kw
            )[part],
            [raw, target], [0, 1],
        )
        _close(tv, jv, 1e-6, 1e-5, f"{case} value {part}")
        for g_t, g_j in zip(tg, jg):
            _close(g_t, g_j, 1e-6, 1e-5, f"{case} grad {part}")
    if case == "all_sentinel":
        assert float(tv) == 0.0  # the reg loss of no positives


@pytest.mark.parametrize("masked", [False, True])
def test_focal_and_smooth_l1_match_jax(masked):
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (B, A, 8, 8, 6, 2)).astype(np.float32)
    one_hot = np.eye(2, dtype=np.float32)[rng.integers(0, 2, logits.shape[:-1])]
    mask = (rng.random(logits.shape[:-1]) < 0.7).astype(np.float32) if masked else None
    jv, jg, tv, tg = _value_and_grads(
        lambda x, y, m: jlosses.softmax_focal_loss(x, y, 2.0, m),
        lambda x, y, m: losses.softmax_focal_loss(x, y, 2.0, m),
        [logits, one_hot, mask], [0],
    )
    _close(tv, jv, 1e-6, 1e-5)
    _close(tg[0], jg[0], 1e-6, 1e-5)

    pred = rng.normal(0, 0.3, (B, A, 20, 6)).astype(np.float32)
    target = rng.normal(0, 0.3, (B, A, 20, 6)).astype(np.float32)
    rmask = (rng.random((B, A, 20, 1)) < (0.5 if masked else 2.0)).astype(np.float32)
    jv, jg, tv, tg = _value_and_grads(
        lambda p, t, m: jlosses.weighted_smooth_l1(p, t, m, 3.0),
        lambda p, t, m: losses.weighted_smooth_l1(p, t, m, 3.0),
        [pred, target, rmask], [0, 1],
    )
    _close(tv, jv, 1e-6, 1e-5)
    for g_t, g_j in zip(tg, jg):
        _close(g_t, g_j, 1e-6, 1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_kd_feature_loss_matches_jax(masked):
    rng = np.random.default_rng(2)
    s = rng.normal(0, 1, (B, A, 4, 4, 16)).astype(np.float32)
    t = rng.normal(0, 1, (B, A, 4, 4, 16)).astype(np.float32)
    mask = np.array([[True, True], [True, False]]) if masked else None
    jv, jg, tv, tg = _value_and_grads(
        jlosses.kd_feature_loss, losses.kd_feature_loss, [s, t, mask], [0],
    )
    _close(tv, jv, 1e-6, 1e-5)
    _close(tg[0], jg[0], 1e-6, 1e-5)
    if masked:
        assert np.all(tg[0].numpy()[1, 1] == 0)


# ---------------------------------------------------------------------------
# BatchNorm in training mode


def _jax_bn_layer(x, features, kernel, stride, masked, mask=None, pair=None):
    """JAX ConvBNRelu with seeded random BN parameters and running stats,
    applied in training mode -> (variables, output, new batch stats)."""
    mod = JaxConvBNRelu(features, kernel=kernel, stride=stride, dtype="float32", masked_bn=masked)
    inp = pair if pair is not None else jnp.asarray(x)
    mode = "pair1x1" if pair is not None else "natural"
    v = mod.init(jax.random.PRNGKey(0), inp, False, mode=mode, sample_mask=mask)
    rng = np.random.default_rng(3)
    bn = v["params"]["BatchNorm_0"]
    v = {
        "params": {**v["params"], "BatchNorm_0": {
            "scale": jnp.asarray(rng.uniform(0.5, 1.5, bn["scale"].shape).astype(np.float32)),
            "bias": jnp.asarray(rng.normal(0, 0.2, bn["bias"].shape).astype(np.float32))}},
        "batch_stats": {"BatchNorm_0": {
            "mean": jnp.asarray(rng.normal(0, 0.3, (features,)).astype(np.float32)),
            "var": jnp.asarray(rng.uniform(0.5, 2.0, (features,)).astype(np.float32))}},
    }
    y, mut = mod.apply(v, inp, True, mode=mode, sample_mask=mask, mutable=["batch_stats"])
    return v, np.asarray(y), mut["batch_stats"]["BatchNorm_0"]


def _port_layer(v, cin, features, kernel, stride):
    holder = torch.nn.Module()  # the key rules map paths below a module's name
    holder.m = ConvBNRelu(cin, features, kernel=kernel, stride=stride, bf16=False)
    load_state_dict_strict(holder, state_dict_from_flax({"m": v["params"]}, {"m": v["batch_stats"]}))
    return holder.m.train()


@pytest.mark.parametrize("shape,stride", [((4, 16, 16, 5), 1), ((4, 4, 4, 5), 2)])
def test_conv_bn_relu_training_matches_jax(shape, stride):
    """The (4, 4, 4) case at stride 2 has 16 elements per channel, where an
    unbiased running-variance update is 1/15 off."""
    x = (np.random.default_rng(4).normal(0.5, 1.0, shape)).astype(np.float32)
    v, want, stats = _jax_bn_layer(x, 8, 3, stride, masked=False)
    layer = _port_layer(v, shape[-1], 8, 3, stride)
    got = layer(_t(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    assert got.dtype == torch.float32
    _close(got.detach().permute(0, 2, 3, 1), want, 1e-5, 1e-5)
    bn = layer.BatchNorm_0
    _close(bn.running_mean, stats["mean"], 1e-5, 1e-5)
    _close(bn.running_var, stats["var"], 1e-5, 1e-5)
    if stride == 2:  # what torch's own update would have given
        n = 16
        ra0 = np.asarray(v["batch_stats"]["BatchNorm_0"]["var"])
        batch_var = (np.asarray(stats["var"]) - 0.9 * ra0) / 0.1
        unbiased = 0.9 * ra0 + 0.1 * batch_var * n / (n - 1)
        assert not np.allclose(unbiased, np.asarray(stats["var"]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["natural", "pair1x1"])
def test_masked_batch_norm_training_matches_jax(mode):
    """The fusion scorer's masked BatchNorm: statistics over real pairs only."""
    rng = np.random.default_rng(5)
    mask = np.array([True, False, True, True, False, True])
    if mode == "natural":
        x = rng.normal(0.3, 1.0, (6, 4, 4, 12)).astype(np.float32)
        v, want, stats = _jax_bn_layer(x, 8, 1, 1, masked=True, mask=jnp.asarray(mask))
        layer = _port_layer(v, 12, 8, 1, 1)
        got = layer.forward_last(_t(x), _t(mask))
    else:
        ego = rng.normal(0.3, 1.0, (2, 4, 4, 6)).astype(np.float32)
        per = rng.normal(0.3, 1.0, (6, 4, 4, 6)).astype(np.float32)
        v, want, stats = _jax_bn_layer(None, 8, 1, 1, masked=True, mask=jnp.asarray(mask),
                                       pair=(jnp.asarray(ego), jnp.asarray(per), 3))
        layer = _port_layer(v, 12, 8, 1, 1)
        got = layer.forward_pair1x1(_t(ego), _t(per), _t(mask))
    _close(got.detach()[mask], want[mask], 1e-5, 1e-5)
    bn = layer.BatchNorm_0
    _close(bn.running_mean, stats["mean"], 1e-5, 1e-5)
    _close(bn.running_var, stats["var"], 1e-5, 1e-5)


# ---------------------------------------------------------------------------
# models and the train step


def _host_batch(sparse=True, seed=0, pad="random"):
    """Student grids at 5% occupancy, teacher grids at 10%; agent (1, 1) is
    absent. ``pad`` "random" fills its grids with random occupancy, which the
    masks must keep out of the losses, the sender softmax and the scorer's
    BatchNorm statistics; "zero" leaves them empty, as the dataset pads."""
    rng = np.random.default_rng(seed)
    H, W, Z = TCFG.bev_shape
    mask = np.array([[True, True], [True, False]])
    bev = (rng.random((B, A, H, W, Z)) < 0.05).astype(np.uint8)
    bev_teacher = (rng.random((B, A, H, W, Z)) < 0.1).astype(np.uint8)
    if pad == "zero":
        bev[~mask] = 0
        bev_teacher[~mask] = 0
    trans = np.tile(np.eye(4, dtype=np.float32), (B, A, A, 1, 1))
    for b in range(B):
        for i in range(A):
            for j in range(A):
                if i != j:
                    th = rng.uniform(-0.5, 0.5)
                    trans[b, i, j, :2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
                    trans[b, i, j, :2, 3] = rng.uniform(-2.0, 2.0, 2)
    tgt = assign_targets(GT, TCFG)
    batch = {"bev": bev, "bev_teacher": bev_teacher, "trans": trans, "agent_mask": mask}
    if sparse:
        idx, pos = sparse_targets(tgt["reg_loss_mask"], tgt["reg_target"], 256)
        batch["reg_pos_idx"] = np.broadcast_to(idx, (B, A) + idx.shape).copy()
        batch["reg_pos_target"] = np.broadcast_to(pos, (B, A) + pos.shape).copy()
    else:
        NA = TCFG.num_anchors
        batch["label_one_hot"] = np.broadcast_to(tgt["label_one_hot"], (B, A, H, W, NA, 2)).copy()
        batch["reg_target"] = np.broadcast_to(tgt["reg_target"], (B, A, H, W, NA, 6)).copy()
        batch["reg_mask"] = np.broadcast_to(tgt["reg_loss_mask"].astype(np.float32), (B, A, H, W, NA)).copy()
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v.astype(np.float32) if v.dtype == np.uint8 else v) for k, v in batch.items()}


JSTUDENT = jax_build_model("disco", JCFG, kd_flag=True)
JTEACHER = JaxTeacherNet(config=JCFG)
_JINIT = {m: jax.jit(m.init, static_argnames="train") for m in (JSTUDENT, JTEACHER)}


def _jax_variables(model, batch, seed, random_stats):
    jb = _jax_batch(batch)
    v = _JINIT[model](jax.random.PRNGKey(seed), jb["bev"], jb["trans"], jb["agent_mask"], train=False)
    stats = v["batch_stats"]
    if random_stats:  # so that eval-mode BN is not the identity
        rng = np.random.default_rng(seed + 40)
        stats = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.asarray(
                (rng.normal(0, 0.3, x.shape) if jax.tree_util.keystr(p).endswith("['mean']")
                 else rng.uniform(0.5, 2.0, x.shape)).astype(np.float32)), stats)
    return {"params": v["params"], "batch_stats": stats}


def _port(com, variables, **kw):
    model = build_model(com, TCFG, device="cpu", **kw)
    return load_state_dict_strict(model, state_dict_from_flax(variables["params"], variables["batch_stats"]))


@jax.jit
def _jax_kd_grads(params, stats, tv, jb):
    """value_and_grad of the JAX KD step's own loss (make_train_step's)."""
    t_out = JTEACHER.apply(tv, jb["bev_teacher"], None, jb["agent_mask"], train=False)

    def loss_fn(p):
        out, mut = JSTUDENT.apply({"params": p, "batch_stats": stats}, jb["bev"], jb["trans"],
                                  jb["agent_mask"], train=True, mutable=["batch_stats"])
        loss, metrics = jdet._losses(out, jb, JCFG, t_out)
        return loss, (metrics, mut["batch_stats"], out, t_out)

    return jax.value_and_grad(loss_fn, has_aux=True)(params)


def _jax_step(batch, seed):
    """One JAX KD train step of DiscoNet from weights seeded by ``seed``: the
    gradients of :func:`_jax_kd_grads`, then the same optax update and global
    norm as the JAX make_train_step."""
    sv = _jax_variables(JSTUDENT, batch, seed, random_stats=False)
    tv = _jax_variables(JTEACHER, batch, seed + 1, random_stats=True)
    (_, (metrics, new_stats, out, t_out)), grads = _jax_kd_grads(
        sv["params"], sv["batch_stats"], tv, _jax_batch(batch))
    tx = optax.adam(1e-3)
    upd, _ = tx.update(grads, tx.init(sv["params"]), sv["params"])
    metrics = {k: float(v) for k, v in metrics.items()}
    metrics["grad_norm"] = float(optax.global_norm(grads))
    return types.SimpleNamespace(
        batch=batch, sv=sv, tv=tv, out=out, t_out=t_out, metrics=metrics, grads=grads,
        new_stats=new_stats, new_params=optax.apply_updates(sv["params"], upd),
    )


def _port_step(ref):
    """The port's make_train_step from the weights and batch of ``ref`` (a
    :func:`_jax_step`) -> (model, teacher, optimizer, device batch, metrics)."""
    model = _port("disco", ref.sv, kd_flag=True)
    teacher = _port("teacher", ref.tv)
    dev = batch_to_device(ref.batch, "cpu")
    optimizer = create_train_state(model)
    metrics = make_train_step(model, TCFG, optimizer, teacher=teacher, kd_flag=True)(dev)
    return model, teacher, optimizer, dev, metrics


def _unbiased_batch_norm_train(y, bn, mesh=None):
    """A planted fault: batch_norm_train normalizing with the unbiased variance."""
    n = y.numel() // y.shape[1]
    var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=1)
    backbone._update_running(bn, mean.detach(), var.detach() * ((n - 1) / n))
    x_hat = (y - mean[:, None, None]) * torch.rsqrt(var[:, None, None] + bn.eps)
    return x_hat * bn.weight[:, None, None] + bn.bias[:, None, None]


_FAULTS = {
    "unbiased_variance": ("batch_norm_train", _unbiased_batch_norm_train),
    "unmasked_scorer": ("masked_batch_norm_train",
                        lambda x, mask, bn, mesh=None, f=backbone.masked_batch_norm_train: f(x, torch.ones_like(mask), bn, mesh)),
}


def _planted(fault):
    """A context in which the port's training BatchNorm carries ``fault``."""
    name, fn = _FAULTS[fault]
    return mock.patch.object(backbone, name, fn)


# Relative L2 distances of the port's KD-step gradients from JAX's (see
# _grad_distances), set between the largest distance measured over seeds and
# the smallest of a planted fault: ``python tests/test_torch_port_training.py``
# prints both (PERF.md section 6, PR 3).
# Random padding, seeds 0-3: groups 1.8e-4 to 1.01e-2, tensors up to
# 1.30e-2; faults: groups 0.130 and above.
GROUP_LIMIT = 3e-2
TENSOR_LIMIT = 5e-2
# Zero padding, seeds 0-3: groups up to 2.48e-2, tensors up to 3.34e-2,
# metrics up to 3.3e-4 relative; faults: groups 0.133 and above, metrics
# 3.6e-3 and above.
ZERO_PAD_GROUP_LIMIT = 6e-2
ZERO_PAD_TENSOR_LIMIT = 8e-2
ZERO_PAD_METRIC_RTOL = 1e-3

# Parameter groups of the gradient comparison, by state_dict key prefix.
GROUPS = {
    "encoder": ("stpn.stages_",),
    "fusion": ("weight_net.",),
    "decoder": ("stpn.dec_", "stpn.head_conv."),
    "heads": ("heads.",),
}


def _grad_distances(model, ref):
    """The port's gradients against JAX's: ({group: relative L2 distance of
    the group's gradients taken together}, largest relative L2 distance of
    one tensor). A tensor's distance is taken relative to 1e-6 of the global
    norm at least: the scorer's output bias has gradient 0 (the softmax
    ignores a shift)."""
    want = _flat(ref.grads)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    scale = np.sqrt(sum(np.sum(w * w) for w in want.values()))  # the global norm
    groups = {}
    for g, prefixes in GROUPS.items():
        keys = [k for k in got if k.startswith(prefixes)]
        num = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in keys))
        groups[g] = num / np.sqrt(sum(np.sum(want[k] ** 2) for k in keys))
    assert sum(len([k for k in got if k.startswith(p)]) for p in GROUPS.values()) == len(got)
    per_tensor = max(np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-6 * scale) for k in got)
    return groups, per_tensor


@pytest.fixture(scope="module")
def kd_step():
    """One KD train step of DiscoNet in JAX and the port's make_train_step
    from the same weights and batch (random padding)."""
    ref = _jax_step(_host_batch(), seed=0)
    t_state = {k: v.clone() for k, v in _port("teacher", ref.tv).state_dict().items()}
    model, teacher, optimizer, dev, port_metrics = _port_step(ref)
    ref.__dict__.update(dev=dev, model=model, teacher=teacher, t_state=t_state,
                        port_metrics=port_metrics, optimizer=optimizer)
    return ref


def _flat(params, stats=None):
    return {k: v.numpy() for k, v in state_dict_from_flax(params, stats).items()}


def test_train_step_metrics_match_jax(kd_step):
    got = {k: float(v) for k, v in kd_step.port_metrics.items()}
    assert set(got) == {"loss", "cls_loss", "reg_loss", "kd_loss", "grad_norm"}
    for k, want in kd_step.metrics.items():
        np.testing.assert_allclose(got[k], want, rtol=1e-4, err_msg=k)
    assert got["loss"] > got["cls_loss"] + got["reg_loss"]  # the KD term is on


def test_train_step_gradients_match_jax(kd_step):
    """The heads' gradients element by element at atol 1e-5 + rtol 1e-4;
    every group's by relative L2 distance within GROUP_LIMIT and every
    tensor's within TENSOR_LIMIT. Upstream of the heads each
    batch-statistics BatchNorm's backward takes the per-channel mean and the
    part along the normalized input out of the gradient, and fp32 rounding
    moves the small residue by more than 1e-4 relative; the limits sit
    between the distances measured over seeds and those of planted faults
    (``python tests/test_torch_port_training.py``; PERF.md)."""
    want = _flat(kd_step.grads)
    for k, p in kd_step.model.named_parameters():
        if k.startswith("heads."):
            _close(p.grad.numpy(), want[k], 1e-5, 1e-4, k)
    groups, per_tensor = _grad_distances(kd_step.model, kd_step)
    assert max(groups.values()) < GROUP_LIMIT, groups
    assert per_tensor < TENSOR_LIMIT, per_tensor


def test_sharded_train_step_matches_jax(kd_step):
    """The port's KD step on a ``data`` 2 mesh (2 gloo ranks on the CPU,
    ``tests/test_torch_port_parallel.py``) from the same weights and batch
    against the JAX package's single-device step, at the bounds of
    :func:`test_train_step_gradients_match_jax`."""
    from test_torch_port_parallel import spawn

    ranks = spawn("jax_oracle", 2, student_state=_port("disco", kd_step.sv, kd_flag=True).state_dict(),
                  teacher_state=_port("teacher", kd_step.tv).state_dict(), batch=kd_step.batch)
    want = _flat(kd_step.grads)
    for res in ranks:
        for k, v in kd_step.metrics.items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=1e-4, err_msg=k)
        for k, g in res["grads"].items():
            if k.startswith("heads."):
                _close(g.numpy(), want[k], 1e-5, 1e-4, k)
        model = types.SimpleNamespace(named_parameters=lambda grads=res["grads"]: [
            (k, types.SimpleNamespace(grad=g)) for k, g in grads.items()])
        groups, per_tensor = _grad_distances(model, kd_step)
        assert max(groups.values()) < GROUP_LIMIT, groups
        assert per_tensor < TENSOR_LIMIT, per_tensor


@pytest.fixture(scope="module")
def zero_pad_step():
    """As ``kd_step`` with the absent agent's grids all zero, as the dataset pads."""
    ref = _jax_step(_host_batch(pad="zero"), seed=0)
    model, _, _, _, metrics = _port_step(ref)
    ref.__dict__.update(model=model, port_metrics=metrics)
    return ref


def test_train_step_with_zero_padding_matches_jax(zero_pad_step):
    """With zero padding the two fp32 steps part further (PERF.md): the
    metrics and the gradients at their own measured limits."""
    for k, want in zero_pad_step.metrics.items():
        np.testing.assert_allclose(float(zero_pad_step.port_metrics[k]), want, rtol=ZERO_PAD_METRIC_RTOL, err_msg=k)
    groups, per_tensor = _grad_distances(zero_pad_step.model, zero_pad_step)
    assert max(groups.values()) < ZERO_PAD_GROUP_LIMIT, groups
    assert per_tensor < ZERO_PAD_TENSOR_LIMIT, per_tensor


@pytest.mark.parametrize("fault", sorted(_FAULTS))
@pytest.mark.parametrize("pad", ["random", "zero"])
def test_planted_faults_break_the_gradient_limit(request, pad, fault):
    """Normalizing with the unbiased variance, or counting the absent
    agents' pairs in the fusion scorer's BatchNorm statistics, moves some
    group's gradients past the limit the port is held to."""
    ref = request.getfixturevalue("kd_step" if pad == "random" else "zero_pad_step")
    with _planted(fault):
        model = _port_step(ref)[0]
    groups, _ = _grad_distances(model, ref)
    assert max(groups.values()) > (GROUP_LIMIT if pad == "random" else ZERO_PAD_GROUP_LIMIT), groups


def test_train_step_batch_stats_match_jax(kd_step):
    want = _flat({}, kd_step.new_stats)
    sd = kd_step.model.state_dict()
    for k, v in want.items():
        _close(sd[k], v, 1e-4, 1e-4, k)


def test_train_step_adam_matches_optax(kd_step):
    """The port's Adam step is optax.adam's on the same gradients: the port's
    own everywhere, and the heads' new values equal JAX's."""
    old = _flat(kd_step.sv["params"])
    grads = {k: p.grad.numpy() for k, p in kd_step.model.named_parameters()}
    tx = optax.adam(1e-3)
    upd, _ = tx.update(grads, tx.init(old), old)
    expect = optax.apply_updates(old, upd)
    want = _flat(kd_step.new_params)
    for k, p in kd_step.model.named_parameters():
        live = np.abs(grads[k]) > 1e-7  # below, the first step's size is set by eps
        got = p.detach().numpy()
        _close(got[live], np.asarray(expect[k])[live], 1e-7, 1e-6, k)
        if k.startswith("heads."):
            _close(got[live], want[k][live], 1e-6, 1e-5, k)


def test_train_step_leaves_teacher_frozen(kd_step):
    for k, v in kd_step.teacher.state_dict().items():
        assert torch.equal(v, kd_step.t_state[k]), k
    assert not kd_step.teacher.training
    opt_params = {id(p) for g in kd_step.optimizer.param_groups for p in g["params"]}
    assert not opt_params & {id(p) for p in kd_step.teacher.parameters()}


@pytest.mark.parametrize("com", ["disco", "teacher"])
def test_train_forward_with_kd_taps_matches_jax(kd_step, com):
    """The train-mode forward (student) and the eval-mode teacher, with KD
    taps, from the step's weights and batch."""
    dev = kd_step.dev
    if com == "disco":
        model = _port("disco", kd_step.sv, kd_flag=True).train()
        with torch.no_grad():
            out = model(bitpack.unpack_bev(dev["bev_packed"], 13), dev["trans"], dev["agent_mask"])
        want = kd_step.out
    else:
        with torch.no_grad():
            out = kd_step.teacher(bitpack.unpack_bev(dev["bev_teacher_packed"], 13), None, dev["agent_mask"])
        want = kd_step.t_out
    for key in ("cls", "reg", "head_raw_f32"):
        _close(out[key], want[key], 1e-4, 1e-4, key)
    assert len(out["kd_feats"]) == len(want["kd_feats"]) == 5
    for i, (f, w) in enumerate(zip(out["kd_feats"], want["kd_feats"])):
        assert f.shape == w.shape and f.dtype == torch.float32
        _close(f, w, 1e-4, 1e-4, f"kd tap {i}")


@pytest.mark.parametrize("com,sparse", [("disco", True), ("", False)])
def test_loss_goes_down(com, sparse):
    """8 bf16 steps on one batch, the packed and the dense loss paths."""
    dev = batch_to_device(_host_batch(sparse=sparse), "cpu")
    model = build_model(com, tiny_config(32), device="cpu")
    step = make_train_step(model, tiny_config(32), create_train_state(model))
    losses_ = [float(step(dev)["loss"]) for _ in range(8)]
    assert np.isfinite(losses_).all() and losses_[-1] < losses_[0], losses_


def test_bf16_kd_taps_are_fp32_stores():
    """In the bf16 mode the KD taps that the steps read are fp32 stores, as
    in JAX: the eval step's KD loss is that of the default forwards, whose
    taps bf16 cannot hold, and detection's bf16 stores (``store_bf16``)
    would move it."""
    cfg = tiny_config(32)
    dev = batch_to_device(_host_batch(), "cpu")
    student = build_model("disco", cfg, device="cpu", seed=0, kd_flag=True)
    teacher = build_model("teacher", cfg, device="cpu", seed=1)
    metrics = make_eval_step(student, cfg, teacher, kd_flag=True)(dev)
    mask = dev["agent_mask"]
    kd = {}
    with torch.no_grad():
        for store in (False, True):
            s = student(get_bev(dev, "bev", cfg), dev["trans"], mask, store_bf16=store)["kd_feats"]
            t = teacher(get_bev(dev, "bev_teacher", cfg), None, mask, store_bf16=store)["kd_feats"]
            for f in s + t:
                assert f.dtype == torch.float32
                assert torch.equal(f, backbone._round_bf16(f)) == store
            kd[store] = sum(losses.kd_feature_loss(a, b, mask=mask.float()) for a, b in zip(s, t)) / len(s)
    _close(metrics["kd_loss"], kd[False], 0.0, 1e-7)
    assert float(kd[True]) != float(kd[False]), kd


def test_loss_paths_agree():
    """Packed, sparse-view and dense targets give the same losses."""
    model = build_model("disco", TCFG, device="cpu", seed=3).train()
    sparse = batch_to_device(_host_batch(sparse=True), "cpu")
    dense = batch_to_device(_host_batch(sparse=False), "cpu")
    cfg_view = tiny_config(32, packed_loss=False, **OVERRIDES)
    from disconet_tpu_torch.training.det_module import _losses

    with torch.no_grad():
        out = model(get_bev(sparse, "bev", TCFG), sparse["trans"], sparse["agent_mask"])
    got = [_losses(out, b, c)[1] for b, c in ((sparse, TCFG), (sparse, cfg_view), (dense, TCFG))]
    for m in got[1:]:
        for k in ("cls_loss", "reg_loss"):
            _close(m[k], got[0][k], 1e-6, 1e-5, k)


# ---------------------------------------------------------------------------
# targets


@pytest.mark.parametrize("case", ["two_gts", "random", "overlapping", "none"])
def test_assign_targets_matches_jax(case):
    rng = np.random.default_rng(6)
    cfg_j, cfg_t = jax_tiny_config(64), tiny_config(64)
    if case == "two_gts":
        gt = GT
    elif case == "random":
        gt = np.stack([rng.uniform(-7, 7, 8), rng.uniform(-7, 7, 8), rng.uniform(1.6, 2.2, 8),
                       rng.uniform(3.8, 5.0, 8), rng.uniform(-np.pi, np.pi, 8)], -1)
    elif case == "overlapping":  # gts that compete for the same anchors
        gt = np.array([[0.1, 0.1, 2.0, 4.0, 0.0], [0.2, 0.0, 2.0, 4.0, 0.05], [0.1, 0.1, 0.5, 0.6, 0.3]])
    else:
        gt = np.zeros((0, 5))
    want = jax_assign_targets(gt, cfg_j)
    got = assign_targets(gt, cfg_t)
    np.testing.assert_array_equal(got["reg_loss_mask"], want["reg_loss_mask"])
    np.testing.assert_array_equal(got["label_one_hot"], want["label_one_hot"])
    np.testing.assert_array_equal(got["gt_max_iou"], want["gt_max_iou"])
    np.testing.assert_array_equal(got["anchors_map"], want["anchors_map"])
    _close(got["reg_target"], want["reg_target"], 1e-6, 1e-6)
    if len(gt):
        assert got["reg_loss_mask"].sum() >= len(gt)
    idx, pos = sparse_targets(got["reg_loss_mask"], got["reg_target"], 64)
    nz = np.nonzero(want["reg_loss_mask"].reshape(-1))[0][:64]
    n_flat = want["reg_loss_mask"].size
    np.testing.assert_array_equal(idx, np.concatenate([nz, np.full(64 - len(nz), n_flat)]))
    np.testing.assert_array_equal(pos[: len(nz)], want["reg_target"].reshape(-1, 6)[nz])


# ---------------------------------------------------------------------------
# checkpoint export, eval and predict steps


def test_save_pth_loads_into_jax(kd_step, tmp_path):
    """The trained port model's export, read by the JAX ``load_pth`` into its
    own templates, gives the JAX eval forward the port's outputs and the JAX
    eval losses the port's ``make_eval_step`` metrics."""
    path = str(tmp_path / "epoch_3.pth")
    save_pth(path, kd_step.model, kd_step.optimizer, epoch=3, loss=1.5)
    ck = torch.load(path, map_location="cpu", weights_only=True)
    assert set(ck) == {"epoch", "model_state_dict", "optimizer_state_dict", "loss"}
    assert ck["optimizer_state_dict"]["state"]  # torch Adam's moments
    params, stats, epoch, loss = jcheckpoint.load_pth(path, kd_step.sv["params"], kd_step.sv["batch_stats"])
    assert epoch == 3 and loss == 1.5

    jb = _jax_batch(kd_step.batch)
    t_out = JTEACHER.apply(kd_step.tv, jb["bev_teacher"], None, jb["agent_mask"])
    out = jax.jit(functools.partial(JSTUDENT.apply, train=False))(
        {"params": params, "batch_stats": stats}, jb["bev"], jb["trans"], jb["agent_mask"])
    _, want = jdet._losses(out, jb, JCFG, t_out)
    model = kd_step.model.eval()
    with torch.no_grad():
        got = model(bitpack.unpack_bev(kd_step.dev["bev_packed"], 13), kd_step.dev["trans"],
                    kd_step.dev["agent_mask"])
    for key in ("cls", "reg", "head_raw"):
        _close(got[key], out[key], 1e-4, 1e-4, key)
    metrics = make_eval_step(model, TCFG, kd_step.teacher, kd_flag=True)(kd_step.dev)
    assert set(metrics) == {"loss", "cls_loss", "reg_loss", "kd_loss"}
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-4, err_msg=k)


def test_predict_step_masks_absent_agents(kd_step):
    boxes, scores, keep = make_predict_step(kd_step.model, TCFG)(kd_step.dev)
    K = TCFG.nms_top_k
    assert boxes.shape == (B, A, K, 5) and scores.shape == (B, A, K) and keep.shape == (B, A, K)
    assert not keep[1, 1].any() and keep[0].any()
    assert torch.isfinite(boxes).all()


def _measure(seeds=range(4)):
    """Prints, for each padding and seed, the relative L2 distance of each
    group's gradients from JAX's, the largest of one tensor and the largest
    relative difference of a metric: for the port and for each planted
    fault. The gradient limits above come from these readings."""
    import contextlib

    for pad in ("random", "zero"):
        for seed in seeds:
            ref = _jax_step(_host_batch(seed=seed, pad=pad), seed=seed)
            for fault in (None,) + tuple(sorted(_FAULTS)):
                with _planted(fault) if fault else contextlib.nullcontext():
                    model, _, _, _, metrics = _port_step(ref)
                groups, per_tensor = _grad_distances(model, ref)
                metric = max(abs(float(metrics[k]) - v) / abs(v) for k, v in ref.metrics.items())
                print(f"pad {pad} seed {seed} {fault or 'port'}: "
                      + " ".join(f"{g} {d:.3e}" for g, d in groups.items())
                      + f" | max tensor {per_tensor:.3e} | max metric {metric:.3e}", flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _measure(range(int(sys.argv[1])) if len(sys.argv) > 1 else range(4))
