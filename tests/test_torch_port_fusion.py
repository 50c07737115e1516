"""The port's other fusion models against the JAX package's.

``--com`` sum, mean, max, cat, agent, v2v, when2com and who2com, each built
on a float32 32-grid config (batch 2 x 3 agent slots, agent (1, 2) absent,
fusion at the grid's default layer 1) with KD taps. The weights start as the
port's seeded initialization with random BatchNorm running statistics, go to
JAX through a ``.pth`` and the JAX package's ``load_pth``, and come back into
the port through ``state_dict_from_flax``; the JAX package's own ``save_pth``
export of them loads into the port strictly. For each model, with the absent
agent's grids random and all zero (as the dataset pads):

* the eval forward (cls, reg, KD taps) within 1e-4 of JAX;
* one KD train step (the frozen teacher's taps on ``bev_teacher``): the
  losses within rtol 1e-4 (random padding) or the training tests'
  ``ZERO_PAD_METRIC_RTOL``, and the gradients per group of layers and their
  global norm within the training tests' ``GROUP_LIMIT`` /
  ``ZERO_PAD_GROUP_LIMIT`` (batch-statistics BatchNorm's backward carries
  fp32 rounding far above 1e-4 upstream of the heads; PERF.md section 6);
  the new BatchNorm running statistics within 1e-4.

Also pinned directly: ``masked_sender_reduce`` against JAX's, When2com
without ``warp_flag``, Who2com's hard select giving absent agents no weight
(and ties to the lower index), V2VNet's ``gru_rounds`` and ``build_model``'s
``ValueError``s.
"""

import types
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from disconet_tpu.config import tiny_config as jax_tiny_config
from disconet_tpu.models import TeacherNet as JaxTeacherNet
from disconet_tpu.models import build_model as jax_build_model
from disconet_tpu.models.base import masked_sender_reduce as jax_masked_sender_reduce
from disconet_tpu.training import checkpoint as jcheckpoint
from disconet_tpu.training import det_module as jdet
from disconet_tpu_torch import build_model, tiny_config
from disconet_tpu_torch.checkpoint import load_pth, load_state_dict_strict, save_pth, state_dict_from_flax
from disconet_tpu_torch.config import default_fusion_layer
from disconet_tpu_torch.data.targets import assign_targets, sparse_targets
from disconet_tpu_torch.models import backbone
from disconet_tpu_torch.models.base import masked_sender_reduce
from disconet_tpu_torch.training import batch_to_device, create_train_state, get_bev, make_train_step
from test_torch_port_training import GROUP_LIMIT, ZERO_PAD_GROUP_LIMIT, ZERO_PAD_METRIC_RTOL

B, A = 2, 3
OVERRIDES = dict(compute_dtype="float32", head_raw_dtype="float32", max_agents=A)
JCFG = jax_tiny_config(32, **OVERRIDES)
TCFG = tiny_config(32, **OVERRIDES)
LAYER = default_fusion_layer(32)
COMS = ["sum", "mean", "max", "cat", "agent", "v2v", "when2com", "who2com"]
MASK = np.array([[True, True, True], [True, True, False]])
GT = np.array([[1.0, 1.5, 2.0, 4.0, 0.4], [-2.0, -2.5, 1.8, 4.2, -0.8]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Few torch threads: XLA's CPU pool keeps its own busy in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(got, want, atol, rtol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


def _host_batch(pad):
    """Student grids at 5% occupancy, teacher grids at 10%, random poses,
    sparse targets of two boxes a frame; the absent agent's grids random or
    all zero (``pad``)."""
    rng = np.random.default_rng(11)
    H, W, Z = TCFG.bev_shape
    bev = (rng.random((B, A, H, W, Z)) < 0.05).astype(np.uint8)
    bev_teacher = (rng.random((B, A, H, W, Z)) < 0.1).astype(np.uint8)
    if pad == "zero":
        bev[~MASK] = 0
        bev_teacher[~MASK] = 0
    trans = np.tile(np.eye(4, dtype=np.float32), (B, A, A, 1, 1))
    for b in range(B):
        for i in range(A):
            for j in range(A):
                if i != j:
                    th = rng.uniform(-0.5, 0.5)
                    trans[b, i, j, :2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
                    trans[b, i, j, :2, 3] = rng.uniform(-2.0, 2.0, 2)
    tgt = assign_targets(GT, TCFG)
    idx, pos = sparse_targets(tgt["reg_loss_mask"], tgt["reg_target"], 256)
    return {"bev": bev, "bev_teacher": bev_teacher, "trans": trans, "agent_mask": MASK.copy(),
            "reg_pos_idx": np.broadcast_to(idx, (B, A) + idx.shape).copy(),
            "reg_pos_target": np.broadcast_to(pos, (B, A) + pos.shape).copy()}


def _jax_batch(batch):
    return {k: jnp.asarray(v.astype(np.float32) if v.dtype == np.uint8 else v) for k, v in batch.items()}


BATCHES = {pad: _host_batch(pad) for pad in ("random", "zero")}


def _randomize_stats(model, seed):
    """Random BatchNorm running statistics, so that eval-mode BN is not the identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("running_mean"):
                v.copy_(torch.randn(v.shape, generator=gen) * 0.3)
            elif k.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=gen) * 1.5 + 0.5)
    return model


def _to_jax(jmodel, port_model, path):
    """The port model's weights as JAX variables, through the JAX ``load_pth``
    into templates of the JAX model's shapes."""
    jb = _jax_batch(BATCHES["random"])
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jb["bev"], jb["trans"], jb["agent_mask"])
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    save_pth(path, port_model)
    params, stats, _, _ = jcheckpoint.load_pth(path, zeros["params"], zeros.get("batch_stats", {}))
    return {"params": params, "batch_stats": stats}


def _port_from_jax(com, variables, **kw):
    model = build_model(com, TCFG, layer=LAYER, device="cpu", kd_flag=True, **kw)
    return load_state_dict_strict(model, state_dict_from_flax(variables["params"], variables["batch_stats"]))


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """A frozen TeacherNet in both frameworks and its taps on both batches."""
    path = str(tmp_path_factory.mktemp("teacher") / "teacher.pth")
    jt = JaxTeacherNet(config=JCFG)
    tv = _to_jax(jt, _randomize_stats(build_model("teacher", TCFG, device="cpu", seed=1), 2), path)
    fwd = jax.jit(lambda v, bev, mask: jt.apply(v, bev, None, mask, train=False))
    taps = {pad: fwd(tv, _jax_batch(b)["bev_teacher"], jnp.asarray(MASK)) for pad, b in BATCHES.items()}
    return types.SimpleNamespace(variables=tv, taps=taps)


def _jax_model(com, **kw):
    return jax_build_model(com, JCFG, kd_flag=True, layer=LAYER, **kw)


@pytest.fixture(scope="module", params=COMS)
def fusion(request, teacher, tmp_path_factory):
    """One model of ``com``: its JAX variables, the JAX eval forward and one
    JAX KD train step's metrics, gradients and batch statistics on each
    padding, and the port models carried from the same variables."""
    com = request.param
    seed = COMS.index(com) + 10
    jm = _jax_model(com)
    path = str(tmp_path_factory.mktemp(com) / "seed.pth")
    v = _to_jax(jm, _randomize_stats(build_model(com, TCFG, layer=LAYER, device="cpu", seed=seed), seed), path)

    @jax.jit
    def run(params, stats, jb, t_out):
        out = jm.apply({"params": params, "batch_stats": stats}, jb["bev"], jb["trans"], jb["agent_mask"],
                       train=False)

        def loss_fn(p):
            o, mut = jm.apply({"params": p, "batch_stats": stats}, jb["bev"], jb["trans"], jb["agent_mask"],
                              train=True, mutable=["batch_stats"])
            loss, metrics = jdet._losses(o, jb, JCFG, t_out)
            return loss, (metrics, mut["batch_stats"])

        (_, (metrics, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return out, metrics, grads, new_stats

    ref = {}
    for pad, batch in BATCHES.items():
        out, metrics, grads, new_stats = run(v["params"], v["batch_stats"], _jax_batch(batch), teacher.taps[pad])
        metrics = {k: float(x) for k, x in metrics.items()}
        metrics["grad_norm"] = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(grads))))
        ref[pad] = types.SimpleNamespace(out=out, metrics=metrics, grads=grads, new_stats=new_stats)
    return types.SimpleNamespace(com=com, variables=v, ref=ref)


def _port_step(fusion, teacher, pad):
    """The port's make_train_step from the fixture's weights on ``pad``'s batch."""
    model = _port_from_jax(fusion.com, fusion.variables)
    t = _port_from_jax("teacher", teacher.variables)
    metrics = make_train_step(model, TCFG, create_train_state(model), teacher=t, kd_flag=True)(
        batch_to_device(BATCHES[pad], "cpu"))
    return model, {k: float(x) for k, x in metrics.items()}


def _group(key):
    if key.startswith("stpn.stages_"):
        return "encoder"
    if key.startswith(("stpn.dec_", "stpn.head_conv.")):
        return "decoder"
    return "heads" if key.startswith("heads.") else "fusion"


def _group_distances(model, grads):
    """{group: relative L2 distance of the port's gradients from JAX's}."""
    want = {k: t.numpy() for k, t in state_dict_from_flax(grads).items()}
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    num, den = {}, {}
    for k in got:
        g = _group(k)
        num[g] = num.get(g, 0.0) + np.sum((got[k] - want[k]) ** 2)
        den[g] = den.get(g, 0.0) + np.sum(want[k] ** 2)
    return {g: np.sqrt(num[g] / den[g]) for g in num}


@pytest.mark.parametrize("pad", ["random", "zero"])
def test_eval_forward_matches_jax(fusion, pad):
    model = _port_from_jax(fusion.com, fusion.variables)
    dev = batch_to_device(BATCHES[pad], "cpu")
    with torch.no_grad():
        out = model(get_bev(dev, "bev", TCFG), dev["trans"], dev["agent_mask"])
    want = fusion.ref[pad].out
    for key in ("cls", "reg", "head_raw"):
        _close(out[key], want[key], 1e-4, 1e-4, f"{fusion.com} {key}")
    assert len(out["kd_feats"]) == len(want["kd_feats"]) == 5
    for i, (f, w) in enumerate(zip(out["kd_feats"], want["kd_feats"])):
        _close(f, w, 1e-4, 1e-4, f"{fusion.com} kd tap {i}")


@pytest.mark.parametrize("pad", ["random", "zero"])
def test_train_step_matches_jax(fusion, teacher, pad):
    model, got = _port_step(fusion, teacher, pad)
    ref = fusion.ref[pad]
    assert set(got) == {"loss", "cls_loss", "reg_loss", "kd_loss", "grad_norm"}
    rtol = 1e-4 if pad == "random" else ZERO_PAD_METRIC_RTOL
    limit = GROUP_LIMIT if pad == "random" else ZERO_PAD_GROUP_LIMIT
    for k, want in ref.metrics.items():
        # grad_norm is the gradients' norm: it is held where they are
        np.testing.assert_allclose(got[k], want, rtol=limit if k == "grad_norm" else rtol,
                                   err_msg=f"{fusion.com} {k}")
    groups = _group_distances(model, ref.grads)
    assert set(groups) >= {"encoder", "decoder", "heads"}
    assert ("fusion" in groups) == (fusion.com not in ("sum", "mean", "max")), groups
    assert max(groups.values()) < limit, groups
    sd = model.state_dict()
    for k, v in state_dict_from_flax({}, ref.new_stats).items():
        _close(sd[k], v, 1e-4, 1e-4, f"{fusion.com} {k}")


def test_unmasked_fusion_batch_norm(fusion, teacher):
    """Counting the absent agents' rows in a masked BatchNorm's statistics
    (cat's projection: present receivers; agent's scorer: real pairs) moves
    the fusion's gradients past the limit the port is held to. The other
    models have no masked BatchNorm: the same plant changes no gradient."""
    unmasked = lambda x, mask, bn, mesh=None, f=backbone.masked_batch_norm_train: f(x, torch.ones_like(mask), bn, mesh)
    with mock.patch.object(backbone, "masked_batch_norm_train", unmasked):
        model, _ = _port_step(fusion, teacher, "random")
    if fusion.com in ("cat", "agent"):
        groups = _group_distances(model, fusion.ref["random"].grads)
        assert groups["fusion"] > GROUP_LIMIT, groups
    else:
        clean, _ = _port_step(fusion, teacher, "random")
        for (k, p), q in zip(model.named_parameters(), clean.parameters()):
            assert torch.equal(p.grad, q.grad), k


def test_jax_save_pth_loads_strictly(fusion, tmp_path):
    """The JAX package's ``save_pth`` export of the model loads into the port
    with ``strict=True`` and gives back every tensor; a renamed key fails."""
    path = str(tmp_path / "export.pth")
    v = fusion.variables
    jcheckpoint.save_pth(path, types.SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"]), epoch=2)
    want = _port_from_jax(fusion.com, v).state_dict()
    loaded, epoch, _ = load_pth(build_model(fusion.com, TCFG, layer=LAYER, device="cpu", seed=99, kd_flag=True), path)
    assert epoch == 2
    for k, t in loaded.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t, want[k]), k
    ck = torch.load(path, weights_only=True)
    key = next((k for k in ck["model_state_dict"] if not k.startswith(("stpn.", "heads."))),
               "stpn.stages_0.ConvBNRelu_0.weight")  # the fusion's own parameters, where it has some
    ck["model_state_dict"][key + "_renamed"] = ck["model_state_dict"].pop(key)
    torch.save(ck, path)
    with pytest.raises(KeyError):
        load_pth(build_model(fusion.com, TCFG, layer=LAYER, device="cpu", kd_flag=True), path)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_masked_sender_reduce_matches_jax(op):
    rng = np.random.default_rng(3)
    warped = rng.normal(0, 1, (3, 4, 4, 2, 3, 5)).astype(np.float32)
    mask = np.array([[1, 1, 0, 1], [1, 0, 0, 0], [0, 0, 0, 0]], bool)  # the last scene is padding
    want = np.asarray(jax_masked_sender_reduce(jnp.asarray(warped), jnp.asarray(mask), op))
    got = masked_sender_reduce(torch.from_numpy(warped), torch.from_numpy(mask), op).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if op == "mean":  # a scene of padding: the count clamps at 1, the mean is 0
        assert np.all(got[2] == 0)
    if op == "max":
        assert np.all(got[1] == warped[1, :, 0]) and np.all(got[2] == np.finfo(np.float32).min)


def test_when2com_without_warp_flag_matches_jax(tmp_path):
    """``warp_flag`` 0: the values are each sender's own map, not warped."""
    jm = _jax_model("when2com", warp_flag=False)
    v = _to_jax(jm, _randomize_stats(build_model("when2com", TCFG, layer=LAYER, device="cpu", seed=5), 5),
                str(tmp_path / "w.pth"))
    jb = _jax_batch(BATCHES["random"])
    want = jax.jit(lambda v: jm.apply(v, jb["bev"], jb["trans"], jb["agent_mask"], train=False))(v)["cls"]
    args = (torch.from_numpy(np.array(jb["bev"])), torch.from_numpy(BATCHES["random"]["trans"]),
            torch.from_numpy(MASK))
    model = _port_from_jax("when2com", v, warp_flag=False)
    assert not model.uses_warp
    with torch.no_grad():
        got = model(*args)["cls"]
        warped = _port_from_jax("when2com", v)(*args)["cls"]
    _close(got, want, 1e-4, 1e-4)
    assert not np.allclose(got.numpy(), warped.numpy(), atol=1e-4)


def test_who2com_hard_select_masks_absent_agents():
    """In eval mode each receiver takes exactly one present sender, the
    argmax of the soft attention with ties to the lower index; an absent
    sender never, even with the highest raw score. In training the
    attention stays soft."""
    model = build_model("who2com", TCFG, layer=LAYER, device="cpu", seed=3)
    h, C = 4, model.layer_channels
    feats = torch.randn(B, A, h, h, C, generator=torch.Generator().manual_seed(0))
    mask = torch.tensor([[True, False, True], [True, True, True]])
    keys = torch.zeros(B * A, 32)
    keys[1] = 100.0  # scene 0's absent sender 1 scores highest
    model.query_net.register_forward_hook(lambda mod, args, out: torch.ones_like(out))
    model.key_net.register_forward_hook(lambda mod, args, out: keys)
    with torch.no_grad():
        model.attn_w.weight.copy_(torch.eye(32))
        hard = model.fuse(feats, None, mask, None)
        model.train()
        soft = model.fuse(feats, None, mask, None)
    # scene 0: the present senders 0 and 2 tie; scene 1: all three tie
    for b in range(B):
        torch.testing.assert_close(hard[b], feats[b, 0].expand(A, h, h, C), rtol=0, atol=0)
    torch.testing.assert_close(soft[0], (0.5 * (feats[0, 0] + feats[0, 2])).expand(A, h, h, C))
    torch.testing.assert_close(soft[1], feats[1].mean(dim=0).expand(A, h, h, C))


def test_v2v_gru_rounds():
    """``gru_rounds`` sets V2VNet's rounds (0 keeps 3); each round changes the output."""
    assert build_model("v2v", TCFG, layer=LAYER, device="cpu").rounds == 3
    dev = batch_to_device(BATCHES["random"], "cpu")
    bev = torch.from_numpy(BATCHES["random"]["bev"]).float()
    outs = []
    for rounds in (1, 2):
        model = build_model("v2v", TCFG, layer=LAYER, device="cpu", gru_rounds=rounds, seed=4)
        assert model.rounds == rounds
        with torch.no_grad():
            outs.append(model(bev, dev["trans"], dev["agent_mask"])["cls"])
    assert not torch.allclose(outs[0], outs[1])


@pytest.mark.parametrize("com,kw,match", [
    ("disco", dict(gru_rounds=2), "--gru_rounds applies to --com v2v only"),
    ("who2com", dict(gru_rounds=1), "--gru_rounds applies to --com v2v only"),
    ("gnn", {}, "unknown --com 'gnn'"),
    ("sum", dict(task="track"), "task must be"),
])
def test_build_model_value_errors(com, kw, match):
    """The JAX factory's errors (and an unknown ``task``, which the JAX
    factory passes on), raised before any device is chosen."""
    if "task" not in kw:
        with pytest.raises(ValueError, match=match):
            jax_build_model(com, JCFG, **kw)
    with pytest.raises(ValueError, match=match):
        build_model(com, TCFG, **kw)
