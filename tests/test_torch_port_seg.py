"""The port's BEV segmentation against the JAX package's, and its CLIs.

CPU, float32 32-grid config (batch 2 x 3 agent slots, agent (1, 2) absent,
fusion at layer 1). Weights start as the port's seeded initialization with
random BatchNorm running statistics and reach JAX through a ``.pth`` and the
JAX ``load_pth``, then come back through ``state_dict_from_flax``. Held
against JAX:

* the eval forward's logits within 1e-4, on the UNet and on the STPN with a
  ``SegHead``, for ``disco``, ``mean`` and the lowerbound;
* ``_seg_loss`` (cross-entropy and accuracy) within 1e-6;
* one seg train step of DiscoNet on the UNet, with the absent agent's grids
  random and all zero: the loss within rtol 1e-4 (random) or the training
  tests' ``ZERO_PAD_METRIC_RTOL``, the accuracy exactly, the gradients per
  group of layers within ``GROUP_LIMIT`` / ``ZERO_PAD_GROUP_LIMIT``;
* ``iou_per_class`` on canned grids, NaN classes included;
* ``V2XSimSeg`` items on a generated 32-grid dataset, both bounds, with and
  without the RSU.

Within the port: the seg CLI cycle on the CPU (create, train 2 epochs,
auto-resume to 3, test prints the per-class table and a finite mIoU), and
the det CLI cycle with ``--com v2v --gru_rounds 2`` and with ``--com
who2com --warp_flag 0``.
"""

import os
import re
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from disconet_tpu.config import tiny_config as jax_tiny_config
from disconet_tpu.data import dataset as jds
from disconet_tpu.models import build_model as jax_build_model
from disconet_tpu.training import checkpoint as jcheckpoint
from disconet_tpu.training import seg_module as jseg
from disconet_tpu_torch import build_model, tiny_config
from disconet_tpu_torch.checkpoint import load_state_dict_strict, save_pth, state_dict_from_flax
from disconet_tpu_torch.config import default_fusion_layer
from disconet_tpu_torch.data import dataset as tds
from disconet_tpu_torch.models.backbone import SegHead
from disconet_tpu_torch.models.unet import UNet
from disconet_tpu_torch.tools.det import test_codet as det_test, train_codet as det_train
from disconet_tpu_torch.tools.seg import create_data_seg, test_codet, train_codet
from disconet_tpu_torch.training import batch_to_device, get_bev
from disconet_tpu_torch.training.seg_module import (
    _seg_loss,
    create_seg_train_state,
    iou_per_class,
    make_seg_predict_step,
    make_seg_train_step,
)
from test_torch_port_training import GROUP_LIMIT, ZERO_PAD_GROUP_LIMIT, ZERO_PAD_METRIC_RTOL

B, A = 2, 3
OVERRIDES = dict(compute_dtype="float32", head_raw_dtype="float32", max_agents=A)
LAYER = default_fusion_layer(32)
MASK = np.array([[True, True, True], [True, True, False]])


def _cfgs(backbone):
    return (jax_tiny_config(32, seg_backbone=backbone, **OVERRIDES),
            tiny_config(32, seg_backbone=backbone, **OVERRIDES))


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
    """Grids at 5% occupancy, random poses and labels; the absent agent's
    grids random or all zero (``pad``)."""
    rng = np.random.default_rng(21)
    bev = (rng.random((B, A, 32, 32, 13)) < 0.05).astype(np.uint8)
    if pad == "zero":
        bev[~MASK] = 0
    trans = np.tile(np.eye(4, dtype=np.float32), (B, A, A, 1, 1))
    for b in range(B):
        for i in range(A):
            for j in range(A):
                if i != j:
                    th = rng.uniform(-0.5, 0.5)
                    trans[b, i, j, :2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
                    trans[b, i, j, :2, 3] = rng.uniform(-2.0, 2.0, 2)
    seg = rng.integers(0, 8, (B, A, 32, 32)).astype(np.int32)
    return {"bev": bev, "trans": trans, "agent_mask": MASK.copy(), "seg_label": seg}


BATCHES = {pad: _host_batch(pad) for pad in ("random", "zero")}


def _jax_batch(batch):
    return {k: jnp.asarray(v.astype(np.float32) if v.dtype == np.uint8 else v) for k, v in batch.items()}


def _carry(com, backbone, seed, path):
    """(JAX model, its variables, the port model from them) of a seg model
    whose weights start as the port's seeded ones with random statistics."""
    jcfg, tcfg = _cfgs(backbone)
    jm = jax_build_model(com, jcfg, layer=LAYER, task="seg")
    port = build_model(com, tcfg, layer=LAYER, device="cpu", seed=seed, task="seg")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in port.state_dict().items():
            if k.endswith("running_mean"):
                v.copy_(torch.randn(v.shape, generator=gen) * 0.3)
            elif k.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=gen) * 1.5 + 0.5)
    jb = _jax_batch(BATCHES["random"])
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb["bev"], jb["trans"], jb["agent_mask"])
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    save_pth(path, port)
    params, stats, _, _ = jcheckpoint.load_pth(path, zeros["params"], zeros["batch_stats"])
    v = {"params": params, "batch_stats": stats}
    model = load_state_dict_strict(build_model(com, tcfg, layer=LAYER, device="cpu", task="seg"),
                                   state_dict_from_flax(params, stats))
    return jm, v, model


@pytest.mark.parametrize("backbone", ["unet", "stpn"])
@pytest.mark.parametrize("com", ["disco", "mean", "lowerbound"])
def test_seg_forward_matches_jax(com, backbone, tmp_path):
    jm, v, model = _carry(com, backbone, 3, str(tmp_path / "w.pth"))
    assert isinstance(model.stpn, UNet) == (backbone == "unet") and isinstance(model.seg_head, SegHead)
    jb = _jax_batch(BATCHES["random"])
    want = jax.jit(lambda v, b: jm.apply(v, b["bev"], b["trans"], b["agent_mask"], train=False))(v, jb)["seg"]
    with torch.no_grad():
        got = model(torch.from_numpy(BATCHES["random"]["bev"]).float(), torch.from_numpy(BATCHES["random"]["trans"]),
                    torch.from_numpy(MASK))["seg"]
    assert got.shape == (B, A, 32, 32, 8) and got.dtype == torch.float32
    _close(got, want, 1e-4, 1e-4, f"{com} {backbone}")


def test_seg_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2, (B, A, 16, 16, 8)).astype(np.float32)
    labels = rng.integers(0, 8, (B, A, 16, 16)).astype(np.int32)
    for mask in (MASK, np.zeros_like(MASK)):  # no present agent: the count clamps at 1
        _, want = jseg._seg_loss({"seg": jnp.asarray(logits)},
                                 {"seg_label": jnp.asarray(labels), "agent_mask": jnp.asarray(mask)})
        _, got = _seg_loss({"seg": torch.from_numpy(logits)},
                           {"seg_label": torch.from_numpy(labels), "agent_mask": torch.from_numpy(mask)})
        for k in ("loss", "acc"):
            _close(got[k], want[k], 1e-6, 1e-6, k)


def _group(key):
    if key.startswith("stpn.stages_"):
        return "encoder"
    if key.startswith(("stpn.dec_", "stpn.head_conv.")):
        return "decoder"
    return "head" if key.startswith("seg_head.") else "fusion"


@pytest.fixture(scope="module")
def seg_step(tmp_path_factory):
    """One JAX seg train step of DiscoNet on the UNet on each padding: its
    metrics and gradients, and the weights they start from."""
    jm, v, _ = _carry("disco", "unet", 4, str(tmp_path_factory.mktemp("seg") / "w.pth"))

    @jax.jit
    def grads(params, stats, jb):
        def loss_fn(p):
            out, mut = jm.apply({"params": p, "batch_stats": stats}, jb["bev"], jb["trans"], jb["agent_mask"],
                                train=True, mutable=["batch_stats"])
            loss, metrics = jseg._seg_loss(out, jb)
            return loss, (metrics, out["seg"])

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    ref = {}
    for pad, batch in BATCHES.items():
        (_, (metrics, logits)), g = grads(v["params"], v["batch_stats"], _jax_batch(batch))
        ref[pad] = types.SimpleNamespace(metrics={k: float(x) for k, x in metrics.items()}, grads=g,
                                         logits=np.asarray(logits))
    return types.SimpleNamespace(variables=v, ref=ref)


# the largest |port - JAX| training-mode logit the step may show; zero
# padding reads ~5.4e-4 (the two BatchNorm variances over the all-zero rows)
SEG_LOGIT_LIMIT = {"random": 1e-4, "zero": 1e-3}


@pytest.mark.parametrize("pad", ["random", "zero"])
def test_seg_train_step_matches_jax(seg_step, pad):
    """The step's loss, accuracy and gradients against JAX's.

    The accuracy is compared cell by cell through the training-mode logits.
    A present cell is a tie where JAX's two best logits lie closer than
    twice the largest |port - JAX| logit difference of the batch: either
    package may pick either class there. Random padding has 3 ties (logits
    part by up to 8.7e-5) and no flip, and the step's accuracy equals JAX's
    within 1e-6. Zero padding has 6 ties (logits part by up to 5.4e-4: the
    port's two-pass BatchNorm variance against flax's E[x^2] - E[x]^2 over
    the all-zero rows) and one of them flips: cell (0, 0, 10, 22), where
    JAX's logits of classes 1 and 2 part by 4.6e-5. That flip reads 0.13340
    against JAX's 0.13320; these are near ties of float32 logits, not exact
    ties. Away from the ties the argmax is equal in every cell and the
    accuracy equals JAX's within 1e-6, on both paddings."""
    tcfg = _cfgs("unet")[1]
    v = seg_step.variables
    model, twin = (load_state_dict_strict(build_model("disco", tcfg, layer=LAYER, device="cpu", task="seg"),
                                          state_dict_from_flax(v["params"], v["batch_stats"])) for _ in range(2))
    dev = batch_to_device(BATCHES[pad], "cpu")
    twin.train()
    with torch.no_grad():  # the step's own forward: the same weights and batch
        logits = twin(get_bev(dev, "bev", tcfg), dev["trans"], dev["agent_mask"])["seg"].numpy()
    step = make_seg_train_step(model, tcfg, create_seg_train_state(model))
    got = {k: float(x) for k, x in step(dev).items()}
    ref = seg_step.ref[pad]
    assert set(got) == {"loss", "acc"}
    np.testing.assert_allclose(got["loss"], ref.metrics["loss"], rtol=1e-4 if pad == "random" else ZERO_PAD_METRIC_RTOL)

    label = BATCHES[pad]["seg_label"]
    present = np.broadcast_to(MASK[:, :, None, None], label.shape)
    diff = np.abs(logits - ref.logits).max()
    assert diff < SEG_LOGIT_LIMIT[pad], diff
    top2 = np.sort(ref.logits, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0] < 2 * diff) & present
    away = present & ~tie
    assert int(tie.sum()) == {"random": 3, "zero": 6}[pad], np.argwhere(tie)
    assert np.array_equal(logits.argmax(-1)[away], ref.logits.argmax(-1)[away])
    port_hit = logits.argmax(-1) == label
    jax_hit = ref.logits.argmax(-1) == label
    assert got["acc"] == pytest.approx(port_hit[present].sum() / present.sum(), abs=1e-6)
    assert ref.metrics["acc"] == pytest.approx(jax_hit[present].sum() / present.sum(), abs=1e-6)
    assert port_hit[away].mean() == pytest.approx(jax_hit[away].mean(), abs=1e-6)
    if pad == "random":  # no tie flips
        assert got["acc"] == pytest.approx(ref.metrics["acc"], abs=1e-6)
    want = {k: t.numpy() for k, t in state_dict_from_flax(ref.grads).items()}
    num, den = {}, {}
    for k, p in model.named_parameters():
        g = _group(k)
        num[g] = num.get(g, 0.0) + np.sum((p.grad.numpy() - want[k]) ** 2)
        den[g] = den.get(g, 0.0) + np.sum(want[k] ** 2)
    groups = {g: np.sqrt(num[g] / den[g]) for g in num}
    assert set(groups) == {"encoder", "decoder", "fusion", "head"}
    assert max(groups.values()) < (GROUP_LIMIT if pad == "random" else ZERO_PAD_GROUP_LIMIT), groups


def test_seg_predict_step_is_the_argmax():
    """The predict step's classes are the argmax of the eval forward, whose
    head input stays fp32 in the bf16 mode's stores."""
    cfg = tiny_config(32, max_agents=A)
    model = build_model("disco", cfg, layer=LAYER, device="cpu", seed=2, task="seg")
    dev = batch_to_device(BATCHES["random"], "cpu")
    pred = make_seg_predict_step(model, cfg)(dev)
    bev = torch.from_numpy(BATCHES["random"]["bev"]).float()
    with torch.no_grad():
        want = model(bev, dev["trans"], dev["agent_mask"])["seg"].argmax(dim=-1)
    assert pred.shape == (B, A, 32, 32)
    assert (pred == want).float().mean().item() > 0.99  # bf16 stores upstream may flip near-ties


def test_iou_per_class_matches_jax():
    rng = np.random.default_rng(7)
    pred = rng.integers(0, 6, (3, 2, 8, 8))
    label = rng.integers(0, 6, (3, 2, 8, 8))
    label[0, 0] = 7  # class 7 only in the labels of one agent; class 6 nowhere: NaN
    mask = np.ones((3, 2, 1, 1), bool)
    mask[2, 1] = False
    for m in (None, mask):
        want = jseg.iou_per_class(pred, label, 8, mask=m)
        got = iou_per_class(pred, label, 8, mask=m)
        assert got["miou"] == want["miou"] and set(got["iou"]) == set(want["iou"]) == set(range(8))
        for c in range(8):
            assert got["iou"][c] == want["iou"][c] or (np.isnan(got["iou"][c]) and np.isnan(want["iou"][c]))
        assert np.isnan(got["iou"][6])
    assert iou_per_class(np.zeros((2, 2)), np.zeros((2, 2)), 3, mask=np.zeros((2, 2), bool))["miou"] == 0.0


@pytest.fixture(scope="module")
def seg_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seg_data"))
    create_data_seg.main(["--data", root, "--mode", "synthetic", "--scenes", "1", "--frames", "3", "--grid", "32"])
    return os.path.join(root, "train")


@pytest.mark.parametrize("rsu", [0, 1])
@pytest.mark.parametrize("bound", ["", "upperbound"])
def test_seg_dataset_items_match_jax(seg_data, rsu, bound):
    port = tds.V2XSimSeg(seg_data, tiny_config(32), rsu=bool(rsu), bound=bound)
    ref = jds.V2XSimSeg(seg_data, jax_tiny_config(32), rsu=bool(rsu), bound=bound)
    assert len(port) == len(ref) == 3 and port.keys == ref.keys
    for i in range(len(port)):
        a, b = port[i], ref[i]
        assert set(a) == set(b), (sorted(a), sorted(b))
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"item {i} {k}")
    if bound == "upperbound":
        assert np.array_equal(port[0]["bev_packed"], port[0]["bev_teacher_packed"])


def _run(capsys, main, argv):
    capsys.readouterr()
    result = main(argv)
    return capsys.readouterr().out, result


def test_seg_cli_cycle_on_cpu(capsys, seg_data, tmp_path):
    logs = str(tmp_path / "logs")
    common = ["--data", seg_data, "--grid", "32", "--batch", "2", "--device", "cpu", "--com", "disco"]
    out, _ = _run(capsys, train_codet.main, [*common, "--nepoch", "2", "--logpath", logs, "--log_every", "1"])
    assert "dataset: 3 scene-frames, 1 batches/epoch" in out and "seg training complete" in out
    losses = [float(v) for v in re.findall(r"epoch \d+ done .*?(?<![\w])loss=([\d.eE+-]+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert sorted(os.listdir(os.path.join(logs, "disco_seg", "ckpt"))) == ["1.pth", "2.pth"]
    out, _ = _run(capsys, train_codet.main, [*common, "--nepoch", "3", "--logpath", logs,
                                              "--auto_resume_path", logs])
    assert "auto-resumed from epoch 2" in out and "epoch 3 done" in out and "epoch 1 done" not in out
    out, res = _run(capsys, test_codet.main, [*common, "--resume", os.path.join(logs, "disco_seg")])
    assert "loaded epoch 3 from" in out
    rows = re.findall(r"^\s*(\w+) \|\s+([\d.]+|n/a)$", out, re.M)
    assert [r[0] for r in rows] == test_codet.CLASS_NAMES + ["mIoU"]
    assert np.isfinite(res["miou"]) and float(rows[-1][1]) == pytest.approx(res["miou"], abs=1e-4)
    assert set(res) == {"iou", "miou", "scenes_per_s"}


@pytest.mark.parametrize("com,flags", [("v2v", ["--gru_rounds", "2"]), ("who2com", ["--warp_flag", "0"])])
def test_det_cli_cycle_other_fusion(capsys, seg_data, tmp_path, com, flags):
    """The det CLIs train and evaluate the other fusion models with their
    flags, under the JAX CLIs' log directory names."""
    logs = str(tmp_path / "logs")
    common = ["--data", seg_data, "--grid", "32", "--batch", "2", "--device", "cpu", "--com", com, *flags]
    out, _ = _run(capsys, det_train.main, [*common, "--nepoch", "1", "--logpath", logs, "--log_every", "1"])
    losses = [float(v) for v in re.findall(r"epoch \d+ done .*?(?<![\w])loss=([\d.eE+-]+)", out)]
    assert len(losses) == 1 and np.isfinite(losses[0])
    pth = os.path.join(logs, com, "epoch_1.pth")
    assert os.path.isfile(pth)
    out, res = _run(capsys, det_test.main, [*common, "--resume", pth, "--logpath", logs])
    assert "(epoch 1)" in out and f"mode '{com}'" in out and np.isfinite(res["mAP@0.5"])
    if com == "v2v":
        with pytest.raises(SystemExit, match="--gru_rounds applies to --com v2v only"):
            det_train.main([*common[:-4], "--com", "disco", "--gru_rounds", "2", "--logpath", logs])
