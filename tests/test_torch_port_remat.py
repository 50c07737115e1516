"""``train_remat`` in the port: the train steps rematerialize each stage in
the backward (``models/backbone.py::stage``) and stay the plain steps.

CPU, float32 32-grid, batch 2 x 2 agents with one absent. For DiscoNet with
KD taps, the lowerbound, V2VNet (its GRU rounds inside the fuse stage) and
DiscoNet segmentation on the UNet, one remat step against one plain step
from the same weights and batch: the metrics within rtol 1e-6, every
gradient within 1e-5, the BatchNorm running statistics bit-equal (the
recompute leaves them alone, so they update once, as JAX's functional
``batch_stats`` do), and the backward really recomputed the stages (more
ConvBNRelu calls than the plain step). Both ``train_codet`` take
``--remat 1``.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from disconet_tpu_torch import build_model, tiny_config
from disconet_tpu_torch.models.backbone import ConvBNRelu
from disconet_tpu_torch.tools.det import create_data_det, train_codet
from disconet_tpu_torch.tools.seg import train_codet as seg_train
from disconet_tpu_torch.training import batch_to_device, create_train_state, make_train_step
from disconet_tpu_torch.training.seg_module import make_seg_train_step
from test_torch_port_training import _host_batch

F32 = dict(compute_dtype="float32", head_raw_dtype="float32")
LAYER = 1  # a 16x16 fusion map at the 32-grid


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _count_conv_calls(model):
    calls = [0]

    def hook(*_):
        calls[0] += 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, ConvBNRelu)]
    return calls, handles


def _step(com, task, remat, batch, seed=4):
    cfg = tiny_config(32, train_remat=remat, **F32)
    kd = com == "disco" and task == "det"
    model = build_model(com, cfg, layer=LAYER, device="cpu", seed=seed, kd_flag=kd, task=task)
    opt = create_train_state(model)
    if task == "seg":
        step = make_seg_train_step(model, cfg, opt)
    elif kd:
        teacher = build_model("teacher", cfg, device="cpu", seed=1)
        step = make_train_step(model, cfg, opt, teacher=teacher, kd_flag=True)
    else:
        step = make_train_step(model, cfg, opt)
    calls, handles = _count_conv_calls(model)
    # the step's own gradients, before Adam's update
    grads = {}
    orig = opt.step

    def capture_then_step(*a, **k):
        grads.update({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
        return orig(*a, **k)

    opt.step = capture_then_step
    metrics = step(batch_to_device(batch, "cpu"))
    for h in handles:
        h.remove()
    return metrics, grads, model, calls[0]


@pytest.mark.parametrize("com,task", [("disco", "det"), ("lowerbound", "det"), ("v2v", "det"), ("disco", "seg")])
def test_remat_step_equals_plain_step(com, task):
    batch = _host_batch(seed=2)
    if task == "seg":
        batch["seg_label"] = np.random.default_rng(0).integers(0, 8, batch["agent_mask"].shape + (32, 32)).astype(np.int32)
    m0, g0, plain, n0 = _step(com, task, False, batch)
    m1, g1, remat, n1 = _step(com, task, True, batch)
    assert n1 > n0  # the backward ran stages again
    assert set(m0) == set(m1)
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-6, err_msg=k)
    assert set(g0) == set(g1) and g0
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    sd0, sd1 = plain.state_dict(), remat.state_dict()
    stats = [k for k in sd0 if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        assert torch.equal(sd0[k], sd1[k]), k  # one update, not two


def test_remat_config_flag_is_off_by_default():
    assert not tiny_config(32).train_remat
    assert dataclasses.replace(tiny_config(32), train_remat=True).train_remat


@pytest.mark.parametrize("cli", ["det", "seg"])
def test_cli_remat(capsys, tmp_path, cli):
    """``--remat 1``: an epoch trains, and its loss is the plain run's."""
    root = str(tmp_path / "data")
    create_data_det.main(["--data", root, "--split", "train", "--scenes", "1", "--frames", "2", "--grid", "32"])
    main = train_codet.main if cli == "det" else seg_train.main
    common = ["--data", os.path.join(root, "train"), "--grid", "32", "--batch", "2", "--com", "disco",
              "--nepoch", "1", "--device", "cpu", "--nworker", "1"]
    losses = {}
    for remat in ("0", "1"):
        capsys.readouterr()
        main([*common, "--logpath", str(tmp_path / f"r{remat}"), "--remat", remat])
        out = capsys.readouterr().out
        losses[remat] = float(re.search(r"epoch 1 done .*?(?<![\w])loss=([\d.eE+-]+)", out).group(1))
    assert np.isfinite(losses["1"]) and losses["1"] == pytest.approx(losses["0"], rel=1e-4)
