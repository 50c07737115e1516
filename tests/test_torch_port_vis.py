"""The port's visualization and the other CLI options it now takes:
``--visualization 1``, ``--debug_nans 1`` and ``--warp_dtype float32``.

CPU, 32-grid. The renderers return figures whose drawn boxes are the JAX
package's; the det and seg CLI hooks write their pngs; without matplotlib
the flag exits naming it. DiscoNet's ``edge_weights`` equal the JAX model's
sown ``edge_weights`` (float32, 1e-5). A planted NaN stops det and seg
training at step 1, naming it; a clean ``--debug_nans`` run finishes and
leaves anomaly mode off. ``--warp_dtype float32`` keeps DiscoNet's
fusion-layer map fp32 at inference and its bf16 forward tracks JAX's with
``warp_dtype="float32"`` within the bounds of
``test_torch_port_model.py::test_bf16_forward_tracks_jax``.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from disconet_tpu.config import tiny_config as jax_tiny_config
from disconet_tpu.models import build_model as jax_build_model
from disconet_tpu.utils import visualization as jax_vis
from disconet_tpu_torch import build_model, example_train_batch, tiny_config
from disconet_tpu_torch.checkpoint import load_state_dict_strict, restore_or_die, save_pth, state_dict_from_flax
from disconet_tpu_torch.tools.det import create_data_det, test_codet, train_codet
from disconet_tpu_torch.tools.seg import create_data_seg, test_codet as seg_test, train_codet as seg_train
from disconet_tpu_torch.utils import profiling, visualization as vis

F32 = dict(compute_dtype="float32", head_raw_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Few torch threads: XLA's CPU pool keeps its own busy in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _run(capsys, main, argv):
    capsys.readouterr()
    result = main(argv)
    return capsys.readouterr().out, result


@pytest.fixture(scope="module")
def det_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vis_det"))
    create_data_det.main(["--data", root, "--mode", "synthetic", "--scenes", "1", "--frames", "3", "--grid", "32"])
    return os.path.join(root, "train")


@pytest.fixture(scope="module")
def seg_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vis_seg"))
    create_data_seg.main(["--data", root, "--mode", "synthetic", "--scenes", "1", "--frames", "2", "--grid", "32"])
    return os.path.join(root, "train")


@pytest.fixture(scope="module")
def disco_ckpt(det_data, tmp_path_factory):
    logs = str(tmp_path_factory.mktemp("vis_logs"))
    train_codet.main(["--data", det_data, "--grid", "32", "--batch", "2", "--com", "disco", "--nepoch", "1",
                      "--logpath", logs, "--device", "cpu"])
    return os.path.join(logs, "disco", "epoch_1.pth")


# ---------------------------------------------------------------------------
# the renderers


def _lines(fig):
    return [line.get_xydata() for ax in fig.axes for line in ax.lines]


def test_render_bev_draws_the_jax_boxes():
    from disconet_tpu.config import tiny_config as jcfg

    rng = np.random.default_rng(0)
    bev = (rng.random((32, 32, 13)) < 0.05).astype(np.float32)
    gt = np.array([[0.0, 0.0, 2.0, 4.0, 0.3], [-1.5, 2.0, 1.8, 4.2, -1.0]])
    det, scores = gt + 0.1, np.array([0.9, 0.5])
    fig = vis.render_bev(tiny_config(32), bev, gt, det, scores)
    ref = jax_vis.render_bev(jcfg(32), bev, gt, det, scores)
    assert isinstance(fig, matplotlib.figure.Figure) and len(_lines(fig)) == 4
    for a, b in zip(_lines(fig), _lines(ref)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert [t.get_text() for t in fig.axes[0].texts] == [t.get_text() for t in ref.axes[0].texts]
    matplotlib.pyplot.close("all")


def test_render_seg_and_edge_weights_return_figures():
    rng = np.random.default_rng(1)
    pred, label = rng.integers(0, 8, (32, 32)), rng.integers(0, 8, (32, 32))
    fig = vis.render_seg(pred, label, 8, ["c%d" % i for i in range(8)])
    assert isinstance(fig, matplotlib.figure.Figure) and len(fig.axes) == 2
    np.testing.assert_array_equal(fig.axes[0].images[0].get_array(), pred.T)
    mask = np.array([True, False, True, True])
    w = rng.random((4, 8, 8))
    fig = vis.render_edge_weights(w, mask, receiver=2)
    ref = jax_vis.render_edge_weights(w, mask, receiver=2)
    assert [ax.get_title() for ax in fig.axes] == [ax.get_title() for ax in ref.axes]
    assert sum("(self)" in ax.get_title() for ax in fig.axes) == 1
    matplotlib.pyplot.close("all")


# ---------------------------------------------------------------------------
# the CLI hooks


def test_det_test_codet_writes_pngs(capsys, tmp_path, det_data, disco_ckpt):
    logs = str(tmp_path)
    out, res = _run(capsys, test_codet.main, ["--data", det_data, "--grid", "32", "--batch", "2", "--com", "disco",
                                               "--resume", disco_ckpt, "--device", "cpu", "--logpath", logs,
                                               "--visualization", "1"])
    pngs = sorted(os.listdir(os.path.join(logs, "vis")))
    agents = [f for f in pngs if re.fullmatch(r"s0_f[01]_a\d\.png", f)]
    edges = [f for f in pngs if re.fullmatch(r"edge_w_s0_f0_a\d\.png", f)]
    assert len(agents) == 12 and len(edges) == 6 and len(pngs) == 18  # 2 frames x 6 agents; 6 receivers
    assert np.isfinite(res["mAP@0.5"]) and "visualization: pngs under" in out


def test_det_train_codet_writes_a_panel_per_checkpoint(capsys, tmp_path, det_data):
    out, _ = _run(capsys, train_codet.main, ["--data", det_data, "--grid", "32", "--batch", "2", "--bound",
                                              "lowerbound", "--nepoch", "2", "--logpath", str(tmp_path),
                                              "--device", "cpu", "--visualization", "1"])
    assert sorted(os.listdir(tmp_path / "lowerbound" / "vis")) == ["epoch_1_a0.png", "epoch_2_a0.png"]
    assert out.count("visualization: ") == 2


def test_seg_test_codet_writes_pngs(capsys, tmp_path, seg_data):
    _run(capsys, seg_train.main, ["--data", seg_data, "--grid", "32", "--batch", "2", "--com", "disco",
                                  "--nepoch", "1", "--logpath", str(tmp_path), "--device", "cpu"])
    _run(capsys, seg_test.main, ["--data", seg_data, "--grid", "32", "--batch", "2", "--com", "disco", "--resume",
                                 str(tmp_path / "disco_seg"), "--device", "cpu", "--logpath", str(tmp_path),
                                 "--visualization", "1"])
    pngs = os.listdir(tmp_path / "vis")
    assert pngs and all(re.fullmatch(r"seg_s0_f0_a\d\.png", f) for f in pngs)


@pytest.mark.parametrize("main,data,extra", [
    (test_codet.main, "det", []),
    (train_codet.main, "det", ["--nepoch", "1"]),
    (seg_test.main, "seg", []),
])
def test_visualization_without_matplotlib_exits(monkeypatch, tmp_path, det_data, seg_data, main, data, extra):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib -> ImportError
    argv = ["--data", det_data if data == "det" else seg_data, "--grid", "32", "--batch", "2", "--device", "cpu",
            "--logpath", str(tmp_path), "--visualization", "1", *extra]
    with pytest.raises(SystemExit, match="--visualization 1 needs matplotlib"):
        main(argv)
    assert not os.path.exists(tmp_path / "vis")


# ---------------------------------------------------------------------------
# DiscoNet's edge weights and --warp_dtype


def _jax_disco(jcfg, bev, trans, mask, seed=1):
    """JAX DiscoNet variables with random running statistics."""
    model = jax_build_model("disco", jcfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), bev, trans, mask)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.uniform(0.5, 1.5, x.shape) if "var" in str(p[-1]) else rng.normal(0, 0.2, x.shape),
                                 x.dtype), variables["batch_stats"])
    return model, {"params": variables["params"], "batch_stats": stats}


def _batch(cfg, seed=3):
    host = example_train_batch(cfg, 2, 3, seed=seed, occupancy=(0.05, 0.1), boxes_per_frame=2)
    return host["bev"].astype(np.float32), host["trans"], host["agent_mask"]


def test_edge_weights_match_jax_sow():
    jcfg, tcfg = jax_tiny_config(32, **F32), tiny_config(32, **F32)
    bev, trans, mask = _batch(tcfg)
    jargs = tuple(jnp.asarray(x) for x in (bev, trans, mask))
    model, variables = _jax_disco(jcfg, *jargs)
    _, inter = model.apply(variables, *jargs, train=False, mutable=["intermediates"])
    want = np.asarray(inter["intermediates"]["edge_weights"][0])
    port = load_state_dict_strict(build_model("disco", tcfg, device="cpu"),
                                  state_dict_from_flax(variables["params"], variables["batch_stats"]))
    port.eval()
    with torch.no_grad():
        got = port.edge_weights(*(torch.from_numpy(x) for x in (bev, trans, mask)))
    assert got.shape == want.shape == (2, 3, 3, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert (got[1, :, 2] == 0).all()  # the absent sender gets no weight


def test_warp_dtype_float32_forward_tracks_jax():
    """bf16 compute with the inference stores (``store_bf16``): the port's
    fusion-layer map is bf16 by default and fp32 with ``warp_dtype`` float32;
    the latter's head logits track the JAX forward with ``warp_dtype``
    float32."""
    jcfg = jax_tiny_config(32, head_raw_dtype="float32", warp_dtype="float32")
    bev, trans, mask = _batch(tiny_config(32))
    jargs = tuple(jnp.asarray(x) for x in (bev, trans, mask))
    model, variables = _jax_disco(jcfg, *jargs)
    want = np.asarray(jax.jit(model.apply)(variables, *jargs)["head_raw"])
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"])
    dtypes, got = {}, {}
    for wd in ("bfloat16", "float32"):
        port = load_state_dict_strict(build_model("disco", tiny_config(32, head_raw_dtype="float32", warp_dtype=wd),
                                                  device="cpu"), sd)
        port.eval()
        warp = port.warp

        def spy(*a, _wd=wd, **k):
            out = warp(*a, **k)
            dtypes[_wd] = out.dtype
            return out

        port.warp = spy
        with torch.no_grad():
            got[wd] = port(*(torch.from_numpy(x) for x in (bev, trans, mask)), store_bf16=True)["head_raw"].numpy()
    assert dtypes == {"bfloat16": torch.bfloat16, "float32": torch.float32}
    err, scale = np.abs(got["float32"] - want), np.abs(want).max()
    assert err.max() < 2e-2 * scale and err.mean() < 3e-3 * scale, (err.max(), err.mean(), scale)


def test_test_codet_warp_dtype_float32(capsys, det_data, disco_ckpt, tmp_path):
    tables = {}
    for wd in ("bfloat16", "float32"):
        out, res = _run(capsys, test_codet.main, ["--data", det_data, "--grid", "32", "--batch", "2", "--com",
                                                   "disco", "--resume", disco_ckpt, "--device", "cpu",
                                                   "--logpath", str(tmp_path), "--warp_dtype", wd])
        tables[wd] = re.search(r"average \|.*", out).group(0)
    assert tables["bfloat16"].split("|")[3] == tables["float32"].split("|")[3]  # the same #gt


# ---------------------------------------------------------------------------
# --debug_nans


def _planted(ckpt, com, cfg, path, task="det"):
    """``ckpt``'s weights with a NaN planted in a bias, saved to ``path``."""
    model = build_model(com, cfg, layer=cfg.fusion_layer, device="cpu", task=task)
    restore_or_die(ckpt, model)
    with torch.no_grad():
        (model.heads.reg.bias if task == "det" else model.seg_head.Conv_0.bias).fill_(float("nan"))
    save_pth(path, model, None, 0)
    return path


def test_debug_nans_stops_det_training(capsys, tmp_path, det_data, disco_ckpt):
    common = ["--data", det_data, "--grid", "32", "--batch", "2", "--com", "disco", "--nepoch", "1",
              "--device", "cpu", "--debug_nans", "1"]
    out, _ = _run(capsys, train_codet.main, [*common, "--logpath", str(tmp_path / "clean")])
    assert "epoch 1 done" in out and not torch.is_anomaly_enabled()
    nan = _planted(disco_ckpt, "disco", tiny_config(32, fusion_layer=1), str(tmp_path / "nan.pth"))
    with pytest.raises(SystemExit, match=r"^--debug_nans: step 1: .*nan"):
        train_codet.main([*common, "--logpath", str(tmp_path / "planted"), "--resume", nan])
    assert not torch.is_anomaly_enabled()


def test_debug_nans_stops_seg_training(capsys, tmp_path, seg_data):
    common = ["--data", seg_data, "--grid", "32", "--batch", "2", "--com", "disco", "--nepoch", "1",
              "--device", "cpu"]
    _run(capsys, seg_train.main, [*common, "--logpath", str(tmp_path)])
    cfg = tiny_config(32, fusion_layer=1)
    nan = _planted(str(tmp_path / "disco_seg"), "disco", cfg, str(tmp_path / "nan.pth"), task="seg")
    with pytest.raises(SystemExit, match=r"^--debug_nans: step 1: "):
        seg_train.main([*common, "--logpath", str(tmp_path / "planted"), "--resume", nan, "--debug_nans", "1"])


def test_first_nonfinite_names_loss_then_gradients():
    model = torch.nn.Linear(2, 2)
    model.weight.grad = torch.zeros(2, 2)
    model.bias.grad = torch.tensor([0.0, float("inf")])
    ok = {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(float("inf"))}
    assert profiling.first_nonfinite(ok, model) == "gradient of bias"
    assert profiling.first_nonfinite({**ok, "loss": torch.tensor(float("nan"))}, model) == "loss"
    model.bias.grad.zero_()
    assert profiling.first_nonfinite(ok, model) is None
