"""The port's KD feature cache, device prefetch, predict step and detection
CLIs.

CPU, 32-grid. Against the JAX package: the cache's byte count; the float32
predict step on a JAX-generated synthetic dataset (weights through
``state_dict_from_flax``), binary and 4-class: keep masks equal, boxes and
scores within 1e-4. Within the port: a KD step from a float32 cache equals
the re-forward step (rtol 1e-6) and one from a bf16 cache stays within
``BF16_CACHE_RTOL`` of it and equals (rtol 1e-6) the re-forward step whose
teacher taps are rounded to bf16; ``prefetch_to_device`` keeps order, passes errors on and
joins its worker on early close; ``pipeline_one_deep`` dispatches a batch
ahead. The CLIs run in-process with ``--device
cpu``: train, auto-resume, evaluate from ``ckpt/``, from a ``.pth`` and from
the log directory with ``--tracking`` and a padded tail batch, ``--save_best``,
the KD cycle (upperbound teacher, then DiscoNet from the cache), late fusion,
pose noise and the mesh flags, which are not ported. A ``gpu`` test runs the cycle
on the card; a ``slow`` one holds the port's ``test_codet`` table against the
JAX CLI's on the same ``.pth``. The JAX package is imported inside the tests
that compare with it, so that the ``gpu`` test collects on a machine without
JAX (``python -m pytest --noconftest tests/test_torch_port_cli.py -m gpu``).
"""

import functools
import importlib.util
import os
import re
import threading

import numpy as np
import pytest
import torch

from disconet_tpu_torch import build_model, tiny_config
from disconet_tpu_torch.checkpoint import load_state_dict_strict, restore_or_die, state_dict_from_flax
from disconet_tpu_torch.config import Config, default_fusion_layer
from disconet_tpu_torch.data.dataset import V2XSimDet, collate_det
from disconet_tpu_torch.tools.det import create_data_det, test_codet, train_codet
from disconet_tpu_torch.training import (
    batch_to_device,
    create_train_state,
    make_predict_step,
    make_train_step,
    pipeline_one_deep,
    precompute_teacher_feats,
    prefetch_to_device,
    teacher_feat_bytes,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(compute_dtype="float32", head_raw_dtype="float32")
# A KD step from bf16 tables against the re-forward step: the taps round to
# 8 mantissa bits (2^-9 relative), which moves the KD MSE by about as much.
BF16_CACHE_RTOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Few torch threads: XLA's CPU pool keeps its own busy in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the KD feature cache


@pytest.mark.parametrize("full,n,batch", [(True, 8, 4), (True, 9, 4), (False, 3, 2), (False, 5, 1)])
def test_teacher_feat_bytes_matches_jax(full, n, batch):
    import jax
    import jax.numpy as jnp

    from disconet_tpu.config import Config as JaxConfig
    from disconet_tpu.config import tiny_config as jax_tiny_config
    from disconet_tpu.models import TeacherNet as JaxTeacherNet
    from disconet_tpu.training import det_module as jdet

    jcfg, tcfg = (JaxConfig(), Config()) if full else (jax_tiny_config(32), tiny_config(32))
    teacher = JaxTeacherNet(config=jcfg)
    bev = jnp.zeros((1, jcfg.max_agents) + jcfg.bev_shape, jnp.float32)
    mask = jnp.ones((1, jcfg.max_agents), bool)
    tv = jax.eval_shape(lambda: teacher.init(jax.random.PRNGKey(0), bev, None, mask, train=False))
    want = jdet.teacher_feat_bytes(teacher, tv, jcfg, n, batch_size=batch)
    assert teacher_feat_bytes(tcfg, n, batch_size=batch) == want
    assert teacher_feat_bytes(tcfg, n, dtype=torch.float32, batch_size=batch) == 2 * want
    if full and n == 8:
        assert want == 8 * 141 * 2**20  # 141 MiB a scene-frame in bf16 at Config()


class _FakeDataset:
    """N frames with the keys the teacher pass reads."""

    def __init__(self, cfg, n, agents, seed=7):
        rng = np.random.default_rng(seed)
        H, W, Z = cfg.bev_shape
        self.items = [
            {"bev_teacher": (rng.random((agents, H, W, Z)) < 0.04).astype(np.float32),
             "agent_mask": np.ones((agents,), bool), "frame_idx": np.int32(i)}
            for i in range(n)
        ]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class _RoundedTaps(torch.nn.Module):
    """A teacher whose KD taps come back rounded to bf16 (held in fp32): the
    values a bf16 cache table holds."""

    def __init__(self, teacher):
        super().__init__()
        self.teacher = teacher

    def forward(self, *args):
        out = self.teacher(*args)
        return {**out, "kd_feats": [t.to(torch.bfloat16).float() for t in out["kd_feats"]]}


def test_kd_cache_step_matches_reforward():
    """A KD step from a float32 cache equals the re-forward step; one from a
    bf16 cache equals the re-forward step whose teacher taps are rounded to
    bf16 (so the step read the bf16 table) and differs from the float32 one.

    The teacher's BatchNorm running statistics are first set from its own
    batch statistics (training-mode forwards at momentum 0.9), so its
    eval-mode taps are of unit scale: with the identity statistics of a
    fresh initialization they are ~1e-2 next to the student's batch-normed
    taps, and rounding them moves the KD loss by less than a float32 ulp."""
    from disconet_tpu_torch import example_train_batch

    A = 2
    cfg = tiny_config(32, max_agents=A, **F32)
    ds = _FakeDataset(cfg, 3, A)
    teacher = build_model("teacher", cfg, device="cpu", seed=1)
    calib = torch.from_numpy(np.stack([ds[i]["bev_teacher"] for i in range(3)]))
    teacher.train()
    with torch.no_grad():
        for _ in range(40):
            teacher(calib, None, torch.ones((3, A), dtype=torch.bool))
    teacher.eval()
    tables = precompute_teacher_feats(teacher, ds, cfg, batch_size=2, dtype=torch.float32, num_workers=1)
    assert all(t.shape[0] == 4 and t.dtype == torch.float32 for t in tables)  # padded to whole batches
    assert sum(t.numel() * 4 for t in tables) == teacher_feat_bytes(cfg, 3, torch.float32, batch_size=2)

    host = example_train_batch(cfg, 2, A, seed=3, occupancy=(0.05, 0.1), boxes_per_frame=2)
    host["bev_teacher"] = np.stack([ds[2]["bev_teacher"], ds[0]["bev_teacher"]])  # out of dataset order
    host["agent_mask"][:] = True
    host["frame_idx"] = np.array([2, 0], np.int32)
    dev = batch_to_device(host, "cpu")
    assert dev["frame_idx"].tolist() == [2, 0]

    def first_step(**kw):
        model = build_model("disco", cfg, device="cpu", seed=0, kd_flag=True)
        return make_train_step(model, cfg, create_train_state(model), kd_flag=True, **kw)(dev)

    m_re = first_step(teacher=teacher)
    m_ca = first_step(kd_from_cache=tables)
    assert set(m_ca) == set(m_re) == {"loss", "cls_loss", "reg_loss", "kd_loss", "grad_norm"}
    for k in m_re:
        np.testing.assert_allclose(float(m_ca[k]), float(m_re[k]), rtol=1e-6, err_msg=k)
    bf16 = precompute_teacher_feats(teacher, ds, cfg, batch_size=2, num_workers=1)
    assert all(t.dtype == torch.bfloat16 for t in bf16)
    m_bf = first_step(kd_from_cache=bf16)
    for k in ("kd_loss", "loss"):
        rel = abs(float(m_bf[k]) - float(m_re[k])) / abs(float(m_re[k]))
        assert 0 < rel < BF16_CACHE_RTOL, (k, rel)
    m_rounded = first_step(teacher=_RoundedTaps(teacher))
    for k in m_rounded:
        np.testing.assert_allclose(float(m_bf[k]), float(m_rounded[k]), rtol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# prefetch_to_device (the JAX package's tests/test_training.py cases)


def test_prefetch_to_device_order():
    batches = [{"agent_mask": np.full((1, 1), i, np.int32)} for i in range(5)]
    out = list(prefetch_to_device(iter(batches), "cpu", depth=3))
    assert [int(b["agent_mask"][0, 0]) for b in out] == list(range(5))
    assert all(isinstance(b["agent_mask"], torch.Tensor) for b in out)


def test_prefetch_to_device_propagates_errors():
    def bad_to_device(b):
        raise RuntimeError("transfer failed")

    with pytest.raises(RuntimeError, match="transfer failed"):
        list(prefetch_to_device(iter([{"x": 1}]), "cpu", to_device=bad_to_device))

    def bad_batches():
        yield {"agent_mask": np.ones((1, 1), bool)}
        raise OSError("loader failed")

    with pytest.raises(OSError, match="loader failed"):
        list(prefetch_to_device(bad_batches(), "cpu"))


def test_prefetch_to_device_early_close_joins_worker():
    before = threading.active_count()
    started = []

    def to_device(b):
        started.append(threading.get_ident())
        return b

    gen = prefetch_to_device(iter([{"i": i} for i in range(10)]), "cpu", to_device=to_device, depth=2)
    assert next(gen) == {"i": 0}
    gen.close()
    assert threading.active_count() == before
    assert started and all(t != threading.get_ident() for t in started)  # ran off-thread
    assert len(started) <= 4  # stopped: not run to the end


def test_pipeline_one_deep_dispatches_ahead():
    events = []

    def dispatch(b):
        events.append(("dispatch", b))
        return (torch.tensor([b]), torch.tensor([b > 0]))

    got = []
    for b, (value, flag) in pipeline_one_deep(range(3), dispatch):
        events.append(("yield", b))
        assert isinstance(value, np.ndarray) and value.tolist() == [b] and flag.tolist() == [b > 0]
        got.append(b)
    assert got == [0, 1, 2]
    assert events == [("dispatch", 0), ("dispatch", 1), ("yield", 0), ("dispatch", 2), ("yield", 1), ("yield", 2)]


# ---------------------------------------------------------------------------
# the predict step against JAX's


@pytest.fixture(scope="module")
def jax_data(tmp_path_factory):
    """JAX-generated 32-grid datasets: binary and 4-class."""
    from disconet_tpu.config import tiny_config as jax_tiny_config
    from disconet_tpu.data.synthetic import generate_dataset as jax_generate_dataset

    out = {}
    for nc in (2, 4):
        root = str(tmp_path_factory.mktemp(f"jax_data_{nc}"))
        jax_generate_dataset(root, jax_tiny_config(32, num_classes=nc), num_scenes=1, frames_per_scene=2, seed=9)
        out[nc] = root
    return out


@pytest.mark.parametrize("nc", [2, 4])
def test_predict_step_matches_jax_on_synthetic_data(jax_data, nc):
    import jax
    import optax

    from disconet_tpu.config import tiny_config as jax_tiny_config
    from disconet_tpu.models import build_model as jax_build_model
    from disconet_tpu.training import det_module as jdet

    over = dict(F32, num_classes=nc, score_threshold=0.3 if nc == 2 else 0.2)
    tcfg, jcfg = tiny_config(32, **over), jax_tiny_config(32, **over)
    layer = default_fusion_layer(32)
    batch = collate_det([V2XSimDet(jax_data[nc], tcfg)[i] for i in range(2)])
    jmodel = jax_build_model("disco", jcfg, layer=layer)
    # jitted init: flax's eager init dispatches op by op, several times slower
    v = jax.jit(functools.partial(jmodel.init, train=False))(
        jax.random.PRNGKey(0), jdet.get_bev_np(batch, "bev", jcfg), batch["trans"], batch["agent_mask"])
    state = jdet.DetTrainState.create(apply_fn=jmodel.apply, params=v["params"], batch_stats=v["batch_stats"],
                                      tx=optax.identity())
    want = jax.device_get(jdet.make_predict_step(jmodel, jcfg)(state, jdet.batch_to_device(batch)))

    model = build_model("disco", tcfg, layer=layer, device="cpu")
    load_state_dict_strict(model, state_dict_from_flax(state.params, state.batch_stats))
    got = make_predict_step(model, tcfg)(batch_to_device(batch, "cpu"))
    assert len(got) == len(want) == (3 if nc == 2 else 4)
    boxes, scores, keep = (t.numpy() for t in got[:3])
    np.testing.assert_array_equal(keep, np.asarray(want[2]))
    assert keep.any() and not keep[~batch["agent_mask"]].any()
    np.testing.assert_allclose(boxes, np.asarray(want[0]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(scores, np.asarray(want[1]), atol=1e-4, rtol=0)
    if nc > 2:
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        assert set(np.unique(got[3].numpy()[keep])) <= {1, 2, 3}


# ---------------------------------------------------------------------------
# the CLIs, in-process


def _table(out):
    """{agent label: [mAP@0.5, mAP@0.7, #gt, #det]} of the last mAP table in ``out``."""
    block = out[out.rindex("Evaluated"):].split("\n\n")[0]
    rows = {}
    for line in block.splitlines():
        cols = [c.strip() for c in line.split("|")]
        if len(cols) == 5 and cols[0] != "agent":
            rows[cols[0]] = [float(cols[1]), float(cols[2]), int(cols[3]), int(cols[4])]
    return rows


def _run(capsys, main, argv):
    capsys.readouterr()
    result = main(argv)
    return capsys.readouterr().out, result


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_data"))
    create_data_det.main(["--data", root, "--split", "train", "--mode", "synthetic",
                          "--scenes", "1", "--frames", "3", "--grid", "32"])
    return os.path.join(root, "train")


def _gt_count(data):
    ds = V2XSimDet(data, tiny_config(32))
    return sum(len(g) for i in range(len(ds)) for g, m in zip(ds[i]["gt_boxes"], ds[i]["agent_mask"]) if m)


def _cycle(capsys, data, logs, device):
    """Train lowerbound 2 epochs, auto-resume to 3, evaluate from ckpt/, a
    .pth and the log directory (batch 1 against the padded batch 2)."""
    common = ["--data", data, "--grid", "32", "--batch", "2", "--logpath", logs, "--device", device]
    out, _ = _run(capsys, train_codet.main, [*common, "--bound", "lowerbound", "--nepoch", "2",
                                              "--log_every", "1", "--save_pth", "1"])
    assert "dataset: 3 scene-frames, 1 batches/epoch" in out and "training complete" in out
    losses = [float(v) for v in re.findall(r"epoch \d+ done .*?(?<![\w])loss=([\d.eE+-]+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert os.path.isfile(os.path.join(logs, "lowerbound", "epoch_2.pth"))
    assert sorted(os.listdir(os.path.join(logs, "lowerbound", "ckpt"))) == ["1.pth", "2.pth"]

    out, _ = _run(capsys, train_codet.main, [*common, "--bound", "lowerbound", "--nepoch", "3",
                                              "--log_every", "1", "--save_pth", "0", "--ckpt_keep", "2",
                                              "--auto_resume_path", logs])
    assert "auto-resumed from epoch 2" in out and "epoch 3 done" in out and "epoch 1 done" not in out
    assert sorted(os.listdir(os.path.join(logs, "lowerbound", "ckpt"))) == ["2.pth", "3.pth"]
    assert not os.path.exists(os.path.join(logs, "lowerbound", "epoch_3.pth"))

    out, result = _run(capsys, test_codet.main, [*common, "--bound", "lowerbound", "--tracking",
                                                  "--resume", os.path.join(logs, "lowerbound", "ckpt")])
    assert "(epoch 3)" in out and "Evaluated 3 scene-frames" in out
    t2 = _table(out)
    assert t2["average"][2] == _gt_count(data) and set(result) == {"mAP@0.5", "mAP@0.7", "scenes_per_s"}
    det_dir = os.path.join(logs, "lowerbound", "with_rsu", "test", "det_dumps")
    dumps = os.listdir(det_dir)
    assert dumps and all(re.fullmatch(r"det_agent\d_scene0\.txt", f) for f in dumps)
    row = open(os.path.join(det_dir, dumps[0])).readline().strip().split(",")
    assert len(row) == 7 and int(row[0]) in (0, 1, 2)

    out, _ = _run(capsys, test_codet.main, [*common, "--bound", "lowerbound",
                                             "--resume", os.path.join(logs, "lowerbound", "epoch_2.pth")])
    assert "loaded checkpoint from" in out and "(epoch 2)" in out

    # --resume the log directory (ckpt/ resolution) at batch 1: the padded
    # tail of batch 2 leaves the table as it was, but for marginal boxes
    out, _ = _run(capsys, test_codet.main, [*common[:5], "1", *common[6:], "--bound", "lowerbound",
                                             "--resume", os.path.join(logs, "lowerbound")])
    t1 = _table(out)
    assert t1.keys() == t2.keys()
    for k in t1:
        assert abs(t1[k][0] - t2[k][0]) <= 0.02 and abs(t1[k][1] - t2[k][1]) <= 0.02, (t1[k], t2[k])
        assert t1[k][2] == t2[k][2]
        assert abs(t1[k][3] - t2[k][3]) <= (6 if k == "average" else 2), (t1[k], t2[k])


def test_cli_cycle_on_cpu(capsys, cli_data, tmp_path):
    _cycle(capsys, cli_data, str(tmp_path / "logs"), "cpu")


def test_cli_save_best(capsys, cli_data, tmp_path):
    logs = str(tmp_path / "logs")
    common = ["--data", cli_data, "--grid", "32", "--batch", "2", "--logpath", logs, "--device", "cpu"]
    out, _ = _run(capsys, train_codet.main, [*common, "--bound", "lowerbound", "--nepoch", "3",
                                              "--log_every", "1", "--save_pth", "0", "--save_best", "1",
                                              "--ckpt_every", "3"])
    best_path = os.path.join(logs, "lowerbound", "best.pth")
    recs = re.findall(r"best checkpoint: epoch (\d+) loss=([\d.eE+-]+)", out)
    assert os.path.isfile(best_path) and len(recs) == 1
    ep_losses = {int(e): float(v) for e, v in re.findall(r"epoch (\d+) done .*?(?<![\w])loss=([\d.eE+-]+)", out)}
    assert len(ep_losses) == 3
    assert float(recs[0][1]) == pytest.approx(min(ep_losses.values()), abs=1e-5)
    assert ep_losses[int(recs[0][0])] == min(ep_losses.values())
    assert restore_or_die(best_path, build_model("", tiny_config(32), layer=1, device="cpu"))[0] == int(recs[0][0])
    out, _ = _run(capsys, test_codet.main, [*common, "--bound", "lowerbound", "--resume", best_path])
    assert "average" in out


def test_cli_kd_cycle_late_fusion_and_pose_noise(capsys, cli_data, tmp_path):
    logs = str(tmp_path / "logs")
    common = ["--data", cli_data, "--grid", "32", "--batch", "2", "--logpath", logs, "--device", "cpu"]
    _run(capsys, train_codet.main, [*common, "--bound", "upperbound", "--nepoch", "1"])
    teacher = os.path.join(logs, "upperbound", "epoch_1.pth")
    out, _ = _run(capsys, train_codet.main, [*common, "--com", "disco", "--kd_flag", "1", "--nepoch", "2",
                                              "--resume_teacher", teacher, "--log_every", "1"])
    assert "loaded frozen teacher" in out and re.search(r"KD cache: \d+ MiB", out)
    kd = [float(v) for v in re.findall(r"epoch \d+ done .*?kd_loss=([\d.eE+-]+)", out)]
    assert len(kd) == 2 and all(np.isfinite(kd)) and os.path.isfile(os.path.join(logs, "disco_kd", "epoch_2.pth"))
    out, _ = _run(capsys, train_codet.main, [*common, "--com", "disco", "--kd_flag", "1", "--nepoch", "1",
                                              "--resume_teacher", teacher, "--kd_cache", "0",
                                              "--logpath", str(tmp_path / "reforward")])
    assert "KD cache" not in out and "training complete" in out
    with pytest.raises(SystemExit, match="no checkpoint found"):
        train_codet.main([*common, "--com", "disco", "--kd_flag", "1", "--resume_teacher", teacher + "x"])

    disco = ["--com", "disco", "--resume", os.path.join(logs, "disco_kd", "epoch_2.pth")]
    tables = {}
    for name, extra in (("plain", []), ("late", ["--apply_late_fusion", "1"]),
                        ("noise", ["--pose_noise_std", "0.2", "--pose_noise_rot_std", "0.05"])):
        out, _ = _run(capsys, test_codet.main, [*common, *disco, *extra])
        tables[name] = _table(out)
        assert tables[name]["average"][2] == _gt_count(cli_data)
    out, _ = _run(capsys, test_codet.main, [*common, *disco, "--pose_noise_std", "0.2", "--pose_noise_rot_std", "0.05"])
    assert _table(out) == tables["noise"]  # the noise rng is local to a run


# ---------------------------------------------------------------------------
# on the card, and against the JAX CLI


@pytest.mark.gpu
def test_cli_cycle_on_the_card(capsys, cli_data, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix

    before = rotated_iou_matrix.launches
    _cycle(capsys, cli_data, str(tmp_path / "logs"), "cuda")
    assert rotated_iou_matrix.launches >= before + 2 + 2 + 3  # a launch per predict batch


@pytest.mark.slow
def test_test_codet_table_matches_the_jax_cli(capsys, cli_data, tmp_path):
    """The port's table and the JAX CLI's on the port's ``.pth``, at the
    tolerances of tests/test_cli_integration.py: bf16 on both sides, and
    marginal boxes may cross a threshold."""
    logs = str(tmp_path / "logs")
    common = ["--data", cli_data, "--grid", "32", "--batch", "2", "--logpath", logs]
    train_codet.main([*common, "--bound", "lowerbound", "--nepoch", "3", "--device", "cpu"])
    resume = ["--bound", "lowerbound", "--resume", os.path.join(logs, "lowerbound", "epoch_3.pth")]
    port, _ = _run(capsys, test_codet.main, [*common, *resume, "--device", "cpu"])
    spec = importlib.util.spec_from_file_location("jax_test_codet", os.path.join(ROOT, "tools/det/test_codet.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    ref, _ = _run(capsys, jax_cli.main, [*common, *resume])
    tp, tj = _table(port), _table(ref)
    assert tp.keys() == tj.keys()
    for k in tp:
        assert abs(tp[k][0] - tj[k][0]) <= 0.02 and abs(tp[k][1] - tj[k][1]) <= 0.02, (tp[k], tj[k])
        assert tp[k][2] == tj[k][2]
        assert abs(tp[k][3] - tj[k][3]) <= (6 if k == "average" else 2), (tp[k], tj[k])
