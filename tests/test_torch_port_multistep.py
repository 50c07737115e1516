"""K optimizer steps per dispatch in the port (``make_train_step_multi``,
``stack_host_batches``) against the JAX package's ``lax.scan`` of the step,
and the det CLI's ``--steps_per_dispatch``.

CPU, float32 32-grid DiscoNet, batch 2 x 2 agents with one absent (the
batches of ``test_torch_port_training``). On the CPU the K steps run one by
one; on the card they are one CUDA graph (the ``gpu`` tests of
``test_torch_port_graph.py`` and ``chip_smoke.py`` phase 12). Held here:

* ``stack_host_batches``: every array leaf equal to JAX's, list keys dropped;
* K = 3 with JAX's SGD recipe (``tests/test_training.py``), port against
  JAX: the port's first step identical to its single step and within 1e-6
  of JAX's, the later steps' losses and the BatchNorm statistics after the
  K steps within the limits that the trajectory's chaos leaves (see
  ``MULTI_LOSS_RTOL``), limits that planted threading faults break;
* K = 3 with Adam: metrics, parameters, BatchNorm statistics and Adam's
  state equal to K sequential single steps;
* the capture's warm-up bookkeeping: what the warm-up steps change is put
  back, and Adam's state that they create starts as Adam's first step does;
* ``train_codet --steps_per_dispatch 2`` over 3 batches an epoch (a tail
  group of 1): the step counts of the K = 1 run and equal weights.

``python tests/test_torch_port_multistep.py`` (with the repo on
``PYTHONPATH``) prints the training-trajectory diagnosis instead: 20 float32
Adam steps of DiscoNet and of the lowerbound from the same weights on
batches of the occluded synthetic data at the 32-grid, port against JAX,
with each group's relative parameter distance at steps 1, 5 and 20.
"""

import os
import re
import sys
from unittest import mock

import numpy as np
import jax
import optax
import pytest
import torch

from disconet_tpu.models import build_model as jax_build_model
from disconet_tpu.training import det_module as jdet
from disconet_tpu_torch import build_model
from disconet_tpu_torch.checkpoint import load_state_dict_strict, state_dict_from_flax
from disconet_tpu_torch.tools.det import create_data_det, train_codet
from disconet_tpu_torch.training import (
    batch_to_device,
    create_train_state,
    make_train_step,
    make_train_step_multi,
    stack_host_batches,
)
from disconet_tpu_torch.training.det_module import _restore, _snapshot
from test_torch_port_training import JCFG, TCFG, _host_batch

K = 3
# Port K-step dispatch against JAX's, K SGD steps at lr 1e-2 from the same
# weights. The JAX package holds its scan against its own loop at rtol 1e-4
# (losses) and 1e-3 (statistics), but the trajectory is chaotic: a float32
# rounding difference grows ~100x a step. Across the packages the first
# step's loss parts by ~1e-7, and the port's own step-3 loss moves by
# 1.1e-3 to 1.8e-3 between 1, 2 and 4 CPU threads, its BatchNorm
# statistics by 3.9e-3 (relative L2 per tensor; elementwise, running means
# near 0 move by 30x an rtol 1e-3 / atol 1e-5 limit). So step 1 is held at
# 1e-6, steps 2..K and the statistics at limits above that floor, which a
# planted fault of the threading must break (test_multi_step_sgd_gate).
STEP1_RTOL = 1e-6
MULTI_LOSS_RTOL = 5e-3
MULTI_STATS_REL_L2 = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Few torch threads: XLA's CPU pool keeps its own busy in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _batches():
    return [_host_batch(seed=s) for s in range(K)]


def _jax_start(model, batch):
    """A JAX train state of ``model`` (Adam) and the port's state_dict of
    its initial variables."""
    state = jdet.create_train_state(model, JCFG, jax.random.PRNGKey(0), batch)
    return state, state_dict_from_flax(state.params, state.batch_stats)


def _port(sd, com="disco"):
    return load_state_dict_strict(build_model(com, TCFG, device="cpu"), sd)


def _stats(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def test_stack_host_batches_matches_jax():
    from disconet_tpu.training import stack_host_batches as jax_stack

    batches = _batches()
    for b in batches:
        b["gt_boxes"] = [np.zeros((1, 5), np.float32)] * 2  # a list key: never stacked
    got, want = stack_host_batches(batches), jax_stack(batches)
    assert set(got) == set(want) == set(batches[0]) - {"gt_boxes"}
    for k in want:
        assert got[k].shape == (K,) + batches[0][k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def sgd_run():
    """JAX's ``make_train_step_multi`` over K batches with SGD(1e-2), the JAX
    package's recipe: its per-step losses and BatchNorm statistics, and the
    port's state_dict of the start."""
    batches = _batches()
    model = jax_build_model("disco", JCFG)
    state, sd = _jax_start(model, batches[0])
    tx = optax.sgd(1e-2)
    state = state.replace(tx=tx, opt_state=tx.init(state.params))
    state, m_jax = jdet.make_train_step_multi(model, JCFG)(
        state, jdet.batch_to_device(stack_host_batches(batches)), None)
    return batches, sd, np.asarray(m_jax["loss"]), state_dict_from_flax({}, state.batch_stats)


def _port_sgd(sd, batches, fault=None):
    """The port's K-step dispatch with SGD(1e-2) -> (metrics, the model).
    ``fault`` plants a threading error: "order" runs the batches in another
    order, "stats" drops each step's BatchNorm statistics update."""
    port = _port(sd)
    if fault == "order":
        batches = [batches[0], batches[2], batches[1]]
    step = make_train_step_multi(port, TCFG, torch.optim.SGD(port.parameters(), lr=1e-2))
    stacked = batch_to_device(stack_host_batches(batches), "cpu")
    if fault == "stats":
        from disconet_tpu_torch.models import backbone

        with mock.patch.object(backbone, "_update_running", lambda *a: None):
            return step(stacked), port
    return step(stacked), port


def _stats_distance(port, want):
    pstats = _stats(port)
    assert set(pstats) == set(want)
    return max(float(torch.linalg.vector_norm(pstats[k] - v) / torch.linalg.vector_norm(v)) for k, v in want.items())


def test_multi_step_matches_jax_sgd(sgd_run):
    """K SGD steps: the port's dispatch against JAX's ``lax.scan`` dispatch,
    from the same weights. Step 1 is the port's single step bit for bit."""
    batches, sd, want, jstats = sgd_run
    got, port = _port_sgd(sd, batches)
    assert set(got) == {"loss", "cls_loss", "reg_loss", "grad_norm"}
    assert all(v.shape == (K,) for v in got.values())
    single = _port(sd)
    first = make_train_step(single, TCFG, torch.optim.SGD(single.parameters(), lr=1e-2))(
        batch_to_device(batches[0], "cpu"))
    assert all(torch.equal(got[k][0], first[k]) for k in first)
    np.testing.assert_allclose(got["loss"][0].item(), want[0], rtol=STEP1_RTOL)
    np.testing.assert_allclose(got["loss"].numpy(), want, rtol=MULTI_LOSS_RTOL)
    assert _stats_distance(port, jstats) < MULTI_STATS_REL_L2


@pytest.mark.parametrize("fault", ["order", "stats"])
def test_multi_step_sgd_gate(sgd_run, fault):
    """The limits of ``test_multi_step_matches_jax_sgd`` catch a K-step
    dispatch that threads the steps wrongly: the batches in another order
    (the losses) or the statistics not carried (the statistics)."""
    batches, sd, want, jstats = sgd_run
    got, port = _port_sgd(sd, batches, fault)
    if fault == "order":
        assert np.abs(got["loss"].numpy() / want - 1).max() > MULTI_LOSS_RTOL
    else:
        assert _stats_distance(port, jstats) > MULTI_STATS_REL_L2


def test_multi_step_adam_equals_sequential():
    """Adam threads its moments and step count through the K steps: the
    dispatch equals K single steps in metrics, weights, BatchNorm
    statistics and Adam's state."""
    batches = _batches()
    sd = build_model("disco", TCFG, device="cpu", seed=5).state_dict()
    seq, multi = _port(sd), _port(sd)
    opt_s, opt_m = create_train_state(seq), create_train_state(multi)
    step = make_train_step(seq, TCFG, opt_s)
    want = [step(batch_to_device(b, "cpu")) for b in batches]
    got = make_train_step_multi(multi, TCFG, opt_m)(batch_to_device(stack_host_batches(batches), "cpu"))
    for k in want[0]:
        assert torch.equal(got[k], torch.stack([w[k] for w in want])), k
    for (name, a), b in zip(seq.state_dict().items(), multi.state_dict().values()):
        assert torch.equal(a, b), name
    for p_s, p_m in zip(seq.parameters(), multi.parameters()):
        s_state, m_state = opt_s.state[p_s], opt_m.state[p_m]
        assert set(s_state) == set(m_state) == {"step", "exp_avg", "exp_avg_sq"}
        assert all(torch.equal(s_state[k], m_state[k]) for k in s_state)


@pytest.mark.parametrize("started", [False, True])
def test_capture_warmup_is_undone(started):
    """What the CUDA graph's warm-up steps change (``_snapshot`` before,
    ``_restore`` after) is put back: parameters, BatchNorm statistics and
    Adam's state. State the warm-up created (a fresh optimizer) restarts at
    zero, so the next step equals the first step of a fresh Adam."""
    b0, b1 = (batch_to_device(b, "cpu") for b in _batches()[:2])
    sd = build_model("disco", TCFG, device="cpu", seed=6).state_dict()
    model, ref = _port(sd), _port(sd)
    opt, opt_ref = create_train_state(model), create_train_state(ref)
    step, step_ref = make_train_step(model, TCFG, opt), make_train_step(ref, TCFG, opt_ref)
    if started:  # a resumed run: Adam's state exists before the capture
        step(b1)
        step_ref(b1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    saved = _snapshot(model, opt)
    for _ in range(2):
        step(b0)
    _restore(saved, opt)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    got, want = step(b0), step_ref(b0)
    assert all(torch.equal(got[k], want[k]) for k in want)
    for p, q in zip(model.parameters(), ref.parameters()):
        assert torch.equal(p, q)
        assert all(torch.equal(opt.state[p][k], opt_ref.state[q][k]) for k in opt_ref.state[q])


def _epoch_lines(out):
    return [(int(e), int(s)) for e, s in re.findall(r"epoch (\d+) done step (\d+):", out)]


def test_cli_steps_per_dispatch_with_a_tail(capsys, tmp_path):
    """``--steps_per_dispatch 2`` over 3 batches an epoch: a group of 2 and a
    tail of 1. ``step`` advances by each group's length, as with K = 1, and
    the weights after 2 epochs equal the K = 1 run's (on the CPU the K steps
    are the same single steps, so the limit is equality)."""
    root = str(tmp_path / "data")
    create_data_det.main(["--data", root, "--split", "train", "--scenes", "1", "--frames", "6", "--grid", "32"])
    common = ["--data", os.path.join(root, "train"), "--grid", "32", "--batch", "2", "--com", "disco",
              "--nepoch", "2", "--device", "cpu", "--log_every", "1", "--nworker", "1"]
    runs = {}
    for k in (1, 2):
        logs = str(tmp_path / f"k{k}")
        capsys.readouterr()
        train_codet.main([*common, "--logpath", logs, "--steps_per_dispatch", str(k)])
        out = capsys.readouterr().out
        runs[k] = (out, torch.load(os.path.join(logs, "disco", "epoch_2.pth"), weights_only=True))
    assert _epoch_lines(runs[1][0]) == _epoch_lines(runs[2][0]) == [(1, 3), (2, 6)]
    steps = [int(s) for s in re.findall(r"epoch \d+ step (\d+):", runs[2][0])]
    assert steps == [2, 3, 5, 6]  # a line a dispatch: a group of 2, then the tail of 1
    w1, w2 = runs[1][1]["model_state_dict"], runs[2][1]["model_state_dict"]
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert runs[1][1]["loss"] == runs[2][1]["loss"]


@pytest.mark.parametrize("flags,needle", [
    (["--steps_per_dispatch", "2", "--mesh_agent", "2"], "single-device only"),
    (["--steps_per_dispatch", "2", "--mesh_spatial", "2"], "single-device only"),
])
def test_cli_steps_per_dispatch_is_single_device(tmp_path, flags, needle):
    with pytest.raises(SystemExit, match=needle):
        train_codet.main(["--data", str(tmp_path), "--grid", "32", "--device", "cpu", *flags])


# ---------------------------------------------------------------------------
# the training-trajectory diagnosis (not a test)


def _groups(name):
    if name.startswith("stpn.stages_"):
        return "encoder"
    if name.startswith(("stpn.dec_", "stpn.head_conv")):
        return "decoder"
    return "heads" if name.startswith("heads.") else "fusion"


def trajectory(com: str, steps=(1, 5, 20), seed: int = 0):
    """Per-group relative L2 distance between the port's and JAX's
    parameters after ``steps`` float32 Adam steps from the same weights, on
    batches of the occluded synthetic data at the 32-grid (2 scenes x 4
    frames, batch 2, the dataset's own order)."""
    import tempfile

    from disconet_tpu.data import BatchIterator as JaxBatchIterator
    from disconet_tpu.data.dataset import V2XSimDet as JaxV2XSimDet

    root = tempfile.mkdtemp(prefix="traj_")
    create_data_det.main(["--data", root, "--split", "train", "--scenes", "2", "--frames", "4", "--grid", "32",
                          "--occlusion", "1"])
    ds = JaxV2XSimDet(os.path.join(root, "train"), JCFG, dense_targets=False)
    batches = list(JaxBatchIterator(ds, 2, shuffle=False, num_workers=1))
    model = jax_build_model(com, JCFG)
    state, sd = _jax_start(model, batches[0])
    port = _port(sd, com)
    opt = create_train_state(port)
    jstep = jdet.make_train_step(model, JCFG)
    pstep = make_train_step(port, TCFG, opt)
    rows = {}
    for n in range(1, max(steps) + 1):
        b = batches[(n - 1) % len(batches)]
        state, _ = jstep(state, jdet.batch_to_device(b), None)
        pstep(batch_to_device(b, "cpu"))
        if n in steps:
            want = state_dict_from_flax(state.params, {})
            num, den = {}, {}
            for name, p in port.named_parameters():
                g = _groups(name)
                num[g] = num.get(g, 0.0) + float(((p.detach() - want[name]) ** 2).sum())
                den[g] = den.get(g, 0.0) + float((want[name] ** 2).sum())
            rows[n] = {g: (num[g] / den[g]) ** 0.5 for g in num}
    return rows


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    for com in ("disco", "lowerbound"):
        for n, row in trajectory(com).items():
            print(f"{com:<11} step {n:>2}: " + ", ".join(f"{g} {v:.3e}" for g, v in sorted(row.items())), flush=True)
    sys.exit(0)
