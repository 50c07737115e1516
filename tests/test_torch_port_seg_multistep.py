"""K seg optimizer steps per dispatch in the port
(``make_seg_train_step_multi``) against the JAX package's, and the seg
CLI's ``--steps_per_dispatch``.

CPU, float32 32-grid DiscoNet on the UNet, batch 2 x 3 agent slots with one
absent (the config of ``test_torch_port_seg``). As for detection
(``test_torch_port_multistep``): K = 3 SGD(1e-2) steps from the same
weights, port against JAX's ``lax.scan`` dispatch: the first step the
port's single step bit for bit and within 1e-6 of JAX's, the later losses
and the BatchNorm statistics within the limits that the trajectory's chaos
leaves, which a planted threading fault breaks; with Adam, the dispatch
equal to K sequential single steps.
"""

import os
import re
from unittest import mock

import numpy as np
import jax
import optax
import pytest
import torch

from disconet_tpu.models import build_model as jax_build_model
from disconet_tpu.training import det_module as jdet
from disconet_tpu.training import seg_module as jseg
from disconet_tpu_torch import build_model
from disconet_tpu_torch.checkpoint import load_state_dict_strict, state_dict_from_flax
from disconet_tpu_torch.tools.seg import create_data_seg, train_codet
from disconet_tpu_torch.training import (
    batch_to_device,
    create_seg_train_state,
    make_seg_train_step,
    make_seg_train_step_multi,
    stack_host_batches,
)
from test_torch_port_multistep import MULTI_LOSS_RTOL, MULTI_STATS_REL_L2, STEP1_RTOL
from test_torch_port_seg import LAYER, MASK, _cfgs

K = 3
JCFG, TCFG = _cfgs("unet")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Few torch threads: XLA's CPU pool keeps its own busy in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _batch(seed):
    """Grids at 5% occupancy, random poses, agent (1, 2) absent; random
    labels (seed 0) or every cell of class 3 * seed mod 8, so that the
    batches' losses differ."""
    rng = np.random.default_rng(seed)
    B, A = MASK.shape
    trans = np.tile(np.eye(4, dtype=np.float32), (B, A, A, 1, 1))
    for b in range(B):
        for i in range(A):
            for j in range(A):
                if i != j:
                    th = rng.uniform(-0.5, 0.5)
                    trans[b, i, j, :2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
                    trans[b, i, j, :2, 3] = rng.uniform(-2.0, 2.0, 2)
    return {"bev": (rng.random((B, A, 32, 32, 13)) < 0.05).astype(np.uint8), "trans": trans,
            "agent_mask": MASK.copy(),
            "seg_label": (rng.integers(0, 8, (B, A, 32, 32)) if seed == 0
                          else np.full((B, A, 32, 32), 3 * seed % 8)).astype(np.int32)}


def _port(sd):
    return load_state_dict_strict(build_model("disco", TCFG, layer=LAYER, device="cpu", task="seg"), sd)


def _stats_distance(port, want):
    pstats = {k: v for k, v in port.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    assert set(pstats) == set(want)
    return max(float(torch.linalg.vector_norm(pstats[k] - v) / torch.linalg.vector_norm(v)) for k, v in want.items())


@pytest.fixture(scope="module")
def sgd_run():
    batches = [_batch(s) for s in range(K)]
    model = jax_build_model("disco", JCFG, layer=LAYER, task="seg")
    state = jdet.create_train_state(model, JCFG, jax.random.PRNGKey(0), batches[0])
    sd = state_dict_from_flax(state.params, state.batch_stats)
    tx = optax.sgd(1e-2)
    state = state.replace(tx=tx, opt_state=tx.init(state.params))
    state, m = jseg.make_seg_train_step_multi(model, JCFG)(state, jdet.batch_to_device(stack_host_batches(batches)))
    return batches, sd, {k: np.asarray(v) for k, v in m.items()}, state_dict_from_flax({}, state.batch_stats)


def _port_sgd(sd, batches, fault=None):
    port = _port(sd)
    if fault == "order":
        batches = [batches[0], batches[2], batches[1]]
    step = make_seg_train_step_multi(port, TCFG, torch.optim.SGD(port.parameters(), lr=1e-2))
    stacked = batch_to_device(stack_host_batches(batches), "cpu")
    if fault == "stats":
        from disconet_tpu_torch.models import backbone

        with mock.patch.object(backbone, "_update_running", lambda *a: None):
            return step(stacked), port
    return step(stacked), port


def test_seg_multi_step_matches_jax_sgd(sgd_run):
    batches, sd, want, jstats = sgd_run
    got, port = _port_sgd(sd, batches)
    assert set(got) == set(want) == {"loss", "acc"} and got["loss"].shape == (K,)
    single = _port(sd)
    first = make_seg_train_step(single, TCFG, torch.optim.SGD(single.parameters(), lr=1e-2))(
        batch_to_device(batches[0], "cpu"))
    assert all(torch.equal(got[k][0], first[k]) for k in first)
    np.testing.assert_allclose(got["loss"][0].item(), want["loss"][0], rtol=STEP1_RTOL)
    np.testing.assert_allclose(got["loss"].numpy(), want["loss"], rtol=MULTI_LOSS_RTOL)
    assert _stats_distance(port, jstats) < MULTI_STATS_REL_L2


@pytest.mark.parametrize("fault", ["order", "stats"])
def test_seg_multi_step_sgd_gate(sgd_run, fault):
    batches, sd, want, jstats = sgd_run
    got, port = _port_sgd(sd, batches, fault)
    if fault == "order":
        assert np.abs(got["loss"].numpy() / want["loss"] - 1).max() > MULTI_LOSS_RTOL
    else:
        assert _stats_distance(port, jstats) > MULTI_STATS_REL_L2


def test_seg_multi_step_adam_equals_sequential():
    batches = [_batch(s) for s in range(K)]
    sd = build_model("disco", TCFG, layer=LAYER, device="cpu", seed=3, task="seg").state_dict()
    seq, multi = _port(sd), _port(sd)
    opt_s, opt_m = create_seg_train_state(seq), create_seg_train_state(multi)
    step = make_seg_train_step(seq, TCFG, opt_s)
    want = [step(batch_to_device(b, "cpu")) for b in batches]
    got = make_seg_train_step_multi(multi, TCFG, opt_m)(batch_to_device(stack_host_batches(batches), "cpu"))
    for k in want[0]:
        assert torch.equal(got[k], torch.stack([w[k] for w in want])), k
    for (name, a), b in zip(seq.state_dict().items(), multi.state_dict().values()):
        assert torch.equal(a, b), name
    for p_s, p_m in zip(seq.parameters(), multi.parameters()):
        assert all(torch.equal(opt_s.state[p_s][k], opt_m.state[p_m][k]) for k in opt_s.state[p_s])


def test_seg_cli_steps_per_dispatch_with_a_tail(capsys, tmp_path):
    """``--steps_per_dispatch 2`` over 3 batches an epoch: the step counts and
    the checkpoint's weights of the K = 1 run."""
    root = str(tmp_path / "data")
    create_data_seg.main(["--data", root, "--split", "train", "--scenes", "1", "--frames", "6", "--grid", "32"])
    common = ["--data", os.path.join(root, "train"), "--grid", "32", "--batch", "2", "--com", "disco",
              "--nepoch", "2", "--device", "cpu", "--log_every", "1", "--nworker", "1"]
    runs = {}
    for k in (1, 2):
        logs = str(tmp_path / f"k{k}")
        capsys.readouterr()
        train_codet.main([*common, "--logpath", logs, "--steps_per_dispatch", str(k)])
        out = capsys.readouterr().out
        runs[k] = (re.findall(r"epoch (\d+) done step (\d+):", out),
                   torch.load(os.path.join(logs, "disco_seg", "ckpt", "2.pth"), weights_only=True))
    assert runs[1][0] == runs[2][0] == [("1", "3"), ("2", "6")]
    w1, w2 = runs[1][1]["model_state_dict"], runs[2][1]["model_state_dict"]
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
