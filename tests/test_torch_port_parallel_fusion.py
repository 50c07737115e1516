"""Every other ``--com`` under the ``agent`` and ``spatial`` mesh axes, on a CPU
gloo group, against the one-process step.

One spawn of 2 ranks per layout (``tests/test_torch_port_parallel.py``'s
``spawn``), each running ``sum``, ``mean``, ``max``, ``cat``, ``agent``,
``v2v``, ``when2com`` and ``who2com`` in turn, 4 agents with one absent:

* ``agent2`` (1, 2, 1) at the 32-grid, 2 scenes;
* ``spatial2`` (1, 1, 2) at the 64-grid, 1 scene: When2com's handshake runs
  two stride-2 convs on each strip of the fusion-layer map, so a strip
  needs a multiple of 4 rows (8 rows over 2 ranks; the 32-grid's 4 rows
  give strips of 2, which the model refuses by name).

Each model's train step, the float32 mode computed in float64, is held to
the one-process float64 step from the same weights and batch at
``chip_smoke.P13_F64_REL``
(metrics, each group of layers' gradients in relative L2, BatchNorm
statistics): the sharded step is the same arithmetic in another order, so
a sharding error of any size above rounding breaks it. Each ``predict``
(float32) is held to the one-process ``predict`` (equal keep counts, the
kept scores and boxes matched); DiscoNet's ``predict`` under both layouts
too. Two planted faults break the gradient bound: the spatial mean of
``agent``'s scorer and When2com's handshake pool taken over a rank's strip
alone (``Mesh.spatial_mean`` without its all_reduce), and V2VNet's second
round reading an all_gather whose all_reduce was skipped (a rank sees its
own senders' states only).
"""

import contextlib
import copy
import functools
from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import P13_F64_REL, _float64, _group_distances  # groups: encoder, decoder, heads, "fusion" the rest
from disconet_tpu_torch import build_model, example_train_batch, tiny_config
from disconet_tpu_torch.models.v2v_net import V2VNet
from disconet_tpu_torch.parallel import attach_mesh, make_mesh, shard_batch
from disconet_tpu_torch.parallel.mesh import Mesh
from disconet_tpu_torch.training import batch_to_device, create_train_state, make_predict_step, make_train_step
from test_torch_port_parallel import GRAD_REL_L2, _assert_detections_equivalent, _step_result, spawn

COMS = ("sum", "mean", "max", "cat", "agent", "v2v", "when2com", "who2com")
# layout -> (n_data, n_agent, n_spatial), grid, scenes
LAYOUTS = {"agent2": ((1, 2, 1), 32, 2), "spatial2": ((1, 1, 2), 64, 1)}
A = 4


def _config(layout: str):
    return tiny_config(LAYOUTS[layout][1], compute_dtype="float32", head_raw_dtype="float32", max_agents=A)


@functools.lru_cache(maxsize=None)
def _host(layout: str):
    _, grid, scenes = LAYOUTS[layout]
    host = example_train_batch(_config(layout), scenes, A, seed=3, occupancy=(0.05, 0.1), boxes_per_frame=4)
    host["agent_mask"][0, A - 1] = False  # an absent agent in every layout
    return host


# ---------------------------------------------------------------------------
# the planted faults


def _strip_mean(self, x, dims):
    """A planted fault: the spatial mean of a rank's strip alone."""
    return x.mean(dim=dims)


def _skip_second_gather():
    """A planted fault: V2VNet's second gather of a forward (its round 2)
    returns what an all_gather without its all_reduce holds: the rank's own
    states in their slot, zeros in the others'."""
    calls = []
    real = V2VNet.gather_senders

    def gather(self, x):
        calls.append(1)
        if len(calls) != 2:
            return real(self, x)
        mesh = self.mesh
        full = x.new_zeros((x.shape[0], x.shape[1] * mesh.axis_size("agent"), x.shape[2] * mesh.axis_size("spatial"))
                           + tuple(x.shape[3:]))
        a, h = mesh.coords["agent"] * x.shape[1], mesh.coords["spatial"] * x.shape[2]
        full[:, a:a + x.shape[1], h:h + x.shape[2]] = x
        return full

    return mock.patch.object(V2VNet, "gather_senders", gather)


# fault -> (the models it is planted in, the layouts, the patch)
FAULTS = {
    "strip_pool": (("agent", "when2com"), ("spatial2",), lambda: mock.patch.object(Mesh, "spatial_mean", _strip_mean)),
    "v2v_round2_gather": (("v2v",), ("agent2", "spatial2"), _skip_second_gather),
}
FAULT_CASES = [(f, c, lay) for f, (coms, lays, _) in FAULTS.items() for c in coms for lay in lays]


# ---------------------------------------------------------------------------
# what the ranks run (and one process)


_built: dict = {}


def _fresh(com, cfg):
    """A copy of the model of ``com`` drawn from seed 0 (drawn once a
    process: the draw costs more than a step)."""
    key = (com, cfg.bev_shape)
    if key not in _built:
        _built[key] = build_model(com, cfg, device="cpu", seed=0)
    return copy.deepcopy(_built[key])


def _train(com, layout, mesh=None, patch=contextlib.nullcontext):
    """One float64 train step of ``com`` from seed 0's weights on the
    layout's batch (this rank's slice under ``mesh``)."""
    cfg, host = _config(layout), _host(layout)
    model = _fresh(com, cfg).to(torch.float64)
    with _float64():
        step = make_train_step(model, cfg, create_train_state(model), mesh=mesh)
        batch = batch_to_device(host, "cpu") if mesh is None else shard_batch(host, mesh)
        with patch():
            return _step_result(model, step(batch))


def _predict(com, layout, mesh=None):
    cfg, host = _config(layout), _host(layout)
    model = _fresh(com, cfg)
    batch = batch_to_device(host, "cpu") if mesh is None else shard_batch(host, mesh)
    return [t.clone() for t in make_predict_step(model, cfg, mesh)(batch)]


def _layout_task(layout):
    mesh = make_mesh(*LAYOUTS[layout][0], device="cpu")
    out = {"coords": mesh.coords}
    for com in COMS:
        out[com] = {"step": _train(com, layout, mesh), "predict": _predict(com, layout, mesh)}
    out["disco"] = {"predict": _predict("disco", layout, mesh)}
    for fault, com, lay in FAULT_CASES:
        if lay == layout:
            out[f"{fault}/{com}"] = _train(com, layout, mesh, FAULTS[fault][2])
    return out


_ranks: dict = {}
_oracle: dict = {}


def _layout_ranks(layout: str) -> list:
    """The ranks' results of the layout's spawn (run once)."""
    if layout not in _ranks:
        _ranks[layout] = spawn(_layout_task, 2, layout=layout)
    return _ranks[layout]


def _one_process(layout: str, com: str, what: str):
    key = (layout, com, what)
    if key not in _oracle:
        _oracle[key] = (_train if what == "step" else _predict)(com, layout)
    return _oracle[key]


# ---------------------------------------------------------------------------
# the train and predict steps


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("com", COMS)
def test_sharded_train_step_equals_one_process(com, layout):
    want = _one_process(layout, com, "step")
    ranks = _layout_ranks(layout)
    for res in ranks:  # every rank holds the global metrics, gradients and statistics
        got = res[com]["step"]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=P13_F64_REL, err_msg=f"{com} {layout} {k}")
        dist_ = _group_distances(got["grads"], want["grads"])
        assert max(dist_.values()) < P13_F64_REL, (com, layout, dist_)
        for k, v in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k].numpy(), v.numpy(), atol=P13_F64_REL, rtol=0, err_msg=k)
    for k, g in ranks[0][com]["step"]["grads"].items():
        assert torch.equal(g, ranks[1][com]["step"]["grads"][k]), k


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("com", COMS + ("disco",))
def test_sharded_predict_matches_one_process(com, layout):
    want = _one_process(layout, com, "predict")
    for res in _layout_ranks(layout):
        c = res["coords"]
        b, a = res[com]["predict"][0].shape[:2]
        rows = [t[c["data"] * b:(c["data"] + 1) * b, c["agent"] * a:(c["agent"] + 1) * a] for t in want]
        _assert_detections_equivalent(*rows, *res[com]["predict"])


@pytest.mark.parametrize("fault,com,layout", FAULT_CASES)
def test_planted_fault_breaks_the_bound(fault, com, layout):
    dist_ = _group_distances(_layout_ranks(layout)[0][f"{fault}/{com}"]["grads"],
                             _one_process(layout, com, "step")["grads"])
    assert max(dist_.values()) > 10 * GRAD_REL_L2, (fault, com, layout, dist_)


# ---------------------------------------------------------------------------
# splits that cannot be even


def test_grid_rows_that_do_not_divide_are_refused():
    mesh = make_mesh(n_data=1, n_spatial=3, device="cpu", rank=0, world_size=3)
    with pytest.raises(ValueError, match=r"bev \(2, 4, 32, 32, 13\) does not split"):
        shard_batch(_host("agent2"), mesh)


@pytest.mark.parametrize("com", ["when2com", "who2com"])
def test_handshake_refuses_a_strip_it_cannot_halve_twice(com):
    """At the 32-grid the fusion-layer map has 4 rows: 2 a strip over
    ``spatial`` 2, which the handshake's second stride-2 conv would get as
    one row."""
    cfg = _config("agent2")
    model = attach_mesh(build_model(com, cfg, device="cpu"),
                        make_mesh(n_data=1, n_spatial=2, device="cpu", rank=0, world_size=2))
    mask = torch.ones(1, A, dtype=torch.bool)
    feats = torch.zeros(1, A, 2, 4, model.layer_channels)
    with pytest.raises(ValueError, match="a strip of 2 rows .4 rows over 2 spatial ranks. is not a multiple of 4"):
        model.fuse_sharded(feats, None, mask, mask, torch.eye(4).expand(1, A, A, 4, 4))
