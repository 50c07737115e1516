"""The generators: the same seed gives the same inputs, on any seed up to
and past 2**31; the grids pack as the program's loader packs them; the
targets are valid sparse targets."""

import numpy as np
import torch

from port_bench.core.traffic import pack_z, predict_pool, train_pool
from port_bench.core.weights import seeded_state
from port_bench.tests.tiny import tiny_config

CFG = tiny_config("disconet")["config"]
PRED = {"batch": 2, "agents": 3, "points_per_agent": 64, "absent": [[1, 2]], "pool": 2, "pose_xy_m": 10.0}
TRAIN = {"batch": 2, "agents": 3, "absent": [[1, 2]], "pool": 2, "pose_xy_m": 10.0, "occupancy": [0.01, 0.02],
         "boxes_per_frame": 8}
BIG = 2**31 + 12345


def test_pack_z_is_np_packbits():
    g = torch.rand(3, 4, 13) < 0.5
    assert np.array_equal(pack_z(g).numpy(), np.packbits(g.numpy(), axis=-1))


def test_predict_pool_repeats_from_the_seed():
    a, b, c = (predict_pool(CFG, PRED, s, "cpu") for s in (BIG, BIG, BIG + 1))
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k], equal_nan=True) for k in x)
    assert not np.array_equal(a[0]["points"], c[0]["points"], equal_nan=True)
    pts = a[0]["points"]
    assert np.isnan(pts[1, 2]).all() and np.isfinite(pts[0]).all()
    assert (pts[0, :, :, 0] >= -4).all() and (pts[0, :, :, 0] < 4).all()
    T = a[0]["trans"]
    assert np.allclose(T[:, range(3), range(3)], np.eye(4), atol=1e-5)


def test_train_pool_gives_valid_sparse_targets():
    pool = train_pool(CFG, TRAIN, BIG, "cpu")
    again = train_pool(CFG, TRAIN, BIG, "cpu")
    n_flat = 32 * 32 * 6
    for k, (b, c) in enumerate(zip(pool, again)):
        assert all(np.array_equal(b[key], c[key]) for key in b)
        assert b["bev_packed"].shape == (2, 3, 32, 32, 2) and not b["bev_packed"][1, 2].any()
        assert list(b["frame_idx"]) == [2 * k, 2 * k + 1]
        idx = b["reg_pos_idx"]
        assert (idx[1, 2] == n_flat).all()
        for s in range(2):
            for a in range(3):
                live = idx[s, a][idx[s, a] < n_flat]
                assert len(np.unique(live)) == len(live)
                if (s, a) != (1, 2):
                    assert 9 <= len(live) <= 72
        assert np.isfinite(b["reg_pos_target"]).all()


def test_weights_repeat_from_the_seed():
    template = {"stpn.stages_0.ConvBNRelu_0.weight": torch.empty(4, 3, 3, 3),
                "stpn.stages_0.ConvBNRelu_0.BatchNorm_0.running_var": torch.empty(4),
                "heads.reg.weight": torch.empty(12, 4, 1, 1), "heads.reg.bias": torch.empty(12),
                "x.num_batches_tracked": torch.zeros((), dtype=torch.long)}
    ones = frozenset({"stpn.stages_0.ConvBNRelu_0.BatchNorm_0.running_var"})
    a, b, c = (seeded_state(template, s, 1, "cpu", ones) for s in (BIG, BIG, BIG + 1))
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["heads.reg.weight"], c["heads.reg.weight"])
    assert torch.equal(a["heads.reg.bias"], torch.tensor([0, 0, 0, 0, 0, 1.0] * 2))
    w = a["stpn.stages_0.ConvBNRelu_0.weight"]
    assert w.abs().max() <= 2 * (2 / 27) ** 0.5 / 0.87962566103423978 + 1e-6
    assert torch.equal(a["stpn.stages_0.ConvBNRelu_0.BatchNorm_0.running_var"], torch.ones(4))
