"""The port's nuScenes walker (``disconet_tpu_torch.data.nuscenes_walker``)
and the ``--mode nuscenes`` CLIs, against the JAX package's walker.

Neither machine has ``nuscenes-devkit``, so the tests install a fake one: a
copy of the faked devkit of ``tests/test_nuscenes_walker.py`` (a 1-scene,
2-frame, 2-agent release with a prev sweep per keyframe, a vehicle and a
pedestrian). Held: the port's det and seg frames equal the JAX walker's byte
for byte, with 1 and 2 sweeps; ``is_det_category``, ``DET_CATEGORIES`` and
``SPLIT_SCENE_RANGES`` equal JAX's; both ``create_data_* --mode nuscenes``
CLIs write the release and the port's det and seg ``train_codet`` train an
epoch on it; without the devkit the CLIs exit naming it.
"""

import os
import re
import sys
import types

import numpy as np
import pytest

from disconet_tpu.config import tiny_config as jax_tiny_config
from disconet_tpu.data import nuscenes_walker as jwalker
from disconet_tpu_torch import tiny_config
from disconet_tpu_torch.data import nuscenes_walker as walker
from disconet_tpu_torch.tools.det import create_data_det, train_codet
from disconet_tpu_torch.tools.seg import create_data_seg, train_codet as seg_train

CFG = tiny_config(32)  # extents +-4 m, voxel 0.25
JCFG = jax_tiny_config(32)


def _yaw_quat(yaw):  # nuScenes [w, x, y, z]
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _pose(yaw, t):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = t
    return T


# scene geometry shared by fixture and assertions
T_WS = {0: _pose(0.0, (0.0, 0.0, 0.0)), 1: _pose(np.pi / 2, (2.0, 1.0, 0.0))}
VEH_WORLD = dict(xy=(1.5, 0.5), w=0.5, l=1.0, yaw=0.3)
N_FRAMES = 2


@pytest.fixture
def fake_devkit(tmp_path, monkeypatch):
    """Install a fake ``nuscenes`` package and build a 1-scene, 2-frame,
    2-agent release under tmp_path. Returns the dataroot."""
    rng = np.random.default_rng(0)
    tables = {"sample": {}, "sample_data": {}, "calibrated_sensor": {},
              "ego_pose": {}, "sample_annotation": {}}

    def add_pose(table, token, T):
        yaw = float(np.arctan2(T[1, 0], T[0, 0]))
        tables[table][token] = {"rotation": _yaw_quat(yaw), "translation": list(T[:3, 3])}

    samples = []
    os.makedirs(os.path.join(tmp_path, "sweeps"), exist_ok=True)
    for f in range(N_FRAMES):
        tok = f"samp{f}"
        data, anns = {}, []
        for a, T in T_WS.items():
            # cal = identity, ego = full pose (walker composes ego @ cal)
            add_pose("ego_pose", f"ego{a}_{f}", T)
            add_pose("calibrated_sensor", f"cal{a}", np.eye(4))
            pts = rng.uniform(-3.0, 3.0, size=(4, 50)).astype(np.float32)
            pts[3] = 2.0  # per-point semantic label channel: class 2 (road)
            rel = f"sweeps/a{a}_f{f}.npy"
            np.save(os.path.join(tmp_path, rel), pts)
            # one prev (non-keyframe) sweep at a shifted ego pose, so
            # sweeps=2 exercises the prev-chain aggregation
            T_prev = T.copy()
            T_prev[0, 3] += 0.5
            add_pose("ego_pose", f"egoprev{a}_{f}", T_prev)
            prev_pts = rng.uniform(-2.0, 2.0, size=(4, 30)).astype(np.float32)
            prev_pts[3] = 2.0
            prev_rel = f"sweeps/a{a}_f{f}_prev.npy"
            np.save(os.path.join(tmp_path, prev_rel), prev_pts)
            tables["sample_data"][f"sw{a}_{f}"] = {
                "filename": prev_rel, "calibrated_sensor_token": f"cal{a}",
                "ego_pose_token": f"egoprev{a}_{f}", "prev": "",
            }
            sd_tok = f"sd{a}_{f}"
            tables["sample_data"][sd_tok] = {
                "filename": rel, "calibrated_sensor_token": f"cal{a}",
                "ego_pose_token": f"ego{a}_{f}", "prev": f"sw{a}_{f}",
            }
            data[f"LIDAR_TOP_id_{a}"] = sd_tok
        tables["sample_annotation"][f"veh{f}"] = {
            "category_name": "vehicle.car", "rotation": _yaw_quat(VEH_WORLD["yaw"]),
            # real nuScenes schema: size = [width, length, height] with
            # *length* along the heading. VEH_WORLD["w"] is the framework's
            # along-heading slot-2 extent, so it goes in size[1]; an
            # asymmetric w != l here catches a walker that swaps them.
            "size": [VEH_WORLD["l"], VEH_WORLD["w"], 1.5],
            "translation": [*VEH_WORLD["xy"], 0.0],
        }
        tables["sample_annotation"][f"ped{f}"] = {
            "category_name": "human.pedestrian.adult", "rotation": _yaw_quat(0.0),
            "size": [0.5, 0.5, 1.8], "translation": [0.5, -0.5, 0.0],
        }
        anns = [f"veh{f}", f"ped{f}"]
        tables["sample"][tok] = {"data": data, "anns": anns,
                                 "next": f"samp{f + 1}" if f + 1 < N_FRAMES else ""}
        samples.append(tok)

    class FakeNuScenes:
        def __init__(self, version, dataroot, verbose=False):
            assert version and os.path.isdir(dataroot)
            self.dataroot = dataroot
            self.scene = [{"first_sample_token": samples[0]}]

        def get(self, table, token):
            return tables[table][token]

    class LidarPointCloud:
        def __init__(self, points):
            self.points = points  # (4, N), devkit layout

        @classmethod
        def from_file(cls, path):
            return cls(np.load(path))

    pkg = types.ModuleType("nuscenes")
    mod = types.ModuleType("nuscenes.nuscenes")
    utils = types.ModuleType("nuscenes.utils")
    dc = types.ModuleType("nuscenes.utils.data_classes")
    mod.NuScenes = FakeNuScenes
    dc.LidarPointCloud = LidarPointCloud
    pkg.nuscenes, pkg.utils, utils.data_classes = mod, utils, dc
    for name, m in [("nuscenes", pkg), ("nuscenes.nuscenes", mod),
                    ("nuscenes.utils", utils), ("nuscenes.utils.data_classes", dc)]:
        monkeypatch.setitem(sys.modules, name, m)
    return str(tmp_path)


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("task", ["det", "seg"])
def test_walker_frames_equal_jax(fake_devkit, tmp_path, task, sweeps):
    name = "create_data_from_nuscenes" if task == "det" else "create_seg_data_from_nuscenes"
    got_root, want_root = str(tmp_path / "port"), str(tmp_path / "jax")
    n = getattr(walker, name)(fake_devkit, got_root, CFG, version="v2.0-mini", sweeps=sweeps)
    m = getattr(jwalker, name)(fake_devkit, want_root, JCFG, version="v2.0-mini", sweeps=sweeps)
    assert n == m == len(T_WS) * N_FRAMES
    got, want = _files(got_root), _files(want_root)
    assert sorted(got) == sorted(want) and len(got) == n
    for k in want:
        assert got[k] == want[k], k


def test_walker_scene_range_matches_jax(fake_devkit, tmp_path):
    for lo_hi in ((0, 1), (1, 2)):
        n = walker.create_data_from_nuscenes(fake_devkit, str(tmp_path / f"p{lo_hi}"), CFG, scene_range=lo_hi)
        m = jwalker.create_data_from_nuscenes(fake_devkit, str(tmp_path / f"j{lo_hi}"), JCFG, scene_range=lo_hi)
        assert n == m
    assert walker.SPLIT_SCENE_RANGES == jwalker.SPLIT_SCENE_RANGES


def test_det_category_map_matches_jax():
    assert walker.DET_CATEGORIES == jwalker.DET_CATEGORIES
    names = list(jwalker.DET_CATEGORIES) + [
        "vehicle.truck.fire", "vehicle", "vehicles.car", "human.pedestrian.adult",
        "static_object.bicycle_rack", "movable_object.barrier", "animal", "",
    ]
    for name in names:
        assert walker.is_det_category(name) == jwalker.is_det_category(name), name
        for cats in (("vehicle.car",), ()):
            assert walker.is_det_category(name, cats) == jwalker.is_det_category(name, cats), (name, cats)


def test_walker_without_the_devkit(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "nuscenes", None)
    monkeypatch.setitem(sys.modules, "nuscenes.nuscenes", None)
    with pytest.raises(ImportError, match="nuscenes-devkit is required"):
        walker.create_data_from_nuscenes(str(tmp_path), str(tmp_path / "out"), CFG)


@pytest.mark.parametrize("task", ["det", "seg"])
def test_cli_nuscenes_mode_trains_end_to_end(fake_devkit, tmp_path, capsys, task):
    """``create_data_* --mode nuscenes`` writes the fake release's frames and
    the port's ``train_codet`` trains an epoch on them."""
    create, train = (create_data_det.main, train_codet.main) if task == "det" else (create_data_seg.main, seg_train.main)
    root = str(tmp_path / "parsed")
    capsys.readouterr()
    create(["--mode", "nuscenes", "--root", fake_devkit, "--data", root, "--split", "train", "--grid", "32"])
    out = capsys.readouterr().out
    assert f"wrote {len(T_WS) * N_FRAMES} agent-frames (scenes [0, 80))" in out
    train(["--data", os.path.join(root, "train"), "--grid", "32", "--batch", "2", "--com", "disco", "--nepoch", "1",
           "--device", "cpu", "--nworker", "1", "--logpath", str(tmp_path / "logs")])
    out = capsys.readouterr().out
    loss = re.search(r"epoch 1 done .*?(?<![\w])loss=([\d.eE+-]+)", out)
    assert loss and np.isfinite(float(loss.group(1)))


@pytest.mark.parametrize("create", [create_data_det.main, create_data_seg.main])
def test_cli_nuscenes_mode_names_the_missing_devkit(monkeypatch, tmp_path, create):
    monkeypatch.setitem(sys.modules, "nuscenes", None)
    with pytest.raises(SystemExit, match="nuscenes-devkit is not installed"):
        create(["--mode", "nuscenes", "--root", str(tmp_path), "--data", str(tmp_path / "out")])
    with pytest.raises(SystemExit, match="needs --root"):
        create(["--mode", "nuscenes", "--data", str(tmp_path / "out")])
