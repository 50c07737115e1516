"""The port's host data path against the JAX package's.

32-grid synthetic data seeded with numpy. Each case holds the port's copy
against the JAX function, exactly unless stated: the generator's frames
(binary, with occlusion, 4 classes) byte for byte, and each package reading
the other's files; ``V2XSimDet`` items over ``rsu``, ``bound``,
``dense_targets`` and ``pack_bits``; ``BatchIterator``'s order, collation and
tail padding, and its producer's errors and shutdown; the host rotated IoU,
the mAP, late fusion and pose noise (to 1e-12) on the JAX tests' cases and on
random ones.
"""

import filecmp
import importlib
import os
import threading
import warnings

import numpy as np
import pytest

from disconet_tpu.config import tiny_config as jax_tiny_config
from disconet_tpu.data import dataset as jds
from disconet_tpu.data import schema as jschema
from disconet_tpu.data.synthetic import generate_dataset as jax_generate_dataset
from disconet_tpu.data.synthetic import visible_fractions as jax_visible_fractions
from disconet_tpu.evaluation import mean_ap as jmap
from disconet_tpu.ops.rotated_iou import rotated_iou_matrix_np as jax_iou_np
from disconet_tpu.utils.pose_noise import perturb_trans as jax_perturb_trans
from disconet_tpu_torch.config import tiny_config
from disconet_tpu_torch.data import dataset as tds
from disconet_tpu_torch.data import schema
from disconet_tpu_torch.data.synthetic import generate_dataset, visible_fractions
from disconet_tpu_torch.evaluation import mean_ap as tmap
from disconet_tpu_torch.ops import late_fusion as tlate
from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix_np
from disconet_tpu_torch.utils.pose_noise import perturb_trans

jlate = importlib.import_module("disconet_tpu.ops.late_fusion")  # the package exports a function of that name

GEN_CASES = {"binary": dict(), "occlusion": dict(occlusion=True), "4-class": dict(num_classes=4)}


def _equal(a, b, where=""):
    """Exact equality of nested frame/item values, dtypes included."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=where)


def _generate(root, case, port):
    kw = dict(GEN_CASES[case])
    nc = kw.pop("num_classes", 2)
    if port:
        generate_dataset(root, tiny_config(32, num_classes=nc), num_scenes=2, frames_per_scene=2, seed=3, **kw)
    else:
        jax_generate_dataset(root, jax_tiny_config(32, num_classes=nc), num_scenes=2, frames_per_scene=2,
                             seed=3, **kw)
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(JAX root, port root) of each generator case, same seed."""
    out = {}
    for case in GEN_CASES:
        base = tmp_path_factory.mktemp(case)
        out[case] = (_generate(str(base / "jax"), case, False), _generate(str(base / "port"), case, True))
    return out


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generator_writes_the_jax_frames(roots, case):
    jroot, troot = roots[case]
    paths = sorted(os.path.relpath(os.path.join(d, f), jroot) for d, _, fs in os.walk(jroot) for f in fs)
    assert paths and paths == sorted(
        os.path.relpath(os.path.join(d, f), troot) for d, _, fs in os.walk(troot) for f in fs)
    for rel in paths:
        jp, tp = os.path.join(jroot, rel), os.path.join(troot, rel)
        assert filecmp.cmp(jp, tp, shallow=False), rel
        # each package reads the other's file as the other does
        _equal(schema.load_frame(jp), jschema.load_frame(tp), rel)
        _equal(schema.load_frame(tp), jschema.load_frame(jp), rel)
    if case == "4-class":
        classes = np.concatenate([schema.load_frame(os.path.join(troot, r))["gt_classes"] for r in paths])
        assert set(classes.tolist()) == {1, 2, 3}
    assert [(s, f) for s, f, _ in schema.list_frames(os.path.join(troot, "agent0"))] == \
        [(s, f) for s, f, _ in jschema.list_frames(os.path.join(jroot, "agent0"))]


def test_visible_fractions_match_jax():
    rng = np.random.default_rng(4)
    boxes = np.stack([rng.uniform(-20, 20, 12), rng.uniform(-20, 20, 12), rng.uniform(1.5, 2.5, 12),
                      rng.uniform(3.5, 5, 12), rng.uniform(-np.pi, np.pi, 12)], -1)
    sensor = rng.uniform(-3, 3, 2)
    np.testing.assert_array_equal(visible_fractions(sensor, boxes), jax_visible_fractions(sensor, boxes))


ITEM_CASES = [(rsu, bound, dense, pack) for rsu in (0, 1) for bound in ("", "upperbound")
              for dense in (True, False) for pack in (True, False)]


@pytest.mark.parametrize("rsu,bound,dense,pack", ITEM_CASES)
def test_dataset_items_match_jax(roots, rsu, bound, dense, pack):
    root = roots["binary"][0]
    kw = dict(rsu=bool(rsu), bound=bound, dense_targets=dense, pack_bits=pack)
    port = tds.V2XSimDet(root, tiny_config(32), **kw)
    ref = jds.V2XSimDet(root, jax_tiny_config(32), **kw)
    assert len(port) == len(ref) == 4 and port.keys == ref.keys
    for i in range(len(port)):
        _equal(port[i], ref[i], f"item {i}")


def test_dataset_items_match_jax_multiclass_and_overflow(roots):
    """4-class items carry reg_pos_cls; a frame over max_pos_anchors warns
    and drops the excess in both."""
    root = roots["4-class"][0]
    for over in (dict(num_classes=4), dict(num_classes=4, max_pos_anchors=16)):
        with warnings.catch_warnings(record=True) as wp:
            warnings.simplefilter("always")
            port = tds.V2XSimDet(root, tiny_config(32, **over), cache_items=2)
            items = [port[i] for i in range(len(port))] + [port[0]]  # the last from the cache
        with warnings.catch_warnings(record=True) as wj:
            warnings.simplefilter("always")
            ref = jds.V2XSimDet(root, jax_tiny_config(32, **over), cache_items=2)
            want = [ref[i] for i in range(len(ref))] + [ref[0]]
        assert "reg_pos_cls" in items[0]
        _equal(items, want)
        n_warn = sum("max_pos_anchors" in str(w.message) for w in wp)
        assert n_warn == sum("max_pos_anchors" in str(w.message) for w in wj)
        assert (n_warn > 0) == ("max_pos_anchors" in over)


def test_batch_iterator_order_collate_and_padding(roots):
    root = roots["binary"][0]
    port = tds.V2XSimDet(root, tiny_config(32))
    ref = jds.V2XSimDet(root, jax_tiny_config(32))
    p_it = tds.BatchIterator(port, 3, shuffle=True, seed=7, drop_last=False, num_workers=2)
    j_it = jds.BatchIterator(ref, 3, shuffle=True, seed=7, drop_last=False, num_workers=2)
    assert len(p_it) == len(j_it) == 2
    for _ in range(2):  # two epochs: the second shuffle is drawn from the same generator
        got, want = list(p_it), list(j_it)
        assert [b["frame_idx"].tolist() for b in got] == [b["frame_idx"].tolist() for b in want]
        _equal(got, want)
        _equal(tds.pad_batch_to(got[-1], 3, 6), jds.pad_batch_to(want[-1], 3, 6))
        assert not got[-1]["agent_mask"][-2:].any() and len(got[-1]["gt_boxes"]) == 3
    items = [port[i] for i in (2, 0)]
    _equal(tds.collate_det(items), jds.collate_det([ref[i] for i in (2, 0)]))
    assert len(tds.BatchIterator(port, 3)) == 1  # drop_last


class _Failing:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        if i == 4:
            raise OSError("corrupt frame 4")
        return {"agent_mask": np.ones((2,), bool), "frame_idx": np.int32(i)}


def test_batch_iterator_passes_errors_and_joins_on_close():
    before = threading.active_count()
    with pytest.raises(OSError, match="corrupt frame 4"):
        list(tds.BatchIterator(_Failing(), 2, shuffle=False))
    it = iter(tds.BatchIterator(_Failing(), 1, shuffle=False))
    assert int(next(it)["frame_idx"][0]) == 0
    it.close()  # the producer is blocked on a full queue: close must stop and join it
    assert threading.active_count() == before


def _box(cx, cy, w=2.0, l=4.0, th=0.0):
    return np.array([cx, cy, w, l, th], np.float64)


def _random_frames(rng, n_frames, classes=None):
    dets, gts = [], []
    for _ in range(n_frames):
        g = rng.integers(0, 6)
        gt = np.stack([rng.uniform(-10, 10, g), rng.uniform(-10, 10, g), rng.uniform(1.5, 2.5, g),
                       rng.uniform(3.5, 5, g), rng.uniform(-np.pi, np.pi, g)], -1).reshape(-1, 5)
        d = np.concatenate([gt + rng.normal(0, 0.2, gt.shape) * [1, 1, 0.1, 0.1, 0.1],
                            np.stack([rng.uniform(-10, 10, 3), rng.uniform(-10, 10, 3), np.full(3, 2.0),
                                      np.full(3, 4.0), rng.uniform(-1, 1, 3)], -1)])
        s = rng.random(len(d))
        if classes:
            dets.append((d, s, rng.integers(1, classes, len(d))))
            gts.append((gt, rng.integers(1, classes, len(gt))))
        else:
            dets.append((d, s))
            gts.append(gt)
    return dets, gts


def test_host_rotated_iou_matches_jax():
    rng = np.random.default_rng(0)
    a = np.stack([rng.uniform(-5, 5, 40), rng.uniform(-5, 5, 40), rng.uniform(0.5, 4, 40),
                  rng.uniform(0.5, 5, 40), rng.uniform(-np.pi, np.pi, 40)], -1)
    a[5] = a[6]  # identical boxes
    a[7, 2:4] = 0.0  # a zero-size box
    with np.errstate(divide="ignore", invalid="ignore"):  # the zero-size box's 0/0, masked to 0
        np.testing.assert_array_equal(rotated_iou_matrix_np(a, a[:17]), jax_iou_np(a, a[:17]))


def test_mean_ap_matches_jax():
    gt = np.stack([_box(0, 0), _box(10, 10)])
    dets = np.stack([_box(0, 0), _box(10, 10), _box(30, 30)])
    scores = np.array([0.9, 0.8, 0.7])
    for thr in (0.5, 0.7):
        _equal(tmap.tpfp_default(dets, scores, gt, thr), jmap.tpfp_default(dets, scores, gt, thr))
    canned = [
        ([(np.stack([_box(0, 0), _box(8, 8)]), np.array([0.9, 0.8])), (np.stack([_box(-5, 3)]), np.array([0.95]))],
         [np.stack([_box(0, 0), _box(8, 8)]), np.stack([_box(-5, 3)])]),
        ([(np.zeros((0, 5)), np.zeros(0))], [np.stack([_box(0, 0)])]),
        ([(np.stack([_box(0, 0), _box(0.1, 0)]), np.array([0.9, 0.8]))], [np.stack([_box(0, 0)])]),
    ]
    rng = np.random.default_rng(1)
    canned += [_random_frames(rng, 12) for _ in range(3)]
    for dets, gts in canned:
        for thr in (0.5, 0.7):
            ap, d = tmap.eval_map(dets, gts, thr)
            ap_j, d_j = jmap.eval_map(dets, gts, thr)
            np.testing.assert_allclose(ap, ap_j, rtol=0, atol=1e-12)
            assert d == d_j
    for mode in ("area", "11points"):
        r, p = np.sort(rng.random(9)), rng.random(9)
        np.testing.assert_allclose(tmap.average_precision(r, p, mode), jmap.average_precision(r, p, mode),
                                   rtol=0, atol=1e-12)

    box = np.array([[0.0, 0.0, 2.0, 4.0, 0.0]], np.float32)
    score = np.array([0.9], np.float32)
    mc = [([(box, score, np.array([1])), (box, score, np.array([3]))], [(box, np.array([1])), (box, np.array([2]))])]
    mc += [_random_frames(rng, 10, classes=4) for _ in range(2)]
    for dets, gts in mc:
        for thr in (0.5, 0.7):
            m, d = tmap.eval_map_multiclass(dets, gts, thr, num_classes=4)
            m_j, d_j = jmap.eval_map_multiclass(dets, gts, thr, num_classes=4)
            np.testing.assert_allclose(m, m_j, rtol=0, atol=1e-12)
            assert d == d_j


def _pose(x, y, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
    T[0, 3], T[1, 3] = x, y
    return T


def test_late_fusion_matches_jax():
    T_wa, T_wb = _pose(0, 0, 0), _pose(5.0, 0.0, np.pi / 2)
    obj = np.array([[2.0, 1.0, 2.0, 4.0, 0.2]], np.float32)
    only_b = tlate.transform_boxes(np.array([[8.0, 3.0, 2.0, 4.0, -0.5]], np.float32), np.linalg.inv(T_wb))
    _equal(tlate.transform_boxes(obj, T_wb), jlate.transform_boxes(obj, T_wb))
    dets = [(tlate.transform_boxes(obj, np.linalg.inv(T_wa)), np.array([0.9], np.float32)),
            (np.concatenate([tlate.transform_boxes(obj, np.linalg.inv(T_wb)), only_b]),
             np.array([0.8, 0.7], np.float32))]
    trans = np.zeros((2, 2, 4, 4), np.float32)
    for i, Ti in enumerate([T_wa, T_wb]):
        for j, Tj in enumerate([T_wa, T_wb]):
            trans[i, j] = np.linalg.inv(Ti) @ Tj
    cases = [(dets, trans, 2), ([(np.zeros((0, 5)), np.zeros(0))] * 2, trans, 2)]
    rng = np.random.default_rng(2)
    for _ in range(3):  # random: 4 agents, clustered boxes, random poses
        poses = [_pose(*rng.uniform(-5, 5, 2), rng.uniform(-np.pi, np.pi)) for _ in range(4)]
        tr = np.stack([np.stack([np.linalg.inv(Ti) @ Tj for Tj in poses]) for Ti in poses]).astype(np.float32)
        per = []
        for a in range(4):
            n = int(rng.integers(0, 8))
            per.append((np.stack([rng.uniform(-6, 6, n), rng.uniform(-6, 6, n), rng.uniform(1.5, 2.5, n),
                                  rng.uniform(3.5, 5, n), rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32),
                        rng.random(n).astype(np.float32)))
        cases.append((per, tr, 4))
    for per, tr, n_agents in cases:
        for recv in range(n_agents):
            for thr in (0.01, 0.1):
                _equal(tlate.late_fusion(per, tr, recv, thr), jlate.late_fusion(per, tr, recv, thr))
    boxes = np.array([[0, 0, 2, 4, 0.0], [0.05, 0, 2, 4, 0.0], [10, 10, 2, 4, 0.0]], np.float64)
    _equal(tlate.nms_np(boxes, np.array([0.9, 0.8, 0.7]), 0.3), jlate.nms_np(boxes, np.array([0.9, 0.8, 0.7]), 0.3))


@pytest.mark.parametrize("thr", [0.0, 0.01, 0.3])
def test_nms_np_matches_jax_on_many_boxes(thr):
    """The port's NMS skips pairs whose circumscribed circles do not meet;
    on 400 boxes, clustered and spread, it keeps what JAX's full IoU matrix
    keeps."""
    rng = np.random.default_rng(9)
    for spread in (3.0, 30.0):
        n = 400
        boxes = np.stack([rng.uniform(-spread, spread, n), rng.uniform(-spread, spread, n), rng.uniform(1, 2.5, n),
                          rng.uniform(2, 5, n), rng.uniform(-np.pi, np.pi, n)], -1)
        scores = rng.random(n)
        _equal(tlate.nms_np(boxes, scores, thr), jlate.nms_np(boxes, scores, thr))


@pytest.mark.parametrize("shape", [(2, 3, 3, 4, 4), (3, 3, 4, 4), (2, 2, 6, 6, 4, 4)])
def test_pose_noise_matches_jax(shape):
    rng = np.random.default_rng(5)
    trans = rng.normal(size=shape).astype(np.float32)
    trans[..., 3, :] = [0, 0, 0, 1]
    for std_t, std_r in ((0.5, 0.1), (0.2, 0.0)):
        got = perturb_trans(trans, std_t, std_r, np.random.default_rng(11))
        want = jax_perturb_trans(trans, std_t, std_r, np.random.default_rng(11))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
