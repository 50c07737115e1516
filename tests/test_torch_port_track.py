"""The port's tracking path against the JAX package's: CLEAR-MOT, SORT and
the MOT evaluation CLI.

CPU. ``clear_mot`` on random sequences with identity swaps, misses, false
positives, stale correspondences and empty frames: every key equal. The
float64 rotated IoU that both associate with: within 1e-12 of JAX's, so no
Hungarian tie can flip. ``Sort`` and ``run_file`` on canned dumps: track
files byte-identical to ``tools/track/sort.py``'s, the class-level id counter
reset on both sides first. ``eval_mot``: MOTA/MOTP within 1e-12 and the same
printed table as ``tools/track/eval_mot.py`` on the same tracks and data,
with and without the RSU and with an empty track file. A CLI cycle at the
32-grid: the port's ``test_codet --tracking`` -> ``sort`` -> ``eval_mot``,
against the JAX tools run on the port's dumps.
"""

import filecmp
import importlib.util
import os

import numpy as np
import pytest

from disconet_tpu.evaluation.mot import clear_mot as jax_clear_mot
from disconet_tpu.ops.rotated_iou import rotated_iou_matrix_np as jax_iou_np
from disconet_tpu_torch.evaluation import clear_mot
from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix_np
from disconet_tpu_torch.tools.det import create_data_det, test_codet, train_codet
from disconet_tpu_torch.tools.track import eval_mot, sort

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "tools", "track", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_SORT = _jax_tool("sort")
JAX_EVAL = _jax_tool("eval_mot")


def _reset_counters():
    sort.KalmanBoxTracker.count = 0
    JAX_SORT.KalmanBoxTracker.count = 0


def _run(capsys, main, argv):
    capsys.readouterr()
    result = main(argv)
    return capsys.readouterr().out, result


# ---------------------------------------------------------------------------
# CLEAR-MOT and the IoU


def _sequence(seed, frames=12, n_obj=6):
    """(gt_frames, hyp_frames) of objects moving on straight lines: gt
    present 85% of frames, hypotheses jittered, dropped (misses), doubled
    (false positives), their ids swapped between two objects now and then
    and re-used after a track ends (stale correspondences); some frames empty
    on one side or both."""
    rng = np.random.default_rng(seed)
    start = np.stack([rng.uniform(-20, 20, n_obj), rng.uniform(-20, 20, n_obj), rng.uniform(1.6, 2.2, n_obj),
                      rng.uniform(3.8, 5.0, n_obj), rng.uniform(-np.pi, np.pi, n_obj)], -1)
    vel = rng.uniform(-1.5, 1.5, (n_obj, 2))
    hyp_id = np.arange(100, 100 + n_obj)
    gt_frames, hyp_frames = [], []
    for f in range(frames):
        boxes = start.copy()
        boxes[:, :2] += f * vel
        present = rng.random(n_obj) < 0.85
        if f == 3:
            present[:] = False  # no gt at all
        gt_frames.append((boxes[present], np.flatnonzero(present) + 1))
        if rng.random() < 0.3:  # two tracks swap identities
            i, j = rng.choice(n_obj, 2, replace=False)
            hyp_id[[i, j]] = hyp_id[[j, i]]
        if rng.random() < 0.2:  # a track ends; its id comes back on another object
            i, j = rng.choice(n_obj, 2, replace=False)
            hyp_id[i] = hyp_id[j]
        seen = present & (rng.random(n_obj) < 0.85)
        h = boxes[seen] + rng.normal(0, [0.3, 0.3, 0.05, 0.1, 0.05], (seen.sum(), 5))
        ids = hyp_id[seen]
        n_fp = rng.integers(0, 3)
        fp = np.stack([rng.uniform(-30, 30, n_fp), rng.uniform(-30, 30, n_fp), np.full(n_fp, 2.0),
                       np.full(n_fp, 4.5), np.zeros(n_fp)], -1)
        h, ids = np.concatenate([h, fp]), np.concatenate([ids, 500 + f * 10 + np.arange(n_fp)])
        if f == 7:
            h, ids = h[:0], ids[:0]  # no hypotheses
        hyp_frames.append((h, ids))
    return gt_frames, hyp_frames


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("thr", [0.5, 0.3])
def test_clear_mot_matches_jax(seed, thr):
    gt, hyp = _sequence(seed)
    got, want = clear_mot(gt, hyp, iou_threshold=thr), jax_clear_mot(gt, hyp, iou_threshold=thr)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], float):
            assert got[k] == pytest.approx(want[k], abs=1e-12), k
        else:
            assert got[k] == want[k], k
    assert want["id_switches"] > 0 and want["misses"] > 0 and want["false_positives"] > 0


def test_clear_mot_empty_sequence():
    empty = [(np.zeros((0, 5)), np.zeros(0, int))] * 3
    assert clear_mot(empty, empty) == jax_clear_mot(empty, empty)


def _iou_cases():
    rng = np.random.default_rng(3)
    rand = np.stack([rng.uniform(-6, 6, 40), rng.uniform(-6, 6, 40), rng.uniform(0.5, 4, 40),
                     rng.uniform(0.5, 5, 40), rng.uniform(-np.pi, np.pi, 40)], -1)
    base = np.array([[0.0, 0.0, 2.0, 4.0, 0.3]])
    return {
        "random": (rand[:20], rand[20:]),
        "identical and pi-turned": (np.repeat(base, 3, 0), base + [[0, 0, 0, 0, 0], [0, 0, 0, 0, np.pi],
                                                                    [0, 0, 0, 0, -np.pi]]),
        "touching and nested": (np.array([[0, 0, 2, 2, 0], [0, 0, 4, 4, 0.0]]),
                                np.array([[2, 0, 2, 2, 0], [0, 0, 1, 1, 0.7], [0, 0, 2, 2, np.pi / 2]])),
        "tracker scale": (rand[:20] * [4, 4, 1, 1, 1], rand[20:] * [4, 4, 1, 1, 1] + 0.2),
    }


@pytest.mark.parametrize("case", list(_iou_cases()))
def test_iou_np_matches_jax(case):
    a, b = _iou_cases()[case]
    np.testing.assert_allclose(rotated_iou_matrix_np(a, b), jax_iou_np(a, b), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# SORT


def _write_dump(path, seed, frames=10, n_obj=5):
    """A ``test_codet --tracking`` dump: noisy detections of objects on
    straight lines, some missed, some false, crossing paths, and a frame with
    no row at all."""
    rng = np.random.default_rng(seed)
    start = np.stack([rng.uniform(-15, 15, n_obj), rng.uniform(-15, 15, n_obj), rng.uniform(1.7, 2.1, n_obj),
                      rng.uniform(4, 4.8, n_obj), rng.uniform(-np.pi, np.pi, n_obj)], -1)
    vel = rng.uniform(-2, 2, (n_obj, 2))
    rows = []
    for f in range(frames):
        if f == 4:
            continue
        boxes = start.copy()
        boxes[:, :2] += f * vel
        boxes += rng.normal(0, [0.2, 0.2, 0.05, 0.05, 0.03], boxes.shape)
        keep = rng.random(n_obj) < 0.8
        extra = rng.integers(0, 2)
        fp = np.stack([rng.uniform(-20, 20, extra), rng.uniform(-20, 20, extra), np.full(extra, 1.9),
                       np.full(extra, 4.4), rng.uniform(-3, 3, extra)], -1)
        for bb in np.concatenate([boxes[keep], fp]):
            rows.append(f"{f},{bb[0]:.3f},{bb[1]:.3f},{bb[2]:.3f},{bb[3]:.3f},{bb[4]:.4f},{rng.uniform(0.3, 1):.4f}")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


@pytest.mark.parametrize("seed,args", [(0, (3, 2, 0.1)), (1, (1, 1, 0.3)), (2, (5, 3, 0.05))])
def test_run_file_byte_identical(tmp_path, seed, args):
    dump = str(tmp_path / "det_agent0_scene0.txt")
    _write_dump(dump, seed)
    _reset_counters()
    n = sort.run_file(dump, str(tmp_path / "port.txt"), *args)
    _reset_counters()
    n_jax = JAX_SORT.run_file(dump, str(tmp_path / "jax.txt"), *args)
    assert n == n_jax > 0
    assert filecmp.cmp(tmp_path / "port.txt", tmp_path / "jax.txt", shallow=False)


def test_sort_update_matches_jax():
    """Frame by frame: the same rows, ids in spawn order."""
    rng = np.random.default_rng(9)
    _reset_counters()
    port, ref = sort.Sort(), JAX_SORT.Sort()
    base = np.array([[0, 0, 2, 4, 0, 0.9], [5, 5, 2, 4, 0.5, 0.8], [-6, 3, 2, 4, 1.0, 0.7]], float)
    for f in range(6):
        dets = base + [f, 0.5 * f, 0, 0, 0, 0] + rng.normal(0, 0.1, base.shape) * [1, 1, 0, 0, 0, 0]
        dets = dets[rng.permutation(len(dets))][: 3 - (f == 2)]
        np.testing.assert_array_equal(port.update(dets), ref.update(dets))


def test_sort_cli_matches_jax(tmp_path, capsys):
    """``main`` over a directory: the id counter runs on across files."""
    dumps = tmp_path / "det_dumps"
    dumps.mkdir()
    for a, s in ((0, 0), (0, 1), (2, 0), (7, 0)):
        _write_dump(str(dumps / f"det_agent{a}_scene{s}.txt"), 10 * a + s)
    _reset_counters()
    out_port, _ = _run(capsys, sort.main, ["--det_logs_path", str(dumps), "--out", str(tmp_path / "port")])
    _reset_counters()
    out_jax, _ = _run(capsys, JAX_SORT.main, ["--det_logs_path", str(dumps), "--out", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3  # agent 7 is past --to_agent
    assert out_port.replace(str(tmp_path / "port"), "") == out_jax.replace(str(tmp_path / "jax"), "")
    for n in names:
        assert filecmp.cmp(tmp_path / "port" / n, tmp_path / "jax" / n, shallow=False), n
    with pytest.raises(SystemExit, match="no det dumps"):
        sort.main(["--det_logs_path", str(tmp_path / "nothing")])


# ---------------------------------------------------------------------------
# eval_mot and the CLI cycle


@pytest.fixture(scope="module")
def track_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("track_data"))
    create_data_det.main(["--data", root, "--split", "val", "--mode", "synthetic",
                          "--scenes", "2", "--frames", "4", "--grid", "32"])
    return os.path.join(root, "val")


def _tracks_from_gt(data, out_dir, rsu, seed):
    """Track files built from the dataset's gt: jittered boxes, dropped rows,
    one swapped id, and one empty file."""
    from disconet_tpu_torch.data import schema

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    for slot in range(5):
        frames = schema.list_frames(os.path.join(data, f"agent{slot if rsu else slot + 1}"))
        for scene in sorted({s for s, _, _ in frames}):
            rows = []
            for s, f, pth in frames:
                if s != scene:
                    continue
                fr = schema.load_frame(pth)
                ids = np.asarray(fr["gt_track_ids"]).copy()
                if f == 2 and len(ids) > 1:
                    ids[[0, 1]] = ids[[1, 0]]
                for bb, i in zip(np.asarray(fr["gt_boxes"]), ids):
                    if rng.random() < 0.8:
                        bb = bb + rng.normal(0, [0.3, 0.3, 0.05, 0.05, 0.05])
                        rows.append(f"{f},{i},{bb[0]:.3f},{bb[1]:.3f},{bb[2]:.3f},{bb[3]:.3f},{bb[4]:.4f},1.0")
            with open(os.path.join(out_dir, f"track_agent{slot}_scene{scene}.txt"), "w") as fh:
                fh.write("" if (slot, scene) == (1, 1) else "\n".join(rows) + "\n")


@pytest.mark.parametrize("rsu", [1, 0])
def test_eval_mot_matches_jax(capsys, tmp_path, track_data, rsu):
    tracks = str(tmp_path / "tracks")
    _tracks_from_gt(track_data, tracks, rsu, seed=rsu)
    argv = ["--data", track_data, "--tracks", tracks, "--rsu", str(rsu), "--grid", "32"]
    out, got = _run(capsys, eval_mot.main, argv)
    ref_out, want = _run(capsys, JAX_EVAL.main, argv)
    assert out == ref_out
    assert got.keys() == want.keys() == {"MOTA", "MOTP"}
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12)
    assert 0 < got["MOTP"] <= 1 and "avg |" in out


def test_eval_mot_without_tracks_exits(tmp_path, track_data):
    with pytest.raises(SystemExit, match="no track files"):
        eval_mot.main(["--data", track_data, "--tracks", str(tmp_path)])


def test_tracking_cli_cycle(capsys, tmp_path, track_data):
    """``test_codet --tracking`` -> ``sort`` -> ``eval_mot``, all the port's,
    against the JAX tools on the port's dumps: byte-identical tracks, the
    same table."""
    logs = str(tmp_path / "logs")
    common = ["--data", track_data, "--grid", "32", "--batch", "2", "--device", "cpu", "--com", "disco"]
    _run(capsys, train_codet.main, [*common, "--nepoch", "2", "--logpath", logs])
    out, _ = _run(capsys, test_codet.main, [*common, "--resume", os.path.join(logs, "disco", "epoch_2.pth"),
                                             "--tracking", "--split", "val", "--logpath", logs])
    dumps = os.path.join(logs, "disco", "with_rsu", "val", "det_dumps")
    assert f"tracking dumps: {len(os.listdir(dumps))} files under {dumps}" in out
    tracks = {}
    for name, tool in (("port", sort), ("jax", JAX_SORT)):
        _reset_counters()
        tracks[name] = str(tmp_path / name)
        _run(capsys, tool.main, ["--det_logs_path", dumps, "--out", tracks[name]])
    names = sorted(os.listdir(tracks["jax"]))
    assert names and names == sorted(os.listdir(tracks["port"]))
    for n in names:
        assert filecmp.cmp(os.path.join(tracks["port"], n), os.path.join(tracks["jax"], n), shallow=False), n
    out, got = _run(capsys, eval_mot.main, ["--data", track_data, "--tracks", tracks["port"], "--grid", "32"])
    ref_out, want = _run(capsys, JAX_EVAL.main, ["--data", track_data, "--tracks", tracks["jax"], "--grid", "32"])
    assert out == ref_out and got == pytest.approx(want, abs=1e-12)
    assert np.isfinite(got["MOTA"]) and np.isfinite(got["MOTP"])
