"""The port's recorder (``utils/profiling.py``): spans and counters where
the work happens, on the CPU at the 32-grid.

Off, a span is one shared no-op and nothing is recorded. Under
``recording()`` a ``predict`` call opens each ``predict/``, ``model/`` and
``nms/`` span once (``model/warp`` once per warp: V2VNet re-warps each
round), the NMS fixpoint counts one ``sync/nms.suppress`` per host read,
the same on a repeated call, and host inputs copied to another device count
their bytes. A train step opens ``train/forward``, ``train/backward`` and
``train/update`` once each, ``train/kd`` once with KD. A ``torch.profiler``
turns recording on and carries the spans into its trace; ``train_codet
--profile`` writes that trace and prints the tables. Counts add up from
many threads.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from disconet_tpu_torch import build_model, example_train_batch, tiny_config
from disconet_tpu_torch.ops.boxes import make_anchors
from disconet_tpu_torch.ops.nms import _suppress
from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix_plain
from disconet_tpu_torch.pipeline import _as_tensor, predict
from disconet_tpu_torch.tools.det import create_data_det, train_codet
from disconet_tpu_torch.training import (
    batch_to_device, create_train_state, make_train_step, precompute_teacher_feats,
)
from disconet_tpu_torch.utils import profiling

PREDICT_SPANS = ("predict/inputs", "predict/voxelize", "model/encode", "model/decode", "nms/select", "nms/suppress")


@pytest.fixture(autouse=True)
def _clear_tables():
    torch.set_num_threads(min(torch.get_num_threads(), 2))
    profiling.snapshot()
    yield
    profiling.snapshot()


def _inputs(cfg, B=2, A=3, N=400, seed=0):
    rng = np.random.default_rng(seed)
    (x0, x1), (y0, y1), (z0, z1) = cfg.area_extents
    points = np.stack([rng.uniform(x0, x1, (B, A, N)), rng.uniform(y0, y1, (B, A, N)),
                       rng.uniform(z0, z1, (B, A, N))], -1).astype(np.float32)
    trans = np.tile(np.eye(4, dtype=np.float32), (B, A, A, 1, 1))
    mask = np.ones((B, A), bool)
    mask[1, A - 1] = False
    return points, trans, mask, make_anchors(cfg)


def test_recording_off_records_nothing():
    cfg = tiny_config(32)
    assert not profiling.active()
    assert profiling.annotate("model/warp") is profiling.annotate("nms/select")
    profiling.count("sync/nms.suppress", 3)
    predict(build_model("disco", cfg, device="cpu").eval(), *_inputs(cfg), cfg)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("com,packed,warps", [("disco", False, 1), ("disco", True, 1), ("v2v", False, 3),
                                              ("lowerbound", False, 0)])
def test_predict_opens_each_span_once_a_call(com, packed, warps):
    cfg = tiny_config(32, packed_nms=packed)
    model = build_model(com, cfg, device="cpu").eval()
    inputs = _inputs(cfg)
    with profiling.recording():
        for _ in range(2):
            predict(model, *inputs, cfg)
    spans = {k: v["count"] for k, v in profiling.snapshot()["spans"].items()}
    want = {s: 2 for s in PREDICT_SPANS}
    if warps:
        want.update({"model/warp": 2 * warps, "model/fuse": 2})
    assert spans == want


def test_h2d_bytes_count_the_host_inputs():
    cfg = tiny_config(32)
    inputs = _inputs(cfg)
    meta = torch.device("meta")
    with profiling.recording():
        for x in inputs:
            _as_tensor(x, torch.float32, meta)
        _as_tensor(torch.ones(5, device=meta), torch.float32, meta)  # already there: no copy
        predict(build_model("disco", cfg, device="cpu").eval(), *inputs, cfg)  # on the host: no copy
    counters = profiling.snapshot()["counters"]
    assert counters == {"h2d_bytes/pageable": sum(np.asarray(x).nbytes for x in inputs),
                        "sync/nms.suppress": counters["sync/nms.suppress"]}


def test_nms_syncs_are_counted_and_repeat():
    cfg = tiny_config(32)
    model = build_model("v2v", cfg, device="cpu").eval()
    inputs = _inputs(cfg, seed=3)
    syncs = []
    for _ in range(2):
        with profiling.recording():
            predict(model, *inputs, cfg)
        syncs.append(profiling.snapshot()["counters"]["sync/nms.suppress"])
    assert 1 <= syncs[0] <= cfg.nms_top_k and syncs[0] == syncs[1]


def test_suppress_counts_one_sync_per_fixpoint_step():
    # a chain of boxes 1 m apart, each overlapping the next (IoU 0.2): greedy
    # keeps 0 and 2, and the fixpoint settles after 3 changes and 1 check
    boxes = torch.tensor([[[float(i), 0.0, 1.5, 1.5, 0.0] for i in range(4)]])
    scores = torch.tensor([[0.9, 0.8, 0.7, 0.6]])
    with profiling.recording():
        keep = _suppress(boxes, scores, 0.1, rotated_iou_matrix_plain)
    assert keep.tolist() == [[True, False, True, False]]
    tables = profiling.snapshot()
    assert tables["counters"] == {"sync/nms.suppress": 4} and tables["spans"]["nms/suppress"]["count"] == 1


@pytest.mark.parametrize("kd", ["none", "teacher", "cache"])
def test_train_step_opens_each_span_once(kd):
    cfg = tiny_config(32)
    model = build_model("disco", cfg, device="cpu", kd_flag=kd != "none")
    teacher = build_model("teacher", cfg, device="cpu") if kd != "none" else None
    host = example_train_batch(cfg, 2, 3, seed=1)
    tables = None
    if kd == "cache":
        host["frame_idx"] = np.arange(2, dtype=np.int64)
        frames = [{"bev_teacher": host["bev_teacher"][i], "agent_mask": host["agent_mask"][i], "frame_idx": i}
                  for i in range(2)]
        tables = precompute_teacher_feats(teacher, frames, cfg, batch_size=2, num_workers=0)
    step = make_train_step(model, cfg, create_train_state(model), None if tables else teacher,
                           kd_flag=kd != "none", kd_from_cache=tables)
    batch = batch_to_device(host, "cpu")
    with profiling.recording():
        step(batch)
    spans = {k: v["count"] for k, v in profiling.snapshot()["spans"].items()}
    want = {"train/forward": 1, "train/backward": 1, "train/update": 1}
    if kd != "none":
        want["train/kd"] = 1
    assert {k: v for k, v in spans.items() if k.startswith("train/")} == want
    # the student's forward, and the teacher's where it runs
    assert spans["model/encode"] == spans["model/decode"] == (2 if kd == "teacher" else 1)


def test_a_profiler_turns_recording_on(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    cfg = tiny_config(32)
    model = build_model("disco", cfg, device="cpu").eval()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.active()
        predict(model, *_inputs(cfg), cfg)
    assert not profiling.active()
    assert set(profiling.snapshot()["spans"]) >= set(PREDICT_SPANS)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"}
    assert names >= set(PREDICT_SPANS) | {"model/warp", "model/fuse"}


def test_the_profiler_flag_is_read_from_torch():
    # the private flag a profiler sets; if torch renames it, spans stop
    # recording under the benchmark's traced phases, so this fails first
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    assert profiling._profiler_state is torch.autograd.profiler


def test_counts_add_up_from_many_threads():
    threads, n = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            def work():
                for _ in range(n):
                    with profiling.annotate("probe/span"):
                        profiling.count("probe/count", 2)

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    tables = profiling.snapshot()
    assert tables["counters"] == {"probe/count": 2 * threads * n}
    assert tables["spans"]["probe/span"]["count"] == threads * n


def test_train_codet_profile_writes_the_trace_and_the_tables(capsys, tmp_path):
    root, logs = str(tmp_path / "data"), str(tmp_path / "logs")
    create_data_det.main(["--data", root, "--split", "train", "--mode", "synthetic",
                          "--scenes", "1", "--frames", "3", "--grid", "32"])
    capsys.readouterr()
    train_codet.main(["--data", os.path.join(root, "train"), "--grid", "32", "--batch", "2", "--logpath", logs,
                      "--device", "cpu", "--bound", "lowerbound", "--nepoch", "3", "--profile", "1"])
    out = capsys.readouterr().out
    with open(os.path.join(logs, "lowerbound", "profile", "trace.json")) as f:
        text = f.read()
    assert '"train/backward"' in text and '"model/encode"' in text
    rows = {line.split()[0]: line.split()[1] for line in out.splitlines() if line.startswith("train/")}
    assert rows == {"train/forward": "1", "train/backward": "1", "train/update": "1"}
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
