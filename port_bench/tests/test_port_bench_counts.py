"""The yardstick's arithmetic: operation counts, roofline bounds, the
trace's reduction and the per-layer readers, against hand counts."""

import math

import pytest
import torch

from port_bench.core import peaks
from port_bench.core.registry import load_cell
from port_bench.core.trace import TraceSummary
from port_bench.reference.fusion import disco, v2v
from port_bench.reference.model import backbone_flops
from port_bench.tests.tiny import tiny_config


def test_backbone_flops_by_hand():
    cfg = tiny_config("disconet")["config"]  # 32x32x13 grid, channels 32..512, head 128, 6 anchors
    enc = [2 * 9 * 32 * 32 * (13 * 32 + 32 * 32), 2 * 9 * 16 * 16 * (32 * 64 + 64 * 64),
           2 * 9 * 8 * 8 * (64 * 128 + 128 * 128), 2 * 9 * 4 * 4 * (128 * 256 + 256 * 256),
           2 * 9 * 2 * 2 * (256 * 512 + 512 * 512)]
    dec = [2 * 9 * 4 * 4 * (768 * 256 + 256 * 256), 2 * 9 * 8 * 8 * (384 * 128 + 128 * 128),
           2 * 9 * 16 * 16 * (192 * 64 + 64 * 64), 2 * 9 * 32 * 32 * (96 * 32 + 32 * 32)]
    head = 2 * 9 * 32 * 32 * 32 * 128 + 2 * 32 * 32 * 128 * 6 * (2 + 6)
    assert backbone_flops(cfg) == sum(enc) + sum(dec) + head == 529_858_560


def test_fusion_flops_by_hand():
    cfg = tiny_config("disconet")["config"]
    present = torch.tensor([[True, True, True], [True, True, False]])  # 9 + 4 present pairs, 5 receivers
    per_pair_cell = 8 * 256 + 2 * (512 * 128 + 128 * 32 + 32 * 8 + 8) + 2 * 256
    assert disco.flops(cfg, 16, 256, present) == 13 * 16 * per_pair_cell
    conv = 2 * 9 * 512 * 256
    assert v2v.flops(cfg, 16, 256, present) == 3 * (13 * 16 * (8 * 256 + conv + 256) + 5 * 16 * 3 * conv)


def test_roofline_bounds_by_hand():
    assert peaks.voxelize_bound_s(10, 2, 100) == (10 * 3 * 4 + 2 * 100 * 4) / 3.35e12
    same = torch.tensor([[[0.0, 0.0, 2.0, 4.0, 0.0], [0.5, 0.0, 2.0, 4.0, 0.3]]])
    # 4 clipped pairs; every pair 10, every box 81, every clipped pair 688 operations
    ops = 2 * 2 * 10 + 4 * 81 + 4 * 688
    assert peaks.rotated_iou_bound_s(same, same) == max((20 * 4 + 4 * 4) / 3.35e12, ops / 67e12)
    far = torch.tensor([[[0.0, 0.0, 2.0, 4.0, 0.0], [50.0, 0.0, 2.0, 4.0, 0.3]]])
    assert int((~peaks.skipped_pairs(far, far)).sum()) == 2
    dead = torch.zeros(1, 2, 5)
    assert bool(peaks.skipped_pairs(dead, same).all())


def _x(name, cat, tid, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def summary():
    ev = [_x("call", "user_annotation", 1, 0, 100), _x("model", "user_annotation", 1, 10, 32),
          _x("fusion", "user_annotation", 1, 20, 10), _x("aten::conv2d", "cpu_op", 1, 9, 29)]
    for corr, (tid, ts) in enumerate([(1, 5), (1, 15), (1, 25), (1, 70), (2, 30)], start=1):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", tid, ts, 1, corr))
    ev += [_x("k1", "kernel", 7, 6, 4, 1), _x("k2", "kernel", 7, 16, 10, 2), _x("k3", "kernel", 7, 26, 10, 3),
           _x("copy", "gpu_memcpy", 8, 80, 5, 4), _x("bwd", "kernel", 7, 40, 5, 5)]
    return TraceSummary(ev, window_s=1e-4)


def test_trace_reduction():
    t = summary()
    us = 1e-6
    assert t.device_s("call") == pytest.approx(29 * us)
    assert t.device_s("call", exclude_cats=("gpu_memcpy",)) == pytest.approx(24 * us)
    assert t.device_s("model", outside=("fusion",)) == pytest.approx(10 * us)
    assert t.device_s("fusion") == pytest.approx(10 * us)
    assert t.device_s("call", outside=("voxelize", "model"), exclude_cats=("gpu_memcpy",)) == pytest.approx(4 * us)
    assert t.busy_s == pytest.approx(34 * us)
    assert sum(t.idle.values()) == pytest.approx(45 * us)
    assert t.idle["call: python"] == pytest.approx(35 * us)  # after the copy, nothing open but the call
    assert t.idle["model: aten::conv2d"] == pytest.approx(10 * us)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k2", pytest.approx(10 * us)] and len(b["idle_gaps"]) == 2


def test_readers():
    cell = load_cell("disconet.predict.b4")
    t = summary()
    r = {"kind": "predict", "trace": t, "device_trace": t, "profiled_calls": 2, "timed_calls": 100,
         "timed_window_s": 2.0,
         "flops_per_call": 989e9, "points_per_call": 10, "frames_per_call": 2, "grid_cells": 100}
    read = {m.name: cell.reader(m.name).read(r) for m in cell.per_layer}
    assert read["idle_share.predict"] == pytest.approx(100 * (1 - (34e-6 / 2) / (2.0 / 100)))
    assert read["mfu.predict"] == pytest.approx(100 * 989e9 * 100 / 2.0 / 989e12)
    assert read["fusion_ms.predict"] is None  # no fusion span was wrapped
    assert read["fusion_ms.predict"] is None and read["rotated_iou_roofline"] is None
    r["fusion_span"] = True
    assert cell.reader("fusion_ms.predict").read(r) == pytest.approx(1e3 * 10e-6 / 2)
    assert cell.reader("backbone_ms.predict").read(r) == pytest.approx(1e3 * 10e-6 / 2)
    assert cell.reader("nms_ms.predict").read(r) == pytest.approx(1e3 * 4e-6 / 2)
    assert cell.reader("voxelize_roofline").read(r) is None  # no device time in a voxelize span
    train = load_cell("disconet.train_kd.b4")
    tr = {"kind": "train", "timed_steps": 10, "timed_window_s": 1.0, "fwd_flops_per_step": 1e12,
          "loader_wait_s": [0.001, 0.003]}
    assert train.reader("mfu.train").read(tr) == pytest.approx(100 * 3e13 / 989e12)
    assert train.reader("loader_wait_ms.train").read(tr) == pytest.approx(2.0)
    assert train.reader("idle_share.train").read(tr) is None
    assert train.reader("mfu.train").read(r) is None  # a predict run has no training steps
    assert math.isfinite(read["idle_share.predict"])
