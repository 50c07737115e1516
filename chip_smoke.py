#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # the whole run, one GPU
    python3 chip_smoke.py --profile  # also print the top CUDA kernels of one predict

Phases, each printing its own line; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. builds the port's CUDA kernels from ``disconet_tpu_torch/csrc`` (timed);
3. the voxelize kernel against its plain version on the card at the main
   path's shape (4, 6, 16384, 3), with NaN, inf, boundary, out-of-extent and
   masked rows, and at a second geometry (Z = 32, W = 121, so bands end
   mid-grid, and N = 10001, off the 4-point loads): bit-exact;
4. the rotated-IoU kernel against its plain version on the card at
   (24, 256, 256): random boxes, identical boxes (diagonal 1 +- 1e-4) and
   zero-size padding rows (exactly 0). Built with ``-fmad=false`` the kernel
   rounds every operation as the plain version does and agrees bit for bit;
   the measured error is printed and 1e-5 stays as the outer limit;
5. the main path: ``predict`` of DiscoNet at the full ``Config()`` width,
   4 scenes x 6 agents x 16384 points with one absent agent, with seeded
   random weights. Both kernels' launch counts must rise; the outputs must be
   finite and equal (keep masks) or within 1e-4 (boxes, scores) to the same
   pipeline run with the plain ops on the card; and on a small float32 input
   the card's pipeline must give the CPU plain pipeline's keep mask;
6. times after warm-up: each kernel with CUDA events around 20 wrapper calls
   (``ms``, host work included) and with torch.profiler as the summed device
   time of what one call launches (``device_ms``), its plain version and its
   bound (the IoU's counts only the pairs this run's boxes make it clip), and
   the IoU's device time on sparser and denser boxes; the stages of
   ``predict``; ``predict`` per batch and scenes/s, the median of 5 windows
   of 60 calls.

Prints the kernels' JSON line, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations of csrc/rotated_iou.cu, counted by hand (each add, mul,
# div, sqrt, abs, min/max, compare and negation as one). Every pair: 2 for
# the area tests, 8 for the separation test. A pair that is clipped (not
# skipped_pairs): for each of the 16 (edge of A, edge of B), 7 shared by both
# passes (corner difference, denominator and its abs), 15 for the A-in-B pass
# and 13 for the B-in-A pass (numerator, parallel test, quotient, min or
# max); 15 per edge for its piece's shoelace term, 8 edges; 8 for the union
# and the quotient.
# Every box: 36 for the corners (with cos and sin), 8 per edge for its
# vector, length and the two tolerance terms, 1 for the area, 12 for the
# reach.
IOU_OPS_PER_PAIR = 2 + 8
IOU_OPS_PER_CLIPPED_PAIR = 16 * (7 + 15 + 13) + 8 * 15 + 8
IOU_OPS_PER_BOX = 36 + 4 * 8 + 1 + 12
BATCH, AGENTS, POINTS = 4, 6, 16384


def iou_reach(boxes):
    """(..., 5) boxes -> (cx, cy, reach), as csrc/rotated_iou.cu's ``reach``
    computes them in float32: the radius of the box's circumscribed circle
    plus a slack of 1e-3 * (1 + |cx| + |cy| + radius), over ten times what the
    clipping's tolerance, parallel test and rounding can move a boundary."""
    cx, cy, w, l = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    r = 0.5 * (w * w + l * l).sqrt()
    return cx, cy, r + 1e-3 * (1.0 + cx.abs() + cy.abs() + r)


def skipped_pairs(boxes_a, boxes_b):
    """(B, N, 5) x (B, M, 5) -> (B, N, M) bool: the pairs the IoU kernel writes
    0 to without clipping, where the plain version's IoU is exactly 0: a box
    without area (the NMS's dead slots), or reaches that do not meet."""
    ax, ay, ar = (v[:, :, None] for v in iou_reach(boxes_a))
    bx, by, br = (v[:, None, :] for v in iou_reach(boxes_b))
    dx, dy, r = ax - bx, ay - by, ar + br
    live = (boxes_a[..., 2] * boxes_a[..., 3] > 0)[:, :, None] & (boxes_b[..., 2] * boxes_b[..., 3] > 0)[:, None, :]
    return ~live | (dx * dx + dy * dy > r * r)


def _time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters=20, warmup=3):
    """Device time of one call of ``fn``: the summed CUDA time of every kernel,
    memset and copy it launches, read from torch.profiler over ``iters`` calls
    after warm-up. Unlike ``_time_ms`` it leaves out the host's share of a
    call. Returns (ms per call, {device event name: ms per call})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name] = per_name.get(e.name, 0.0) + e.device_time_total / 1e3 / iters
    if not per_name:
        raise AssertionError("torch.profiler recorded no device work")
    return sum(per_name.values()), per_name


def _points(cfg, rng, batch, agents, n):
    import numpy as np

    (x_lo, x_hi), (y_lo, y_hi), (z_lo, z_hi) = cfg.area_extents
    return rng.uniform(
        [x_lo, y_lo, z_lo], [x_hi, y_hi, z_hi], size=(batch, agents, n, 3)
    ).astype(np.float32)


def _random_boxes(rng, frames, n):
    import numpy as np

    return np.stack(
        [
            rng.uniform(-8, 8, (frames, n)),
            rng.uniform(-8, 8, (frames, n)),
            rng.uniform(0.5, 4, (frames, n)),
            rng.uniform(0.5, 5, (frames, n)),
            rng.uniform(-np.pi, np.pi, (frames, n)),
        ],
        -1,
    ).astype(np.float32)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from disconet_tpu_torch import Config, build_model, example_batch, make_anchors, predict, tiny_config
    from disconet_tpu_torch import _build
    from disconet_tpu_torch.models.base import agents_to_batch
    from disconet_tpu_torch.ops.nms import packed_scores_and_deltas, rotated_nms_decode
    from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix, rotated_iou_matrix_plain
    from disconet_tpu_torch.ops.voxelize import voxelize_occupy, voxelize_occupy_plain

    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")

    cfg = Config()
    rng = np.random.default_rng(0)

    # 3. voxelize kernel vs plain, bit-exact
    pts = _points(cfg, rng, BATCH, AGENTS, POINTS)
    pts[..., :64, :] *= 1.5  # some rows out of extent
    pts[0, 0, 100] = np.nan
    pts[0, 1, 101] = [np.inf, 0.0, 0.0]
    pts[1, 0, 102] = [32.0, 0.0, 0.0]  # on hi: dropped
    pts[1, 1, 103] = [-32.0, -32.0, -3.0]  # on lo: kept
    vmask = rng.random(pts.shape[:-1]) < 0.9
    vmask[1, 1, 103] = True
    pts_d = torch.from_numpy(pts).to(dev)
    vmask_d = torch.from_numpy(vmask).to(dev)
    vox_err = 0.0
    for m in (None, vmask_d):
        got = voxelize_occupy(pts_d, cfg.voxel_size, cfg.area_extents, mask=m)
        want = voxelize_occupy_plain(pts_d, cfg.voxel_size, cfg.area_extents, mask=m)
        torch.cuda.synchronize()
        vox_err = max(vox_err, (got - want).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"voxelize kernel != plain (mask={m is not None}): "
                                 f"{int((got != want).sum())} cells differ")
        if got[1, 1, 0, 0, 0].item() != 1.0:
            raise AssertionError("the point on lo was dropped")
    print(f"voxelize: bit-exact at {tuple(pts.shape)} -> {tuple(got.shape)}, "
          f"{int(got.sum().item())} occupied cells")
    vs2, ext2 = (0.25, 0.25, 0.15625), ((-20.0, 20.0), (-15.125, 15.125), (-3.0, 2.0))
    pts2 = rng.uniform([-21, -16, -3.5], [21, 16, 2.5], size=(2, 3, 10001, 3)).astype(np.float32)
    pts2_d = torch.from_numpy(pts2).to(dev)
    mask2_d = torch.from_numpy(rng.random(pts2.shape[:-1]) < 0.9).to(dev)
    for m in (None, mask2_d):
        got2 = voxelize_occupy(pts2_d, vs2, ext2, mask=m)
        want2 = voxelize_occupy_plain(pts2_d, vs2, ext2, mask=m)
        torch.cuda.synchronize()
        vox_err = max(vox_err, (got2 - want2).abs().max().item())
        if got2.shape[-3:] != (160, 121, 32) or not torch.equal(got2, want2):
            raise AssertionError(f"voxelize kernel != plain at {tuple(got2.shape)} "
                                 f"(mask={m is not None})")
    print(f"voxelize: bit-exact at {tuple(pts2.shape)} -> {tuple(got2.shape)}, "
          f"{int(got2.sum().item())} occupied cells")

    # 4. rotated-IoU kernel vs plain
    K = cfg.nms_top_k
    frames = BATCH * AGENTS
    boxes = _random_boxes(rng, frames, K)
    boxes[:, 10:20] = boxes[:, 0:10]  # identical pairs off the diagonal
    boxes[:, -16:] = 0.0  # padding rows
    boxes_d = torch.from_numpy(boxes).to(dev)
    got = rotated_iou_matrix(boxes_d, boxes_d)
    want = rotated_iou_matrix_plain(boxes_d, boxes_d)
    torch.cuda.synchronize()
    iou_err = (got - want).abs().max().item()
    if not iou_err <= 1e-5:
        raise AssertionError(f"IoU kernel vs plain max abs err {iou_err}")
    diag = torch.diagonal(got[:, :-16, :-16], dim1=1, dim2=2)
    if not (diag - 1).abs().max().item() <= 1e-4:
        raise AssertionError(f"IoU diagonal off 1 by {(diag - 1).abs().max().item()}")
    if not (got[:, 10:20, 0:10].diagonal(dim1=1, dim2=2) - 1).abs().max().item() <= 1e-4:
        raise AssertionError("identical boxes off the diagonal do not give IoU 1")
    if got[:, -16:].abs().max().item() != 0.0 or got[:, :, -16:].abs().max().item() != 0.0:
        raise AssertionError("padding rows are not exactly 0")
    print(f"rotated_iou: max abs err {iou_err:.3e} (limit 1e-5) at {tuple(got.shape)}")

    # 5. the main path at full width
    model = build_model("disco", cfg, seed=0)
    _, trans, amask = example_batch(cfg, BATCH, AGENTS, seed=0)
    amask[1, AGENTS - 1] = False
    pts = _points(cfg, rng, BATCH, AGENTS, POINTS)
    pts[1, AGENTS - 1] = np.nan  # the absent agent sends only padding
    anchors = torch.from_numpy(make_anchors(cfg)).to(dev)
    pts_d = torch.from_numpy(pts).to(dev)
    trans_d = torch.from_numpy(trans).to(dev)
    amask_d = torch.from_numpy(amask).to(dev)

    voxelize_occupy.launches = 0
    rotated_iou_matrix.launches = 0
    out_boxes, out_scores, keep = predict(model, pts_d, trans_d, amask_d, anchors, cfg)
    torch.cuda.synchronize()
    launches = {"voxelize": voxelize_occupy.launches, "rotated_iou": rotated_iou_matrix.launches}
    print(f"predict: launches {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    if out_boxes.shape != (BATCH, AGENTS, K, 5) or keep.shape != (BATCH, AGENTS, K):
        raise AssertionError(f"bad output shapes {tuple(out_boxes.shape)} {tuple(keep.shape)}")
    if not (torch.isfinite(out_boxes).all() and torch.isfinite(out_scores).all()):
        raise AssertionError("non-finite outputs")
    pb, ps, pk = predict(model, pts_d, trans_d, amask_d, anchors, cfg,
                         voxelize=voxelize_occupy_plain, iou=rotated_iou_matrix_plain)
    torch.cuda.synchronize()
    if not torch.equal(keep, pk):
        raise AssertionError(f"keep masks differ from the plain ops in {int((keep != pk).sum())} slots")
    box_err = (out_boxes - pb).abs().max().item()
    score_err = (out_scores - ps).abs().max().item()
    if not (box_err <= 1e-4 and score_err <= 1e-4):
        raise AssertionError(f"kernel vs plain pipeline: box err {box_err}, score err {score_err}")
    print(f"predict: {int(keep.sum())} kept of {int((out_scores > -1).sum())} candidates; "
          f"vs plain ops: keep equal, box err {box_err:.3e}, score err {score_err:.3e}")

    # small float32 input: the card's pipeline against the CPU plain pipeline
    small = tiny_config(64, compute_dtype="float32", head_raw_dtype="float32")
    srng = np.random.default_rng(1)
    s_pts = _points(small, srng, 1, 3, 4096)
    _, s_trans, s_mask = example_batch(small, 1, 3, seed=1)
    s_anchors = make_anchors(small)
    gpu = predict(build_model("disco", small, seed=1), s_pts, s_trans, s_mask, s_anchors, small)
    cpu = predict(build_model("disco", small, device="cpu", seed=1), s_pts, s_trans, s_mask, s_anchors, small)
    if not torch.equal(gpu[2].cpu(), cpu[2]):
        raise AssertionError("small input: card keep mask != CPU plain keep mask")
    small_err = (gpu[0].cpu() - cpu[0]).abs().max().item()
    if not small_err <= 1e-4:
        raise AssertionError(f"small input: card boxes differ from CPU by {small_err}")
    print(f"small f32 input: card == CPU plain keep ({int(cpu[2].sum())} kept), box err {small_err:.3e}")

    # 6. timing
    iou_in = torch.cat(
        [out_boxes[..., :2], out_boxes[..., 2:4].abs(), out_boxes[..., 4:]], dim=-1
    ).reshape(frames, K, 5).contiguous()  # the main path's IoU input
    main_iou_err = (rotated_iou_matrix(iou_in, iou_in) - rotated_iou_matrix_plain(iou_in, iou_in)).abs().max().item()
    if not main_iou_err <= 1e-5:
        raise AssertionError(f"IoU kernel vs plain on the main path's boxes: {main_iou_err}")
    print(f"rotated_iou: max abs err {main_iou_err:.3e} (limit 1e-5) on the main path's boxes")
    vox_ms = _time_ms(lambda: voxelize_occupy(pts_d, cfg.voxel_size, cfg.area_extents))
    vox_plain_ms = _time_ms(lambda: voxelize_occupy_plain(pts_d, cfg.voxel_size, cfg.area_extents))
    iou_ms = _time_ms(lambda: rotated_iou_matrix(iou_in, iou_in))
    iou_plain_ms = _time_ms(lambda: rotated_iou_matrix_plain(iou_in, iou_in))
    vox_dev_ms, vox_dev = _device_ms(lambda: voxelize_occupy(pts_d, cfg.voxel_size, cfg.area_extents))
    iou_dev_ms, iou_dev = _device_ms(lambda: rotated_iou_matrix(iou_in, iou_in))
    for name, total, parts in (("voxelize", vox_dev_ms, vox_dev), ("rotated_iou", iou_dev_ms, iou_dev)):
        print(f"device ms: {name} {total:.4f} = "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(parts.items(), key=lambda kv: -kv[1])))
    H, W, Z = cfg.bev_shape
    vox_bytes = pts_d.numel() * 4 + frames * H * W * Z * 4
    vox_bound = vox_bytes / HBM_BYTES_PER_S * 1e3
    iou_bytes = 2 * iou_in.numel() * 4 + frames * K * K * 4
    clipped = int((~skipped_pairs(iou_in, iou_in)).sum())
    iou_ops = frames * (K * K * IOU_OPS_PER_PAIR + 2 * K * IOU_OPS_PER_BOX) + clipped * IOU_OPS_PER_CLIPPED_PAIR
    iou_bound = max(iou_bytes / HBM_BYTES_PER_S, iou_ops / FP32_OPS_PER_S) * 1e3
    print(f"bounds: voxelize {vox_bytes} bytes -> {vox_bound:.4f} ms; rotated_iou "
          f"{iou_bytes} bytes, {iou_ops} fp32 ops ({clipped} of {frames * K * K} pairs "
          f"clipped) -> {iou_bound:.4f} ms")
    # The IoU kernel's time depends on how many pairs it clips. Random weights
    # leave every slot of the main path live and spread over the map; a trained
    # model at the score threshold leaves tens of live slots a frame, clustered
    # on objects, and the NMS zeroes the rest. So the kernel is also timed on
    # the main path's 32 best candidates a frame with the rest zeroed, on 8
    # objects a frame with 4 jittered candidates each and the rest zeroed, on
    # phase 4's boxes (centres within +-8 m) and on the same boxes packed
    # within +-1 m, where nearly every pair is clipped.
    top32 = iou_in.clone()
    top32[:, 32:] = 0.0
    objects = np.stack([rng.uniform(-30, 30, (frames, 8)), rng.uniform(-30, 30, (frames, 8)),
                        rng.uniform(1.8, 2.1, (frames, 8)), rng.uniform(4.2, 4.8, (frames, 8)),
                        rng.uniform(-np.pi, np.pi, (frames, 8))], -1)
    jitter = rng.uniform(-1, 1, (frames, 8, 4, 5)) * [0.3, 0.3, 0.1, 0.2, 0.1]
    clustered = np.zeros((frames, K, 5), np.float32)
    clustered[:, :32] = (objects[:, :, None] + jitter).reshape(frames, 32, 5)
    packed = boxes_d.clone()
    packed[:, :-16, :2] /= 8.0
    for name, x in (("the main path's 32 best a frame", top32),
                    ("8 objects x 4 candidates a frame", torch.from_numpy(clustered).to(dev)),
                    ("phase 4's boxes", boxes_d), ("packed boxes", packed)):
        share = (~skipped_pairs(x, x)).float().mean().item()
        if not torch.equal(rotated_iou_matrix(x, x), rotated_iou_matrix_plain(x, x)):
            raise AssertionError(f"IoU kernel != plain on {name}")
        print(f"rotated_iou on {name}: {share:.4f} of pairs clipped, device ms "
              f"{_device_ms(lambda: rotated_iou_matrix(x, x))[0]:.4f}, bit-exact")

    with torch.inference_mode():
        bev = voxelize_occupy(pts_d, cfg.voxel_size, cfg.area_extents)
        model_ms = _time_ms(lambda: model(bev, trans_d, amask_d), iters=100)
        raw = agents_to_batch(model(bev, trans_d, amask_d)["head_raw"])

        def nms():
            s, d = packed_scores_and_deltas(raw, cfg.num_anchors, cfg.box_code_size)
            return rotated_nms_decode(d, s, anchors, cfg.nms_iou_threshold, cfg.score_threshold, K)

        nms_ms = _time_ms(nms, iters=100)
    # 5 windows of 60 calls, ~4 s in all; the figure is the median window, so
    # a host stall in one window does not move it.
    windows = [_time_ms(lambda: predict(model, pts_d, trans_d, amask_d, anchors, cfg), iters=60)
               for _ in range(5)]
    predict_ms = sorted(windows)[2]
    print(f"stages ms: voxelize {vox_ms:.4f}, model {model_ms:.4f}, scores+nms {nms_ms:.4f}")
    print(f"predict: {predict_ms:.3f} ms per batch of {BATCH} scenes, "
          f"{BATCH * 1e3 / predict_ms:.2f} scenes/s (median of 5 windows of 60 calls: "
          + ", ".join(f"{BATCH * 1e3 / w:.2f}" for w in windows)
          + f"), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    if "--profile" in argv:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            predict(model, pts_d, trans_d, amask_d, anchors, cfg)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))

    kernels = [
        {
            "name": "voxelize_occupy",
            "route": "cuda",
            "source": "disconet_tpu_torch/csrc/voxelize.cu",
            "replaces": "disconet_tpu/ops/pallas/voxelize_pallas.py:121",
            "launches": launches["voxelize"],
            "max_abs_err": vox_err,
            "ms": vox_ms,
            "device_ms": vox_dev_ms,
            "plain_ms": vox_plain_ms,
            "bound_ms": vox_bound,
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "rotated_iou_matrix",
            "route": "cuda",
            "source": "disconet_tpu_torch/csrc/rotated_iou.cu",
            "replaces": "disconet_tpu/ops/pallas/rotated_iou_pallas.py:135",
            "launches": launches["rotated_iou"],
            "max_abs_err": max(iou_err, main_iou_err),
            "ms": iou_ms,
            "device_ms": iou_dev_ms,
            "plain_ms": iou_plain_ms,
            "bound_ms": iou_bound,
            "bound_by": "operations" if iou_ops / FP32_OPS_PER_S > iou_bytes / HBM_BYTES_PER_S else "bytes",
            "library_ms": None,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
