#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # the whole run, one GPU
    python3 chip_smoke.py --profile  # also print the top CUDA kernels of one predict and one KD step
    python3 chip_smoke.py --conv3x3  # phases 1, 2 and 16 alone

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
   of 60 calls;
7. DiscoNet training with knowledge distillation at the full ``Config()``
   width in bf16: a student with KD taps and a frozen TeacherNet, batch 4 x
   6 agents with one absent, occupancy grids packed on the host and
   unpacked on the card, sparse targets of 8 car-sized boxes a frame from
   the port's ``assign_targets``. 3 warm-up KD steps, then 5 windows of 5
   steps on the same batch; every metric must be finite, the loss must
   fall, the student's BatchNorm statistics must move and the teacher must
   stay bit-identical. Prints the step's ms (median window), scenes/s, peak
   memory and a breakdown (plain step, KD step, teacher forward alone).
   Then the trained student's ``predict`` from points: both kernels'
   launch counts must rise, keep masks equal to the plain ops';
8. one KD step on the card against the same step on the CPU, float32
   64-grid, same weights and batch: every metric within rtol 1e-4, the
   second step's loss within 1e-3;
9. the detection CLIs at the full ``Config()`` width, in-process, in a
   temporary directory under ``build/``: ``create_data_det`` writes 2
   scenes x 4 frames of synthetic data; ``train_codet`` trains the
   upperbound teacher 1 epoch, then DiscoNet with KD from the teacher's
   cached features 2 epochs (the ``KD cache:`` line, a finite loss every
   epoch) and auto-resumes it to epoch 3; ``test_codet`` evaluates epoch 3
   under torch.profiler with ``--tracking`` (the table parses, its ``#gt``
   is the dataset's, the IoU kernel ran on every predict batch, the dumps
   exist), again to time it, and with late fusion and with pose noise.
   The tracking tools read its dumps: ``sort``, then ``eval_mot`` against
   the dataset's ground truth (the ``track cli:`` line; a finite avg row).
   ``test_codet --warp_dtype float32`` (its table counts the dataset's
   ``#gt``); ``train_codet --debug_nans 1``: one epoch that finishes, then
   a run from a checkpoint with a NaN planted in a head bias, which must
   stop at step 1; ``--visualization 1``: pngs where matplotlib imports,
   else the exit that names it.
   Then a KD step from a float32 cache against the re-forward step on the
   card (64-grid, rtol 1e-5 on loss and kd_loss), and at full width in
   bf16 the two steps timed in turns on phase 7's batch. Prints each
   epoch's scenes/s (loader included) with its share spent waiting on the
   loader, the cache's MiB and precompute seconds, both steps' ms and
   ``test_codet``'s scenes/s.

10. the other fusion models and segmentation at the full ``Config()``
   width, batch 4 x 6 agents with one absent. For each of ``sum``, ``mean``,
   ``max``, ``cat``, ``agent``, ``v2v``, ``when2com`` and ``who2com``, with
   seeded random weights: ``predict`` from phase 5's points (both kernels'
   launch counts must rise, and the 3x3 conv kernel's must read 15 for
   ``v2v`` and 0 for the others; keep masks equal to the plain ops'
   pipeline, boxes and scores within 1e-4), its scenes/s as the median of 3
   windows of 20 calls; one train step on phase 7's batch (finite metrics, a
   finite nonzero gradient in every group of layers, 30 launches of the
   conv kernel for ``v2v`` and 0 for the others), then 3 timed; peak memory;
   and a float32 forward at the 64-grid on the card within 1e-4 of the CPU.
   Then DiscoNet segmentation on the UNet: 3 warm-up steps and 5 windows of
   5 on phase 7's grids with labels learnable from them (the loss must
   fall), scenes/s, peak memory and the predict step's time; one step on
   the STPN backbone; one float32 seg step on the card against the CPU
   (64-grid, loss rtol 1e-4, accuracy within 1e-4); and the seg CLIs
   in-process under ``build/`` (removed after): ``create_data_seg`` (1
   scene x 4 frames), ``train_codet --com disco`` 2 epochs, an auto-resumed
   third, ``test_codet`` (a row per class, a finite mIoU).
11. the other NMS entry points at the main path's shapes: ``predict`` with
   ``packed_nms`` (both kernels' launch counts must rise); on the same head
   outputs, ``rotated_nms_decode_packed`` against the score path: boxes,
   scores and keep equal except in frames where two distinct logit
   differences give the same float32 sigmoid (counted and printed); the two
   ``predict`` in turns, 3 windows of 20 calls each; ``rotated_nms`` on
   caller boxes and the flat layout of ``rotated_nms_decode`` with the IoU
   kernel against the plain IoU: keep and boxes equal.
12. K optimizer steps per dispatch as one CUDA graph, rematerialization and
   the CLI options of item 10 and 11, at the full ``Config()`` width on
   phase 7's batch, bf16. DiscoNet's KD step from the teacher's cached
   taps: a graph of K = 8 steps against 8 single steps from the same
   weights (each step's loss within ``K_STEP_LOSS_RTOL``, every metric
   finite, the BatchNorm statistics moved), then both timed in turns, 3
   windows of 8 steps each (ms a step, scenes/s, the device's idle share
   from torch.profiler); the same for the UNet seg step. One plain step with
   ``train_remat`` against one without from the same weights (metrics and
   each group's gradients), with the peak memory of each at batch 4 and at
   the largest of 16 and 8 that the plain step fits. ``train_codet
   --steps_per_dispatch 8`` at batch 1 over 2 scenes x 5 frames (a graph
   and a tail of 2 an epoch), auto-resumed, then ``test_codet`` (its table
   counts the dataset's ``#gt``; the IoU kernel ran on every predict
   batch). ``create_data_det --mode nuscenes`` exits naming
   nuscenes-devkit, which the card's machine lacks.
13. data and agent parallelism on the one card: DiscoNet's float32 KD step
   (teacher re-forward) and the predict step at the full ``Config()`` width,
   batch 4 x 6 agents, on ``data`` 2 (2 processes) and ``data`` 2 x
   ``agent`` 2 (4 processes) in a ``gloo`` group with CUDA tensors (nccl
   refuses two ranks on one card), and on a world of 1 over ``nccl``, each
   rank against the one-process step on the card: the losses within 1e-5,
   ``grad_norm`` within 1e-4, each group of layers' gradients within 1e-2
   (relative L2) and the running statistics within 1e-5, the CPU tests'
   bounds; predict keep counts equal and the kept scores within 2e-3. The
   one-process step run twice prints the card's own spread (0 with the
   tap-matrix warp, and at every grid since the gathered warp's backward
   adds in a fixed order). Then every
   other ``--com`` (``sum``, ``mean``, ``max``,
   ``cat``, ``agent``, ``v2v``, ``when2com``, ``who2com``) under ``agent``
   2 and under ``spatial`` 2 (2 gloo ranks on the card, one spawn per
   layout, the models in turn): one float32 train step, the same step
   computed in float64 and one ``predict`` of each at the same width and
   batch, and DiscoNet's ``predict``, against the one-process steps on the
   card: each group of layers' gradients within 1e-2 (relative L2) in
   float32 and within 1e-9 in float64 (the same arithmetic in another
   order, so any sharding error above rounding breaks it), keep counts
   equal; a line per model with the worst float32 group and the
   one-process step's own spread. Then ``train_codet --com disco
   --mesh_agent 2`` under ``torchrun`` (gloo, both ranks on the card) for
   an epoch of 1 scene x 4 frames of synthetic data at full width,
   auto-resumed for a second.

14. the block-out decoder and the tap-matrix warp (the JAX package's
   defaults): DiscoNet's float32 KD step at the 64-grid with both decoder
   stages in the block-out layout (``block_out_dec1``), card against CPU at
   phase 8's bounds; DiscoNet's bf16 K-step graph (8 steps a dispatch) run
   twice from one seed, at the quality protocol's 64-grid (3 dispatches)
   and at the full ``Config()`` width (1 dispatch), every parameter and
   buffer compared with ``torch.equal``; phase 13's float32 KD step twice
   with cuDNN's own algorithms and with deterministic ones (as
   ``build_model`` sets them: bit-identical); the ops that
   ``torch.use_deterministic_algorithms`` names in a single step of each,
   and in a full-width step fused at layer 2 (64x64 cells: the gather),
   whose K-step graph (1 dispatch of 8) must repeat bit for bit too; the
   gather's float32 forward and backward at 64x64 against autograd's
   ``index_select`` backward (an ``index_add`` with atomics), in turns:
   the same forward, gradients within 1e-6 (relative L2);
   the gather and the tap-matrix product timed in turns at 32x32 (layer 3
   at full width) and 8x8 (layer 3 of the 64-grid) cells, training
   (forward and backward, float32) and inference (bf16 forward); decoder
   stage 0 at full width in both layouts, the same; DiscoNet's KD step
   (teacher re-forward) and ``predict`` at full width against the parent's
   layout (natural decoder, gathered warp), and the KD step with cuDNN's
   own algorithms against deterministic ones, in turns.
15. the block-space layouts at the full ``Config()`` width, batch 4 x 6
   agents with one absent: DiscoNet with ``block_space`` and with
   ``block_out_encoder`` against the natural layout from the same weights,
   the float32 KD step (teacher re-forward; losses and the BatchNorm
   statistics within 1e-4, each group's gradients and ``grad_norm`` within
   the CPU tests' 3e-2 against JAX)
   and the step in float64 on one scene (every metric and group within
   1e-9: the rewrite is exact); each layout's bf16 KD step and ``predict`` timed in
   turns against the default (block-out) layout, both kernels launching
   once per ``predict``; ``head_in_dtype`` "bfloat16": ``predict``'s keep
   masks equal to the default's, its KD step timed against the default's;
   ``ConfigGlobal`` builds the teacher, whose outputs equal a ``Config()``
   teacher's from the same seed.

16. (run right after phase 2) V2VNet's float32 3x3 convs on the 3xTF32
   kernel (``ops/conv3x3.py``) at the shapes of its fusion at every
   ``--layer`` (the message conv's halves and the ConvGRU's convs at 32x32
   x 256, the main path, 64x64 x 128, 128x128 x 64 and 256x256 x 32) and
   the ConvGRU's halo form on a strip of spatial 2: forward and input gradient against a float64 conv of
   the same inputs, the kernel's largest and RMS error at most 2x cuDNN
   float32's (TF32 off) on the same data, a planted single TF32 pass past
   that limit, two runs bit-identical; ptxas's registers and spills; the
   kernel's times beside cuDNN's and the 3-pass bound, and their sums over a
   ``predict``'s 15 convs at each ``--layer``.

Phases 7, 9 and 12 also time their bf16 steps with the parent's arithmetic
(every conv result rounded to bf16, patched in) and with the repair
(operands rounded, fp32 results) in turns, printing ``precision A/B`` lines
with the card's name and power limit: the KD step with the teacher
re-forward, the KD step from the cache, the K-step graphs of KD and UNet seg
steps and the 64-grid quality step in a graph of 8.

Prints the kernels' JSON line, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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


# the card's "name, power.limit" (phase 1), printed beside every A/B reading
_SMI = ""


def _parent_conv(x, w, stride, padding):
    """The parent's bf16 conv: cuDNN's bf16 conv, its result rounded to bf16."""
    import torch
    import torch.nn.functional as F

    return F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), stride=stride, padding=padding).float()


def _parent_round(x):
    """The parent's operand rounding, whose backward rounded the cotangent."""
    import torch

    return x.to(torch.bfloat16).float()


@contextlib.contextmanager
def _arithmetic(arm: str):
    """``arm`` "parent": the bf16 arithmetic before the precision repair
    (every conv result rounded to bf16, the dots' cotangents rounded),
    patched into ``models/backbone.py`` for a before/after timing;
    "repair": the port's own (operands rounded, fp32 results)."""
    from unittest import mock

    from disconet_tpu_torch.models import backbone

    with contextlib.ExitStack() as stack:
        if arm == "parent":
            stack.enter_context(mock.patch.object(backbone, "conv2d_bf16_operands", _parent_conv))
            stack.enter_context(mock.patch.object(backbone, "_round_bf16", _parent_round))
        yield


def _turns(label, fns, calls=5, windows=4, unit="a step", per_call=1):
    """``fns`` {arm: fn} (each sets its own arithmetic or layout), warmed
    up, then timed in turns (A B, B A, ...), ``windows`` windows of
    ``calls`` calls each with CUDA events. Prints and returns the medians,
    ms a call divided by ``per_call`` (the steps one call runs)."""
    import statistics

    import torch

    arms = list(fns)
    for fn in fns.values():
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    times = {a: [] for a in arms}
    for i in range(windows):
        for arm in arms if i % 2 == 0 else arms[::-1]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fns[arm]()
            end.record()
            torch.cuda.synchronize()
            times[arm].append(start.elapsed_time(end) / (calls * per_call))
    med = {a: statistics.median(v) for a, v in times.items()}
    a, b = arms
    print(f"{label}: {a} {med[a]:.4f} ms, {b} {med[b]:.4f} ms {unit} ({100 * (med[b] / med[a] - 1):+.1f}%; "
          f"windows " + "; ".join(f"{k} " + ", ".join(f"{w:.4f}" for w in v) for k, v in times.items())
          + f"); {_SMI}")
    return med


def _precision_ab(label, build, steps_per_call=1, calls=5, windows=4):
    """One call of ``build()`` under each arithmetic ("parent", then
    "repair") -> a function that runs ``steps_per_call`` train steps (a
    K-step graph captures under its arithmetic); timed in turns by
    :func:`_turns`, each call under its arithmetic. Returns the medians, ms
    a step."""
    fns = {}
    for arm in ("parent", "repair"):
        with _arithmetic(arm):
            fn = build()

        def run(fn=fn, arm=arm):
            with _arithmetic(arm):
                fn()

        fns[arm] = run
    return _turns(f"precision A/B, {label}", fns, calls, windows, per_call=steps_per_call)


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

    from disconet_tpu_torch import (
        Config, build_model, example_batch, example_train_batch, make_anchors, predict, tiny_config,
    )
    from disconet_tpu_torch import _build
    from disconet_tpu_torch.models.base import agents_to_batch
    from disconet_tpu_torch.ops.conv3x3 import conv3x3_f32x3
    from disconet_tpu_torch.ops.nms import packed_scores_and_deltas, rotated_nms_decode
    from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix, rotated_iou_matrix_plain
    from disconet_tpu_torch.ops.voxelize import voxelize_occupy, voxelize_occupy_plain

    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    global _SMI
    _SMI = smi
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    # phase 16 runs here, before phase 3: at the end of a whole run torch.profiler
    # recorded no device work in it (after phases 3-15, phase 13's ranks last)
    p16 = _phase16()
    if "--conv3x3" in argv:  # phase 16 alone
        print(json.dumps({"conv3x3": p16}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

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
    conv3x3_f32x3.launches = 0
    out_boxes, out_scores, keep = predict(model, pts_d, trans_d, amask_d, anchors, cfg)
    torch.cuda.synchronize()
    launches = {"voxelize": voxelize_occupy.launches, "rotated_iou": rotated_iou_matrix.launches,
                "conv3x3": conv3x3_f32x3.launches}
    print(f"predict: launches {launches}")
    if min(launches["voxelize"], launches["rotated_iou"]) < 1 or launches["conv3x3"] != 0:
        raise AssertionError(f"a kernel was not launched on the main path, or V2VNet's conv was: {launches}")
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
        model_ms = _time_ms(lambda: model(bev, trans_d, amask_d, store_bf16=True), iters=100)
        raw = agents_to_batch(model(bev, trans_d, amask_d, store_bf16=True)["head_raw"])

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

    # 7. KD training at full width, then the trained student's predict
    from disconet_tpu_torch.training import batch_to_device, create_train_state, get_bev, make_train_step

    t0 = time.perf_counter()
    host7 = example_train_batch(cfg, BATCH, AGENTS, seed=2)
    tb = batch_to_device(host7)
    n_pos = int((tb["reg_pos_idx"] < np.prod(cfg.bev_shape[:2]) * cfg.num_anchors).sum())
    print(f"train batch: {n_pos} positive anchors, bev shipped as {tuple(tb['bev_packed'].shape)} uint8, "
          f"built in {time.perf_counter() - t0:.2f} s")
    student = build_model("disco", cfg, seed=0, kd_flag=True)
    teacher = build_model("teacher", cfg, seed=1)
    t_state = {k: v.clone() for k, v in teacher.state_dict().items()}
    stats0 = {k: v.clone() for k, v in student.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    kd_step = make_train_step(student, cfg, create_train_state(student), teacher=teacher, kd_flag=True)
    history = [kd_step(tb) for _ in range(3)]  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_windows = []
    for _ in range(5):  # 5 windows of 5 steps on the same batch
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            history.append(kd_step(tb))
        end.record()
        torch.cuda.synchronize()
        step_windows.append(start.elapsed_time(end) / 5)
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    hist = {k: torch.stack([h[k] for h in history]).cpu() for k in history[0]}
    if set(hist) != {"loss", "cls_loss", "reg_loss", "kd_loss", "grad_norm"}:
        raise AssertionError(f"train step metrics {sorted(hist)}")
    bad = [k for k, v in hist.items() if not torch.isfinite(v).all()]
    if bad:
        raise AssertionError(f"non-finite train metrics: {bad}")
    if not hist["loss"][-1] < hist["loss"][0]:
        raise AssertionError(f"loss did not fall: {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}")
    sd = student.state_dict()
    if all(torch.equal(sd[k], v) for k, v in stats0.items()):
        raise AssertionError("the student's BatchNorm running statistics did not move")
    changed = [k for k, v in teacher.state_dict().items() if not torch.equal(v, t_state[k])]
    if changed:
        raise AssertionError(f"the frozen teacher changed: {changed[:5]}")
    train_ms = sorted(step_windows)[2]
    print(f"train: {len(history)} KD steps, loss {hist['loss'][0]:.2f} -> {hist['loss'][-1]:.2f} "
          f"(cls {hist['cls_loss'][-1]:.4f}, reg {hist['reg_loss'][-1]:.4f}, kd {hist['kd_loss'][-1]:.6f}, "
          f"grad_norm {hist['grad_norm'][-1]:.1f}); metrics finite, BN statistics moved, teacher unchanged")
    print(f"train: {train_ms:.3f} ms per KD step of {BATCH} scenes, {BATCH * 1e3 / train_ms:.2f} scenes/s "
          f"(median of 5 windows of 5 steps: " + ", ".join(f"{w:.3f}" for w in step_windows)
          + f" ms), peak memory {train_peak:.2f} GiB")
    plain = build_model("disco", cfg, seed=0)
    plain_step = make_train_step(plain, cfg, create_train_state(plain))
    plain_ms = _time_ms(lambda: plain_step(tb), iters=10)
    bev_teacher = get_bev(tb, "bev_teacher", cfg)
    with torch.no_grad():
        teacher_ms = _time_ms(lambda: teacher(bev_teacher, None, tb["agent_mask"]), iters=10)
    del plain, plain_step
    print(f"train breakdown ms: plain step (KD off) {plain_ms:.3f}; KD step with teacher re-forward "
          f"{train_ms:.3f} (+{train_ms - plain_ms:.3f}); teacher forward alone {teacher_ms:.3f}")

    def kd_reforward():
        s, t = build_model("disco", cfg, seed=0, kd_flag=True), build_model("teacher", cfg, seed=1)
        step = make_train_step(s, cfg, create_train_state(s), teacher=t, kd_flag=True)
        return lambda: step(tb)

    _precision_ab("KD step with teacher re-forward (phase 7)", kd_reforward)
    if "--profile" in argv:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            kd_step(tb)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))

    student.eval()
    voxelize_occupy.launches = 0
    rotated_iou_matrix.launches = 0
    s_boxes, s_scores, s_keep = predict(student, pts_d, trans_d, amask_d, anchors, cfg)
    torch.cuda.synchronize()
    train_launches = {"voxelize": voxelize_occupy.launches, "rotated_iou": rotated_iou_matrix.launches}
    if min(train_launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched by the trained model's predict: {train_launches}")
    pb, ps, pk = predict(student, pts_d, trans_d, amask_d, anchors, cfg,
                         voxelize=voxelize_occupy_plain, iou=rotated_iou_matrix_plain)
    if not torch.equal(s_keep, pk):
        raise AssertionError(f"trained model: keep masks differ from the plain ops in {int((s_keep != pk).sum())} slots")
    s_err = max((s_boxes - pb).abs().max().item(), (s_scores - ps).abs().max().item())
    if not (torch.isfinite(s_boxes).all() and s_err <= 1e-4):
        raise AssertionError(f"trained model vs plain pipeline: err {s_err}")
    print(f"trained predict: launches {train_launches}, {int(s_keep.sum())} kept; vs plain ops: keep equal, "
          f"err {s_err:.3e}")

    # 8. one KD step on the card against the CPU, float32
    _card_vs_cpu_kd_step(tiny_config(64, compute_dtype="float32", head_raw_dtype="float32"), "f32, 64-grid")

    cli = _phase9(cfg, host7, tb, kd_step, teacher)
    other = _phase10(cfg, host7, tb, (pts_d, trans_d, amask_d, anchors))
    packed = _phase11(cfg, model, (pts_d, trans_d, amask_d, anchors))
    kstep = _phase12(cfg, host7, teacher)
    del kd_step, student, tb
    torch.cuda.empty_cache()
    _phase14(cfg, host7, teacher, (pts_d, trans_d, amask_d, anchors))
    p15 = _phase15(cfg, host7, (pts_d, trans_d, amask_d, anchors))
    del teacher
    torch.cuda.empty_cache()
    _phase13(cfg)

    kernels = [
        {
            "name": "voxelize_occupy",
            "route": "cuda",
            "source": "disconet_tpu_torch/csrc/voxelize.cu",
            "replaces": "disconet_tpu/ops/pallas/voxelize_pallas.py:121",
            "launches": launches["voxelize"],
            "path_launches": {"predict": launches["voxelize"], "trained predict": train_launches["voxelize"],
                              "test_codet": cli["launches"]["voxelize"],
                              **{f"predict {c}": n["voxelize"] for c, n in other.items()},
                              "predict packed_nms": packed["voxelize"],
                              **{f"predict {a}": n["voxelize"] for a, n in p15.items()},
                              "test_codet after K-step training": kstep["launches"]["voxelize"]},
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
            "path_launches": {"predict": launches["rotated_iou"], "trained predict": train_launches["rotated_iou"],
                              "test_codet": cli["launches"]["rotated_iou"],
                              **{f"predict {c}": n["rotated_iou"] for c, n in other.items()},
                              "predict packed_nms": packed["rotated_iou"],
                              **{f"predict {a}": n["rotated_iou"] for a, n in p15.items()},
                              "test_codet after K-step training": kstep["launches"]["rotated_iou"]},
            "max_abs_err": max(iou_err, main_iou_err),
            "ms": iou_ms,
            "device_ms": iou_dev_ms,
            "plain_ms": iou_plain_ms,
            "bound_ms": iou_bound,
            "bound_by": "operations" if iou_ops / FP32_OPS_PER_S > iou_bytes / HBM_BYTES_PER_S else "bytes",
            "library_ms": None,
        },
        {
            "name": "conv3x3_f32x3",
            "route": "cuda",
            "source": "disconet_tpu_torch/csrc/conv3x3_f32x3.cu",
            "replaces": None,
            "launches": other["v2v"]["conv3x3"],
            "path_launches": {"predict": launches["conv3x3"],
                              **{f"predict {c}": n["conv3x3"] for c, n in other.items()},
                              **{f"train step {c}": n["conv3x3 train step"] for c, n in other.items()}},
            "ms": p16["per_predict"][3]["ms"],
            "device_ms": p16["per_predict"][3]["device_ms"],
            "plain_ms": p16["per_predict"][3]["library_ms"],
            "bound_ms": p16["per_predict"][3]["bound_ms"],
            "bound_by": "operations",
            "library_ms": p16["per_predict"][3]["library_ms"],
            "per_layer": p16["per_predict"],
            "shapes": p16["rows"],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


def _card_vs_cpu_kd_step(small, label):
    """Two float32 KD steps of DiscoNet at config ``small`` on the card and
    on the CPU from the same weights and batch: every metric of the first
    within 1e-4 (relative), the second loss within 1e-3."""
    from disconet_tpu_torch import build_model, example_train_batch
    from disconet_tpu_torch.training import batch_to_device, create_train_state, make_train_step

    host = example_train_batch(small, 2, 3, seed=3, occupancy=(0.05, 0.1), boxes_per_frame=4)
    steps = {}
    for name in ("cuda", "cpu"):
        s_model = build_model("disco", small, device=name, seed=0, kd_flag=True)
        s_teacher = build_model("teacher", small, device=name, seed=1)
        step = make_train_step(s_model, small, create_train_state(s_model), teacher=s_teacher, kd_flag=True)
        b = batch_to_device(host, name)
        steps[name] = [{k: float(v) for k, v in step(b).items()} for _ in range(2)]
    (g1, g2), (c1, c2) = steps["cuda"], steps["cpu"]
    rel = {k: abs(g1[k] - c1[k]) / abs(c1[k]) for k in c1}
    rel2 = abs(g2["loss"] - c2["loss"]) / abs(c2["loss"])
    if max(rel.values()) > 1e-4 or rel2 > 1e-3:
        raise AssertionError(f"card vs CPU KD step ({label}): relative differences {rel}, second loss {rel2}")
    print(f"card vs CPU KD step ({label}): " + ", ".join(f"{k} {g1[k]:.6g} ({rel[k]:.1e})" for k in sorted(c1))
          + f"; second loss {g2['loss']:.6g} ({rel2:.1e}); limits 1e-4, 1e-3")


class _Frames:
    """Scene-frames of a host batch as a dataset of the keys the teacher
    pass reads."""

    def __init__(self, host):
        self.host = host

    def __len__(self):
        return len(self.host["agent_mask"])

    def __getitem__(self, i):
        import numpy as np

        return {"bev_teacher": self.host["bev_teacher"][i], "agent_mask": self.host["agent_mask"][i],
                "frame_idx": np.int32(i)}


def _cli(main, argv):
    """Run a CLI's ``main(argv)`` in-process; echo its output indented and
    return (output, result)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    out = buf.getvalue()
    print("\n".join("    | " + line for line in out.splitlines() if line.strip()))
    return out, result


def _mean_ap_table(out):
    """{agent label: [mAP@0.5, mAP@0.7, #gt, #det]} of the table in ``out``."""
    rows = {}
    for line in out[out.rindex("Evaluated"):].split("\n\n")[0].splitlines():
        cols = [c.strip() for c in line.split("|")]
        if len(cols) == 5 and cols[0] != "agent":
            rows[cols[0]] = [float(cols[1]), float(cols[2]), int(cols[3]), int(cols[4])]
    if "average" not in rows:
        raise AssertionError(f"no mAP table in the output:\n{out}")
    return rows


def _epochs(out):
    """(epoch, loss, scenes/s, loader-wait share) of each ``epoch N done`` line."""
    rows = re.findall(r"epoch (\d+) done .*?(?<![\w])loss=(\S+).*scenes_per_sec=(\S+)\s+loader_wait_share=(\S+)", out)
    return [(int(e), float(l), float(s), float(w)) for e, l, s, w in rows]


def _phase9(cfg, host7, tb, kd_step, teacher):
    """The detection CLIs at full width, and the KD cache on the card (see
    the module docstring). Returns the IoU and voxelize launches of the
    evaluation run."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from disconet_tpu_torch import build_model, example_train_batch, tiny_config
    from disconet_tpu_torch.data.dataset import V2XSimDet
    from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix
    from disconet_tpu_torch.ops.voxelize import voxelize_occupy
    from disconet_tpu_torch.tools.det import create_data_det, test_codet, train_codet
    from disconet_tpu_torch.tools.track import eval_mot, sort
    from disconet_tpu_torch.training import (
        batch_to_device, create_train_state, make_train_step, precompute_teacher_feats, teacher_feat_bytes,
    )

    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="cli_", dir=build)
    grid = ["--grid", str(cfg.bev_shape[0])]
    try:
        t0 = time.perf_counter()
        _cli(create_data_det.main, ["--data", work, "--mode", "synthetic", "--scenes", "2", "--frames", "4", *grid])
        data, logs = os.path.join(work, "train"), os.path.join(work, "logs")
        ds = V2XSimDet(data, cfg)
        n_gt = sum(len(g) for i in range(len(ds)) for g, m in zip(ds[i]["gt_boxes"], ds[i]["agent_mask"]) if m)
        data_s = time.perf_counter() - t0
        print(f"cli data: {len(ds)} scene-frames, {int(sum(ds[i]['agent_mask'].sum() for i in range(len(ds))))} "
              f"agent-frames, {n_gt} gt boxes, written in {data_s:.2f} s")
        common = ["--data", data, *grid, "--batch", "4", "--logpath", logs, "--log_every", "1"]

        out, _ = _cli(train_codet.main, [*common, "--bound", "upperbound", "--nepoch", "1"])
        epochs = {"teacher": _epochs(out)}
        teacher_pth = os.path.join(logs, "upperbound", "epoch_1.pth")
        if not os.path.isfile(teacher_pth) or len(epochs["teacher"]) != 1:
            raise AssertionError("the teacher run wrote no epoch_1.pth")
        student = [*common, "--com", "disco", "--kd_flag", "1", "--resume_teacher", teacher_pth, "--kd_cache", "1"]
        out, _ = _cli(train_codet.main, [*student, "--nepoch", "2"])
        cache = re.search(r"KD cache: (\d+) MiB of teacher features precomputed in ([\d.]+)s", out)
        epochs["student"] = _epochs(out)
        if not cache or [e[0] for e in epochs["student"]] != [1, 2]:
            raise AssertionError("the student run printed no KD cache line or not 2 epochs")
        want_mib = teacher_feat_bytes(cfg, len(ds), batch_size=4) / 2**20
        if int(cache.group(1)) != round(want_mib):
            raise AssertionError(f"KD cache {cache.group(1)} MiB, expected {want_mib:.0f}")
        out, _ = _cli(train_codet.main, [*student, "--nepoch", "3", "--auto_resume_path", logs])
        epochs["resumed"] = _epochs(out)
        if "auto-resumed from epoch 2" not in out or [e[0] for e in epochs["resumed"]] != [3]:
            raise AssertionError("the run did not auto-resume from epoch 2 to epoch 3")
        resume = os.path.join(logs, "disco_kd", "epoch_3.pth")
        if not os.path.isfile(resume):
            raise AssertionError("no epoch_3.pth")
        bad = [e for run in epochs.values() for e in run if not np.isfinite(e[1])]
        if bad:
            raise AssertionError(f"non-finite epoch losses: {bad}")

        evaluate = ["--data", data, *grid, "--com", "disco", "--resume", resume, "--batch", "4", "--logpath", logs]
        n_batches = -(-len(ds) // 4)
        voxelize_occupy.launches = 0
        rotated_iou_matrix.launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out, _ = _cli(test_codet.main, [*evaluate, "--tracking"])
            torch.cuda.synchronize()
        launches = {"voxelize": voxelize_occupy.launches, "rotated_iou": rotated_iou_matrix.launches}
        traced = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and "rotated_iou_kernel" in e.name)
        table = _mean_ap_table(out)
        if launches["rotated_iou"] < n_batches or traced < n_batches:
            raise AssertionError(f"IoU kernel: {launches['rotated_iou']} launches, {traced} in the trace, "
                                 f"for {n_batches} predict batches")
        if table["average"][2] != n_gt:
            raise AssertionError(f"the table counts {table['average'][2]} gt boxes, the dataset {n_gt}")
        dump_dir = os.path.join(logs, "disco", "with_rsu", "test", "det_dumps")
        dumps = os.listdir(dump_dir) if os.path.isdir(dump_dir) else []
        if not dumps:
            raise AssertionError("no tracking dumps")
        print(f"test_codet: launches {launches} for {n_batches} predict batches, {traced} IoU kernels in the "
              f"trace, {len(dumps)} tracking dumps, #gt {n_gt} as the dataset")
        tracks = os.path.join(os.path.dirname(dump_dir), "tracks")
        out, _ = _cli(sort.main, ["--det_logs_path", dump_dir, "--out", tracks])
        n_rows = sum(int(n) for n in re.findall(r": (\d+) track rows", out))
        out, mot = _cli(eval_mot.main, ["--data", data, "--tracks", tracks, *grid])
        if not re.search(r"^\s*avg \|", out, re.M) or not all(np.isfinite(mot[k]) for k in ("MOTA", "MOTP")):
            raise AssertionError(f"eval_mot printed no finite avg row: {mot}")
        print(f"track cli: {n_rows} track rows from {len(dumps)} dumps; MOTA {mot['MOTA']:.4f}, "
              f"MOTP {mot['MOTP']:.4f}")
        out, _ = _cli(test_codet.main, [*evaluate, "--warp_dtype", "float32"])
        f32_table = _mean_ap_table(out)
        if f32_table["average"][2] != n_gt:
            raise AssertionError(f"--warp_dtype float32: the table counts {f32_table['average'][2]} gt boxes")
        print(f"test_codet --warp_dtype float32: mAP@0.5 {f32_table['average'][0]:.4f}, mAP@0.7 "
              f"{f32_table['average'][1]:.4f}, #gt {n_gt} as the dataset (bf16 store: "
              f"{table['average'][0]:.4f}, {table['average'][1]:.4f})")
        _debug_nans_and_vis(cfg, common, evaluate, logs)
        out, result = _cli(test_codet.main, evaluate)
        if _mean_ap_table(out) != table:
            raise AssertionError("a second evaluation of the same checkpoint gave another table")
        for extra in (["--apply_late_fusion", "1"], ["--pose_noise_std", "0.2"]):
            out, _ = _cli(test_codet.main, [*evaluate, *extra])
            if _mean_ap_table(out)["average"][2] != n_gt:
                raise AssertionError(f"{extra}: wrong #gt")
        for name, run in epochs.items():
            for e, loss, sps, wait in run:
                print(f"cli epochs: {name} epoch {e}: {sps:.2f} scenes/s, loader wait {100 * wait:.1f}% of the "
                      f"epoch, loss {loss:.4f}")
        print(f"cli KD cache: {cache.group(1)} MiB, precomputed in {cache.group(2)} s; "
              f"test_codet {result['scenes_per_s']:.2f} scenes/s (loader, predict and mAP bookkeeping)")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # a KD step from a float32 cache against the re-forward step, on the card
    small = tiny_config(64, compute_dtype="float32", head_raw_dtype="float32")
    host = example_train_batch(small, 2, 3, seed=4, occupancy=(0.05, 0.1), boxes_per_frame=4)
    s_teacher = build_model("teacher", small, seed=1)
    tables = precompute_teacher_feats(s_teacher, _Frames(host), small, batch_size=2, dtype=torch.float32)
    host["frame_idx"] = np.array([1, 0], np.int32)
    host["bev_teacher"] = host["bev_teacher"][::-1].copy()
    host["agent_mask"] = host["agent_mask"][::-1].copy()
    b = batch_to_device(host)
    first = {}
    for name, kw in (("re-forward", dict(teacher=s_teacher)), ("cache", dict(kd_from_cache=tables))):
        m = build_model("disco", small, seed=0, kd_flag=True)
        first[name] = {k: float(v) for k, v in
                       make_train_step(m, small, create_train_state(m), kd_flag=True, **kw)(b).items()}
    rel = {k: abs(first["cache"][k] - first["re-forward"][k]) / abs(first["re-forward"][k]) for k in ("loss", "kd_loss")}
    if max(rel.values()) > 1e-5:
        raise AssertionError(f"KD step from the float32 cache vs re-forward: {rel}")
    print("card KD step from a float32 cache vs re-forward (64-grid): "
          + ", ".join(f"{k} {first['cache'][k]:.6g} ({v:.1e})" for k, v in rel.items()) + "; limit 1e-5")

    # full width, bf16: the two KD steps in turns on phase 7's batch
    t0 = time.perf_counter()
    full = precompute_teacher_feats(teacher, _Frames(host7), cfg, batch_size=BATCH)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    tb = dict(tb, frame_idx=torch.arange(BATCH, dtype=torch.int32, device=tb["agent_mask"].device))
    cached = build_model("disco", cfg, seed=0, kd_flag=True)
    cache_step = make_train_step(cached, cfg, create_train_state(cached), kd_flag=True, kd_from_cache=full)
    for _ in range(3):
        cache_step(tb)
    windows = {"re-forward": [], "cache": []}
    for _ in range(5):
        for name, step in (("re-forward", kd_step), ("cache", cache_step)):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                metrics = step(tb)
            end.record()
            torch.cuda.synchronize()
            windows[name].append(start.elapsed_time(end) / 5)
            if not all(torch.isfinite(v).item() for v in metrics.values()):
                raise AssertionError(f"non-finite metrics in the {name} step")
    med = {k: sorted(v)[2] for k, v in windows.items()}
    print(f"cli KD step ms (median of 5 windows of 5, in turns): re-forward {med['re-forward']:.3f}, "
          f"from the cache {med['cache']:.3f} ({BATCH * 1e3 / med['cache']:.2f} scenes/s); windows "
          + "; ".join(f"{k} " + ", ".join(f"{w:.3f}" for w in v) for k, v in windows.items())
          + f"; {BATCH} rows of {sum(t[0].numel() for t in full) * 2 / 2**20:.0f} MiB precomputed in {pre_s:.2f} s")
    # the device's share of a step: its summed CUDA time over the step's median time
    busy = {name: _device_ms(lambda: step(tb), iters=5, warmup=1)[0]
            for name, step in (("re-forward", kd_step), ("cache", cache_step))}
    print("cli KD step device ms (torch.profiler, summed CUDA time of one step): "
          + ", ".join(f"{k} {v:.3f} ({100 * v / med[k]:.1f}% of {med[k]:.3f} ms)" for k, v in busy.items()))
    del cached, cache_step

    def kd_cache():
        s = build_model("disco", cfg, seed=0, kd_flag=True)
        step = make_train_step(s, cfg, create_train_state(s), kd_flag=True, kd_from_cache=full)
        return lambda: step(tb)

    _precision_ab("KD step from the cache (phase 9)", kd_cache)
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s, {data_s:.1f} s of it writing the data")
    return {"launches": launches}


def _debug_nans_and_vis(cfg, common, evaluate, logs):
    """``train_codet --debug_nans 1``: one epoch that finishes, and a run from
    a checkpoint with a planted NaN that stops at step 1; ``--visualization
    1``: pngs where matplotlib imports, else the exit that names it."""
    import torch

    from disconet_tpu_torch import build_model
    from disconet_tpu_torch.checkpoint import restore_or_die, save_pth
    from disconet_tpu_torch.tools.det import test_codet, train_codet

    t0 = time.perf_counter()
    nan_logs = os.path.join(logs, "debug_nans")
    train = [*common[:-4], "--bound", "lowerbound", "--nepoch", "1", "--debug_nans", "1"]  # no --logpath
    out, _ = _cli(train_codet.main, [*train, "--logpath", nan_logs])
    if "epoch 1 done" not in out or torch.is_anomaly_enabled():
        raise AssertionError("the --debug_nans epoch did not finish, or left anomaly mode on")
    model = build_model("lowerbound", cfg, seed=0)
    restore_or_die(os.path.join(nan_logs, "lowerbound", "epoch_1.pth"), model)
    with torch.no_grad():
        model.heads.reg.bias.fill_(float("nan"))
    planted = os.path.join(nan_logs, "nan.pth")
    save_pth(planted, model, None, 0)
    try:
        _cli(train_codet.main, [*train, "--logpath", os.path.join(nan_logs, "planted"), "--resume", planted])
        raise AssertionError("training from a checkpoint with a NaN was not stopped")
    except SystemExit as e:
        if not str(e).startswith("--debug_nans: step 1:"):
            raise AssertionError(f"the planted NaN stopped the run with {e}") from None
        stopped = str(e)
    print(f"debug_nans: one epoch finished; the planted NaN stopped the run: {stopped[:120]} "
          f"({time.perf_counter() - t0:.1f} s)")
    vis_logs = os.path.join(logs, "vis_run")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        try:
            _cli(test_codet.main, [*evaluate[:-2], "--logpath", vis_logs, "--visualization", "1"])
            raise AssertionError("--visualization 1 ran without matplotlib")
        except SystemExit as e:
            if "matplotlib" not in str(e):
                raise AssertionError(f"--visualization 1 exited without naming matplotlib: {e}") from None
            print(f"visualization: matplotlib absent; --visualization 1 exits: {e}")
        return
    _cli(test_codet.main, [*evaluate[:-2], "--logpath", vis_logs, "--visualization", "1"])
    pngs = os.listdir(os.path.join(vis_logs, "vis"))
    if not any(p.startswith("edge_w_") for p in pngs) or len(pngs) < 2:
        raise AssertionError(f"--visualization 1 wrote {pngs}")
    print(f"visualization: {len(pngs)} pngs")


def _sigmoid_ties(raw, num_anchors, top_k):
    """(F,) bool: frames where two distinct logit differences among the
    top_k * num_anchors + 1 largest (every value the two-level selection can
    rank) give the same float32 sigmoid: there the packed NMS may choose or
    order candidates otherwise than the score path
    (``ops/nms.py::rotated_nms_decode_packed``)."""
    import torch

    r = raw.float()
    diff = (r[..., num_anchors:2 * num_anchors] - r[..., :num_anchors]).reshape(raw.shape[0], -1)
    top = torch.sort(diff, dim=-1, descending=True).values[:, :top_k * num_anchors + 1]
    sig = torch.sigmoid(top)
    return ((top[:, 1:] != top[:, :-1]) & (sig[:, 1:] == sig[:, :-1])).any(dim=-1)


def _phase11(cfg, model, main_path):
    """The NMS entry points besides the main path's (see the module
    docstring). Returns the launches of the packed ``predict``."""
    import numpy as np
    import torch

    from disconet_tpu_torch import predict
    from disconet_tpu_torch.models.base import agents_to_batch
    from disconet_tpu_torch.ops.nms import (
        packed_scores_and_deltas, rotated_nms, rotated_nms_decode, rotated_nms_decode_packed,
    )
    from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix, rotated_iou_matrix_plain
    from disconet_tpu_torch.ops.voxelize import voxelize_occupy

    pts_d, trans_d, amask_d, anchors = main_path
    packed_cfg = dataclasses.replace(cfg, packed_nms=True)
    K = cfg.nms_top_k
    kw = dict(iou_threshold=cfg.nms_iou_threshold, score_threshold=cfg.score_threshold, top_k=K)
    voxelize_occupy.launches = 0
    rotated_iou_matrix.launches = 0
    boxes, scores, keep = predict(model, pts_d, trans_d, amask_d, anchors, packed_cfg)
    torch.cuda.synchronize()
    launches = {"voxelize": voxelize_occupy.launches, "rotated_iou": rotated_iou_matrix.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched by the packed_nms predict: {launches}")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("packed_nms predict: non-finite outputs")
    with torch.inference_mode():
        bev = voxelize_occupy(pts_d, cfg.voxel_size, cfg.area_extents)
        raw = agents_to_batch(model(bev, trans_d, amask_d, store_bf16=True)["head_raw"])
        s, d = packed_scores_and_deltas(raw, cfg.num_anchors, cfg.box_code_size)
        ref = rotated_nms_decode(d, s, anchors, **kw)
        got = rotated_nms_decode_packed(raw, anchors, cfg.num_anchors, **kw)
    ties = _sigmoid_ties(raw, cfg.num_anchors, K)
    same = [torch.equal(g[~ties], r[~ties]) for g, r in zip(got, ref)]
    if not all(same):
        raise AssertionError(f"packed NMS != score path outside the sigmoid ties (boxes, scores, keep: {same})")
    tie_slots = int((got[2][ties] != ref[2][ties]).sum())
    print(f"packed nms: on the same head outputs, boxes, scores and keep equal to the score path in "
          f"{int((~ties).sum())} of {len(ties)} frames; {int(ties.sum())} frames with sigmoid ties, "
          f"{tie_slots} keep slots differing there; {int(keep.sum())} kept by predict, launches {launches}")
    windows = {"packed_nms": [], "default": []}
    for w in range(3):  # in turns, 3 windows of 20 calls each
        for name, c in (("packed_nms", packed_cfg), ("default", cfg)):
            windows[name].append(_time_ms(lambda: predict(model, pts_d, trans_d, amask_d, anchors, c), iters=20,
                                          warmup=2 if w == 0 else 0))
    med = {k: sorted(v)[1] for k, v in windows.items()}
    print(f"packed nms predict: {med['packed_nms']:.3f} ms per batch of {BATCH}, "
          f"{BATCH * 1e3 / med['packed_nms']:.2f} scenes/s; default {med['default']:.3f} ms, "
          f"{BATCH * 1e3 / med['default']:.2f} scenes/s (median of 3 windows of 20, in turns: "
          + "; ".join(f"{k} " + ", ".join(f"{BATCH * 1e3 / x:.2f}" for x in v) for k, v in windows.items()) + ")")

    # caller boxes and the flat layout: the kernel against the plain IoU
    rng = np.random.default_rng(7)
    cb = torch.from_numpy(_random_boxes(rng, BATCH * AGENTS, 1024)).to(pts_d.device)
    cs = torch.from_numpy(rng.uniform(0, 1, (BATCH * AGENTS, 1024)).astype(np.float32)).to(pts_d.device)
    flat = (d.reshape(d.shape[0], -1, cfg.box_code_size), s.reshape(s.shape[0], -1), anchors.reshape(-1, 5))
    for name, fn in (("rotated_nms (caller boxes)", lambda iou: rotated_nms(cb, cs, 0.1, 0.2, K, iou=iou)),
                     ("rotated_nms_decode (flat)", lambda iou: rotated_nms_decode(*flat, **kw, iou=iou))):
        with torch.inference_mode():
            k_out, p_out = fn(rotated_iou_matrix), fn(rotated_iou_matrix_plain)
        if not (torch.equal(k_out[2], p_out[2]) and torch.equal(k_out[0], p_out[0])):
            raise AssertionError(f"{name}: the kernel's keep or boxes differ from the plain IoU's")
        print(f"{name}: keep and boxes equal with the kernel and the plain IoU, {int(k_out[2].sum())} kept of "
              f"{int((k_out[1] > -1).sum())} candidates")
    return launches


OTHER_COMS = ("sum", "mean", "max", "cat", "agent", "v2v", "when2com", "who2com")


def _layer_group(name):
    """The group of layers of a parameter name."""
    if name.startswith("stpn.stages_"):
        return "encoder"
    if name.startswith(("stpn.dec_", "stpn.head_conv.")):
        return "decoder"
    return "heads" if name.startswith(("heads.", "seg_head.")) else "fusion"


def _grad_groups(model):
    """{group of layers: global norm of its gradients} after a backward."""
    sq = {}
    for k, p in model.named_parameters():
        g = _layer_group(k)
        sq[g] = sq.get(g, 0.0) + (p.grad.float().square().sum().item() if p.grad is not None else 0.0)
    return {g: v ** 0.5 for g, v in sq.items()}


def _seg_labels(bev_u8, classes):
    """Labels a model can learn from the grid: the count of occupied z cells
    of each column, capped at ``classes - 1``."""
    import numpy as np

    return np.minimum(bev_u8.sum(axis=-1), classes - 1).astype(np.int32)


def _phase10(cfg, host7, tb, main_path):
    """The other fusion models and segmentation (see the module docstring).
    Returns {com: launches of its predict, and of the 3x3 conv kernel in its
    first train step}."""
    import numpy as np
    import torch

    from disconet_tpu_torch import build_model, example_train_batch, predict, tiny_config
    from disconet_tpu_torch.ops.conv3x3 import conv3x3_f32x3
    from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix, rotated_iou_matrix_plain
    from disconet_tpu_torch.ops.voxelize import voxelize_occupy, voxelize_occupy_plain
    from disconet_tpu_torch.tools.seg import create_data_seg, test_codet as seg_test, train_codet as seg_train
    from disconet_tpu_torch.training import (
        batch_to_device, create_train_state, make_seg_predict_step, make_seg_train_step, make_train_step,
    )

    t_phase = time.perf_counter()
    pts_d, trans_d, amask_d, anchors = main_path
    small = tiny_config(64, compute_dtype="float32", head_raw_dtype="float32", max_agents=3)
    s_host = example_train_batch(small, 2, 3, seed=5, occupancy=(0.05, 0.1), boxes_per_frame=4)
    s_args = [torch.from_numpy(s_host[k]) for k in ("bev", "trans", "agent_mask")]
    s_args[0] = s_args[0].float()
    all_launches = {}
    for com in OTHER_COMS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(com, cfg, seed=3)
        # V2VNet's fusion runs 15 3x3 convs on the kernel a predict (3 rounds
        # x the message conv's two halves and the ConvGRU's 3), 30 a train
        # step (and their input gradients); no other model runs one
        want_conv = {"conv3x3": 15, "conv3x3 train step": 30} if com == "v2v" else \
            {"conv3x3": 0, "conv3x3 train step": 0}
        voxelize_occupy.launches = 0
        rotated_iou_matrix.launches = 0
        conv3x3_f32x3.launches = 0
        boxes, scores, keep = predict(model, pts_d, trans_d, amask_d, anchors, cfg)
        torch.cuda.synchronize()
        launches = {"voxelize": voxelize_occupy.launches, "rotated_iou": rotated_iou_matrix.launches,
                    "conv3x3": conv3x3_f32x3.launches}
        if min(launches["voxelize"], launches["rotated_iou"]) < 1 or launches["conv3x3"] != want_conv["conv3x3"]:
            raise AssertionError(f"{com}: predict's launches {launches}, want {want_conv['conv3x3']} of conv3x3")
        all_launches[com] = launches
        pb, ps, pk = predict(model, pts_d, trans_d, amask_d, anchors, cfg,
                             voxelize=voxelize_occupy_plain, iou=rotated_iou_matrix_plain)
        if not torch.equal(keep, pk):
            raise AssertionError(f"{com}: keep masks differ from the plain ops in {int((keep != pk).sum())} slots")
        err = max((boxes - pb).abs().max().item(), (scores - ps).abs().max().item())
        if not (torch.isfinite(boxes).all() and err <= 1e-4):
            raise AssertionError(f"{com}: kernel vs plain pipeline err {err}")
        windows = [_time_ms(lambda: predict(model, pts_d, trans_d, amask_d, anchors, cfg), iters=20,
                            warmup=2 if w == 0 else 0) for w in range(3)]
        predict_ms = sorted(windows)[1]
        predict_peak = torch.cuda.max_memory_allocated() / 2**30
        optimizer = create_train_state(model)
        step = make_train_step(model, cfg, optimizer)
        conv3x3_f32x3.launches = 0
        first = {k: float(v) for k, v in step(tb).items()}
        launches["conv3x3 train step"] = conv3x3_f32x3.launches
        if launches["conv3x3 train step"] != want_conv["conv3x3 train step"]:
            raise AssertionError(f"{com}: {launches['conv3x3 train step']} conv3x3 launches in a train step, want "
                                 f"{want_conv['conv3x3 train step']}")
        groups = _grad_groups(model)
        if not all(np.isfinite(v) for v in first.values()) or not all(0 < g < float("inf") for g in groups.values()):
            raise AssertionError(f"{com}: train step metrics {first}, gradient norms by group {groups}")
        step_ms = _time_ms(lambda: step(tb), iters=3, warmup=0)
        train_peak = torch.cuda.max_memory_allocated() / 2**30
        del model, optimizer, step
        # float32 at the 64-grid: the card's forward against the CPU's
        outs = {}
        for name in ("cuda", "cpu"):
            m = build_model(com, small, layer=2, device=name, seed=4)
            with torch.no_grad():
                o = m(*(t.to(next(m.parameters()).device) for t in s_args))
            outs[name] = {k: o[k].cpu() for k in ("cls", "reg")}
        f32_err = max((outs["cuda"][k] - outs["cpu"][k]).abs().max().item() for k in ("cls", "reg"))
        if not f32_err <= 1e-4:
            raise AssertionError(f"{com}: float32 card forward vs CPU err {f32_err}")
        print(f"fusion {com}: predict {predict_ms:.3f} ms, {BATCH * 1e3 / predict_ms:.2f} scenes/s (median of 3 "
              f"windows of 20: " + ", ".join(f"{BATCH * 1e3 / w:.2f}" for w in windows) + f"), launches {launches}, "
              f"{int(keep.sum())} kept, keep equal to the plain ops; train step {step_ms:.3f} ms (loss "
              f"{first['loss']:.4f}, gradient norms " + ", ".join(f"{g} {v:.3g}" for g, v in sorted(groups.items()))
              + f"); peak {predict_peak:.2f} GiB predict, {train_peak:.2f} GiB train; f32 64-grid card vs CPU "
              f"{f32_err:.2e}")

    # segmentation: DiscoNet on the UNet at full width, phase 7's grids
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    seg_tb = dict(tb, seg_label=torch.from_numpy(_seg_labels(host7["bev"], cfg.num_seg_classes)).to(tb["trans"].device))
    model = build_model("disco", cfg, seed=0, task="seg")
    step = make_seg_train_step(model, cfg, create_train_state(model))
    history = [step(seg_tb) for _ in range(3)]
    groups = _grad_groups(model)
    windows = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            history.append(step(seg_tb))
        end.record()
        torch.cuda.synchronize()
        windows.append(start.elapsed_time(end) / 5)
    loss = torch.stack([h["loss"] for h in history]).cpu()
    acc = torch.stack([h["acc"] for h in history]).cpu()
    if not (torch.isfinite(loss).all() and loss[-1] < loss[0]) or not all(0 < g < float("inf") for g in groups.values()):
        raise AssertionError(f"seg step: loss {loss.tolist()}, gradient norms {groups}")
    seg_ms = sorted(windows)[2]
    seg_peak = torch.cuda.max_memory_allocated() / 2**30
    pred_step = make_seg_predict_step(model, cfg)
    pred = pred_step(seg_tb)
    if pred.shape != tuple(seg_tb["seg_label"].shape) or int(pred.max()) >= cfg.num_seg_classes:
        raise AssertionError(f"seg predict: shape {tuple(pred.shape)}, max class {int(pred.max())}")
    pw = [_time_ms(lambda: pred_step(seg_tb), iters=20, warmup=2 if w == 0 else 0) for w in range(3)]
    seg_pred_ms = sorted(pw)[1]
    print(f"seg unet: {len(history)} steps, loss {loss[0]:.4f} -> {loss[-1]:.4f}, acc {acc[0]:.4f} -> "
          f"{acc[-1]:.4f}; {seg_ms:.3f} ms per step of {BATCH} scenes, {BATCH * 1e3 / seg_ms:.2f} scenes/s (median "
          "of 5 windows of 5: " + ", ".join(f"{w:.3f}" for w in windows) + f" ms), peak {seg_peak:.2f} GiB; "
          f"predict {seg_pred_ms:.3f} ms, {BATCH * 1e3 / seg_pred_ms:.2f} scenes/s (median of 3 windows of 20)")
    del model, step, pred_step
    stpn_cfg = dataclasses.replace(cfg, seg_backbone="stpn")
    model = build_model("disco", stpn_cfg, seed=0, task="seg")
    first = {k: float(v) for k, v in make_seg_train_step(model, stpn_cfg, create_train_state(model))(seg_tb).items()}
    if not all(np.isfinite(v) for v in first.values()):
        raise AssertionError(f"seg stpn step: {first}")
    print(f"seg stpn: one step, loss {first['loss']:.4f}, acc {first['acc']:.4f}")
    del model
    # float32 seg step at the 64-grid: the card against the CPU
    s_host["seg_label"] = _seg_labels(s_host["bev"], small.num_seg_classes)
    got = {}
    for name in ("cuda", "cpu"):
        m = build_model("disco", small, layer=2, device=name, seed=6, task="seg")
        got[name] = {k: float(v) for k, v in
                     make_seg_train_step(m, small, create_train_state(m))(batch_to_device(s_host, name)).items()}
    rel = abs(got["cuda"]["loss"] - got["cpu"]["loss"]) / abs(got["cpu"]["loss"])
    acc_err = abs(got["cuda"]["acc"] - got["cpu"]["acc"])
    if rel > 1e-4 or acc_err > 1e-4:
        raise AssertionError(f"float32 seg step card vs CPU: {got}")
    print(f"card vs CPU seg step (f32, 64-grid): loss {got['cuda']['loss']:.6g} ({rel:.1e}), acc "
          f"{got['cuda']['acc']:.6g} ({acc_err:.1e}); limits 1e-4")

    # the seg CLIs in-process at full width
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="seg_", dir=build)
    grid = ["--grid", str(cfg.bev_shape[0])]
    try:
        t0 = time.perf_counter()
        _cli(create_data_seg.main, ["--data", work, "--mode", "synthetic", "--scenes", "1", "--frames", "4", *grid])
        data_s = time.perf_counter() - t0
        data, logs = os.path.join(work, "train"), os.path.join(work, "logs")
        common = ["--data", data, *grid, "--batch", "4", "--com", "disco"]
        train = [*common, "--logpath", logs, "--log_every", "1"]
        out, _ = _cli(seg_train.main, [*train, "--nepoch", "2"])
        epochs = _epochs(out)
        out, _ = _cli(seg_train.main, [*train, "--nepoch", "3", "--auto_resume_path", logs])
        epochs += _epochs(out)
        if "auto-resumed from epoch 2" not in out or [e[0] for e in epochs] != [1, 2, 3]:
            raise AssertionError(f"seg CLI epochs {epochs}")
        if not all(np.isfinite(e[1]) for e in epochs):
            raise AssertionError(f"non-finite seg epoch losses: {epochs}")
        out, res = _cli(seg_test.main, [*common, "--resume", os.path.join(logs, "disco_seg")])
        rows = re.findall(r"^\s*(\w+) \|\s+([\d.]+|n/a)$", out, re.M)
        if len(rows) != cfg.num_seg_classes + 1 or rows[-1][0] != "mIoU" or not np.isfinite(res["miou"]):
            raise AssertionError(f"seg test_codet table: {rows}")
        for e, l, sps, wait in epochs:
            print(f"seg cli epoch {e}: {sps:.2f} scenes/s, loader wait {100 * wait:.1f}%, loss {l:.4f}")
        print(f"seg cli: data (4 scene-frames) written in {data_s:.2f} s; test_codet mIoU {res['miou']:.4f} over "
              f"{cfg.num_seg_classes} classes, {res['scenes_per_s']:.2f} scenes/s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return all_launches


# K-step graph against single steps at full width, bf16: each step's loss,
# relative; steps 1-2, then the rest. With the gathered warp at
# this grid its backward's atomics parted the two paths from step 2 and the
# trajectory amplified it: three H100 runs read up to 6.3e-5 at step 2 and
# 3.3e-3, 6.9e-3 and 1.0e-2 by step 8 (PERF.md §5). A skipped update or a
# stale batch moves a loss by 10% or more.
K_STEP_LOSS_RTOL = (1e-3, 5e-2)
# remat against plain, one bf16 step from the same weights: metrics
# (relative) and each group's gradient (relative L2). The recompute repeats
# the forward's arithmetic; the gathered warp's atomics at this grid moved
# the gradients: 1.1e-6 and 1.3e-3 (encoder) on the H100 (PERF.md §5)
REMAT_METRIC_RTOL = 1e-3
REMAT_GRAD_REL = 2e-2
K_STEPS = 8


def _superbatch(host, k):
    """``k`` copies of a host batch stacked for a K-step dispatch."""
    from disconet_tpu_torch.training import stack_host_batches

    return stack_host_batches([host] * k)


def _k_step_vs_single(name, model_fn, step_fn, multi_fn, tb, sb):
    """Two models from the same weights: ``K_STEPS`` single steps on ``tb``
    against one K-step graph on the superbatch ``sb``; then both timed in
    turns, 3 windows of one dispatch (K steps) each, with the device's busy
    share from torch.profiler. Returns the printed readings."""
    import torch

    single_model, graph_model = model_fn(), model_fn()
    stats0 = {k: v.clone() for k, v in graph_model.state_dict().items() if k.endswith("running_var")}
    single, multi = step_fn(single_model), multi_fn(graph_model)
    rows = [single(tb) for _ in range(K_STEPS)]
    want = {k: torch.stack([r[k] for r in rows]).float().cpu() for k in rows[0]}
    t0 = time.perf_counter()
    got = {k: v.float().cpu() for k, v in multi(sb).items()}  # the capture, then the first replay
    capture_s = time.perf_counter() - t0
    bad = [k for k, v in got.items() if v.shape != (K_STEPS,) or not torch.isfinite(v).all()]
    if bad or set(got) != set(want):
        raise AssertionError(f"{name}: K-step metrics {got}")
    rel = (got["loss"] - want["loss"]).abs() / want["loss"].abs()
    early, late = K_STEP_LOSS_RTOL
    print(f"{name}: K-step graph vs {K_STEPS} single steps, loss relative difference per step "
          + ", ".join(f"{r:.2e}" for r in rel.tolist()) + f" (limits {early} to step 2, {late} after); capture "
          f"and first replay {capture_s:.2f} s")
    if rel[:2].max() > early or rel.max() > late:
        raise AssertionError(f"{name}: K-step losses part from the single steps' by {rel.tolist()}")
    if all(torch.equal(v, stats0[k]) for k, v in graph_model.state_dict().items() if k in stats0):
        raise AssertionError(f"{name}: the K-step graph did not move the BatchNorm statistics")
    runs = {"single": lambda: [single(tb) for _ in range(K_STEPS)], "graph": lambda: multi(sb)}
    windows = {k: [] for k in runs}
    for _ in range(3):
        for k, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            windows[k].append((time.perf_counter() - t0) * 1e3 / K_STEPS)
    busy = {k: _device_ms(fn, iters=1, warmup=0)[0] / K_STEPS for k, fn in runs.items()}
    out = {}
    for k in runs:
        ms = sorted(windows[k])[1]
        out[k] = {"ms": ms, "scenes_per_s": BATCH * 1e3 / ms, "idle": 1 - busy[k] / ms, "device_ms": busy[k]}
        print(f"{name} {k}: {ms:.3f} ms per step (median of 3 windows of {K_STEPS} steps: "
              + ", ".join(f"{w:.3f}" for w in windows[k]) + f"), {BATCH * 1e3 / ms:.2f} scenes/s, device "
              f"{busy[k]:.3f} ms per step (torch.profiler), idle {100 * (1 - busy[k] / ms):.1f}%")
    return out


def _phase12(cfg, host7, teacher):
    """K optimizer steps per dispatch as one CUDA graph, rematerialization
    and the CLI options of the seventh slice (see the module docstring).
    Returns the IoU and voxelize launches of its ``test_codet`` run."""
    import numpy as np
    import torch

    from disconet_tpu_torch import build_model, example_train_batch, tiny_config
    from disconet_tpu_torch.data.dataset import V2XSimDet
    from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix
    from disconet_tpu_torch.ops.voxelize import voxelize_occupy
    from disconet_tpu_torch.tools.det import create_data_det, test_codet, train_codet
    from disconet_tpu_torch.training import (
        batch_to_device, create_train_state, make_seg_train_step, make_seg_train_step_multi, make_train_step,
        make_train_step_multi, precompute_teacher_feats,
    )

    t_phase = time.perf_counter()
    # 1. DiscoNet KD from the cache: K steps in one graph against K single steps
    host = {k: v for k, v in host7.items() if k != "bev_teacher"}
    host["frame_idx"] = np.arange(BATCH, dtype=np.int32)
    tables = precompute_teacher_feats(teacher, _Frames(host7), cfg, batch_size=BATCH)
    tb, sb = batch_to_device(host), batch_to_device(_superbatch(host, K_STEPS))
    kd = _k_step_vs_single(
        "kd cache step", lambda: build_model("disco", cfg, seed=0, kd_flag=True),
        lambda m: make_train_step(m, cfg, create_train_state(m), kd_flag=True, kd_from_cache=tables),
        lambda m: make_train_step_multi(m, cfg, create_train_state(m), kd_flag=True, kd_from_cache=tables), tb, sb)

    def kd_graph():
        m = build_model("disco", cfg, seed=0, kd_flag=True)
        multi = make_train_step_multi(m, cfg, create_train_state(m), kd_flag=True, kd_from_cache=tables)
        return lambda: multi(sb)

    _precision_ab(f"KD step from the cache, one graph of {K_STEPS} (phase 12)", kd_graph, K_STEPS, calls=2)
    del tables, tb, sb
    torch.cuda.empty_cache()

    # the quality protocol's step: DiscoNet at the 64-grid, batch 4 x 6, one graph of 8
    q_cfg = tiny_config(64)
    q_sb = batch_to_device(_superbatch(example_train_batch(q_cfg, BATCH, AGENTS, seed=6), K_STEPS))

    def quality_graph():
        m = build_model("disco", q_cfg, seed=0)
        multi = make_train_step_multi(m, q_cfg, create_train_state(m))
        return lambda: multi(q_sb)

    _precision_ab(f"64-grid quality step, one graph of {K_STEPS} (phase 12)", quality_graph, K_STEPS, calls=10)
    del q_sb

    # 2. the seg step on the UNet
    seg_host = {k: host7[k] for k in ("bev", "trans", "agent_mask")}
    seg_host["seg_label"] = _seg_labels(host7["bev"], cfg.num_seg_classes)
    tb, sb = batch_to_device(seg_host), batch_to_device(_superbatch(seg_host, K_STEPS))
    seg = _k_step_vs_single(
        "seg step", lambda: build_model("disco", cfg, seed=0, task="seg"),
        lambda m: make_seg_train_step(m, cfg, create_train_state(m)),
        lambda m: make_seg_train_step_multi(m, cfg, create_train_state(m)), tb, sb)

    def seg_graph():
        m = build_model("disco", cfg, seed=0, task="seg")
        multi = make_seg_train_step_multi(m, cfg, create_train_state(m))
        return lambda: multi(sb)

    _precision_ab(f"UNet seg step, one graph of {K_STEPS} (phase 12)", seg_graph, K_STEPS, calls=2)
    del tb, sb
    torch.cuda.empty_cache()

    # 3. one step with --remat's path against one without, from the same weights
    def remat_step(remat, host_b, timed=False):
        """(metrics, gradients, peak GiB, ms a step or None) of a first step."""
        c = dataclasses.replace(cfg, train_remat=remat)
        model = build_model("disco", c, seed=0)
        opt = create_train_state(model)
        grads = {}
        opt_step = opt.step

        def grab_then_step(*a, **k):  # the first step's gradients, before Adam's update
            if not grads:
                grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None})
            return opt_step(*a, **k)

        opt.step = grab_then_step
        b = batch_to_device(host_b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step = make_train_step(model, c, opt)
        metrics = {k: float(v) for k, v in step(b).items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = _time_ms(lambda: step(b), iters=3, warmup=1) if timed else None
        del model, opt, b, step
        torch.cuda.empty_cache()
        return metrics, grads, peak, ms

    plain_host = {k: v for k, v in host7.items() if k != "bev_teacher"}
    (m0, g0, p0, t0), (m1, g1, p1, t1) = remat_step(False, plain_host, True), remat_step(True, plain_host, True)
    m_rel = max(abs(m1[k] - m0[k]) / max(abs(m0[k]), 1e-12) for k in m0)
    num, den = {}, {}
    for k, g in g0.items():
        grp = _layer_group(k)
        num[grp] = num.get(grp, 0.0) + (g1[k] - g).float().square().sum().item()
        den[grp] = den.get(grp, 0.0) + g.float().square().sum().item()
    g_rel = {grp: (num[grp] / den[grp]) ** 0.5 for grp in num}
    del g0, g1
    print(f"remat: one bf16 step against the plain step from the same weights: metrics relative difference "
          f"{m_rel:.2e} (limit {REMAT_METRIC_RTOL}), gradients' relative L2 distance by group "
          + ", ".join(f"{g} {v:.2e}" for g, v in sorted(g_rel.items())) + f" (limit {REMAT_GRAD_REL}); peak "
          f"{p0:.2f} GiB plain, {p1:.2f} GiB remat at batch {BATCH}; {t0:.3f} ms a step plain, {t1:.3f} ms remat "
          "(3 steps after 1)")
    if m_rel > REMAT_METRIC_RTOL or max(g_rel.values()) > REMAT_GRAD_REL:
        raise AssertionError(f"remat step vs plain: metrics {m0} / {m1}, gradient distances {g_rel}")
    peaks = {}
    for n in (16, 8):
        big = {k: np.concatenate([v] * (n // BATCH)) for k, v in plain_host.items()}
        try:
            peaks[n] = (remat_step(False, big)[2], remat_step(True, big)[2])
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            print(f"remat: the plain step does not fit at batch {n}")
    for n, (pp, pr) in peaks.items():
        print(f"remat: peak {pp:.2f} GiB plain, {pr:.2f} GiB remat at batch {n}, the largest of 8 and 16 that "
              "the plain step fits")
    del big
    torch.cuda.empty_cache()

    # 4. the det CLIs with --steps_per_dispatch 8: a group of 8 and a tail of 2 an epoch
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="kstep_", dir=build)
    grid = ["--grid", str(cfg.bev_shape[0])]
    try:
        _cli(create_data_det.main, ["--data", work, "--mode", "synthetic", "--scenes", "2", "--frames", "5", *grid])
        data, logs = os.path.join(work, "train"), os.path.join(work, "logs")
        ds = V2XSimDet(data, cfg)
        n_gt = sum(len(g) for i in range(len(ds)) for g, m in zip(ds[i]["gt_boxes"], ds[i]["agent_mask"]) if m)
        train = ["--data", data, *grid, "--batch", "1", "--com", "disco", "--logpath", logs, "--log_every", "1",
                 "--steps_per_dispatch", str(K_STEPS)]
        out, _ = _cli(train_codet.main, [*train, "--nepoch", "1"])
        epochs = _epochs(out)
        out, _ = _cli(train_codet.main, [*train, "--nepoch", "2", "--auto_resume_path", logs])
        epochs += _epochs(out)
        steps = [int(s) for s in re.findall(r"epoch \d+ done step (\d+):", out)]
        if "auto-resumed from epoch 1" not in out or [e[0] for e in epochs] != [1, 2] or steps != [len(ds)]:
            raise AssertionError(f"--steps_per_dispatch {K_STEPS}: epochs {epochs}, steps {steps}")
        if not all(np.isfinite(e[1]) for e in epochs):
            raise AssertionError(f"non-finite epoch losses: {epochs}")
        voxelize_occupy.launches = 0
        rotated_iou_matrix.launches = 0
        out, _ = _cli(test_codet.main, ["--data", data, *grid, "--com", "disco", "--batch", "4", "--logpath", logs,
                                        "--resume", os.path.join(logs, "disco", "epoch_2.pth")])
        launches = {"voxelize": voxelize_occupy.launches, "rotated_iou": rotated_iou_matrix.launches}
        table = _mean_ap_table(out)
        if launches["rotated_iou"] < -(-len(ds) // 4) or table["average"][2] != n_gt:
            raise AssertionError(f"test_codet after K-step training: launches {launches}, #gt "
                                 f"{table['average'][2]} for {n_gt}")
        for e, loss, sps, wait in epochs:
            print(f"kstep cli epoch {e}: {sps:.2f} scenes/s, loader wait {100 * wait:.1f}%, loss {loss:.4f}")
        print(f"kstep cli: {len(ds)} scene-frames at batch 1, a graph of {K_STEPS} and a tail of "
              f"{len(ds) - K_STEPS} an epoch, resumed; test_codet #gt {n_gt} as the dataset, launches {launches}")
        # 5. --mode nuscenes exits naming the devkit this machine lacks
        try:
            create_data_det.main(["--mode", "nuscenes", "--root", work, "--data", os.path.join(work, "nu")])
            raise AssertionError("--mode nuscenes ran without nuscenes-devkit")
        except SystemExit as e:
            if "nuscenes-devkit" not in str(e):
                raise AssertionError(f"--mode nuscenes exit: {e}") from None
            print(f"create_data_det --mode nuscenes: exits with \"{str(e)[:60]}...\"")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "kd": kd, "seg": seg}


# phase 14: DiscoNet's bf16 K-step graph twice from one seed: dispatches of
# K_STEPS steps at the quality protocol's 64-grid, at full width and at full
# width fused at layer 2 (the gathered warp)
P14_REPEAT_DISPATCHES = {"64-grid": 3, "full width": 1, "full width at layer 2": 1}
# the gathered warp's gradients against index_select's backward, float32
P14_WARP_GRAD_REL = 1e-6


def index_select_warp(feats, trans, extent_xy):
    """The gathered warp differentiated by autograd through
    ``index_select``, whose backward adds with atomics on the card: the
    forward of ``ops/warp.py::warp_features`` and the oracle of its
    backward (here and in the CPU tests)."""
    import torch

    from disconet_tpu_torch.ops.warp import _sample_coords

    *lead, A, H, W, C = feats.shape
    Ar = trans.shape[-4]
    nb = 1
    for d in lead:
        nb *= d
    px, py = _sample_coords(trans.reshape(nb, Ar, A, 4, 4), extent_xy, H, W)
    flat = feats.reshape(nb * A * H * W, C)
    dev = feats.device
    base = ((torch.arange(nb, device=dev)[:, None, None] * A + torch.arange(A, device=dev)[None, None, :])
            * (H * W))[..., None, None]
    x0, y0 = torch.floor(px), torch.floor(py)
    wx1, wy1 = px - x0, py - y0
    x0i, y0i = x0.long(), y0.long()
    out = None
    for xi, yi, w in ((x0i, y0i, (1 - wx1) * (1 - wy1)), (x0i + 1, y0i, wx1 * (1 - wy1)),
                      (x0i, y0i + 1, (1 - wx1) * wy1), (x0i + 1, y0i + 1, wx1 * wy1)):
        inb = (xi >= 0) & (xi < H) & (yi >= 0) & (yi < W)
        rows = (base + xi.clamp(0, H - 1) * W + yi.clamp(0, W - 1)).reshape(-1)
        t = flat.index_select(0, rows).reshape(px.shape + (C,)) * (w * inb.to(w.dtype))[..., None]
        out = t if out is None else out + t
    return out.to(feats.dtype).reshape(tuple(lead) + (Ar, A) + tuple(px.shape[-2:]) + (C,))


@contextlib.contextmanager
def _layout(arm: str, *models):
    """``arm`` "parent": the layout before the tenth slice patched in, the
    natural decoder in ``models`` and the gathered warp at every grid;
    "block_out": the port's own (the JAX package's defaults)."""
    from unittest import mock

    from disconet_tpu_torch.models import base

    prev = [m.stpn.block_out for m in models]
    with contextlib.ExitStack() as stack:
        if arm == "parent":
            stack.enter_context(mock.patch.object(base, "MATMUL_WARP_CELLS", 0))
            for m in models:
                m.stpn.block_out = False
        try:
            yield
        finally:
            for m, p in zip(models, prev):
                m.stpn.block_out = p


def _nondeterministic_ops(step, batch):
    """The ops that ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` warns about in one call of ``step(batch)``, and
    ``torch.histc`` on the card as a control that the warnings are caught
    (it has no deterministic implementation). Ops that have one (a gather's
    or ``index_select``'s backward, ``index_add``) switch to it silently
    and are not named."""
    import warnings

    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            step(batch)
            torch.histc(batch["trans"].flatten().float(), bins=4)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    names = set()
    for w in rec:
        msg = str(w.message)
        if "does not have a deterministic implementation" in msg:
            names.add(msg.split(" does not have")[0].strip())
        elif "CuBLAS" in msg or "CUBLAS" in msg:
            names.add("cuBLAS (CUBLAS_WORKSPACE_CONFIG unset)")
    control = {n for n in names if "histc" in n}
    return sorted(names - control), bool(control)


def _fp32_repeat(host, deterministic):
    """Phase 13's float32 KD step at full width run twice from the same
    weights with ``torch.backends.cudnn.deterministic`` set as given
    (``build_model`` sets it on): each group's gradient distance between
    the two runs."""
    import torch

    from disconet_tpu_torch import build_model
    from disconet_tpu_torch.training import batch_to_device, create_train_state, make_train_step

    cfg, batch, grads = _p13_config(), batch_to_device(host), []
    for _ in range(2):
        student, teacher = build_model("disco", cfg, seed=0, kd_flag=True), build_model("teacher", cfg, seed=1)
        torch.backends.cudnn.deterministic = deterministic
        try:
            make_train_step(student, cfg, create_train_state(student), teacher=teacher, kd_flag=True)(batch)
        finally:
            torch.backends.cudnn.deterministic = True
        grads.append({k: p.grad.cpu() for k, p in student.named_parameters()})
    return _group_distances(grads[1], grads[0])


def _repeat_runs(label, cfg_r, host, dispatches):
    """DiscoNet's bf16 K-step graph from seed 0, ``dispatches`` dispatches of
    ``K_STEPS`` steps on ``host``'s superbatch, run twice: the keys of the
    parameters and buffers that differ (``torch.equal``) and the losses."""
    import torch

    from disconet_tpu_torch import build_model
    from disconet_tpu_torch.training import batch_to_device, create_train_state, make_train_step_multi

    sb = batch_to_device(_superbatch(host, K_STEPS))
    runs = []
    for _ in range(2):
        m = build_model("disco", cfg_r, seed=0, layer=cfg_r.fusion_layer)
        multi = make_train_step_multi(m, cfg_r, create_train_state(m))
        losses = [multi(sb)["loss"].float().cpu() for _ in range(dispatches)]
        runs.append(({k: v.detach().clone() for k, v in m.state_dict().items()}, torch.cat(losses)))
        del m, multi
        torch.cuda.empty_cache()
    (p0, l0), (p1, l1) = runs
    differ = [k for k in p0 if not torch.equal(p0[k], p1[k])]
    print(f"repeat {label}: 2 runs of {dispatches} x {K_STEPS} bf16 steps from seed 0, {len(p0) - len(differ)} of "
          f"{len(p0)} parameters and buffers bit-identical; last loss {l0[-1].item():.6g} / {l1[-1].item():.6g}, "
          f"losses equal: {torch.equal(l0, l1)}")
    return differ


def _phase14(cfg, host7, teacher, main_path):
    """The block-out decoder and the tap-matrix warp (see the module
    docstring)."""
    import torch

    from disconet_tpu_torch import build_model, example_train_batch, predict, tiny_config
    from disconet_tpu_torch.ops.warp import warp_features, warp_features_matmul
    from disconet_tpu_torch.training import batch_to_device, create_train_state, make_train_step

    t_phase = time.perf_counter()
    # 1. the block-out float32 step, both block-out stages, against the CPU
    _card_vs_cpu_kd_step(tiny_config(64, compute_dtype="float32", head_raw_dtype="float32", block_out_dec1=True),
                         "f32, 64-grid, block-out stages 0 and 1")

    # 2. the K-step graph twice from one seed
    q_cfg = tiny_config(64)
    q_host = example_train_batch(q_cfg, BATCH, AGENTS, seed=6)
    host = {k: v for k, v in host7.items() if k != "bev_teacher"}
    layer2 = dataclasses.replace(cfg, fusion_layer=2)
    differ = {"64-grid": _repeat_runs("64-grid (quality protocol)", q_cfg, q_host, P14_REPEAT_DISPATCHES["64-grid"]),
              "full width": _repeat_runs("full width", cfg, host, P14_REPEAT_DISPATCHES["full width"]),
              "full width at layer 2": _repeat_runs("full width at layer 2 (64x64 cells, the gathered warp)", layer2,
                                                    host, P14_REPEAT_DISPATCHES["full width at layer 2"])}
    for label, (c, h) in {"64-grid step": (q_cfg, q_host), "full-width step": (cfg, host),
                          "full-width step at layer 2 (gather)": (dataclasses.replace(cfg, fusion_layer=2), host)
                          }.items():
        m = build_model("disco", c, seed=0, layer=c.fusion_layer)
        ops, control = _nondeterministic_ops(make_train_step(m, c, create_train_state(m)), batch_to_device(h))
        print(f"nondeterministic ops of a {label}: {ops or 'none'} (the control, histc, named: {control})")
        del m
    if any(differ.values()):
        raise AssertionError(f"DiscoNet's K-step graph does not repeat: {differ}")
    fp32 = {det: _fp32_repeat(host7, det) for det in (False, True)}
    print("float32 KD step at full width twice, gradient distance by group: cuDNN's own algorithms "
          + ", ".join(f"{k} {v:.2e}" for k, v in fp32[False].items()) + "; deterministic (build_model's) "
          + ", ".join(f"{k} {v:.2e}" for k, v in fp32[True].items()))
    if max(fp32[True].values()) > 0:
        raise AssertionError(f"the float32 step does not repeat with deterministic cuDNN: {fp32[True]}")

    # 3. the gathered warp at 64x64 (layer 2 of full width) against
    # index_select's backward, then the warp's two forms at layer 3 of full
    # width (32x32) and of the 64-grid (8x8)
    trans = batch_to_device(host)["trans"]
    dev = trans.device
    ext, c2 = cfg.area_extents[:2], cfg.backbone_channels[2]
    g = torch.Generator(device=dev).manual_seed(2)
    feats = torch.randn(BATCH, AGENTS, 64, 64, c2, device=dev, generator=g)
    cot = torch.randn(BATCH, AGENTS, AGENTS, 64, 64, c2, device=dev, generator=g)
    fr = feats.clone().requires_grad_(True)
    got, want = warp_features(fr, trans, ext), index_select_warp(fr, trans, ext)
    g_got, = torch.autograd.grad(got, fr, cot)
    g_want, = torch.autograd.grad(want, fr, cot)
    rel = ((g_got - g_want).norm() / g_want.norm()).item()
    print(f"warp 64x64 (layer 2 at full width): the gather's forward equal to index_select's: {torch.equal(got, want)}, "
          f"gradients {rel:.2e} apart (limit {P14_WARP_GRAD_REL:g})")
    if not torch.equal(got, want) or rel > P14_WARP_GRAD_REL:
        raise AssertionError(f"the gathered warp parts from index_select's: forward equal {torch.equal(got, want)}, "
                             f"gradients {rel}")
    del got, want, g_got, g_want
    train = {name: (lambda fn=fn: torch.autograd.grad(fn(fr, trans, ext), fr, cot))
             for name, fn in (("index_add", index_select_warp), ("sorted", warp_features))}
    _turns("warp 64x64, float32 forward and backward", train, calls=10)
    del feats, cot, fr
    for c in (cfg, q_cfg):
        hw = c.map_dims[0] // 8
        label, ext = f"{hw}x{hw}", c.area_extents[:2]
        g = torch.Generator(device=dev).manual_seed(1)
        feats = torch.randn(BATCH, AGENTS, hw, hw, 256, device=dev, generator=g)
        cot = torch.randn(BATCH, AGENTS, AGENTS, hw, hw, 256, device=dev, generator=g)
        err = (warp_features_matmul(feats, trans, ext) - warp_features(feats, trans, ext)).abs().max().item()
        fb = feats.to(torch.bfloat16)
        err_b = (warp_features_matmul(fb, trans, ext).float() - warp_features(fb, trans, ext).float()).abs().max().item()
        print(f"warp {label}: the product against the gather, float32 max |diff| {err:.2e}, bf16 {err_b:.2e}")
        if err > 1e-5:
            raise AssertionError(f"warp {label}: the product parts from the gather by {err}")
        fr = feats.clone().requires_grad_(True)
        train = {name: (lambda fn=fn: torch.autograd.grad(fn(fr, trans, ext), fr, cot))
                 for name, fn in (("gather", warp_features), ("matmul", warp_features_matmul))}
        _turns(f"warp {label}, float32 forward and backward", train, calls=10)
        infer = {name: (lambda fn=fn: fn(fb, trans, ext))
                 for name, fn in (("gather", warp_features), ("matmul", warp_features_matmul))}
        _turns(f"warp {label}, bf16 forward", infer, calls=10)
        del feats, cot, fr, fb

    # 4. decoder stage 0 at full width in both layouts
    dec = build_model("disco", cfg, seed=0).stpn.dec_0
    n, (H, W), (c0, c1) = BATCH * AGENTS, cfg.map_dims, cfg.backbone_channels[:2]
    x = torch.randn(n, c1, H // 2, W // 2, device=dev).contiguous(memory_format=torch.channels_last)
    skip = torch.randn(n, c0, H, W, device=dev).contiguous(memory_format=torch.channels_last)
    cot = torch.randn(n, c0, H, W, device=dev).contiguous(memory_format=torch.channels_last)
    xr = x.clone().requires_grad_(True)
    dec.train()
    train = {arm: (lambda arm=arm: torch.autograd.grad(dec(xr, skip, mode=arm), [xr] + list(dec.parameters()), cot))
             for arm in ("natural", "block_out")}
    _turns("decoder stage 0 at full width, bf16 training forward and backward", train)
    dec.eval()
    with torch.no_grad():
        infer = {arm: (lambda arm=arm: dec(x, skip, store_bf16=True, mode=arm))
                 for arm in ("natural", "block_out")}
        _turns("decoder stage 0 at full width, bf16 inference (store_bf16)", infer, calls=10)
    del dec, x, skip, cot, xr

    # 5. the KD step and predict at full width, the parent's layout against the port's
    tb = batch_to_device(host7)
    students = {arm: build_model("disco", cfg, seed=0, kd_flag=True) for arm in ("parent", "block_out")}
    steps = {arm: make_train_step(m, cfg, create_train_state(m), teacher=teacher, kd_flag=True)
             for arm, m in students.items()}

    def kd(arm):
        with _layout(arm, students[arm], teacher):
            steps[arm](tb)

    _turns("KD step (teacher re-forward) at full width, layout A/B", {a: functools.partial(kd, a) for a in steps})

    def cudnn(det, fn):
        torch.backends.cudnn.deterministic = det
        try:
            fn()
        finally:
            torch.backends.cudnn.deterministic = True

    _turns("KD step at full width, cuDNN's own algorithms against deterministic ones",
           {n: functools.partial(cudnn, d, functools.partial(kd, "block_out")) for n, d in (("own", False),
                                                                                               ("deterministic", True))})
    pts_d, trans_d, amask_d, anchors = main_path
    model = build_model("disco", cfg, seed=0).eval()

    def pred(arm):
        with _layout(arm, model):
            predict(model, pts_d, trans_d, amask_d, anchors, cfg)

    _turns("predict at full width, layout A/B", {a: functools.partial(pred, a) for a in ("parent", "block_out")},
           calls=20, unit="a batch")
    del students, steps, model, tb
    torch.cuda.empty_cache()
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")


# phase 15: the block-space layouts against the natural one from the same
# weights: float32 losses and statistics within 1e-4; each group's gradients
# and grad_norm within the CPU tests' 3e-2 against JAX
# (tests/test_torch_port_training.py GROUP_LIMIT, below the 0.13 of planted
# BatchNorm faults): every batch-statistics BatchNorm's backward leaves a
# residue whose fp32 rounding the reordered sums move (a CPU rehearsal read
# 1.0e-2). In float64 every metric and group within phase 13's 1e-9: the
# rewrite is exact.
P15_LOSS_RTOL, P15_STATS_ATOL, P15_GRAD_REL_L2 = 1e-4, 1e-4, 3e-2


def _p15_step(cfg, host, encoder=False, dtype="float32"):
    """DiscoNet's KD step (teacher re-forward) of seed 0's student and seed
    1's teacher in ``cfg``'s layout (``encoder``: ``block_out_encoder`` on
    both), computed in ``dtype`` -> metrics, gradients and running
    statistics on the host."""
    import torch

    from disconet_tpu_torch import build_model
    from disconet_tpu_torch.training import batch_to_device, create_train_state, make_train_step

    student, teacher = build_model("disco", cfg, seed=0, kd_flag=True), build_model("teacher", cfg, seed=1)
    for m in (student, teacher):
        m.stpn.block_out_encoder = encoder
        m.to(getattr(torch, dtype))
    with _float64() if dtype == "float64" else contextlib.nullcontext():
        metrics = make_train_step(student, cfg, create_train_state(student), teacher=teacher, kd_flag=True)(
            batch_to_device(host))
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {k: p.grad.cpu() for k, p in student.named_parameters()},
        "stats": {k: v.cpu() for k, v in student.state_dict().items() if k.endswith(("running_mean", "running_var"))},
    }


def _p15_layouts(host, host64):
    """The float32 (on ``host``) and float64 (on ``host64``) KD steps of
    each layout against the natural layout's; raises past the bounds."""
    import torch

    natural = dataclasses.replace(_p13_config(), block_out=False)
    layouts = {"block_space": (dataclasses.replace(natural, block_space=True), False),
               "block_out_encoder": (natural, True)}
    for dtype, host in (("float32", host), ("float64", host64)):
        want = _p15_step(natural, host, dtype=dtype)
        for name, (c, enc) in layouts.items():
            got = _p15_step(c, host, enc, dtype)
            rel = {k: abs(got["metrics"][k] - v) / max(abs(v), 1e-12) for k, v in want["metrics"].items()}
            losses = max(v for k, v in rel.items() if k != "grad_norm")
            stats = max((got["stats"][k] - v).abs().max().item() for k, v in want["stats"].items())
            groups = _group_distances(got["grads"], want["grads"])
            groups["grad_norm"] = rel["grad_norm"]
            print(f"layout {name} against natural, {dtype} KD step at full width: losses {losses:.2e}, "
                  f"statistics {stats:.2e}, gradients by group " + ", ".join(f"{k} {v:.2e}" for k, v in groups.items()))
            limits = ((P15_LOSS_RTOL, P15_STATS_ATOL, P15_GRAD_REL_L2) if dtype == "float32"
                      else (P13_F64_REL,) * 3)
            if losses > limits[0] or stats > limits[1] or max(groups.values()) > limits[2]:
                raise AssertionError(f"layout {name} ({dtype}) parts from the natural layout: metrics {rel}, "
                                     f"statistics {stats}, gradients {groups}")
    torch.cuda.empty_cache()


def _phase15(cfg, host7, main_path):
    """The block-space layouts, ``head_in_dtype`` and ``ConfigGlobal`` (see
    the module docstring) -> each layout's kernel launches in one
    ``predict``."""
    import torch

    from disconet_tpu_torch import ConfigGlobal, build_model, example_train_batch, predict
    from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix
    from disconet_tpu_torch.ops.voxelize import voxelize_occupy
    from disconet_tpu_torch.training import batch_to_device, create_train_state, get_bev, make_train_step

    t_phase = time.perf_counter()
    # float64 on one scene of 6 agents: a float64 KD step of 4 scenes does not fit the card
    _p15_layouts(host7, example_train_batch(cfg, 1, AGENTS, seed=2))

    pts_d, trans_d, amask_d, anchors = main_path
    tb = batch_to_device(host7)
    arms = {"block_out": (cfg, False), "block_space": (dataclasses.replace(cfg, block_space=True), False),
            "block_out_encoder": (cfg, True), "head_in bf16": (dataclasses.replace(cfg, head_in_dtype="bfloat16"), False)}
    launches, keeps = {}, {}
    steps, models = {}, {}
    for arm, (c, enc) in arms.items():
        student, teacher = build_model("disco", c, seed=0, kd_flag=True), build_model("teacher", c, seed=1)
        model = build_model("disco", c, seed=0).eval()
        for m in (student, teacher, model):
            m.stpn.block_out_encoder = enc
        steps[arm] = functools.partial(make_train_step(student, c, create_train_state(student), teacher=teacher,
                                                       kd_flag=True), tb)
        models[arm] = functools.partial(predict, model, pts_d, trans_d, amask_d, anchors, c)
        voxelize_occupy.launches = rotated_iou_matrix.launches = 0
        out = models[arm]()
        torch.cuda.synchronize()
        launches[arm] = {"voxelize": voxelize_occupy.launches, "rotated_iou": rotated_iou_matrix.launches}
        keeps[arm] = out[2].cpu()
        if launches[arm] != {"voxelize": 1, "rotated_iou": 1}:
            raise AssertionError(f"predict in layout {arm}: kernel launches {launches[arm]}, not one each")
    print("phase 15 predict launches: " + "; ".join(f"{a} {n}" for a, n in launches.items()))
    if not torch.equal(keeps["head_in bf16"], keeps["block_out"]):
        raise AssertionError("head_in_dtype bfloat16 changes predict's keep masks")
    print(f"head_in_dtype bfloat16: predict's keep masks equal to the default's ({int(keeps['block_out'].sum())} kept)")
    for arm in ("block_space", "block_out_encoder", "head_in bf16"):
        _turns(f"KD step at full width, {arm} against the default layout",
               {"block_out": steps["block_out"], arm: steps[arm]})
        if arm != "head_in bf16":
            _turns(f"predict at full width, {arm} against the default layout",
                   {"block_out": models["block_out"], arm: models[arm]}, calls=20, unit="a batch")
    del steps, models, tb

    t_default = build_model("teacher", cfg, seed=1)
    t_global = build_model("teacher", ConfigGlobal(), seed=1)
    tb = batch_to_device(host7)
    with torch.no_grad():
        bev = get_bev(tb, "bev_teacher", cfg)
        a, b = t_default(bev, None, tb["agent_mask"]), t_global(bev, None, tb["agent_mask"])
    same = all(torch.equal(a[k], b[k]) for k in ("cls", "reg"))
    print(f"ConfigGlobal teacher: outputs equal to a Config() teacher's from the same seed: {same}")
    if not (isinstance(t_global.config, ConfigGlobal) and same):
        raise AssertionError("the ConfigGlobal teacher parts from the Config() teacher")
    del t_default, t_global, tb
    torch.cuda.empty_cache()
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 13: the sharded steps on the card against the one-process step,
# float32 at full width, at the CPU tests' bounds
# (tests/test_torch_port_parallel.py): losses 1e-5, grad_norm 1e-4, each
# group of layers' gradients 1e-2 (relative L2), running statistics 1e-5.
# The mesh path on a world of one rank (nccl) read 2.7e-3 in the gradients
# and the sharded steps 2.7e-3 to 2.9e-3 on the H100 (PERF.md): the
# composed BatchNorm of the mesh path against F.batch_norm's
P13_METRIC_RTOL, P13_GRAD_NORM_RTOL, P13_GRAD_REL_L2, P13_STATS_ATOL = 1e-5, 1e-4, 1e-2, 1e-5
P13_RUNS = (("data=2", "gloo", (2, 1, 1)), ("data=2 x agent=2", "gloo", (2, 2, 1)), ("world 1", "nccl", (1, 1, 1)))
# the groups of layers whose gradients are compared; "fusion" is the rest
# (DiscoNet's weight_net, the other models' fusion layers)
P13_GROUPS = {"encoder": ("stpn.stages_",), "decoder": ("stpn.dec_", "stpn.head_conv."), "heads": ("heads.",)}


def _p13_config():
    from disconet_tpu_torch import Config

    return Config(compute_dtype="float32", head_raw_dtype="float32")


def _p13_step(host, mesh=None):
    """DiscoNet's KD step (teacher re-forward) and the predict step of fresh
    seeded models, on ``mesh``'s slice of ``host`` (the whole batch without
    one) -> metrics, gradients, running statistics, predict outputs and the
    step's seconds, on the host."""
    import torch

    from disconet_tpu_torch import build_model
    from disconet_tpu_torch.parallel import shard_batch
    from disconet_tpu_torch.training import batch_to_device, create_train_state, make_predict_step, make_train_step

    cfg = _p13_config()
    batch = batch_to_device(host) if mesh is None else shard_batch(host, mesh)
    student, teacher = build_model("disco", cfg, seed=0, kd_flag=True), build_model("teacher", cfg, seed=1)
    step = make_train_step(student, cfg, create_train_state(student), teacher=teacher, kd_flag=True, mesh=mesh)
    t0 = time.perf_counter()
    metrics = step(batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    model = build_model("disco", cfg, seed=0)
    predict = make_predict_step(model, cfg, mesh)(batch)
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {k: p.grad.cpu() for k, p in student.named_parameters()},
        "stats": {k: v.cpu() for k, v in student.state_dict().items() if k.endswith(("running_mean", "running_var"))},
        "predict": [t.cpu() for t in predict[:3]],
        "coords": None if mesh is None else mesh.coords,
        "step_s": step_s,
    }


def _p13_rank(rank, world, port, backend, shape, host, path, fn):
    """A rank of phase 13's group, every rank on the one card: ``fn(host,
    mesh)`` saved to ``path``.rank."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from disconet_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    try:
        torch.save(fn(host, make_mesh(*shape, device="cuda:0")), f"{path}.{rank}")
    finally:
        dist.destroy_process_group()


def _p13_spawn(backend, shape, host, work, fn=None):
    """Phase 13's ranks of ``shape`` on the card, each running ``fn``
    (:func:`_p13_step` by default) -> their results."""
    import math
    import multiprocessing
    import socket

    import torch

    world = math.prod(shape)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    path = os.path.join(work, f"{backend}_{'x'.join(map(str, shape))}")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_p13_rank, args=(r, world, port, backend, shape, host, path, fn or _p13_step))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 300
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"phase 13 {backend} {shape}: rank exit codes {codes}")
    return [torch.load(f"{path}.{r}", weights_only=False) for r in range(world)]


def _group_distances(got, want):
    """{group: relative L2 distance of the group's gradients taken together};
    a model's parameters outside ``P13_GROUPS`` form its "fusion" group."""
    import torch

    groups = {g: [k for k in want if k.startswith(p)] for g, p in P13_GROUPS.items()}
    taken = {k for keys in groups.values() for k in keys}
    groups["fusion"] = [k for k in want if k not in taken]
    out = {}
    for g, keys in groups.items():
        if keys:
            num = torch.sqrt(sum(((got[k] - want[k]) ** 2).sum() for k in keys))
            out[g] = float(num / torch.sqrt(sum((want[k] ** 2).sum() for k in keys)))
    return out


def _detections_equivalent(want, got, score_atol=2e-3, box_atol=5e-2, tie_frac=0.15):
    """``tests/test_parallel.py``'s equivalence of two predict outputs:
    equal keep counts per (scene, agent), the kept scores' spectra within
    ``score_atol``, nearly every kept box matched within ``box_atol``.
    Returns (kept boxes, unmatched)."""
    import numpy as np

    (b1, s1, k1), (b2, s2, k2) = ([np.asarray(t) for t in x] for x in (want, got))
    if not np.array_equal(k1.sum(-1), k2.sum(-1)):
        raise AssertionError(f"keep counts differ: {k1.sum(-1)} vs {k2.sum(-1)}")
    total = unmatched = 0
    for bi in range(k1.shape[0]):
        for ai in range(k1.shape[1]):
            x1, x2 = b1[bi, ai][k1[bi, ai]], b2[bi, ai][k2[bi, ai]]
            d_s = np.abs(np.sort(s1[bi, ai][k1[bi, ai]]) - np.sort(s2[bi, ai][k2[bi, ai]]))
            if d_s.size and d_s.max() > score_atol:
                raise AssertionError(f"score spectra differ by {d_s.max()} at scene {bi} agent {ai}")
            if len(x1):
                d = np.abs(x1[:, None, :] - x2[None, :, :]).max(-1)
                unmatched += int((d.min(axis=1) > box_atol).sum())
                total += len(x1)
    if total == 0 or unmatched > tie_frac * total:
        raise AssertionError(f"{unmatched}/{total} kept boxes unmatched")
    return total, unmatched


def _phase13(cfg):
    """Data and agent parallelism on the one card (see the module docstring)."""
    import numpy as np
    import torch

    from disconet_tpu_torch import example_train_batch

    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="p13_", dir=build)
    try:
        host = example_train_batch(_p13_config(), BATCH, AGENTS, seed=5)
        ref, again = _p13_step(host), _p13_step(host)
        torch.cuda.empty_cache()
        floor = _group_distances(again["grads"], ref["grads"])
        print("parallel: the one-process float32 KD step twice on the card (its own spread), gradient "
              "distance by group " + ", ".join(f"{k} {v:.2e}" for k, v in floor.items())
              + f"; a step {ref['step_s'] * 1e3:.1f} ms with its first-call work")
        for name, backend, shape in P13_RUNS:
            ranks = _p13_spawn(backend, shape, host, work)
            worst = {"metric": 0.0, "grad_norm": 0.0, "group": 0.0, "stats": 0.0}
            kept = unmatched = 0
            for res in ranks:
                for k, v in ref["metrics"].items():
                    rel = abs(res["metrics"][k] - v) / abs(v)
                    key = "grad_norm" if k == "grad_norm" else "metric"
                    worst[key] = max(worst[key], rel)
                worst["group"] = max(worst["group"], max(_group_distances(res["grads"], ref["grads"]).values()))
                worst["stats"] = max(worst["stats"], max(float((res["stats"][k] - v).abs().max())
                                                         for k, v in ref["stats"].items()))
                c = res["coords"]
                b, a = res["predict"][0].shape[:2]
                want = [t[c["data"] * b:(c["data"] + 1) * b, c["agent"] * a:(c["agent"] + 1) * a]
                        for t in ref["predict"]]
                n, u = _detections_equivalent(want, res["predict"])
                kept, unmatched = kept + n, unmatched + u
            print(f"parallel {name} ({backend}, {len(ranks)} rank(s) on the one card): losses {worst['metric']:.1e} "
                  f"(limit {P13_METRIC_RTOL}), grad_norm {worst['grad_norm']:.1e} ({P13_GRAD_NORM_RTOL}), "
                  f"gradients {worst['group']:.2e} ({P13_GRAD_REL_L2}), statistics {worst['stats']:.1e} "
                  f"({P13_STATS_ATOL}) from one process; predict keep counts equal, {unmatched}/{kept} kept boxes "
                  f"unmatched; a rank's step {max(r['step_s'] for r in ranks) * 1e3:.1f} ms with its first-call work")
            if (worst["metric"] > P13_METRIC_RTOL or worst["grad_norm"] > P13_GRAD_NORM_RTOL
                    or worst["group"] > P13_GRAD_REL_L2 or worst["stats"] > P13_STATS_ATOL):
                raise AssertionError(f"parallel {name}: the sharded step parts from one process: {worst}")
        _p13_fusion(host, work)
        _p13_torchrun(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")


# phase 13, the other fusion models: each --com's float32 train step, the
# same step in float64, and predict under agent 2 and under spatial 2 (2
# gloo ranks on the card, one spawn per layout, the models in turn),
# DiscoNet's predict too, against the one-process steps on the same batch:
# each group of layers' gradients within P13_GRAD_REL_L2 in float32 and
# P13_F64_REL in float64, predict keep counts equal
P13_COMS = ("sum", "mean", "max", "cat", "agent", "v2v", "when2com", "who2com")
P13_LAYOUTS = (("agent=2", (1, 2, 1)), ("spatial=2", (1, 1, 2)))
# the sharded float64 step against the one-process float64 step: the same
# arithmetic in another order (the CPU tests read 3e-14)
P13_F64_REL = 1e-9


@contextlib.contextmanager
def _float64():
    """The float32 mode computed in float64: ``Tensor.float`` keeps float64
    and new floating tensors default to it (the caller casts the model);
    V2VNet's 3x3 convs go to ``F.conv2d`` (the kernel takes float32 only)."""
    import torch
    from unittest import mock

    import torch.nn.functional as F

    from disconet_tpu_torch.models import v2v_net

    def conv64(x, weight, bias=None, pad_h=1):
        return F.conv2d(x, weight, bias, padding=(pad_h, 1))

    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with mock.patch.object(torch.Tensor, "float", lambda self, *a, **k: self.to(torch.float64)), \
                mock.patch.object(v2v_net, "conv3x3_f32x3", conv64):
            yield
    finally:
        torch.set_default_dtype(default)


def _p13_fusion_steps(host, mesh=None, twice=False, device="cuda"):
    """Per ``--com``: one float32 train step, the same step in float64 and
    one predict of the model of seed 0 on ``mesh``'s slice of ``host`` (the
    whole batch without one; ``twice``: a second float32 step from the same
    weights) -> metrics and gradients on the host, predict outputs;
    DiscoNet's predict alone."""
    import copy

    import torch

    from disconet_tpu_torch import build_model
    from disconet_tpu_torch.parallel import shard_batch
    from disconet_tpu_torch.training import batch_to_device, create_train_state, make_predict_step, make_train_step

    cfg = _p13_config()

    def step(drawn, dtype):
        model = copy.deepcopy(drawn).to(dtype)
        with _float64() if dtype == torch.float64 else contextlib.nullcontext():
            batch = batch_to_device(host, device) if mesh is None else shard_batch(host, mesh)
            metrics = make_train_step(model, cfg, create_train_state(model), mesh=mesh)(batch)
        return {"metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {k: p.grad.cpu() for k, p in model.named_parameters()}}

    batch = batch_to_device(host, device) if mesh is None else shard_batch(host, mesh)
    out = {}
    for com in P13_COMS:
        drawn = build_model(com, cfg, device=device, seed=0)
        res = {"predict": [t.cpu() for t in make_predict_step(copy.deepcopy(drawn), cfg, mesh)(batch)[:3]]}
        for run in ("step", "again") if twice else ("step",):
            res[run] = step(drawn, torch.float32)
        res["f64"] = step(drawn, torch.float64)
        out[com] = res
        del drawn
        if device == "cuda":
            torch.cuda.empty_cache()
    model = build_model("disco", cfg, device=device, seed=0)
    out["disco"] = {"predict": [t.cpu() for t in make_predict_step(model, cfg, mesh)(batch)[:3]]}
    out["coords"] = None if mesh is None else mesh.coords
    return out


def _p13_fusion_check(ref, layouts):
    """Hold each layout's ranks to the one-process results ``ref``: one
    line per ``--com``, then an AssertionError naming every model past the
    gradient limit."""
    past = []
    for com in P13_COMS + ("disco",):
        parts = []
        for name, ranks in layouts.items():
            grad = grad64 = loss = 0.0
            worst = ""
            kept = unmatched = 0
            for res in ranks:
                c = res["coords"]
                b, a = res[com]["predict"][0].shape[:2]
                want = [t[c["data"] * b:(c["data"] + 1) * b, c["agent"] * a:(c["agent"] + 1) * a]
                        for t in ref[com]["predict"]]
                n, u = _detections_equivalent(want, res[com]["predict"])
                kept, unmatched = kept + n, unmatched + u
                if "step" in res[com]:
                    got, exp = res[com]["step"], ref[com]["step"]
                    by_group = _group_distances(got["grads"], exp["grads"])
                    g = max(by_group, key=by_group.get)
                    if by_group[g] >= grad:
                        grad, worst = by_group[g], g
                    grad64 = max(grad64, max(_group_distances(res[com]["f64"]["grads"],
                                                              ref[com]["f64"]["grads"]).values()))
                    loss = max(loss, abs(got["metrics"]["loss"] / exp["metrics"]["loss"] - 1))
            step = (f"gradients {grad:.2e} ({worst}), float64 {grad64:.1e}, loss {loss:.1e}, "
                    if com != "disco" else "")
            parts.append(f"{name}: {step}keep counts equal, {unmatched}/{kept} kept boxes unmatched")
            if grad > P13_GRAD_REL_L2 or grad64 > P13_F64_REL:
                past.append(f"{com} {name} {grad:.3e} (float64 {grad64:.1e})")
        floor = ""
        if "again" in ref[com]:
            f = max(_group_distances(ref[com]["again"]["grads"], ref[com]["step"]["grads"]).values())
            floor = f"; one process twice {f:.2e}"
        print(f"parallel {com} (full width, 2 gloo ranks on the card): " + "; ".join(parts)
              + f" (gradient limits {P13_GRAD_REL_L2}, float64 {P13_F64_REL}{floor})")
    if past:
        raise AssertionError(f"parallel: gradients past {P13_GRAD_REL_L2} (float64 {P13_F64_REL}) from one "
                             f"process: {', '.join(past)}")


def _p13_fusion(host, work):
    """Every other ``--com`` (and DiscoNet's predict) under ``agent`` 2 and
    ``spatial`` 2 against one process on the card."""
    import torch

    t0 = time.perf_counter()
    ref = _p13_fusion_steps(host, twice=True)
    torch.cuda.empty_cache()
    layouts = {name: _p13_spawn("gloo", shape, host, work, _p13_fusion_steps) for name, shape in P13_LAYOUTS}
    _p13_fusion_check(ref, layouts)
    print(f"parallel, the other --com under agent and spatial: {time.perf_counter() - t0:.1f} s")


def _p13_torchrun(work):
    """``train_codet --com disco --mesh_agent 2`` under ``torchrun`` on the
    card (gloo, both ranks on it) for an epoch of synthetic data at full
    width, then auto-resumed for a second."""
    import socket

    from disconet_tpu_torch.tools.det import create_data_det

    root = os.path.dirname(os.path.abspath(__file__))
    _cli(create_data_det.main, ["--data", work, "--mode", "synthetic", "--scenes", "1", "--frames", "4"])
    logs = os.path.join(work, "logs")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    outs = []
    for nepoch, extra in (("1", []), ("2", ["--auto_resume_path", logs])):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = str(sock.getsockname()[1])
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
               "--master_port", port, "-m", "disconet_tpu_torch.tools.det.train_codet",
               "--data", os.path.join(work, "train"), "--com", "disco", "--batch", "2", "--nepoch", nepoch,
               "--mesh_agent", "2", "--dist_backend", "gloo", "--logpath", logs, *extra]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=600)
        print("\n".join("    | " + line for line in run.stdout.splitlines() if line.strip()))
        if run.returncode != 0:
            raise AssertionError(f"torchrun train_codet exited {run.returncode}: {run.stderr[-3000:]}")
        outs.append((run.stdout, time.perf_counter() - t0))
    (first, s1), (second, s2) = outs
    needles = ("mesh: {'data': 1, 'agent': 2} over 2 ranks (gloo, cuda:0)", "epoch 1 done")
    if not all(n in first for n in needles) or first.count("epoch 1 done") != 1:
        raise AssertionError("torchrun train_codet: no mesh line or not one epoch line")
    if "auto-resumed from epoch 1" not in second or "epoch 2 done" not in second:
        raise AssertionError("torchrun train_codet: the resumed run did not continue from epoch 1")
    if not os.path.exists(os.path.join(logs, "disco", "epoch_2.pth")):
        raise AssertionError("torchrun train_codet: no epoch_2.pth")
    print(f"torchrun train_codet --mesh_agent 2 (gloo, 2 ranks on the card): an epoch in {s1:.1f} s, resumed for a "
          f"second in {s2:.1f} s (process start included)")


# phase 16: V2VNet's float32 3x3 convs on the 3xTF32 kernel
# (ops/conv3x3.py) at its fusion's shapes (images, rows out, width, Cin,
# Cout, pad_h), each against a float64 conv of the same inputs beside
# cuDNN's float32 (TF32 off) on the same data, forward and input gradient:
# the kernel's largest and RMS error at most 2x cuDNN's; the planted single
# TF32 pass (TF32-rounded activations, no lo weights) past that limit; two
# runs bit-identical. Then the kernel's times beside cuDNN's and its bound.
# (--layer, fusion grid, C) of V2VNet at batch 4 x 6 agents; --layer 3 is the main path
CONV_LAYERS = ((3, 32, 256), (2, 64, 128), (1, 128, 64), (0, 256, 32))
TF32_OPS_PER_S = 495e12


def _conv_shapes():
    """(shape, --layer, what, convs of the shape a predict) of each conv."""
    for layer, g, c in CONV_LAYERS:
        yield (BATCH * AGENTS * AGENTS, g, g, c, c, 1), layer, "msg_conv sender half", 3
        yield (BATCH * AGENTS, g, g, c, c, 1), layer, "msg_conv receiver half", 3
        yield (BATCH * AGENTS, g, g, 2 * c, c, 1), layer, "ConvGRU update, reset, cand", 9
        if layer == 3:
            yield (BATCH * AGENTS, g // 2, g, 2 * c, c, 0), layer, "ConvGRU on a strip of spatial 2 (halo rows)", 0


def _tf32_round(t):
    import torch

    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _rel_errors(got, ref):
    d = got.double() - ref
    return (d.abs().max() / ref.abs().max()).item(), (d.norm() / ref.norm()).item()


def _ptxas_report(name):
    """ptxas's registers, shared memory and spills of csrc/<name>.cu."""
    from disconet_tpu_torch import _build

    with tempfile.TemporaryDirectory() as tmp:
        run = subprocess.run([_build._nvcc(), *[f for f in _build.NVCC_FLAGS if f != "-shared"], "-Xptxas", "-v",
                              "-c", "-o", os.path.join(tmp, "k.o"), os.path.join(_build.CSRC, f"{name}.cu")],
                             capture_output=True, text=True)
    lines = [ln.strip() for ln in (run.stdout + run.stderr).splitlines() if ln.strip()]
    print(f"ptxas {name}.cu:\n    " + "\n    ".join(lines))


def _phase16():
    import torch
    import torch.nn.functional as F

    from disconet_tpu_torch.ops import conv3x3 as c3
    from disconet_tpu_torch.ops.conv3x3 import conv3x3_f32x3

    t_phase = time.perf_counter()
    _ptxas_report("conv3x3_f32x3")
    dev = torch.device("cuda")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    try:
        for i, ((n, h, w, cin, cout, pad_h), layer, what, per_predict) in enumerate(_conv_shapes()):
            g = torch.Generator(device="cuda").manual_seed(16 + i)
            cl = torch.channels_last
            x = torch.randn(n, cin, h + 2 - 2 * pad_h, w, device=dev, generator=g).contiguous(memory_format=cl)
            wt = torch.randn(cout, cin, 3, 3, device=dev, generator=g) * (2.0 / (9 * cin)) ** 0.5
            b = torch.randn(cout, device=dev, generator=g) * 0.1
            gy = torch.randn(n, cout, h, w, device=dev, generator=g).contiguous(memory_format=cl)
            x64 = x.double().requires_grad_()
            ref = F.conv2d(x64, wt.double(), b.double(), padding=(pad_h, 1))
            ref.backward(gy.double())
            x32 = x.clone().requires_grad_()
            F.conv2d(x32, wt, b, padding=(pad_h, 1)).backward(gy)
            lib = F.conv2d(x, wt, b, padding=(pad_h, 1))
            xk = x.clone().requires_grad_()
            got = conv3x3_f32x3(xk, wt, b, pad_h)
            got.backward(gy)
            again = conv3x3_f32x3(x, wt, b, pad_h)
            dx_again = c3._launch(gy, c3._prepare(wt, True), None, 2 - pad_h)
            torch.cuda.synchronize()
            if not (torch.equal(got, again) and torch.equal(xk.grad, dx_again)):
                raise AssertionError(f"conv3x3 {what} at --layer {layer}: two runs differ")

            def fault(t, bias, transpose, pad):
                wsplit = c3._prepare(wt, transpose)
                wsplit[1].zero_()
                return c3._launch(_tf32_round(t.permute(0, 2, 3, 1)).permute(0, 3, 1, 2), wsplit, bias, pad)

            errs = {}
            for part, kernel, cudnn, exact, planted in (
                    ("forward", got, lib, ref.detach(), fault(x, b, False, pad_h)),
                    ("input grad", xk.grad, x32.grad, x64.grad, fault(gy, None, True, 2 - pad_h))):
                k, c, f = (_rel_errors(t, exact) for t in (kernel, cudnn, planted))
                errs[part] = {"kernel": k, "cudnn": c, "single_pass": f}
                if not (k[0] <= 2 * c[0] and k[1] <= 2 * c[1]):
                    raise AssertionError(f"conv3x3 {what} at --layer {layer} {part}: kernel max/rms {k} past 2x "
                                         f"cuDNN's {c}")
                if not (f[0] > 2 * c[0] or f[1] > 2 * c[1]):
                    raise AssertionError(f"conv3x3 {what} at --layer {layer} {part}: the single-pass fault {f} "
                                         f"passes 2x cuDNN's {c}")
            del x64, ref, x32, xk, got, again, dx_again
            torch.cuda.empty_cache()
            wsplit_t = c3._prepare(wt, True)
            ops = 2 * 9 * cin * cout * n * h * w
            row = {
                "shape": [n, h, w, cin, cout, pad_h], "layer": layer, "what": what, "per_predict": per_predict,
                "errors": errs,
                "ms": _time_ms(lambda: conv3x3_f32x3(x, wt, b, pad_h)),
                "device_ms": _device_ms(lambda: conv3x3_f32x3(x, wt, b, pad_h))[0],
                "library_ms": _time_ms(lambda: F.conv2d(x, wt, b, padding=(pad_h, 1))),
                "grad_ms": _time_ms(lambda: c3._launch(gy, c3._prepare(wt, True), None, 2 - pad_h)),
                "grad_library_ms": _time_ms(lambda: torch.ops.aten.convolution_backward(
                    gy, x, wt, None, [1, 1], [pad_h, 1], [1, 1], False, [0, 0], 1, [True, False, False])),
                "grad_kernel_only_ms": _time_ms(lambda: c3._launch(gy, wsplit_t, None, 2 - pad_h)),
                "bound_ms": 3 * ops / TF32_OPS_PER_S * 1e3,
            }
            row["tflops"] = ops / row["ms"] / 1e9
            rows.append(row)
            e = errs["forward"]
            print(f"conv3x3 --layer {layer} {what} {tuple(row['shape'])}: {row['ms']:.3f} ms ({row['device_ms']:.3f} "
                  f"device, {row['tflops']:.1f} TFLOP/s), cuDNN fp32 {row['library_ms']:.3f}, bound "
                  f"{row['bound_ms']:.3f}; input grad {row['grad_ms']:.3f} (kernel alone "
                  f"{row['grad_kernel_only_ms']:.3f}) against cuDNN {row['grad_library_ms']:.3f}; max/rms error vs "
                  f"float64: forward kernel {e['kernel'][0]:.2e}/{e['kernel'][1]:.2e}, cuDNN "
                  f"{e['cudnn'][0]:.2e}/{e['cudnn'][1]:.2e}, single pass "
                  f"{e['single_pass'][0]:.2e}/{e['single_pass'][1]:.2e}; input grad kernel "
                  f"{errs['input grad']['kernel'][0]:.2e}/{errs['input grad']['kernel'][1]:.2e}, cuDNN "
                  f"{errs['input grad']['cudnn'][0]:.2e}/{errs['input grad']['cudnn'][1]:.2e}, single pass "
                  f"{errs['input grad']['single_pass'][0]:.2e}/{errs['input grad']['single_pass'][1]:.2e}  [{_SMI}]")
            del x, wt, b, gy, wsplit_t
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    per_predict = {}
    for layer, _, _ in CONV_LAYERS:
        per_predict[layer] = {k: sum(r[k] * r["per_predict"] for r in rows if r["layer"] == layer)
                              for k in ("ms", "device_ms", "library_ms", "bound_ms", "grad_ms", "grad_library_ms")}
        print(f"conv3x3 per predict at --layer {layer} (15 convs): "
              + ", ".join(f"{k} {v:.3f}" for k, v in per_predict[layer].items()))
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return {"rows": rows, "per_predict": per_predict}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
