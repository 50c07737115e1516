"""The inference pipeline: points -> voxelize -> DiscoNet -> rotated NMS.

:func:`predict` runs every (scene, agent) frame of a batch through voxelize,
the fusion model, the packed score/delta split and the batched rotated NMS,
on the model's device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.data.targets import assign_targets, sparse_targets
from disconet_tpu_torch.models.base import agents_to_batch
from disconet_tpu_torch.ops.boxes import make_anchors
from disconet_tpu_torch.ops.nms import (
    IouFn, packed_scores_and_deltas, rotated_nms_decode, rotated_nms_decode_packed,
)
from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix
from disconet_tpu_torch.ops.voxelize import voxelize_occupy


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype).contiguous()


def predict(
    model: nn.Module,
    points,
    trans,
    agent_mask,
    anchors,
    cfg: Config,
    voxelize: Callable = voxelize_occupy,
    iou: IouFn = rotated_iou_matrix,
):
    """Detections for a batch of scenes.

    Args:
        model: an eval-mode fusion model (``build_model``); its device is the
            device of the run.
        points: (B, A, N, 3) float32 LiDAR points per agent; non-finite rows
            are padding and are dropped.
        trans: (B, A, A, 4, 4) relative poses, trans[b, i, j] maps sender j
            into receiver i.
        agent_mask: (B, A) bool, present agents.
        anchors: (H, W, NA, 5) from ``make_anchors``.
        cfg: the model's config.
        voxelize, iou: the voxelizer and the IoU function. The defaults are
            the kernel wrappers; the plain versions can be passed to run the
            same pipeline without the kernels.

    Returns:
        boxes (B, A, K, 5), scores (B, A, K), keep (B, A, K) bool with
        K = cfg.nms_top_k; dead slots have keep False.
    """
    dev = next(model.parameters()).device
    points = _as_tensor(points, torch.float32, dev)
    trans = _as_tensor(trans, torch.float32, dev)
    agent_mask = _as_tensor(agent_mask, torch.bool, dev)
    anchors = _as_tensor(anchors, torch.float32, dev)
    with torch.inference_mode():
        bev = voxelize(points, cfg.voxel_size, cfg.area_extents)
        return detect(model, bev, trans, agent_mask, anchors, cfg, iou)


def detect(model: nn.Module, bev, trans, agent_mask, anchors, cfg: Config, iou: IouFn = rotated_iou_matrix):
    """The model and the rotated NMS on device tensors: bev (B, A, H, W, Z)
    -> boxes (B, A, K, 5), scores (B, A, K), keep (B, A, K), as
    :func:`predict`. The caller sets the grad mode. The model stores its
    ConvBNRelu outputs in bf16 in the bf16 mode (``store_bf16``): the NMS
    reads no value that the rounding changes. ``cfg.packed_nms`` chooses the
    candidates from the head's logits (:func:`ops.nms.rotated_nms_decode_packed`)."""
    B, A = bev.shape[:2]
    out = model(bev, trans, agent_mask, store_bf16=True)
    raw = agents_to_batch(out["head_raw"])
    nms = dict(iou_threshold=cfg.nms_iou_threshold, score_threshold=cfg.score_threshold,
               top_k=cfg.nms_top_k, iou=iou)
    if cfg.packed_nms:
        boxes, top_scores, keep = rotated_nms_decode_packed(raw, anchors, cfg.num_anchors, **nms)
    else:
        scores, deltas = packed_scores_and_deltas(raw, cfg.num_anchors, cfg.box_code_size)
        boxes, top_scores, keep = rotated_nms_decode(deltas, scores, anchors, **nms)
    K = cfg.nms_top_k
    return boxes.reshape(B, A, K, 5), top_scores.reshape(B, A, K), keep.reshape(B, A, K)


def example_batch(cfg: Config, batch: int, agents: int, seed: int = 0):
    """Random example inputs: (bev, trans, mask) as numpy arrays.

    bev (B, A, H, W, Z) with 1% occupancy; trans from random planar rigid
    poses per agent, trans[b, i, j] = inv(pose_i) @ pose_j; all agents present.
    """
    rng = np.random.default_rng(seed)
    H, W, Z = cfg.bev_shape
    bev = (rng.random((batch, agents, H, W, Z)) < 0.01).astype(np.float32)
    trans = np.tile(np.eye(4, dtype=np.float32), (batch, agents, agents, 1, 1))
    for b in range(batch):
        poses = []
        for _ in range(agents):
            th = rng.uniform(-np.pi, np.pi)
            c, s = np.cos(th), np.sin(th)
            T = np.eye(4, dtype=np.float32)
            T[:2, :2] = [[c, -s], [s, c]]
            T[:2, 3] = rng.uniform(-10, 10, 2)
            poses.append(T)
        for i in range(agents):
            inv = np.linalg.inv(poses[i])
            for j in range(agents):
                trans[b, i, j] = inv @ poses[j]
    mask = np.ones((batch, agents), bool)
    return bev, trans, mask


def example_train_batch(cfg: Config, batch: int, agents: int, seed: int = 0,
                        occupancy=(0.01, 0.02), boxes_per_frame: int = 8):
    """A random host training batch for ``cfg``: uint8 occupancy grids for
    the student and the teacher (``occupancy``), the poses of
    :func:`example_batch`, agent (1, agents - 1) absent when ``batch`` > 1,
    and the sparse targets (``reg_pos_idx``, ``reg_pos_target``) of
    ``boxes_per_frame`` car-sized boxes a frame, 3 m or more inside the
    extent, from ``assign_targets``. Ship it with
    ``training.batch_to_device``."""
    rng = np.random.default_rng(seed)
    H, W, Z = cfg.bev_shape
    _, trans, mask = example_batch(cfg, batch, agents, seed=seed)
    if batch > 1:
        mask[1, agents - 1] = False
    anchors = make_anchors(cfg)
    (x_lo, x_hi), (y_lo, y_hi), _ = cfg.area_extents
    P, code, n = cfg.max_pos_anchors, cfg.box_code_size, boxes_per_frame
    idx = np.empty((batch, agents, P), np.int32)
    pos = np.empty((batch, agents, P, code), np.float32)
    for b in range(batch):
        for a in range(agents):
            gt = np.stack([rng.uniform(x_lo + 3, x_hi - 3, n), rng.uniform(y_lo + 3, y_hi - 3, n),
                           rng.uniform(1.8, 2.2, n), rng.uniform(4.0, 5.0, n),
                           rng.uniform(-np.pi, np.pi, n)], -1)
            t = assign_targets(gt, cfg, anchors)
            idx[b, a], pos[b, a] = sparse_targets(t["reg_loss_mask"], t["reg_target"], P)
    return {
        "bev": (rng.random((batch, agents, H, W, Z)) < occupancy[0]).astype(np.uint8),
        "bev_teacher": (rng.random((batch, agents, H, W, Z)) < occupancy[1]).astype(np.uint8),
        "trans": trans,
        "agent_mask": mask,
        "reg_pos_idx": idx,
        "reg_pos_target": pos,
    }
