"""Late (detection-level) fusion, the port's copy of the JAX package's
helpers (the reference's ``postprocess.py`` late-fusion path).

Late collaboration: each agent detects independently; receivers then merge
*boxes* (not features): every sender's detections are transformed into the
receiver's frame via the 4x4 relative pose and the union is de-duplicated with
rotated NMS. Host-side numpy — box counts per agent are small and ragged.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix_np


def transform_boxes(boxes: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Rigidly transform BEV boxes (N, 5) by a 4x4 pose: p' = T @ p."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 5).copy()
    if len(boxes) == 0:
        return boxes
    yaw = float(np.arctan2(T[1, 0], T[0, 0]))
    homo = np.c_[boxes[:, :2], np.zeros(len(boxes)), np.ones(len(boxes))]
    p = (np.asarray(T, np.float64) @ homo.T).T
    boxes[:, 0:2] = p[:, 0:2].astype(np.float32)
    boxes[:, 4] += yaw
    return boxes


def nms_np(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy rotated NMS, host numpy; returns kept indices (descending score).

    Each kept box computes its IoU only with the boxes not yet suppressed
    whose circumscribed circles reach its own: two boxes whose circles do
    not meet have IoU 0, so with a threshold >= 0 the result is the full
    (N, N) matrix's. An untrained model's ~1500 boxes a scene then take
    seconds, not the half minute of the full matrix."""
    order = np.argsort(-np.asarray(scores))
    boxes = np.asarray(boxes, np.float64).reshape(-1, 5)
    keep: List[int] = []
    if len(boxes) == 0:
        return np.zeros(0, np.int64)
    centers = boxes[:, :2]
    reach = 0.5 * np.hypot(boxes[:, 2], boxes[:, 3])
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        suppressed[i] = True
        dist = np.hypot(centers[:, 0] - centers[i, 0], centers[:, 1] - centers[i, 1])
        near = np.flatnonzero(~suppressed & (dist <= (reach + reach[i]) * (1 + 1e-9) + 1e-9))
        if near.size:
            iou = rotated_iou_matrix_np(boxes[i : i + 1], boxes[near])[0]
            suppressed[near[iou > iou_threshold]] = True
    return np.asarray(keep, np.int64)


def late_fusion(
    per_agent_dets: Sequence[Tuple[np.ndarray, np.ndarray]],
    trans: np.ndarray,
    receiver: int,
    iou_threshold: float = 0.01,
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge all agents' detections into ``receiver``'s frame (late fusion).

    Args:
        per_agent_dets: per agent slot, (boxes (Ni, 5), scores (Ni,)); absent
            agents pass empty arrays.
        trans: (A, A, 4, 4) with trans[i, j] mapping sender-j -> receiver-i.
        receiver: receiver slot index.
        iou_threshold: de-duplication NMS threshold (reference default).
    Returns:
        (boxes (M, 5), scores (M,)) in the receiver's frame, NMS-deduplicated.
    """
    all_boxes, all_scores = [], []
    for j, (boxes, scores) in enumerate(per_agent_dets):
        if boxes is None or len(boxes) == 0:
            continue
        all_boxes.append(transform_boxes(boxes, trans[receiver, j]))
        all_scores.append(np.asarray(scores, np.float32).reshape(-1))
    if not all_boxes:
        return np.zeros((0, 5), np.float32), np.zeros(0, np.float32)
    boxes = np.concatenate(all_boxes)
    scores = np.concatenate(all_scores)
    keep = nms_np(boxes, scores, iou_threshold)
    return boxes[keep], scores[keep]
