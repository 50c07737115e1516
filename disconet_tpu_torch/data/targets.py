"""Anchor-target assignment on the host (numpy), and the sparse encoding the
training step reads.

Rule (as the JAX package's ``data/targets.py``):

* an anchor is positive if its best-gt IoU >= ``pos_iou_threshold``;
* every gt's best anchor is forced positive, after all regular updates, so a
  later gt cannot revoke an earlier gt's forced anchor; a gt takes the best
  of its candidates not yet claimed by another gt;
* positives get the one-hot of their gt's class and ``reg_target`` =
  ``encode_boxes(gt, anchor)``; the rest are background.

Only (anchor, gt) pairs whose circumscribed circles meet are evaluated: the
IoU of the others is exactly 0. The IoU is the host version
(``ops.rotated_iou.rotated_iou_pairs_np``, a copy of the JAX package's), so
that the positive sets agree exactly.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import numpy as np

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.ops.boxes import encode_boxes, make_anchors
from disconet_tpu_torch.ops.rotated_iou import rotated_iou_pairs_np

def assign_targets(
    gt_boxes: np.ndarray,
    config: Config,
    anchors: Optional[np.ndarray] = None,
    gt_classes: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Assign gt boxes (G, 5) to the anchors (H, W, NA, 5).

    ``gt_classes`` (G,) holds class ids in 1..num_classes-1; None makes every
    gt class 1 (the binary vehicle task).

    Returns label_one_hot (H, W, NA, C), reg_target (H, W, NA, code),
    reg_loss_mask (H, W, NA) bool, gt_max_iou (G, 2) (best IoU, its flat
    anchor) and anchors_map (H, W, NA, 6) = (cx, cy, w, l, sin, cos).
    """
    if anchors is None:
        anchors = make_anchors(config)
    H, W, NA, _ = anchors.shape
    C = config.num_classes
    gt_boxes = np.asarray(gt_boxes, dtype=np.float32).reshape(-1, 5)
    G = len(gt_boxes)
    flat = anchors.reshape(-1, 5)
    n = flat.shape[0]

    label = np.zeros((n, C), dtype=np.float32)
    label[:, 0] = 1.0
    reg_target = np.zeros((n, config.box_code_size), dtype=np.float32)
    reg_mask = np.zeros((n,), dtype=bool)
    gt_max_iou = np.zeros((G, 2), dtype=np.float32)

    if G > 0:
        anchor_rad = 0.5 * np.hypot(flat[:, 2], flat[:, 3])
        gt_rad = 0.5 * np.hypot(gt_boxes[:, 2], gt_boxes[:, 3])
        best_iou = np.zeros((n,), dtype=np.float32)
        best_gt = np.full((n,), -1, dtype=np.int64)

        # regular best-gt-per-anchor assignment; each gt's candidates are kept
        cand_per_gt = []
        for g in range(G):
            d = np.hypot(flat[:, 0] - gt_boxes[g, 0], flat[:, 1] - gt_boxes[g, 1])
            cand = np.nonzero(d <= anchor_rad + gt_rad[g])[0]
            if cand.size == 0:  # no anchor meets the box: the nearest, at IoU 0
                cand = np.array([int(np.argmin(d))])
            ious = rotated_iou_pairs_np(flat[cand], np.broadcast_to(gt_boxes[g], (cand.size, 5)))
            upd = ious > best_iou[cand]
            best_iou[cand[upd]] = ious[upd]
            best_gt[cand[upd]] = g
            gt_max_iou[g] = (float(ious.max()), float(cand[int(np.argmax(ious))]))
            cand_per_gt.append((cand, ious))

        # forced matches, greedy over each gt's candidates by IoU, skipping
        # anchors another gt already claimed (shared only when all are)
        claimed: Dict[int, int] = {}
        for g in range(G):
            cand, ious = cand_per_gt[g]
            pick = -1
            for o in np.argsort(-ious):
                if int(cand[o]) not in claimed:
                    pick = int(cand[o])
                    break
            if pick < 0:
                pick = int(cand[int(np.argmax(ious))])
            claimed.setdefault(pick, g)
            best_gt[pick] = g
            reg_mask[pick] = True

        reg_mask |= (best_iou >= config.pos_iou_threshold) & (best_gt >= 0)
        pos_idx = np.nonzero(reg_mask)[0]  # strictly increasing: unique sites
        if pos_idx.size:
            reg_target[pos_idx] = encode_boxes(gt_boxes[best_gt[pos_idx]], flat[pos_idx]).astype(np.float32)
            if gt_classes is None:
                cls_col = np.ones(pos_idx.size, dtype=np.int64)
            else:
                cls_col = np.asarray(gt_classes, np.int64).reshape(-1)[best_gt[pos_idx]]
                if cls_col.min(initial=1) < 1 or cls_col.max(initial=1) >= C:
                    raise ValueError(f"gt_classes must be in [1, {C - 1}] for num_classes={C}")
            label[pos_idx, 0] = 0.0
            label[pos_idx, cls_col] = 1.0

    anchors_map = np.concatenate(
        [anchors[..., 0:4], np.sin(anchors[..., 4:5]), np.cos(anchors[..., 4:5])], axis=-1
    ).astype(np.float32)
    return {
        "label_one_hot": label.reshape(H, W, NA, C),
        "reg_target": reg_target.reshape(H, W, NA, config.box_code_size),
        "reg_loss_mask": reg_mask.reshape(H, W, NA),
        "gt_max_iou": gt_max_iou,
        "anchors_map": anchors_map,
    }


def sparse_targets(reg_mask: np.ndarray, reg_target: np.ndarray, max_pos: int) -> Tuple[np.ndarray, np.ndarray]:
    """Dense targets of one agent-frame -> (reg_pos_idx (P,) int32,
    reg_pos_target (P, code) float32) with P = ``max_pos``.

    The sites are the positives' flat indices in increasing order, padded with
    the sentinel ``reg_mask.size``; excess positives are dropped with a
    warning.
    """
    code = reg_target.shape[-1]
    n_flat = reg_mask.size
    nz = np.nonzero(np.asarray(reg_mask).reshape(-1))[0]
    if len(nz) > max_pos:
        warnings.warn(
            f"{len(nz)} positive anchors exceed max_pos_anchors={max_pos}; "
            "the excess positives are dropped"
        )
        nz = nz[:max_pos]
    idx = np.full((max_pos,), n_flat, np.int32)
    target = np.zeros((max_pos, code), np.float32)
    idx[: len(nz)] = nz
    target[: len(nz)] = np.asarray(reg_target, np.float32).reshape(-1, code)[nz]
    return idx, target


def anchors_from_map(anchors_map: np.ndarray) -> np.ndarray:
    """(H, W, A, 6) stored (cx, cy, w, l, sin, cos) -> (H, W, A, 5) with the
    angle theta = arctan2(sin, cos)."""
    theta = np.arctan2(anchors_map[..., 4], anchors_map[..., 5])
    return np.concatenate([anchors_map[..., :4], theta[..., None]], axis=-1)
