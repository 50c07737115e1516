"""mAP evaluation, the port's copy of the JAX package's (the reference's
``mean_ap.py``, mmdetection-v1 lineage).

Host numpy, numerically mmdet-v1-compatible: greedy per-frame TP/FP
assignment at a rotated-BEV-IoU threshold, a dataset-level PR curve over
score-sorted detections, area-mode average precision. Binary vehicle class:
mAP == AP.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix_np


def tpfp_default(
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    gt_boxes: np.ndarray,
    iou_thr: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy TP/FP flags for one frame (dets sorted by descending score).

    Each det matches the highest-IoU unmatched gt; IoU >= iou_thr => TP, else
    FP; a gt can absorb only one det (mmdet-v1 ``tpfp_default`` semantics).
    """
    order = np.argsort(-np.asarray(det_scores))
    det_boxes = np.asarray(det_boxes, np.float64).reshape(-1, 5)[order]
    n, m = len(det_boxes), len(gt_boxes)
    tp = np.zeros(n, np.float64)
    fp = np.zeros(n, np.float64)
    if m == 0:
        fp[:] = 1.0
    else:
        iou = rotated_iou_matrix_np(det_boxes, gt_boxes) if n else np.zeros((0, m))
        matched = np.zeros(m, bool)
        for i in range(n):
            j = int(np.argmax(iou[i]))
            if iou[i, j] >= iou_thr and not matched[j]:
                matched[j] = True
                tp[i] = 1.0
            else:
                fp[i] = 1.0
    # undo the sort so flags align with the caller's det order
    inv = np.empty_like(order)
    inv[order] = np.arange(n)
    return tp[inv], fp[inv]


def average_precision(recalls: np.ndarray, precisions: np.ndarray, mode: str = "area") -> float:
    """mmdet-v1 ``average_precision``: 'area' under the monotone PR envelope or
    11-point interpolation."""
    recalls = np.concatenate([[0.0], recalls, [1.0]])
    precisions = np.concatenate([[0.0], precisions, [0.0]])
    if mode == "area":
        for i in range(len(precisions) - 2, -1, -1):
            precisions[i] = max(precisions[i], precisions[i + 1])
        idx = np.where(recalls[1:] != recalls[:-1])[0]
        return float(np.sum((recalls[idx + 1] - recalls[idx]) * precisions[idx + 1]))
    if mode == "11points":
        ap = 0.0
        for t in np.arange(0.0, 1.01, 0.1):
            mask = recalls[1:-1] >= t
            ap += (precisions[1:-1][mask].max() if mask.any() else 0.0) / 11.0
        return float(ap)
    raise ValueError(mode)


def eval_map(
    det_results: Sequence[Tuple[np.ndarray, np.ndarray]],
    annotations: Sequence[np.ndarray],
    iou_thr: float = 0.5,
) -> Tuple[float, dict]:
    """Dataset mAP for the binary vehicle class.

    Args:
        det_results: per frame, (boxes (N,5), scores (N,)).
        annotations: per frame, gt boxes (M,5).
        iou_thr: rotated-BEV IoU threshold (0.5 / 0.7).
    Returns:
        (mAP, details) where details has recall/precision arrays and counts.
    """
    all_scores: List[np.ndarray] = []
    all_tp: List[np.ndarray] = []
    all_fp: List[np.ndarray] = []
    num_gts = 0
    for (boxes, scores), gts in zip(det_results, annotations):
        gts = np.asarray(gts, np.float64).reshape(-1, 5)
        num_gts += len(gts)
        tp, fp = tpfp_default(boxes, scores, gts, iou_thr)
        all_scores.append(np.asarray(scores))
        all_tp.append(tp)
        all_fp.append(fp)

    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    tp = np.concatenate(all_tp) if all_tp else np.zeros(0)
    fp = np.concatenate(all_fp) if all_fp else np.zeros(0)
    order = np.argsort(-scores)
    tp_cum = np.cumsum(tp[order])
    fp_cum = np.cumsum(fp[order])
    eps = np.finfo(np.float64).eps
    recalls = tp_cum / max(num_gts, 1)
    precisions = tp_cum / np.maximum(tp_cum + fp_cum, eps)
    ap = average_precision(recalls, precisions) if num_gts > 0 else 0.0
    return ap, {
        "num_gts": num_gts,
        "num_dets": int(len(scores)),
        "recall": float(recalls[-1]) if len(recalls) else 0.0,
        "precision": float(precisions[-1]) if len(precisions) else 0.0,
    }


def eval_map_multiclass(
    det_results: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    annotations: Sequence[Tuple[np.ndarray, np.ndarray]],
    iou_thr: float = 0.5,
    num_classes: int = 2,
) -> Tuple[float, dict]:
    """Per-class mAP (mmdet-v1 semantics: mean over classes with >=1 gt).

    The reference's ``predict_all`` runs per-class NMS and ``mean_ap`` scores
    each class independently; this is the same protocol over labelled
    detections.

    Args:
        det_results: per frame, (boxes (N,5), scores (N,), labels (N,) int
            class ids in 1..num_classes-1).
        annotations: per frame, (gt boxes (M,5), gt classes (M,)).
        iou_thr: rotated-BEV IoU threshold.
    Returns:
        (mean_ap, details) — details has per-class ``ap``/``num_gts``/
        ``num_dets`` dicts plus the summed counts so binary callers' table
        code keeps working.
    """
    per_class: dict = {}
    for c in range(1, num_classes):
        dets_c = [(b[l == c], s[l == c]) for b, s, l in det_results]
        gts_c = [g[gc == c] for g, gc in annotations]
        ap, d = eval_map(dets_c, gts_c, iou_thr=iou_thr)
        per_class[c] = {"ap": ap, **d}
    with_gt = [c for c, d in per_class.items() if d["num_gts"] > 0]
    mean = float(np.mean([per_class[c]["ap"] for c in with_gt])) if with_gt else 0.0
    return mean, {
        "per_class": per_class,
        "num_gts": int(sum(d["num_gts"] for d in per_class.values())),
        "num_dets": int(sum(d["num_dets"] for d in per_class.values())),
    }
