"""CLEAR-MOT metrics, the port's copy of the JAX package's (Bernardin and
Stiefelhagen 2008).

Host numpy and scipy. Per frame, the existing gt-to-hypothesis
correspondences are kept while still valid (IoU >= threshold), one to one;
the remaining pairs are matched by the Hungarian method on IoU. Misses,
false positives and identity switches accumulate into MOTA, the matched IoU
into MOTP.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix_np


def clear_mot(
    gt_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
    hyp_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
    iou_threshold: float = 0.5,
) -> Dict[str, float]:
    """CLEAR-MOT over one sequence.

    Args:
        gt_frames: per frame, (gt_boxes (G, 5), gt_ids (G,)).
        hyp_frames: per frame, (hyp_boxes (H, 5), hyp_ids (H,)).
        iou_threshold: a correspondence is valid while IoU >= this.
    Returns:
        MOTA, MOTP, misses, false_positives, id_switches, num_gt, matches,
        and the trajectory counts: MT / PT / ML (gt trajectories tracked in
        >= 80%, between, <= 20% of their frames), num_trajectories, and FRAG
        (tracked runs of a trajectory less one, summed over gt ids).
    """
    assert len(gt_frames) == len(hyp_frames)
    misses = fps = idsw = num_gt = matches = 0
    iou_sum = 0.0
    corr: Dict[int, int] = {}  # gt id -> last matched hyp id
    present: Dict[int, int] = {}  # gt id -> frames present
    tracked: Dict[int, int] = {}  # gt id -> frames matched
    runs: Dict[int, int] = {}  # gt id -> tracked runs
    in_run: Dict[int, bool] = {}

    for (g_boxes, g_ids), (h_boxes, h_ids) in zip(gt_frames, hyp_frames):
        g_boxes = np.asarray(g_boxes, np.float64).reshape(-1, 5)
        h_boxes = np.asarray(h_boxes, np.float64).reshape(-1, 5)
        g_ids = list(np.asarray(g_ids).astype(int))
        h_ids = list(np.asarray(h_ids).astype(int))
        num_gt += len(g_ids)
        if len(g_ids) and len(h_ids):
            iou = rotated_iou_matrix_np(g_boxes, h_boxes)
        else:
            iou = np.zeros((len(g_ids), len(h_ids)))

        matched_g: Dict[int, int] = {}  # gt index -> hyp index
        used_h = set()
        # 1) keep the valid correspondences, one to one: after track churn two
        # gt ids can remember the same hyp id, and only the first keeps it
        for gi, gid in enumerate(g_ids):
            hid = corr.get(gid)
            if hid is not None and hid in h_ids:
                hj = h_ids.index(hid)
                if hj not in used_h and iou[gi, hj] >= iou_threshold:
                    matched_g[gi] = hj
                    used_h.add(hj)
        # 2) the Hungarian method over the rest
        free_g = [i for i in range(len(g_ids)) if i not in matched_g]
        free_h = [j for j in range(len(h_ids)) if j not in used_h]
        if free_g and free_h:
            sub = iou[np.ix_(free_g, free_h)]
            rows, cols = linear_sum_assignment(-sub)
            for r, c in zip(rows, cols):
                if sub[r, c] >= iou_threshold:
                    matched_g[free_g[r]] = free_h[c]
                    used_h.add(free_h[c])

        for gi, hj in matched_g.items():
            gid, hid = g_ids[gi], h_ids[hj]
            if gid in corr and corr[gid] != hid:
                idsw += 1
            corr[gid] = hid
            matches += 1
            iou_sum += iou[gi, hj]

        misses += len(g_ids) - len(matched_g)
        fps += len(h_ids) - len(used_h)

        matched_ids = {g_ids[gi] for gi in matched_g}
        for gid in g_ids:
            present[gid] = present.get(gid, 0) + 1
            if gid in matched_ids:
                tracked[gid] = tracked.get(gid, 0) + 1
                if not in_run.get(gid, False):
                    runs[gid] = runs.get(gid, 0) + 1
                    in_run[gid] = True
            else:
                in_run[gid] = False

    mt = pt = ml = frag = 0
    for gid, n_present in present.items():
        ratio = tracked.get(gid, 0) / n_present
        if ratio >= 0.8:
            mt += 1
        elif ratio <= 0.2:
            ml += 1
        else:
            pt += 1
        frag += max(0, runs.get(gid, 0) - 1)
    return {
        "MOTA": 1.0 - (misses + fps + idsw) / max(num_gt, 1),
        "MOTP": iou_sum / max(matches, 1),
        "misses": misses,
        "false_positives": fps,
        "id_switches": idsw,
        "num_gt": num_gt,
        "matches": matches,
        "MT": mt,
        "PT": pt,
        "ML": ml,
        "FRAG": frag,
        "num_trajectories": len(present),
    }
