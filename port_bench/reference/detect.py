"""Plain reference of the detection pipeline around the model, and the
comparison of a served ``predict`` call with it.

* :func:`voxelize`: binary occupancy of the finite points inside the
  extent, cell ``floor((p - lo) / voxel)`` in float32.
* :func:`candidates`: the foreground score ``sigmoid(l1 - l0)`` of every
  anchor and the best-scoring ``k`` anchors of each frame, decoded
  (cx = dx * d_a + ax, w = exp(dw) * aw, theta = atan2(sin, cos)).
* :func:`rotated_iou`: a frozen copy of the program's plain rotated IoU
  (``disconet_tpu_torch/ops/rotated_iou.py`` lines 40-131: Liang-Barsky
  boundary pieces of each quad inside the other, with its tolerances), the
  arithmetic the program's CUDA kernel reproduces bit for bit; and
  :func:`greedy_keep`, greedy NMS in score order.

:func:`compare_call` judges one served call. Anchors of one size differ
only by their deltas, so neighbouring anchors decode to boxes a fraction of
a metre apart, and a served box alone does not say which anchor it came
from. A served detection (box and score) is therefore matched to the
reference anchor that explains it best: of the anchors whose reference
boxes are centred in the cell of the served box's centre or one of its
eight neighbours (:func:`nearest_anchors`), the one with the least cost
max(corner distance / ``BOX_SCALE``, score gap / ``SCORE_SCALE``). Then:

* ``box_gap``: the corner distance (metres) from a served box to its
  match, the widest over all;
* ``score_gap``: the gap between a served score and its match's reference
  score, the widest over all;
* ``rank_gap``: how far the served detections depart from the reference's
  best ``k``. The cut is the reference's k-th best score, or the score
  threshold where that is higher. A served detection whose match lies
  under the cut reads by how much; so does a reference detection over the
  cut that no served one explains at a cost of 1 or less, by how much it
  lies over it; and a dead slot, by how far the reference's score of the
  same rank lies over the threshold (the top scores of a frame may crowd
  near 1, where a ranking turned upside down serves only dead slots and
  leaves the others within a hair of the cut). The widest;
* ``keep_gap``: how many keep flags differ from greedy NMS run on the
  program's own boxes and scores: exact.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_TOL = 1e-4
_EPS = 1e-9
# reference boxes looked at per cell around a served box's centre (a cell
# holds the centres of about its own anchors' boxes, six)
NEAR_PER_CELL = 96
# what a match may differ by before it costs 1 (metres, score): over the
# widest gaps of a sound bfloat16 run, under the control's
BOX_SCALE = 0.5
SCORE_SCALE = 0.05


def voxelize(points: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """(B, A, N, 3) float32 -> (B, A, H, W, Z) float32 occupancy."""
    lo = torch.tensor([e[0] for e in cfg["area_extents"]], dtype=torch.float32, device=points.device)
    hi = torch.tensor([e[1] for e in cfg["area_extents"]], dtype=torch.float32, device=points.device)
    vs = torch.tensor(cfg["voxel_size"], dtype=torch.float32, device=points.device)
    dims = torch.ceil((hi.double() - lo.double()) / vs.double() - 1e-9).long()
    H, W, Z = (int(d) for d in dims)
    B, A, N, _ = points.shape
    p = points.reshape(B * A, N, 3)
    ok = torch.isfinite(p).all(-1)
    p = torch.where(ok[..., None], p, lo - 1.0)
    idx = torch.floor((p - lo) / vs).long()
    ok &= ((p >= lo) & (p < hi)).all(-1) & ((idx >= 0) & (idx < dims)).all(-1)
    frame = torch.arange(B * A, device=p.device)[:, None].expand(B * A, N)
    flat = ((frame * H + idx[..., 0]) * W + idx[..., 1]) * Z + idx[..., 2]
    grid = torch.zeros(B * A * H * W * Z, device=p.device)
    grid[flat[ok]] = 1.0
    return grid.reshape(B, A, H, W, Z)


def decode(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    da = torch.sqrt(anchors[..., 2] ** 2 + anchors[..., 3] ** 2)
    return torch.stack([
        deltas[..., 0] * da + anchors[..., 0],
        deltas[..., 1] * da + anchors[..., 1],
        torch.exp(deltas[..., 2].clamp(-10, 10)) * anchors[..., 2],
        torch.exp(deltas[..., 3].clamp(-10, 10)) * anchors[..., 3],
        torch.atan2(deltas[..., 4], deltas[..., 5]),
    ], dim=-1)


def candidates(cls: torch.Tensor, reg: torch.Tensor, anchors: torch.Tensor, k: int):
    """cls (F, H, W, NA, 2), reg (F, H, W, NA, code) -> every anchor's
    foreground score (F, H*W*NA), the ``k`` best anchors of each frame (F,
    k), best first (ties to the lower index), and every anchor's decoded
    box (F, H, W, NA, 5)."""
    Fr = cls.shape[0]
    scores = torch.sigmoid(cls[..., 1] - cls[..., 0]).reshape(Fr, -1)
    _, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return scores, idx[:, :k], decode(reg, anchors)


def served(scores: torch.Tensor, top: torch.Tensor, boxes: torch.Tensor, thr: float):
    """What a detector serves from :func:`candidates`: the best anchors'
    boxes (F, k, 5) and scores (F, k), a slot under ``thr`` dead (score -1,
    box zero)."""
    Fr = scores.shape[0]
    s = torch.gather(scores, 1, top)
    s = torch.where(s >= thr, s, torch.full_like(s, -1.0))
    b = torch.gather(boxes.reshape(Fr, -1, 5), 1, top[..., None].expand(-1, -1, 5))
    return torch.where((s > -1)[..., None], b, torch.zeros_like(b)), s


def corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) -> (..., 4, 2), counter-clockwise from (+w/2, +l/2)."""
    cx, cy, w, l, th = boxes.unbind(-1)
    dx = torch.stack([w / 2, -w / 2, -w / 2, w / 2], dim=-1)
    dy = torch.stack([l / 2, l / 2, -l / 2, -l / 2], dim=-1)
    c, s = torch.cos(th)[..., None], torch.sin(th)[..., None]
    return torch.stack([cx[..., None] + c * dx - s * dy, cy[..., None] + s * dx + c * dy], dim=-1)


def _corner_list(cx, cy, w, l, th):
    c, s = torch.cos(th), torch.sin(th)
    hw, hl = 0.5 * w, 0.5 * l
    return [(cx + c * dx - s * dy, cy + s * dx + c * dy) for dx, dy in ((hw, hl), (-hw, hl), (-hw, -hl), (hw, -hl))]


def _pieces_area(P, C, tol):
    total = None
    for e in range(4):
        e1x, e1y = P[e]
        e2x, e2y = P[(e + 1) % 4]
        dx, dy = e2x - e1x, e2y - e1y
        dlen = torch.sqrt(dx * dx + dy * dy)
        t_lo = t_hi = par_ok = None
        for k in range(4):
            c1x, c1y = C[k]
            c2x, c2y = C[(k + 1) % 4]
            nx, ny = -(c2y - c1y), (c2x - c1x)
            num = nx * (e1x - c1x) + ny * (e1y - c1y)
            den = nx * dx + ny * dy
            nlen = torch.sqrt(nx * nx + ny * ny)
            ntol = tol * nlen
            is_par = torch.abs(den) < 1e-5 * nlen * dlen + _EPS
            t_cross = -(num + ntol) / torch.where(is_par, torch.ones_like(den), den)
            if t_lo is None:
                t_lo, t_hi = torch.zeros_like(t_cross), torch.ones_like(t_cross)
                par_ok = torch.ones_like(is_par)
            t_lo = torch.where(~is_par & (den > 0), torch.maximum(t_lo, t_cross), t_lo)
            t_hi = torch.where(~is_par & (den < 0), torch.minimum(t_hi, t_cross), t_hi)
            par_ok = par_ok & (~is_par | (num >= -ntol))
        alive = (t_hi > t_lo) & par_ok
        q1x, q1y = e1x + t_lo * dx, e1y + t_lo * dy
        q2x, q2y = e1x + t_hi * dx, e1y + t_hi * dy
        piece = torch.where(alive, 0.5 * (q1x * q2y - q1y * q2x), torch.zeros_like(q1x))
        total = piece if total is None else total + piece
    return total


def rotated_iou(boxes: torch.Tensor) -> torch.Tensor:
    """(F, K, 5) -> (F, K, K) IoU of each frame's boxes against themselves."""
    a = [t[:, :, None] for t in boxes.unbind(-1)]
    b = [t[:, None, :] for t in boxes.unbind(-1)]
    ca, cb = _corner_list(*a), _corner_list(*b)
    inter = torch.clamp(_pieces_area(ca, cb, _TOL) + _pieces_area(cb, ca, -_TOL), min=0.0)
    area_a, area_b = a[2] * a[3], b[2] * b[3]
    union = area_a + area_b - inter
    ok = (area_a > 0) & (area_b > 0) & (union > 1e-8)
    return torch.where(ok, inter / union, torch.zeros_like(inter))


def greedy_keep(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over slots in the given order (F, K): a live slot (score
    above -1) is kept unless a kept earlier slot overlaps it by more than
    the threshold."""
    b = torch.cat([boxes[..., :2], boxes[..., 2:4].abs(), boxes[..., 4:]], dim=-1)
    over = rotated_iou(b) > iou_threshold
    live = scores > -1.0
    keep = torch.zeros_like(live)
    for i in range(live.shape[1]):
        keep[:, i] = live[:, i] & ~(keep[:, :i] & over[:, :i, i]).any(dim=1)
    return keep


def nearest_anchors(boxes: torch.Tensor, ref_all: torch.Tensor, cfg: Dict):
    """For each of the program's boxes (F, K, 5), the reference anchors
    whose decoded boxes (of ``ref_all``, F, H, W, NA, 5) are centred in the
    cell of the box's centre or one of its eight neighbours: their flat
    indices (F, K, M), the corner distance (metres) to each, infinite where
    a slot holds no anchor."""
    Fr, H, W, NA, _ = ref_all.shape
    K = boxes.shape[1]
    (x_lo, _), (y_lo, _), _ = cfg["area_extents"]
    vx, vy, _ = cfg["voxel_size"]

    def cell_of(b):
        h = torch.floor((b[..., 0] - x_lo) / vx).long().clamp(-1, H)
        w = torch.floor((b[..., 1] - y_lo) / vy).long().clamp(-1, W)
        return (h + 1) * (W + 2) + (w + 1)  # a border of one cell takes what lies outside

    flat = ref_all.reshape(Fr, -1, 5)
    keys, order = torch.sort(cell_of(flat), dim=1, stable=True)
    c = cell_of(boxes)  # (F, K)
    off = torch.tensor([dh * (W + 2) + dw for dh in (-1, 0, 1) for dw in (-1, 0, 1)], device=boxes.device)
    q = (c[..., None] + off).reshape(Fr, -1)  # (F, K*9)
    lo = torch.searchsorted(keys, q)
    hi = torch.searchsorted(keys, q, right=True)
    slot = lo[..., None] + torch.arange(NEAR_PER_CELL, device=boxes.device)  # (F, K*9, M)
    ok = slot < hi[..., None]
    idx = torch.gather(order, 1, slot.clamp(max=keys.shape[1] - 1).reshape(Fr, -1))
    near = torch.gather(flat, 1, idx[..., None].expand(-1, -1, 5)).reshape(Fr, K, -1, 5)
    d = (corners(boxes)[:, :, None] - corners(near)).norm(dim=-1).amax(-1)
    return idx.reshape(Fr, K, -1), torch.where(ok.reshape(Fr, K, -1), d, torch.full_like(d, float("inf")))


def _cost(dist: torch.Tensor, score_gap: torch.Tensor) -> torch.Tensor:
    return torch.maximum(dist / BOX_SCALE, score_gap / SCORE_SCALE)


def _widest(x: torch.Tensor) -> float:
    return x.max().item() if x.numel() else 0.0


def compare_call(boxes: torch.Tensor, scores: torch.Tensor, keep: torch.Tensor, ref_scores: torch.Tensor,
                 ref_top: torch.Tensor, ref_all: torch.Tensor, cfg: Dict) -> Dict[str, float]:
    """One served call's (F, K, 5) boxes, (F, K) scores and keep, on the
    reference's device, against the reference's scores of every anchor (F,
    N), its best K anchors (F, K) and every anchor's decoded box (F, H, W,
    NA, 5) of the same frames."""
    thr = cfg["score_threshold"]
    live = scores > -1.0
    # each served detection's match
    idx, dist = nearest_anchors(boxes, ref_all, cfg)
    sgap = (scores[..., None] - torch.gather(ref_scores, 1, idx.flatten(1)).reshape(idx.shape)).abs()
    j = _cost(dist, sgap).argmin(-1, keepdim=True)
    box_gap, score_gap = dist.gather(-1, j)[..., 0], sgap.gather(-1, j)[..., 0]
    match = idx.gather(-1, j)[..., 0]
    # the ranking: served matches under the cut, reference detections over it that nothing served explains
    best = torch.gather(ref_scores, 1, ref_top)  # (F, K), best first
    cut = best[:, -1:].clamp(min=thr)
    under = (cut - torch.gather(ref_scores, 1, match)).clamp(min=0.0)[live]
    best_boxes = torch.gather(ref_all.reshape(ref_all.shape[0], -1, 5), 1, ref_top[..., None].expand(-1, -1, 5))
    d = (corners(best_boxes)[:, :, None] - corners(boxes)[:, None]).norm(dim=-1).amax(-1)  # (F, K, K)
    cost = _cost(d, (best[..., None] - scores[:, None, :]).abs())
    explained = (cost.masked_fill(~live[:, None, :], float("inf")).amin(-1) <= 1.0)
    over = (best - cut)[(best >= cut) & ~explained]
    dead = (torch.sort(torch.where(live, scores, torch.zeros_like(scores)), dim=1, descending=True)[0] <= 0) \
        & (best >= thr)
    dead = (best - thr)[dead]
    keep_gap = int((greedy_keep(boxes, scores, cfg["nms_iou_threshold"]) != keep).sum())
    return {"box_gap": _widest(box_gap[live]), "score_gap": _widest(score_gap[live]),
            "rank_gap": max(_widest(under), _widest(over), _widest(dead)), "keep_gap": float(keep_gap)}


def reference_candidates(ctx_factory, fusion, batch: Dict[str, np.ndarray], anchors: torch.Tensor, cfg: Dict,
                         layer: int, k: int, device):
    """:func:`candidates` of the reference on every frame of a predict batch
    (F = B * A frames)."""
    pts = torch.from_numpy(batch["points"]).to(device)
    trans = torch.from_numpy(batch["trans"]).to(device)
    mask = torch.from_numpy(batch["agent_mask"]).to(device)
    with torch.no_grad():
        bev = voxelize(pts, cfg)
        from port_bench.reference.model import forward

        out = forward(ctx_factory(), fusion, bev, trans, mask, layer)
        B, A = mask.shape
        cls = out["cls"].reshape((B * A,) + tuple(out["cls"].shape[2:]))
        reg = out["reg"].reshape((B * A,) + tuple(out["reg"].shape[2:]))
        return candidates(cls, reg, anchors, k)
