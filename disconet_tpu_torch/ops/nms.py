"""Rotated NMS over encoded predictions, batched over frames.

The JAX package maps one frame's NMS over frames with ``vmap``; here the frame
axis is a batch dimension: one rotated-IoU launch covers every frame, and the
fixpoint suppression loop runs until no frame changes.

Top-k ties: empty BEV regions give many exactly equal scores. ``lax.top_k``
breaks ties toward the lower index, while ``torch.topk`` promises no order, so
every selection here is a stable descending sort cut to ``k``: among equal
scores the lower index wins, as in JAX. Selection is exact; the JAX package's
``approx_max_k`` is a TPU device choice, not part of the semantics.
"""

from __future__ import annotations

from typing import Callable

import torch

from disconet_tpu_torch.ops.boxes import decode_boxes
from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix

IouFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def packed_scores_and_deltas(raw: torch.Tensor, num_anchors: int, box_code_size: int = 6):
    """Split the class-major packed head tensor (..., NA*2 + NA*code) into
    float32 foreground scores (..., NA) = sigmoid(l1 - l0) and the packed
    deltas (..., NA*code)."""
    NA = num_anchors
    if raw.shape[-1] != NA * (2 + box_code_size):
        raise ValueError(
            f"packed head tensor has {raw.shape[-1]} channels, expected "
            f"NA*(2 + {box_code_size}) = {NA * (2 + box_code_size)} (binary-class layout)"
        )
    scores = torch.sigmoid(raw[..., NA : 2 * NA].float() - raw[..., :NA].float())
    return scores, raw[..., 2 * NA :]


def _top_k_stable(x: torch.Tensor, k: int):
    """Exact top-k along the last axis, ties to the lower index (lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pad_to(x: torch.Tensor, top_k: int, fill) -> torch.Tensor:
    """Pad axis 1 (the candidate axis) of a (F, k, ...) tensor to ``top_k``."""
    pad = top_k - x.shape[1]
    if pad <= 0:
        return x
    block = torch.full((x.shape[0], pad) + tuple(x.shape[2:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, block], dim=1)


def _select_candidates_spatial(scores: torch.Tensor, score_threshold: float, top_k: int):
    """Two-level top-k over (F, H, W, A) scores.

    Level 1 takes the top-k of the (H*W) per-cell maxima; level 2 the top-k
    of the winners' k*A scores. Exact: a score in the global top-k has fewer
    than k cells with a larger maximum, so its cell survives level 1.
    Returns thresholded scores (F, top_k) and (h, w, a) index tensors.
    """
    Fr, H, W, A = scores.shape
    k = min(top_k, H * W)
    _, cells = _top_k_stable(scores.amax(-1).reshape(Fr, H * W), k)  # (F, k)
    cand = torch.gather(
        scores.reshape(Fr, H * W, A), 1, cells[..., None].expand(Fr, k, A)
    )  # (F, k, A)
    kk = min(top_k, k * A)
    vals, pos = _top_k_stable(cand.reshape(Fr, k * A), kk)
    cell_sel = torch.gather(cells, 1, torch.div(pos, A, rounding_mode="floor"))
    h = torch.div(cell_sel, W, rounding_mode="floor")
    w = cell_sel % W
    a = pos % A
    vals = torch.where(vals >= score_threshold, vals, torch.full_like(vals, -1.0))
    return (
        _pad_to(vals, top_k, -1.0),
        (_pad_to(h, top_k, 0), _pad_to(w, top_k, 0), _pad_to(a, top_k, 0)),
    )


def _mask_invalid_boxes(top_boxes: torch.Tensor, top_scores: torch.Tensor) -> torch.Tensor:
    """Zero the box rows of dead slots (below threshold or padding)."""
    return torch.where((top_scores > -1.0)[..., None], top_boxes, torch.zeros_like(top_boxes))


def _iou_matrix(top_boxes: torch.Tensor, iou: IouFn = rotated_iou_matrix) -> torch.Tensor:
    """(F, K, K) rotated IoU of each frame's candidates against themselves.

    A box is the same point set under w -> |w|, but the IoU assumes w, l >= 0,
    so the sizes are normalised first.
    """
    b = torch.cat([top_boxes[..., :2], top_boxes[..., 2:4].abs(), top_boxes[..., 4:]], dim=-1)
    return iou(b, b)


def _suppress(
    top_boxes: torch.Tensor,
    top_scores: torch.Tensor,
    iou_threshold: float,
    iou: IouFn = rotated_iou_matrix,
) -> torch.Tensor:
    """Greedy suppression as an exact fixpoint iteration, (F, K) keep mask.

    Greedy NMS is the unique solution of
    ``keep[i] = valid[i] and not any(j < i: keep[j] and iou[j, i] > thr)``.
    Iterating ``keep <- f(keep)`` from ``keep = valid`` settles at least one
    more prefix index per step, so iterating until no frame changes (at most K
    steps) is exact. A frame already at its fixpoint stays there, so running
    all frames until the last one settles gives each frame's own result.
    """
    K = top_scores.shape[-1]
    ious = _iou_matrix(top_boxes, iou)
    valid = top_scores > -1.0
    ar = torch.arange(K, device=top_scores.device)
    conflict = (ious > iou_threshold) & (ar[:, None] < ar[None, :])  # [f, j, i]
    keep = valid
    for _ in range(K):
        new = valid & ~(keep[..., :, None] & conflict).any(dim=-2)
        changed = bool((new != keep).any())
        keep = new
        if not changed:
            break
    return keep


def rotated_nms_decode(
    deltas: torch.Tensor,
    scores: torch.Tensor,
    anchors: torch.Tensor,
    iou_threshold: float,
    score_threshold: float = 0.0,
    top_k: int = 256,
    iou: IouFn = rotated_iou_matrix,
):
    """Rotated NMS over packed encoded predictions: top-k first, decode only winners.

    Args:
        deltas: (F, H, W, A*code) packed deltas, the head's channel layout.
        scores: (F, H, W, A) foreground scores, strictly above -1 (the
            dead-slot sentinel).
        anchors: (H, W, A, 5).
        iou_threshold: suppress boxes with IoU > threshold against a kept box.
        score_threshold: candidates below it become dead slots.
        top_k: candidates per frame, and the size of the outputs.
        iou: the (B, N, 5) x (B, M, 5) IoU function; the kernel wrapper by
            default.

    Returns:
        boxes (F, top_k, 5) float32, scores (F, top_k), keep (F, top_k) bool.
        Dead slots have score -1, zero boxes and keep False.

    Deltas are decoded in float32 whatever their storage dtype.
    """
    Fr, H, W, A = scores.shape
    top_scores, (h, w, a) = _select_candidates_spatial(scores, score_threshold, top_k)
    code = deltas.shape[-1] // A
    cell = h * W + w  # (F, top_k)
    rows = torch.gather(
        deltas.reshape(Fr, H * W, A * code), 1, cell[..., None].expand(Fr, top_k, A * code)
    ).reshape(Fr, top_k, A, code)
    d = torch.gather(rows, 2, a[..., None, None].expand(Fr, top_k, 1, code))[:, :, 0]
    anc = anchors.reshape(H * W * A, 5)[cell * A + a]  # (F, top_k, 5)
    top_boxes = decode_boxes(d.float(), anc)
    top_boxes = _mask_invalid_boxes(top_boxes, top_scores)
    keep = _suppress(top_boxes, top_scores, iou_threshold, iou)
    return top_boxes, top_scores, keep


def multiclass_nms_decode(
    deltas: torch.Tensor,
    cls_logits: torch.Tensor,
    anchors: torch.Tensor,
    iou_threshold: float,
    score_threshold: float = 0.0,
    top_k: int = 256,
    iou: IouFn = rotated_iou_matrix,
):
    """Per-class rotated NMS over encoded predictions, batched over frames:
    the reference's ``predict_all`` runs NMS independently per class.

    Args:
        deltas: (F, H, W, A, code) class-agnostic box deltas.
        cls_logits: (F, H, W, A, C) raw class logits, class 0 background.
        anchors, iou_threshold, score_threshold, top_k, iou: as
            :func:`rotated_nms_decode`.

    Each foreground class c selects, decodes and suppresses on its own
    softmax probability, so boxes of different classes never suppress each
    other; every class runs :func:`rotated_nms_decode` over all frames.

    Returns:
        boxes (F, (C-1)*top_k, 5), scores, keep and labels (int32 class ids
        1..C-1), class-major within a frame.
    """
    Fr, H, W, A, code = deltas.shape
    C = cls_logits.shape[-1]
    probs = torch.softmax(cls_logits.float(), dim=-1)
    packed = deltas.float().reshape(Fr, H, W, A * code)
    per_class = [
        rotated_nms_decode(packed, probs[..., c], anchors, iou_threshold, score_threshold, top_k, iou)
        for c in range(1, C)
    ]
    boxes, scores, keep = (torch.stack(t, dim=1).reshape((Fr, (C - 1) * top_k) + t[0].shape[2:])
                           for t in zip(*per_class))
    labels = torch.arange(1, C, dtype=torch.int32, device=deltas.device)
    labels = labels[None, :, None].expand(Fr, C - 1, top_k).reshape(Fr, (C - 1) * top_k)
    return boxes, scores, keep, labels
