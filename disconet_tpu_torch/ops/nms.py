"""Rotated NMS, batched over frames: on caller boxes (:func:`rotated_nms`),
over encoded predictions in three layouts (:func:`rotated_nms_decode`),
straight from the packed head tensor (:func:`rotated_nms_decode_packed`) and
per class (:func:`multiclass_nms_decode`).

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
from disconet_tpu_torch.utils import profiling

IouFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def foreground_scores(cls_logits: torch.Tensor) -> torch.Tensor:
    """Per-anchor foreground probability of raw class logits (..., C), float32:
    ``sigmoid(l1 - l0)`` for two classes (the 2-way softmax's class 1), else
    ``1 - p(background)`` with class 0 the background."""
    cls_logits = cls_logits.float()
    if cls_logits.shape[-1] == 2:
        return torch.sigmoid(cls_logits[..., 1] - cls_logits[..., 0])
    return 1.0 - torch.softmax(cls_logits, dim=-1)[..., 0]


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


def _select_candidates_flat(scores: torch.Tensor, score_threshold: float, top_k: int):
    """Top-k of (F, N) scores after thresholding (below it: -1), padded to
    ``top_k``: (scores (F, top_k), indices (F, k)) with k = min(top_k, N)."""
    scores = torch.where(scores >= score_threshold, scores, torch.full_like(scores, -1.0))
    vals, idx = _top_k_stable(scores, min(top_k, scores.shape[-1]))
    return _pad_to(vals, top_k, -1.0), idx


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (F, N, c), idx (F, k) -> (F, k, c)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


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
    Each step reads one bool of the device on the host (``sync/nms.suppress``).
    """
    with profiling.annotate("nms/suppress"):
        K = top_scores.shape[-1]
        ious = _iou_matrix(top_boxes, iou)
        valid = top_scores > -1.0
        ar = torch.arange(K, device=top_scores.device)
        conflict = (ious > iou_threshold) & (ar[:, None] < ar[None, :])  # [f, j, i]
        keep = valid
        for _ in range(K):
            new = valid & ~(keep[..., :, None] & conflict).any(dim=-2)
            changed = bool((new != keep).any())
            profiling.count("sync/nms.suppress")
            keep = new
            if not changed:
                break
        return keep


def rotated_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    score_threshold: float = 0.0,
    top_k: int = 256,
    iou: IouFn = rotated_iou_matrix,
):
    """Greedy rotated NMS of caller boxes, per frame.

    Args:
        boxes: (F, N, 5) rotated boxes (cx, cy, w, l, theta).
        scores: (F, N), strictly above -1 (the dead-slot sentinel).
        iou_threshold: suppress boxes with IoU > threshold against a kept box.
        score_threshold: boxes below it are dropped before the top-k.
        top_k: candidates per frame, and the size of the outputs.
        iou: as :func:`rotated_nms_decode`.

    Returns:
        boxes (F, top_k, 5), scores (F, top_k), keep (F, top_k) bool, as
        :func:`rotated_nms_decode`.
    """
    with profiling.annotate("nms/select"):
        top_scores, idx = _select_candidates_flat(scores, score_threshold, top_k)
        top_boxes = _pad_to(_gather_rows(boxes, idx), top_k, 0.0)
        top_boxes = _mask_invalid_boxes(top_boxes, top_scores)
    return top_boxes, top_scores, _suppress(top_boxes, top_scores, iou_threshold, iou)


def rotated_nms_decode(
    deltas: torch.Tensor,
    scores: torch.Tensor,
    anchors: torch.Tensor,
    iou_threshold: float,
    score_threshold: float = 0.0,
    top_k: int = 256,
    iou: IouFn = rotated_iou_matrix,
):
    """Rotated NMS over encoded predictions: top-k first, decode only winners.

    Three layouts, told apart by the ranks of ``scores`` and ``deltas``:

    * packed spatial: deltas (F, H, W, A*code), the head's channel layout,
      scores (F, H, W, A), anchors (H, W, A, 5); the per-anchor split
      happens on the winners only;
    * spatial: deltas (F, H, W, A, code), scores and anchors as above;
    * flat: deltas (F, N, code), scores (F, N), anchors (N, 5).

    The spatial layouts select by a two-level top-k (cells, then the winning
    cells' anchors) and threshold the winners; the flat one thresholds and
    takes one top-k. Scores lie strictly above -1 (the dead-slot sentinel).

    Args:
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
    with profiling.annotate("nms/select"):
        if scores.dim() == 2:
            top_scores, idx = _select_candidates_flat(scores, score_threshold, top_k)
            top_boxes = decode_boxes(_gather_rows(deltas, idx).float(), anchors[idx])
            top_boxes = _pad_to(top_boxes, top_k, 0.0)
        else:
            Fr, H, W, A = scores.shape
            top_scores, (h, w, a) = _select_candidates_spatial(scores, score_threshold, top_k)
            cell = h * W + w  # (F, top_k)
            code = deltas.shape[-1] // A if deltas.dim() == 4 else deltas.shape[-1]
            # the winners' cells, then their anchors: the (F, H, W, A, code) split
            # of the packed layout is never built
            rows = _gather_rows(deltas.reshape(Fr, H * W, A * code), cell).reshape(Fr, top_k, A, code)
            d = torch.gather(rows, 2, a[..., None, None].expand(Fr, top_k, 1, code))[:, :, 0]
            top_boxes = decode_boxes(d.float(), anchors.reshape(H * W * A, 5)[cell * A + a])
        top_boxes = _mask_invalid_boxes(top_boxes, top_scores)
    return top_boxes, top_scores, _suppress(top_boxes, top_scores, iou_threshold, iou)


def rotated_nms_decode_packed(
    raw: torch.Tensor,
    anchors: torch.Tensor,
    num_anchors: int,
    iou_threshold: float,
    score_threshold: float = 0.0,
    top_k: int = 256,
    iou: IouFn = rotated_iou_matrix,
):
    """Rotated NMS straight from the packed class-major head tensor
    (F, H, W, 2*NA + NA*code) (see :func:`packed_scores_and_deltas`).

    Sigmoid is monotonic, so candidates are chosen on the logit differences
    ``l1 - l0``: the top-k cells by their largest difference, then the top-k
    of the winning cells' differences; only the ``top_k`` winners are
    sigmoided and thresholded. The result is :func:`rotated_nms_decode`'s on
    ``packed_scores_and_deltas(raw)`` except where float32 sigmoid saturates
    (differences above ~17 give exactly 1.0): the score path breaks those
    ties by index, this path still orders them by logit, so the selected sets
    can differ among anchors scoring 1.0. Outputs as :func:`rotated_nms_decode`.
    """
    with profiling.annotate("nms/select"):
        Fr, H, W, C = raw.shape
        NA = num_anchors
        code = (C - 2 * NA) // NA
        r = raw.float()
        k = min(top_k, H * W)
        _, cells = _top_k_stable((r[..., NA:2 * NA] - r[..., :NA]).amax(-1).reshape(Fr, H * W), k)
        rows = _gather_rows(raw.reshape(Fr, H * W, C), cells)  # (F, k, C) winner rows
        diff = rows[..., NA:2 * NA].float() - rows[..., :NA].float()
        kk = min(top_k, k * NA)
        vals, pos = _top_k_stable(diff.reshape(Fr, k * NA), kk)
        sel = torch.div(pos, NA, rounding_mode="floor")
        a = pos % NA
        cell = torch.gather(cells, 1, sel)
        scores = torch.sigmoid(vals)
        scores = torch.where(scores >= score_threshold, scores, torch.full_like(scores, -1.0))
        d = _gather_rows(rows[..., 2 * NA:], sel).reshape(Fr, kk, NA, code)
        d = torch.gather(d, 2, a[..., None, None].expand(Fr, kk, 1, code))[:, :, 0]
        top_boxes = decode_boxes(d.float(), anchors.reshape(H * W * NA, 5)[cell * NA + a])
        top_boxes = _pad_to(top_boxes, top_k, 0.0)
        top_scores = _pad_to(scores, top_k, -1.0)
        top_boxes = _mask_invalid_boxes(top_boxes, top_scores)
    return top_boxes, top_scores, _suppress(top_boxes, top_scores, iou_threshold, iou)


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
    Fr = deltas.shape[0]
    C = cls_logits.shape[-1]
    probs = torch.softmax(cls_logits.float(), dim=-1)
    per_class = [
        rotated_nms_decode(deltas, probs[..., c], anchors, iou_threshold, score_threshold, top_k, iou)
        for c in range(1, C)
    ]
    boxes, scores, keep = (torch.stack(t, dim=1).reshape((Fr, (C - 1) * top_k) + t[0].shape[2:])
                           for t in zip(*per_class))
    labels = torch.arange(1, C, dtype=torch.int32, device=deltas.device)
    labels = labels[None, :, None].expand(Fr, C - 1, top_k).reshape(Fr, (C - 1) * top_k)
    return boxes, scores, keep, labels
