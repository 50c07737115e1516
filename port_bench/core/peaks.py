"""The yardstick's peaks and the kernels' operation and byte counts.

Frozen copies, so that a change to the program cannot move what it is
measured against:

* the peaks and the rotated-IoU operation counts from ``chip_smoke.py``
  lines 200-216 (``HBM_BYTES_PER_S``, ``FP32_OPS_PER_S``,
  ``IOU_OPS_PER_*``), with the data sheet's bf16 dense rate beside them;
* ``iou_reach`` and ``skipped_pairs`` from ``chip_smoke.py`` lines 220-238;
* the voxelizer's and the IoU's byte counts from ``chip_smoke.py`` lines
  559-565.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit; a card
set below it runs slower, so every result prints the card's power limit
beside these shares.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_DENSE_FLOPS_PER_S = 989e12

# fp32 operations of csrc/rotated_iou.cu, counted by hand (each add, mul,
# div, sqrt, abs, min/max, compare and negation as one). Every pair: 2 for
# the area tests, 8 for the separation test. A pair that is clipped (not
# skipped_pairs): for each of the 16 (edge of A, edge of B), 7 shared by both
# passes, 15 for the A-in-B pass and 13 for the B-in-A pass; 15 per edge for
# its piece's shoelace term, 8 edges; 8 for the union and the quotient.
# Every box: 36 for the corners, 8 per edge, 1 for the area, 12 for the reach.
IOU_OPS_PER_PAIR = 2 + 8
IOU_OPS_PER_CLIPPED_PAIR = 16 * (7 + 15 + 13) + 8 * 15 + 8
IOU_OPS_PER_BOX = 36 + 4 * 8 + 1 + 12


def iou_reach(boxes: torch.Tensor):
    """(..., 5) boxes -> (cx, cy, reach), as the IoU kernel computes them in
    float32: the circumscribed radius plus a slack of
    1e-3 * (1 + |cx| + |cy| + radius)."""
    cx, cy, w, l = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    r = 0.5 * (w * w + l * l).sqrt()
    return cx, cy, r + 1e-3 * (1.0 + cx.abs() + cy.abs() + r)


def skipped_pairs(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(B, N, 5) x (B, M, 5) -> (B, N, M) bool: the pairs the IoU kernel
    writes 0 to without clipping (a box without area, or reaches that do not
    meet)."""
    ax, ay, ar = (v[:, :, None] for v in iou_reach(boxes_a))
    bx, by, br = (v[:, None, :] for v in iou_reach(boxes_b))
    dx, dy, r = ax - bx, ay - by, ar + br
    live = (boxes_a[..., 2] * boxes_a[..., 3] > 0)[:, :, None] & (boxes_b[..., 2] * boxes_b[..., 3] > 0)[:, None, :]
    return ~live | (dx * dx + dy * dy > r * r)


def voxelize_bound_s(n_points: int, frames: int, grid_cells: int) -> float:
    """The least time of one voxelize call: read every point (3 float32),
    write every frame's float32 grid once."""
    return (n_points * 3 * 4 + frames * grid_cells * 4) / HBM_BYTES_PER_S


def rotated_iou_bound_s(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> float:
    """The least time of one IoU call on these boxes: the larger of its
    bytes (both inputs read, the matrix written) over the HBM rate and its
    fp32 operations (the pairs whose reaches meet are clipped) over the fp32
    rate."""
    frames, n, _ = boxes_a.shape
    m = boxes_b.shape[1]
    nbytes = (boxes_a.numel() + boxes_b.numel()) * 4 + frames * n * m * 4
    clipped = int((~skipped_pairs(boxes_a, boxes_b)).sum())
    ops = frames * (n * m * IOU_OPS_PER_PAIR + (n + m) * IOU_OPS_PER_BOX) + clipped * IOU_OPS_PER_CLIPPED_PAIR
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
