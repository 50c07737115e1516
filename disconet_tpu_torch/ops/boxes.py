"""Anchors and the rotated-box codec.

Boxes everywhere are (cx, cy, w, l, theta): metric BEV coordinates, theta in
radians. Corners run counter-clockwise from the (+w/2, +l/2) corner in the
box frame.
"""

from __future__ import annotations

import numpy as np
import torch

from disconet_tpu_torch.config import Config


def make_anchors(config: Config) -> np.ndarray:
    """(H, W, A, 5) anchor boxes [cx, cy, w, l, theta], float32."""
    centers = config.anchor_centers()  # (H, W, 2)
    H, W, _ = centers.shape
    A = config.num_anchors
    sizes = np.asarray(config.anchor_sizes, dtype=np.float32)  # (A, 3)
    anchors = np.zeros((H, W, A, 5), dtype=np.float32)
    anchors[..., 0:2] = centers[:, :, None, :]
    anchors[..., 2] = sizes[None, None, :, 0]
    anchors[..., 3] = sizes[None, None, :, 1]
    anchors[..., 4] = sizes[None, None, :, 2]
    return anchors


def encode_boxes(gt: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Gt boxes (..., 5) against anchors (..., 5) -> deltas (..., 6), float64
    on the host; the inverse of :func:`decode_boxes`.

    dx = (gx - ax) / d_a, dy = (gy - ay) / d_a with d_a = sqrt(aw^2 + al^2);
    dw = log(gw / aw), dl = log(gl / al); (sin, cos) of the gt heading.
    """
    gt = np.asarray(gt, np.float64)
    anchors = np.asarray(anchors, np.float64)
    da = np.sqrt(anchors[..., 2] ** 2 + anchors[..., 3] ** 2)
    return np.stack(
        [
            (gt[..., 0] - anchors[..., 0]) / da,
            (gt[..., 1] - anchors[..., 1]) / da,
            np.log(gt[..., 2] / anchors[..., 2]),
            np.log(gt[..., 3] / anchors[..., 3]),
            np.sin(gt[..., 4]),
            np.cos(gt[..., 4]),
        ],
        axis=-1,
    )


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Deltas (..., 6) against anchors (..., 5) -> boxes (..., 5).

    cx = dx * d_a + ax, cy = dy * d_a + ay with d_a = sqrt(aw^2 + al^2);
    w = exp(clip(dw, -10, 10)) * aw, l likewise; theta = atan2(sin, cos).
    """
    da = torch.sqrt(anchors[..., 2] ** 2 + anchors[..., 3] ** 2)
    cx = deltas[..., 0] * da + anchors[..., 0]
    cy = deltas[..., 1] * da + anchors[..., 1]
    w = torch.exp(torch.clamp(deltas[..., 2], -10.0, 10.0)) * anchors[..., 2]
    l = torch.exp(torch.clamp(deltas[..., 3], -10.0, 10.0)) * anchors[..., 3]
    theta = torch.atan2(deltas[..., 4], deltas[..., 5])
    return torch.stack([cx, cy, w, l, theta], dim=-1)


def box_corners_np(boxes: np.ndarray) -> np.ndarray:
    """Boxes (..., 5) -> corners (..., 4, 2), counter-clockwise, float64 on
    the host."""
    cx, cy, w, l, th = (np.asarray(boxes, np.float64)[..., i] for i in range(5))
    dx = np.stack([w / 2, -w / 2, -w / 2, w / 2], axis=-1)
    dy = np.stack([l / 2, l / 2, -l / 2, -l / 2], axis=-1)
    c, s = np.cos(th)[..., None], np.sin(th)[..., None]
    return np.stack([cx[..., None] + c * dx - s * dy, cy[..., None] + s * dx + c * dy], axis=-1)


def box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """Boxes (..., 5) -> corners (..., 4, 2), counter-clockwise."""
    cx, cy, w, l, th = boxes.unbind(-1)
    dx = torch.stack([w / 2, -w / 2, -w / 2, w / 2], dim=-1)
    dy = torch.stack([l / 2, l / 2, -l / 2, -l / 2], dim=-1)
    c, s = torch.cos(th)[..., None], torch.sin(th)[..., None]
    x = cx[..., None] + c * dx - s * dy
    y = cy[..., None] + s * dx + c * dy
    return torch.stack([x, y], dim=-1)
