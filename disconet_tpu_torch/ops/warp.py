"""Pose-aware feature warping: every sender's map into every receiver's frame.

Convention: feature grids are (H, W, C) with axis 0 = metric x and axis 1 =
metric y, as the voxelizer lays them out. ``trans[i, j]`` maps homogeneous
sender-j coordinates into receiver i's frame: p_i = T_ij @ p_j. Sampling is
bilinear with zero padding at cell centres; this module holds the only copy of
that half-pixel convention (so it does not call ``F.grid_sample``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def pose_to_affine(trans: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) poses -> (..., 2, 3) [R' | t'] with m_sender = R' m_receiver + t'.

    Inverts the xy block with the general 2x2 inverse.
    """
    R = trans[..., 0:2, 0:2]
    t = trans[..., 0:2, 3]
    det = R[..., 0, 0] * R[..., 1, 1] - R[..., 0, 1] * R[..., 1, 0]
    det = torch.where(det.abs() < 1e-12, torch.ones_like(det), det)
    inv = torch.stack(
        [
            torch.stack([R[..., 1, 1], -R[..., 0, 1]], dim=-1),
            torch.stack([-R[..., 1, 0], R[..., 0, 0]], dim=-1),
        ],
        dim=-2,
    ) / det[..., None, None]
    t_inv = -torch.stack(
        [
            inv[..., 0, 0] * t[..., 0] + inv[..., 0, 1] * t[..., 1],
            inv[..., 1, 0] * t[..., 0] + inv[..., 1, 1] * t[..., 1],
        ],
        dim=-1,
    )
    return torch.cat([inv, t_inv[..., None]], dim=-1)


def _sample_coords(trans: torch.Tensor, extent_xy, H: int, W: int, rows: Optional[Tuple[int, int]] = None):
    """(..., 4, 4) poses -> sender pixel coords px, py of shape (..., Hr, W)
    for every receiver pixel of the rows ``rows`` = (first, end) of the H
    axis (all H rows by default)."""
    (x_lo, x_hi), (y_lo, y_hi) = extent_xy
    cell_x = (x_hi - x_lo) / H
    cell_y = (y_hi - y_lo) / W
    dev = trans.device
    r0, r1 = rows if rows is not None else (0, H)
    mx = x_lo + (torch.arange(r0, r1, device=dev, dtype=torch.float32) + 0.5) * cell_x
    my = y_lo + (torch.arange(W, device=dev, dtype=torch.float32) + 0.5) * cell_y
    gx, gy = torch.meshgrid(mx, my, indexing="ij")  # (Hr, W)
    aff = pose_to_affine(trans.float())[..., None, None]  # (..., 2, 3, 1, 1)
    sx = aff[..., 0, 0, :, :] * gx + aff[..., 0, 1, :, :] * gy + aff[..., 0, 2, :, :]
    sy = aff[..., 1, 0, :, :] * gx + aff[..., 1, 1, :, :] * gy + aff[..., 1, 2, :, :]
    px = (sx - x_lo) / cell_x - 0.5
    py = (sy - y_lo) / cell_y - 0.5
    return px, py


def warp_features(
    feats: torch.Tensor, trans: torch.Tensor, extent_xy: Tuple[Tuple[float, float], ...],
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Warp every sender's features into every receiver's frame (gather form).

    Args:
        feats: (..., As, H, W, C) the senders' maps; leading dims are a batch.
        trans: (..., Ar, As, 4, 4); trans[..., i, j] maps sender j into
            receiver i (Ar = As for all pairs; fewer receivers for a rank of
            an agent-sharded mesh).
        extent_xy: ((x_lo, x_hi), (y_lo, y_hi)) metric extent of the map.
        rows: (first, end) receiver rows of the H axis to compute (a strip of
            an H-sharded mesh); all H rows by default.

    Returns:
        (..., Ar, As, Hr, W, C), zeros outside each sender's field of view,
        in ``feats``' dtype; the four taps accumulate in float32.
    """
    *lead, A, H, W, C = feats.shape
    Ar = trans.shape[-4]
    nb = 1
    for d in lead:
        nb *= d
    px, py = _sample_coords(trans.reshape(nb, Ar, A, 4, 4), extent_xy, H, W, rows)  # (nb, Ar, A, Hr, W)
    flat = feats.reshape(nb * A * H * W, C)
    # row of sender (b, j) in the flattened feature table
    base = (
        torch.arange(nb, device=feats.device)[:, None, None] * A
        + torch.arange(A, device=feats.device)[None, None, :]
    ) * (H * W)  # (nb, 1, A)
    base = base[..., None, None]
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx1 = px - x0
    wy1 = py - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)

    def tap(xi, yi, w):
        inb = (xi >= 0) & (xi < H) & (yi >= 0) & (yi < W)
        xc = xi.clamp(0, H - 1)
        yc = yi.clamp(0, W - 1)
        rows = (base + xc * W + yc).reshape(-1)
        vals = flat.index_select(0, rows).reshape(px.shape + (C,))
        return vals * (w * inb.to(w.dtype))[..., None]

    out = tap(x0i, y0i, wx0 * wy0)
    out += tap(x0i + 1, y0i, wx1 * wy0)
    out += tap(x0i, y0i + 1, wx0 * wy1)
    out += tap(x0i + 1, y0i + 1, wx1 * wy1)
    return out.to(feats.dtype).reshape(tuple(lead) + (Ar, A) + tuple(px.shape[-2:]) + (C,))
