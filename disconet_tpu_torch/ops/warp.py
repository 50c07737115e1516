"""Pose-aware feature warping: every sender's map into every receiver's frame.

Convention: feature grids are (H, W, C) with axis 0 = metric x and axis 1 =
metric y, as the voxelizer lays them out. ``trans[i, j]`` maps homogeneous
sender-j coordinates into receiver i's frame: p_i = T_ij @ p_j. Sampling is
bilinear with zero padding at cell centres; this module holds the only copy of
that half-pixel convention (so it does not call ``F.grid_sample``).
:func:`affine_grid` and :func:`grid_sample` are the JAX package's
torch-convention primitives (normalized coordinates), kept as the public
API; they are ``F.affine_grid`` and ``F.grid_sample`` (bilinear, zero
padding), which the JAX package wrote them to equal.

Two forms compute the warp, as in the JAX package: :func:`warp_features`
gathers the four taps of each receiver cell, :func:`warp_features_matmul`
multiplies by the dense (receiver cells x sender cells) tap matrix. The JAX
package takes the product at fusion grids of up to 1024 cells
(``models/base.py::warp_all_pairs``). Both backwards repeat bit for bit on
the card: the product's is a product, and the gather's adds every tap's
cotangent into the sampled map by a sort of the tap rows (:class:`_GatherTaps`),
in an order that the indices fix, not the threads' timing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from disconet_tpu_torch.device import exact_products


def affine_grid(theta: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """(N, 2, 3) affine matrices over normalized coordinates and a
    torch-style (N, C, H, W) ``size`` -> the (N, H, W, 2) sampling grid, last
    axis (x, y) in [-1, 1]."""
    return F.affine_grid(theta, list(size), align_corners=align_corners)


def grid_sample(input_nchw: torch.Tensor, grid: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """Bilinear sample of (N, C, H, W) at the (N, Ho, Wo, 2) normalized
    (x, y) ``grid`` (x indexes W), zeros outside -> (N, C, Ho, Wo)."""
    return F.grid_sample(input_nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=align_corners)


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


class _GatherTaps(torch.autograd.Function):
    """The four bilinear taps of every receiver cell: table (T, C), rows,
    spread and weights (4, R) -> (R, C), sum_k table[rows[k]] * weights[k]
    added in tap order, in float32 (or float64) whatever the table's dtype.

    The backward adds each tap's cotangent ``g * weights[k]`` into a (T, C)
    table with one ``index_put_(accumulate=True)``, which on the card sorts
    the rows (a stable radix sort) and adds each row's contributions in that
    order: two runs add in one order, so they repeat bit for bit, where
    ``index_select``'s backward (``index_add``) adds with atomics. A tap
    outside the sender's map reads a clamped edge row with weight 0; its
    zero cotangent goes to ``spread`` instead, the tap's cell wrapped into
    the map, so that no edge row collects thousands of them (the sort adds
    a row's contributions one after another). The poses get no gradient:
    they are data."""

    @staticmethod
    def forward(ctx, table, rows, spread, weights):
        if weights.requires_grad:
            raise ValueError("the gathered warp gives no gradient to the poses")
        out = table.index_select(0, rows[0]) * weights[0, :, None]
        for k in range(1, 4):
            out += table.index_select(0, rows[k]) * weights[k, :, None]
        ctx.save_for_backward(spread, weights)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        spread, weights = ctx.saved_tensors
        C = g.shape[-1]
        grad = g.new_zeros(ctx.table_shape)
        grad.index_put_((spread.reshape(-1),), (g[None] * weights[..., None]).reshape(-1, C), accumulate=True)
        return grad.to(ctx.table_dtype), None, None, None


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
    cells, spread, weights = [], [], []
    for xi, yi, w in ((x0i, y0i, wx0 * wy0), (x0i + 1, y0i, wx1 * wy0),
                      (x0i, y0i + 1, wx0 * wy1), (x0i + 1, y0i + 1, wx1 * wy1)):
        inb = (xi >= 0) & (xi < H) & (yi >= 0) & (yi < W)
        cells.append((base + xi.clamp(0, H - 1) * W + yi.clamp(0, W - 1)).reshape(-1))
        spread.append((base + (xi % H) * W + (yi % W)).reshape(-1))
        weights.append((w * inb.to(w.dtype)).reshape(-1))
    out = _GatherTaps.apply(flat, torch.stack(cells), torch.stack(spread), torch.stack(weights))
    return out.to(feats.dtype).reshape(tuple(lead) + (Ar, A) + tuple(px.shape[-2:]) + (C,))


def warp_features_matmul(
    feats: torch.Tensor, trans: torch.Tensor, extent_xy: Tuple[Tuple[float, float], ...],
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """:func:`warp_features` as a product with the dense tap matrix, the JAX
    package's ``warp_features_matmul``: same arguments and output.

    For every (scene, receiver, sender) the (Hr*W, H*W) matrix holds each
    receiver cell's four bilinear weights at its taps' sender cells, built in
    float32; a tap outside the sender's map has weight 0. The product
    accumulates in float32. With bf16 ``feats`` the matrix is rounded to
    bf16 and the output too (the JAX package's TPU arithmetic: bf16 products,
    an fp32 accumulator); float32 ``feats`` give float32 products on the card
    as on the CPU (no TF32).
    """
    *lead, A, H, W, C = feats.shape
    Ar = trans.shape[-4]
    nb = 1
    for d in lead:
        nb *= d
    px, py = _sample_coords(trans.reshape(nb, Ar, A, 4, 4), extent_xy, H, W, rows)  # (nb, Ar, A, Hr, W)
    Hr = px.shape[-2]
    # one product per (scene, sender): the senders' axis ahead of the receivers'
    px = px.transpose(1, 2).reshape(nb, A, Ar * Hr * W)
    py = py.transpose(1, 2).reshape(nb, A, Ar * Hr * W)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx1 = px - x0
    wy1 = py - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    cells, weights = [], []
    for xi, yi, w in ((x0i, y0i, (1 - wx1) * (1 - wy1)), (x0i + 1, y0i, wx1 * (1 - wy1)),
                      (x0i, y0i + 1, (1 - wx1) * wy1), (x0i + 1, y0i + 1, wx1 * wy1)):
        inb = (xi >= 0) & (xi < H) & (yi >= 0) & (yi < W)
        cells.append(xi.clamp(0, H - 1) * W + yi.clamp(0, W - 1))
        weights.append(w * inb.to(w.dtype))
    # each in-map tap lands on a cell of its own; an outside tap adds 0
    # where it is clamped, so the sum is the tap's weight in any order
    dt = torch.float64 if feats.dtype == torch.float64 else torch.float32
    taps = torch.zeros(nb, A, Ar * Hr * W, H * W, device=feats.device, dtype=dt)
    taps.scatter_add_(-1, torch.stack(cells, dim=-1), torch.stack(weights, dim=-1).to(dt))
    values = feats.reshape(nb * A, H * W, C)
    taps = taps.reshape(nb * A, Ar * Hr * W, H * W)
    with exact_products(feats):
        if feats.dtype == torch.bfloat16:
            taps = taps.to(torch.bfloat16)
            if feats.device.type == "cuda":
                out = torch.bmm(taps, values)
            else:  # the CPU's bf16 products through fp32 (exact), rounded once
                out = torch.bmm(taps.float(), values.float()).to(torch.bfloat16)
        else:
            out = torch.bmm(taps, values.to(dt)).to(feats.dtype)
    out = out.reshape(nb, A, Ar, Hr, W, C).transpose(1, 2).contiguous()
    return out.reshape(tuple(lead) + (Ar, A, Hr, W, C))
