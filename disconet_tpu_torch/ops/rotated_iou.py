"""Batched rotated-box BEV IoU, (B, N, 5) x (B, M, 5) -> (B, N, M) float32.

* :func:`rotated_iou_matrix_plain` — plain PyTorch, the same arithmetic as the
  JAX package's Pallas kernel (``rotated_iou_pallas.py``): Liang-Barsky
  boundary pieces of each quad inside the other, a fixed boundary tolerance
  ``1e-4*|n|`` that is +tol for the A-in-B pass and -tol for the B-in-A pass
  (coincident edges count once), the scale-aware parallel test
  ``|den| < 1e-5*|n|*|d| + 1e-9``, and IoU 0 where ``union <= 1e-8``. Boxes
  need w, l >= 0; corners are taken counter-clockwise as built.
* :func:`rotated_iou_matrix` — the wrapper: CUDA tensors go to the
  hand-written kernel (``csrc/rotated_iou.cu``), CPU tensors to the plain
  version.
* :func:`rotated_iou_pairs` — (P, 5) x (P, 5) -> (P,), the IoU of each pair
  of rows by the plain version's arithmetic, on the boxes' device (the JAX
  package computes its paired IoU in jnp, not in Pallas).
* :func:`rotated_iou_pairs_np` and :func:`rotated_iou_matrix_np` — host numpy
  in float64, the JAX package's copies for target assignment, the mAP and
  late fusion: the polygon of edge crossings and corners inside the other
  box, sorted by angle. Not the kernel's arithmetic.

One deliberate difference from the Pallas kernel: a box of zero area (the
NMS's padding rows, w = l = 0) gives IoU 0 against every box. The Pallas
kernel returns values of order 1e6 there, because the zero box's degenerate
half-planes admit all of the other box and the union is a rounding residue.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from disconet_tpu_torch.ops.boxes import box_corners_np

_TOL = 1e-4
_EPS = 1e-9


def _corners(cx, cy, w, l, th):
    c, s = torch.cos(th), torch.sin(th)
    hw, hl = 0.5 * w, 0.5 * l
    offs = ((hw, hl), (-hw, hl), (-hw, -hl), (hw, -hl))  # CCW from (+w/2, +l/2)
    return [(cx + c * dx - s * dy, cy + s * dx + c * dy) for dx, dy in offs]


def _pieces_area(P, C, tol):
    """Sum of the shoelace terms of P's edge pieces that lie inside quad C."""
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
            nx, ny = -(c2y - c1y), (c2x - c1x)  # inward normal (CCW)
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


def _check(boxes_a: torch.Tensor, boxes_b: torch.Tensor):
    for name, t in (("boxes_a", boxes_a), ("boxes_b", boxes_b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3 or t.shape[-1] != 5:
            raise ValueError(f"{name} must be (B, N, 5), got {tuple(t.shape)}")
    if boxes_a.shape[0] != boxes_b.shape[0]:
        raise ValueError(f"batch sizes differ: {boxes_a.shape[0]} vs {boxes_b.shape[0]}")
    if boxes_a.device != boxes_b.device:
        raise ValueError("boxes_a and boxes_b lie on different devices")


def _iou(a, b):
    """IoU of the boxes whose fields ``a`` and ``b`` (cx, cy, w, l, theta)
    broadcast against each other."""
    ca, cb = _corners(*a), _corners(*b)
    inter = _pieces_area(ca, cb, _TOL) + _pieces_area(cb, ca, -_TOL)
    inter = torch.clamp(inter, min=0.0)
    area_a, area_b = a[2] * a[3], b[2] * b[3]
    union = area_a + area_b - inter
    ok = (area_a > 0) & (area_b > 0) & (union > 1e-8)
    return torch.where(ok, inter / union, torch.zeros_like(inter))


def rotated_iou_matrix_plain(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(B, N, 5) x (B, M, 5) -> (B, N, M) float32 rotated IoU, plain PyTorch."""
    _check(boxes_a, boxes_b)
    return _iou([t[:, :, None] for t in boxes_a.unbind(-1)], [t[:, None, :] for t in boxes_b.unbind(-1)])


def rotated_iou_pairs(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(P, 5) x (P, 5) -> (P,) float32 rotated IoU of row i of ``boxes_a``
    with row i of ``boxes_b``: :func:`rotated_iou_matrix_plain`'s
    arithmetic on the pairs, on the boxes' device."""
    if boxes_a.dim() != 2 or boxes_a.shape != boxes_b.shape:
        raise ValueError(f"paired boxes must be two (P, 5) tensors, got {tuple(boxes_a.shape)} and "
                         f"{tuple(boxes_b.shape)}")
    _check(boxes_a[None], boxes_b[None])
    return _iou(boxes_a.unbind(-1), boxes_b.unbind(-1))


@functools.cache
def _launcher():
    """The kernel's C entry point, resolved and typed once per process."""
    from disconet_tpu_torch import _build

    fn = _build.load("rotated_iou").rotated_iou_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fn


def rotated_iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Wrapper: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

    (B, N, 5) x (B, M, 5) float32 contiguous -> (B, N, M) float32.
    """
    if boxes_a.device.type == "cpu" and boxes_b.device.type == "cpu":
        return rotated_iou_matrix_plain(boxes_a, boxes_b)
    _check(boxes_a, boxes_b)
    if boxes_a.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes_a.device}")
    if not (boxes_a.is_contiguous() and boxes_b.is_contiguous()):
        raise ValueError("boxes must be contiguous")
    B, N, _ = boxes_a.shape
    M = boxes_b.shape[1]
    if B > 65535:
        raise ValueError(f"at most 65535 frames per launch, got {B}")
    with torch.cuda.device(boxes_a.device):
        out = torch.empty((B, N, M), dtype=torch.float32, device=boxes_a.device)
        err = _launcher()(
            boxes_a.data_ptr(),
            boxes_b.data_ptr(),
            out.data_ptr(),
            B,
            N,
            M,
            torch.cuda.current_stream(boxes_a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rotated IoU kernel launch failed with CUDA error {err}")
    rotated_iou_matrix.launches += 1
    return out


rotated_iou_matrix.launches = 0


_EPS_NP = 1e-8


def _intersection_area_np(ca: np.ndarray, cb: np.ndarray) -> np.ndarray:
    """Intersection area of paired convex quads (..., 4, 2): the polygon of
    edge crossings and corners inside the other quad, sorted by angle."""

    def force_ccw(c):
        x, y = c[..., 0], c[..., 1]
        signed = np.sum(x * np.roll(y, -1, axis=-1) - y * np.roll(x, -1, axis=-1), axis=-1)
        return np.where(signed[..., None, None] >= 0, c, c[..., ::-1, :])

    ca = force_ccw(np.asarray(ca, np.float64))
    cb = force_ccw(np.asarray(cb, np.float64))
    p = ca[..., :, None, :]
    r = (np.roll(ca, -1, axis=-2) - ca)[..., :, None, :]
    q = cb[..., None, :, :]
    s = (np.roll(cb, -1, axis=-2) - cb)[..., None, :, :]
    rxs = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qmp = q - p
    t_num = qmp[..., 0] * s[..., 1] - qmp[..., 1] * s[..., 0]
    u_num = qmp[..., 0] * r[..., 1] - qmp[..., 1] * r[..., 0]
    denom = np.where(np.abs(rxs) < _EPS_NP, 1.0, rxs)
    t, u = t_num / denom, u_num / denom
    crossing = (np.abs(rxs) >= _EPS_NP) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    cross_pts = p + t[..., None] * r  # (..., 4, 4, 2)

    def inside(points, corners):  # within a scale-aware tolerance of every edge
        e1 = corners
        d = np.roll(corners, -1, axis=-2) - e1
        v = points[..., :, None, :] - e1[..., None, :, :]
        cross = d[..., None, :, 0] * v[..., 1] - d[..., None, :, 1] * v[..., 0]
        elen = np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)[..., None, :]
        return np.all(cross >= -1e-4 * (elen + _EPS_NP), axis=-1)

    batch = ca.shape[:-2]
    pts = np.concatenate([cross_pts.reshape(batch + (16, 2)), ca, cb], axis=-2)
    valid = np.concatenate([crossing.reshape(batch + (16,)), inside(ca, cb), inside(cb, ca)], axis=-1)
    n_valid = valid.sum(axis=-1)
    centroid = np.where(valid[..., None], pts, 0.0).sum(axis=-2) / np.maximum(n_valid, 1)[..., None]
    ang = np.arctan2(pts[..., 1] - centroid[..., None, 1], pts[..., 0] - centroid[..., None, 0])
    order = np.argsort(np.where(valid, ang, np.inf), axis=-1)
    pts = np.take_along_axis(pts, order[..., None], axis=-2)
    valid = np.take_along_axis(valid, order, axis=-1)
    closed = np.where(valid[..., None], pts, pts[..., :1, :])
    nxt = np.roll(closed, -1, axis=-2)
    area = 0.5 * np.abs(np.sum(closed[..., 0] * nxt[..., 1] - closed[..., 1] * nxt[..., 0], axis=-1))
    return np.where(n_valid >= 3, area, 0.0)


def rotated_iou_pairs_np(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Rotated IoU of paired boxes (P, 5) x (P, 5) -> (P,), float64."""
    boxes_a = np.asarray(boxes_a, np.float64).reshape(-1, 5)
    boxes_b = np.asarray(boxes_b, np.float64).reshape(-1, 5)
    inter = _intersection_area_np(box_corners_np(boxes_a), box_corners_np(boxes_b))
    union = boxes_a[:, 2] * boxes_a[:, 3] + boxes_b[:, 2] * boxes_b[:, 3] - inter
    return np.where(union > _EPS_NP, inter / union, 0.0)


def rotated_iou_matrix_np(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, 5) x (M, 5) -> (N, M) rotated IoU, float64."""
    boxes_a = np.atleast_2d(np.asarray(boxes_a, np.float64))
    boxes_b = np.atleast_2d(np.asarray(boxes_b, np.float64))
    N, M = len(boxes_a), len(boxes_b)
    ca = np.broadcast_to(box_corners_np(boxes_a)[:, None], (N, M, 4, 2))
    cb = np.broadcast_to(box_corners_np(boxes_b)[None, :], (N, M, 4, 2))
    inter = _intersection_area_np(ca, cb)
    union = (boxes_a[:, 2] * boxes_a[:, 3])[:, None] + (boxes_b[:, 2] * boxes_b[:, 3])[None] - inter
    return np.where(union > _EPS_NP, inter / union, 0.0)
