"""Point cloud -> binary BEV occupancy voxelization.

* :func:`voxelize_occupy_plain` — plain PyTorch; the CPU path and the
  reference the CUDA kernel is held against.
* :func:`voxelize_occupy` — the wrapper: CUDA tensors go to the hand-written
  kernel (``csrc/voxelize.cu``), CPU tensors to the plain version.

Both drop masked, non-finite and out-of-extent rows, and index with float32
``floor((p - lo) / vs)`` on float32-rounded extents, bit for bit as the numpy
oracle of the JAX package does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def grid_dims(voxel_size, extents) -> Tuple[int, ...]:
    """The grid-shape rule: cell boundaries are the float32-rounded extents,
    the count division runs in float64 with a 1e-9 guard."""
    lo = np.array([e[0] for e in extents], dtype=np.float32)
    hi = np.array([e[1] for e in extents], dtype=np.float32)
    vs = np.asarray(voxel_size, dtype=np.float32)
    counts = (hi.astype(np.float64) - lo.astype(np.float64)) / vs.astype(np.float64)
    return tuple(int(d) for d in np.ceil(counts - 1e-9).astype(np.int64))


def _geometry(voxel_size, extents):
    lo = np.array([e[0] for e in extents], dtype=np.float32)
    hi = np.array([e[1] for e in extents], dtype=np.float32)
    vs = np.asarray(voxel_size, dtype=np.float32)
    return lo, hi, vs, grid_dims(voxel_size, extents)


def _check(points: torch.Tensor, mask: Optional[torch.Tensor]):
    if points.dtype != torch.float32:
        raise TypeError(f"points must be float32, got {points.dtype}")
    if points.dim() < 2 or points.shape[-1] != 3:
        raise ValueError(f"points must be (..., N, 3), got {tuple(points.shape)}")
    if mask is not None:
        if mask.dtype != torch.bool:
            raise TypeError(f"mask must be bool, got {mask.dtype}")
        if mask.shape != points.shape[:-1]:
            raise ValueError(f"mask {tuple(mask.shape)} does not match points {tuple(points.shape)}")
        if mask.device != points.device:
            raise ValueError("mask and points lie on different devices")


def voxelize_occupy_plain(
    points: torch.Tensor,
    voxel_size: Sequence[float],
    extents: Sequence[Tuple[float, float]],
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """points (..., N, 3) float32 [+ mask (..., N) bool] -> (..., H, W, Z) float32."""
    _check(points, mask)
    lo_np, hi_np, vs_np, dims = _geometry(voxel_size, extents)
    dev = points.device
    lo, hi, vs = (torch.from_numpy(a).to(dev) for a in (lo_np, hi_np, vs_np))
    dims_t = torch.tensor(dims, device=dev)
    batch_shape = points.shape[:-2]
    n = points.shape[-2]
    pts = points.reshape(-1, n, 3)
    nb = pts.shape[0]

    finite = torch.isfinite(pts).all(-1)
    safe = torch.where(finite[..., None], pts, lo - 1.0)
    idx = torch.floor((safe - lo) / vs).to(torch.int64)
    ok = finite & ((safe >= lo) & (safe < hi)).all(-1)
    ok &= ((idx >= 0) & (idx < dims_t)).all(-1)
    if mask is not None:
        ok &= mask.reshape(nb, n)
    frame = torch.arange(nb, device=dev)[:, None].expand(nb, n)
    H, W, Z = dims
    flat = ((frame * H + idx[..., 0]) * W + idx[..., 1]) * Z + idx[..., 2]
    grid = torch.zeros(nb * H * W * Z, dtype=torch.float32, device=dev)
    grid[flat[ok]] = 1.0
    return grid.reshape(batch_shape + (H, W, Z))


def voxelize_occupy(
    points: torch.Tensor,
    voxel_size: Sequence[float],
    extents: Sequence[Tuple[float, float]],
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Wrapper: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

    points (..., N, 3) float32 contiguous [+ mask (..., N) bool] ->
    (..., H, W, Z) float32 occupancy.
    """
    if points.device.type == "cpu":
        return voxelize_occupy_plain(points, voxel_size, extents, mask)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    _check(points, mask)
    if not points.is_contiguous() or (mask is not None and not mask.is_contiguous()):
        raise ValueError("points and mask must be contiguous")
    lo, hi, vs, dims = _geometry(voxel_size, extents)
    H, W, Z = dims
    if Z > 32:
        raise ValueError(f"the bit-packed kernel takes at most 32 z cells, got {Z}")
    from disconet_tpu_torch import _build

    lib = _build.load("voxelize")
    fn = lib.voxelize_occupy_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5

    batch_shape = points.shape[:-2]
    n = points.shape[-2]
    nb = int(np.prod(batch_shape))
    with torch.cuda.device(points.device):
        packed = torch.zeros((nb, H, W), dtype=torch.int32, device=points.device)
        out = torch.empty((nb, H, W, Z), dtype=torch.float32, device=points.device)
        f3 = ctypes.c_float * 3
        err = fn(
            points.data_ptr(),
            None if mask is None else mask.data_ptr(),
            packed.data_ptr(),
            out.data_ptr(),
            nb,
            n,
            f3(*lo),
            f3(*hi),
            f3(*vs),
            (ctypes.c_int * 3)(*dims),
            torch.cuda.current_stream(points.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"voxelize kernel launch failed with CUDA error {err}")
    voxelize_occupy.launches += 1
    return out.reshape(batch_shape + (H, W, Z))


voxelize_occupy.launches = 0
