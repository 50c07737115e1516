"""Bit-packed BEV transport from the host to the device.

The binary occupancy grid is the bulk of a training batch (4 scenes x 6
agents x 256x256x13 voxels, twice with the teacher's grid), so the z-column
of 13 voxels ships as 2 packed bytes:

* :func:`pack_bev_np` on the host, ``np.packbits`` over the z axis;
* :func:`unpack_bev` on the device, shift and mask.

The round trip is exact for {0, 1} grids.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_bev_np(bev: np.ndarray) -> np.ndarray:
    """(..., Z) binary grid -> (..., ceil(Z/8)) uint8, np.packbits bit order."""
    return np.packbits(np.asarray(bev) != 0, axis=-1)


def packed_width(z: int) -> int:
    """Bytes of a packed z-column of ``z`` voxels."""
    return (z + 7) // 8


def unpack_bev(packed: torch.Tensor, z: int) -> torch.Tensor:
    """(..., ceil(Z/8)) uint8 -> (..., Z) float32 on ``packed``'s device.

    np.packbits packs big-endian within each byte (bit 0 of the input is the
    most significant bit of byte 0), so the shifts run 7..0.
    """
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    bits = bits.reshape(tuple(packed.shape[:-1]) + (packed.shape[-1] * 8,))
    return bits[..., :z].float()
