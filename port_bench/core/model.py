"""What a configuration file says of the model: the program's ``Config``
and the operation count of one forward."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from port_bench.reference.model import backbone_flops


def port_config(cfg: Dict):
    """The program's ``Config`` of a configuration file's ``config`` block."""
    from disconet_tpu_torch.config import Config

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    return Config(**{k: tup(v) for k, v in cfg.items()})


def fusion_geometry(cfg: Dict, layer: int):
    """(cells, channels) of the fusion layer's map."""
    H = int(np.ceil((cfg["area_extents"][0][1] - cfg["area_extents"][0][0]) / cfg["voxel_size"][0] - 1e-9))
    W = int(np.ceil((cfg["area_extents"][1][1] - cfg["area_extents"][1][0]) / cfg["voxel_size"][1] - 1e-9))
    return (H >> layer) * (W >> layer), cfg["backbone_channels"][layer]


def forward_flops(cell, mask: np.ndarray) -> float:
    """Operations of one forward of the cell's model on a batch with agent
    mask ``mask``, present frames and pairs only (the natural layout: the
    same count whatever layout or warp the program takes)."""
    cfg, layer = cell.config["config"], cell.config["layer"]
    cells, C = fusion_geometry(cfg, layer)
    present = torch.from_numpy(np.asarray(mask))
    return backbone_flops(cfg) * float(mask.sum()) + cell.fusion_reference().flops(cfg, cells, C, present)
