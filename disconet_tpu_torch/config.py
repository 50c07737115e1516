"""Configuration of the PyTorch port: the reference geometry and model widths.

The port's own copy of the JAX package's ``Config`` (the port imports nothing
of that package). It keeps the fields the inference and training paths read
plus the derived geometry. ``block_out`` and ``block_out_dec1`` are the JAX
package's layout of the decoder's narrow convs (``ops/blockspace.py``): they
change no parameter, but in bf16 they change the arithmetic (summed kernel
taps round once), so the port runs them as the JAX package does, on by
default. ``block_space`` (off, as in the JAX package) runs encoder stage 0
and decoder stage 0 on the space-to-depth map instead; it changes no
parameter either. ``ConfigGlobal`` is the teacher's configuration, the JAX
package's name for the same geometry.

Geometry: voxel 0.25x0.25x0.4 m over x,y in [-32, 32] m and z in [-3, 2] m, a
256x256x13 binary BEV occupancy grid; 6 rotated anchors per cell with a
(dx, dy, dw, dl, sin, cos) box code; binary (background/vehicle) classes;
8 BEV segmentation classes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Config:
    """Detection configuration (numeric defaults of the reference Config)."""

    # dataset split the data tools label their output with
    split: str = "train"

    voxel_size: Tuple[float, float, float] = (0.25, 0.25, 0.4)
    area_extents: Tuple[Tuple[float, float], ...] = ((-32.0, 32.0), (-32.0, 32.0), (-3.0, 2.0))

    # 5 vehicles + optionally 1 RSU.
    max_agents: int = 6

    # 6 rotated anchors per BEV cell, (w, l, theta).
    anchor_sizes: Tuple[Tuple[float, float, float], ...] = (
        (2.0, 4.0, 0.0),
        (2.0, 4.0, math.pi / 2.0),
        (1.0, 1.0, 0.0),
        (1.0, 2.0, 0.0),
        (1.0, 2.0, math.pi / 2.0),
        (0.8, 0.8, 0.0),
    )

    # (dx, dy, dw, dl, sin, cos)
    box_code_size: int = 6
    num_classes: int = 2

    # Target assignment: an anchor is positive at IoU >= pos_iou_threshold
    # with its best gt (and each gt's best anchor is forced positive).
    pos_iou_threshold: float = 0.4

    # Positive anchors per agent-frame in the sparse target encoding.
    max_pos_anchors: int = 2048

    score_threshold: float = 0.3
    nms_iou_threshold: float = 0.01
    nms_top_k: int = 256

    backbone_channels: Tuple[int, ...] = (32, 64, 128, 256, 512)
    head_channels: int = 128

    # Fusion stage index (``--layer``); 3 fuses 32x32x256 maps at the 256 grid.
    fusion_layer: int = 3

    # Loss weights: cls + reg (focal, smooth-L1) + kd_weight * KD feature MSE.
    cls_weight: float = 1.0
    reg_weight: float = 2.0
    kd_weight: float = 100000.0
    focal_gamma: float = 2.0
    smooth_l1_sigma: float = 3.0

    # Train on the fp32 packed head tensor (ops/losses.py packed_det_losses)
    # when sparse targets are given; False takes the (B, A, H, W, NA, .)
    # cls/reg views, the oracle path.
    packed_loss: bool = True

    # Rematerialize in the training backward: the train steps run each
    # encoder stage, the warp and fuse, each decoder stage and the head conv
    # under torch.utils.checkpoint, so only the stage outputs are kept for
    # the backward (models/backbone.py ``stage``), the boundaries the JAX
    # package tags "stage_boundary". The same arithmetic runs twice; the
    # BatchNorm running statistics update once.
    train_remat: bool = False

    # "bfloat16": conv inputs and weights in bf16, accumulation and BatchNorm
    # in fp32. "float32": the exact mode the parity tests run.
    compute_dtype: str = "bfloat16"

    # Decoder stage 0 in the block-out layout (ops/blockspace.py): its convs
    # emit 2x2 output blocks as channels, the first one an up-conv of the
    # half-resolution map whose kernel sums the taps that read one source
    # pixel, in fp32 before the bf16 rounding. The JAX package's default;
    # False runs the natural conv of the upsampled concat. The parameters
    # are the same either way.
    block_out: bool = True

    # The same for decoder stage 1 (needs block_out); off, as in the JAX
    # package.
    block_out_dec1: bool = False

    # Encoder stage 0 and decoder stage 0 in 2x2 block space
    # (ops/blockspace.py): the input is space-to-depth'ed once, stage 0's
    # convs run on (4*C)-channel blocks, stage 1's stride-2 conv reads the
    # blocks and writes the natural map, and decoder stage 0's output goes
    # back by one depth-to-space. The same parameters as the natural layout;
    # in bf16 the same values (every block-kernel entry is one tap). It
    # rewrites the convs that block_out does, so it turns block_out and
    # block_out_dec1 off; fusion at layer 0 keeps the natural layout (the
    # fused map must be addressable by space). Off, as in the JAX package.
    block_space: bool = False

    # Storage dtype of the packed (B*A, H, W, 48) head tensor that the NMS
    # reads. The fp32 cls/reg views are always sliced from the fp32 result.
    head_raw_dtype: str = "bfloat16"

    # Storage dtype of the head conv's output, the head input: "bfloat16"
    # rounds it once; the bf16 detection heads round their input anyway, so
    # their outputs are bit-identical, while the KD taps and the SegHead
    # read the rounded map. "float32" (the JAX package's default) keeps it.
    head_in_dtype: str = "float32"

    # Inference dtype of DiscoNet's fusion-layer map, which the all-pairs
    # warp samples: "bfloat16" stores it in bf16 under ``store_bf16`` (the
    # predict paths), "float32" keeps it fp32. Training is fp32 either way.
    warp_dtype: str = "bfloat16"

    # Binary-class NMS of the predict paths straight from the packed head
    # tensor, choosing candidates on logit differences
    # (ops/nms.py rotated_nms_decode_packed); False scores every anchor first.
    packed_nms: bool = False

    # Segmentation: BEV semantic classes, the backbone of the seg models
    # ("unet": the reference seg zoo's UNet topology, models/unet.py;
    # "stpn": the detection pyramid with a 1x1 SegHead) and the UNet widths.
    # Detection models ignore all three.
    num_seg_classes: int = 8
    seg_backbone: str = "unet"
    unet_channels: Tuple[int, ...] = (64, 128, 256, 512, 512)

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        """BEV grid cells per axis: ceil(extent / voxel)."""
        dims = []
        for (lo, hi), v in zip(self.area_extents, self.voxel_size):
            dims.append(int(math.ceil((hi - lo) / v - 1e-9)))
        return tuple(dims)

    @property
    def bev_shape(self) -> Tuple[int, int, int]:
        """(H, W, Z) occupancy shape, Z as channels."""
        return self.grid_size

    @property
    def map_dims(self) -> Tuple[int, int]:
        """(H, W) of the BEV map."""
        return self.grid_size[:2]

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_sizes)

    @property
    def fusion_channels(self) -> int:
        return self.backbone_channels[min(self.fusion_layer, len(self.backbone_channels) - 1)]

    def anchor_centers(self) -> np.ndarray:
        """(H, W, 2) metric xy centers of each BEV cell."""
        (x_lo, _), (y_lo, _), _ = self.area_extents
        vx, vy, _ = self.voxel_size
        gx, gy, _ = self.grid_size
        xs = x_lo + (np.arange(gx, dtype=np.float32) + 0.5) * vx
        ys = y_lo + (np.arange(gy, dtype=np.float32) + 0.5) * vy
        cx, cy = np.meshgrid(xs, ys, indexing="ij")
        return np.stack([cx, cy], axis=-1)


@dataclasses.dataclass(frozen=True)
class ConfigGlobal(Config):
    """The teacher's configuration (the reference's ConfigGlobal): the
    holistic view is voxelized into the same grid, so only the name
    differs."""

    split: str = "train"


# Footprints of the synthetic data's vehicle classes, class id (1-based) ->
# ((w_lo, w_hi), (l_lo, l_hi)) in metres: car (the binary task's only class),
# truck/bus, motorcycle. Disjoint enough that per-class AP is learnable from
# the geometry alone; 3-4-class data (``num_classes`` 3 or 4) draws from them.
VEHICLE_CLASS_SIZES: Tuple[Tuple[Tuple[float, float], Tuple[float, float]], ...] = (
    ((1.7, 2.1), (3.6, 4.8)),
    ((2.2, 2.6), (6.0, 9.0)),
    ((0.7, 0.9), (1.8, 2.4)),
)


def default_fusion_layer(grid: int) -> int:
    """The default ``--layer`` for a ``grid``: the reference's layer 3 while
    the fusion map stays at least 16x16, else the deepest layer that keeps
    it there (floor 16x16). Layer 3 of a 64-grid fuses 8x8 maps of 2 m a
    cell, too coarse for the warp to carry a 4.5 m vehicle; the JAX package
    measured layer-3 DiscoNet below the lowerbound there."""
    return max(0, min(3, int(math.log2(max(16, grid))) - 4))


def tiny_config(grid: int = 64, **overrides) -> Config:
    """A small config for tests: the full architecture on a ``grid``^2 map."""
    half = grid * 0.25 / 2.0
    defaults = dict(
        area_extents=((-half, half), (-half, half), (-3.0, 2.0)),
        nms_top_k=64,
    )
    defaults.update(overrides)
    return Config(**defaults)
