"""Plain reference of the detection models: STPN backbone, heads, warp.

Plain PyTorch in the natural layout, float32 (``precision.py`` gives the
control's rounding), over a dict of tensors keyed as the program's
``state_dict``; it imports nothing of the program. It follows the published
DiscoNet and V2VNet pipelines as the configuration states them:

* every (scene, agent) BEV grid (B, A, H, W, Z) is encoded by the STPN: five
  stages of two 3x3 ConvBNRelu (strides 1, 2, 2, 2, 2); the map of stage
  ``layer`` of every agent is fused (``fusion/<model>.py``); the decoder
  upsamples by 2 (nearest), concatenates the skip and runs two ConvBNRelu
  per stage, then a 3x3 ConvBNRelu to the head input;
* 1x1 heads give class logits (H, W, anchors, classes) and box deltas
  (H, W, anchors, 6), anchor-major channels;
* BatchNorm (eps 1e-5) normalizes training batches with the biased
  variance and blends it into the running statistics with momentum 0.9
  (flax's convention); eval mode reads the running statistics;
* the warp samples every sender's map at the receiver's cell centres,
  bilinear with zeros outside (``F.grid_sample``, half-pixel centres).

Absent agents still run through the conv stack as all-zero grids, as the
program's do; the fusion gives them no weight as senders.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.precision import Precision

EPS = 1e-5
MOMENTUM = 0.9
BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


class Ctx:
    """The weights ``P`` (parameters and BatchNorm buffers by name), the
    config dict, the arithmetic and the mode. In training the running
    statistics in ``P`` are replaced by updated tensors."""

    def __init__(self, P: Dict[str, torch.Tensor], cfg: Dict, prec: Precision, train: bool,
                 calibrate: bool = False):
        self.P, self.cfg, self.prec, self.train, self.calibrate = P, cfg, prec, train, calibrate

    @property
    def stated(self) -> str:
        return self.cfg["compute_dtype"]


def batch_norm(ctx: Ctx, prefix: str, y: torch.Tensor, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BatchNorm of (N, C, ...) ``y``; in training the statistics count the
    rows where ``rows`` (N,) holds (all rows without it)."""
    P = ctx.P
    gamma, beta = P[prefix + ".weight"], P[prefix + ".bias"]
    shape = (1, -1) + (1,) * (y.dim() - 2)
    if ctx.train:
        red = (0,) + tuple(range(2, y.dim()))
        if rows is None:
            mean = y.mean(red)
            var = y.var(red, unbiased=False)
        else:
            m = rows.to(y.dtype).reshape((-1,) + (1,) * (y.dim() - 1))
            cnt = m.sum() * float(np.prod(y.shape[2:]))
            mean = (y * m).sum(red) / cnt
            var = (y * y * m).sum(red) / cnt - mean * mean
        with torch.no_grad():
            keep = 0.0 if ctx.calibrate else MOMENTUM
            P[prefix + ".running_mean"] = keep * P[prefix + ".running_mean"] + (1 - keep) * mean
            P[prefix + ".running_var"] = keep * P[prefix + ".running_var"] + (1 - keep) * var
    else:
        mean, var = P[prefix + ".running_mean"], P[prefix + ".running_var"]
    return (y - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + EPS) * gamma.reshape(shape) + beta.reshape(shape)


def conv_bn_relu(ctx: Ctx, prefix: str, x: torch.Tensor, stride: int = 1, rows=None) -> torch.Tensor:
    w = ctx.P[prefix + ".weight"]
    y = ctx.prec.conv(x, w, None, stride, w.shape[-1] // 2, stated=ctx.stated)
    return F.relu(batch_norm(ctx, prefix + ".BatchNorm_0", y, rows))


def encode(ctx: Ctx, x: torch.Tensor) -> List[torch.Tensor]:
    feats = []
    for i in range(len(ctx.cfg["backbone_channels"])):
        x = conv_bn_relu(ctx, f"stpn.stages_{i}.ConvBNRelu_0", x, 1 if i == 0 else 2)
        x = conv_bn_relu(ctx, f"stpn.stages_{i}.ConvBNRelu_1", x)
        feats.append(x)
    return feats


def decode(ctx: Ctx, feats: List[torch.Tensor]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """-> the head input and the KD taps (the decoder stages coarse to fine,
    then the head input)."""
    x, taps = feats[-1], []
    for i in reversed(range(len(feats) - 1)):
        x = torch.cat([F.interpolate(x, scale_factor=2, mode="nearest"), feats[i]], dim=1)
        x = conv_bn_relu(ctx, f"stpn.dec_{i}.ConvBNRelu_0", x)
        x = conv_bn_relu(ctx, f"stpn.dec_{i}.ConvBNRelu_1", x)
        taps.append(x)
    head_in = conv_bn_relu(ctx, "stpn.head_conv", x)
    return head_in, taps + [head_in]


def heads(ctx: Ctx, head_in: torch.Tensor):
    """-> class logits (N, H, W, NA, NC) and deltas (N, H, W, NA, code)."""
    P, cfg = ctx.P, ctx.cfg
    NA, NC, code = len(cfg["anchor_sizes"]), cfg["num_classes"], cfg["box_code_size"]
    N, _, H, W = head_in.shape
    cls = ctx.prec.conv(head_in, P["heads.cls.weight"], P["heads.cls.bias"], stated=ctx.stated)
    reg = ctx.prec.conv(head_in, P["heads.reg.weight"], P["heads.reg.bias"], stated=ctx.stated)
    return (cls.permute(0, 2, 3, 1).reshape(N, H, W, NA, NC),
            reg.permute(0, 2, 3, 1).reshape(N, H, W, NA, code))


def warp(feats: torch.Tensor, trans: torch.Tensor, extent_xy) -> torch.Tensor:
    """Every sender's map in every receiver's frame: feats (B, As, C, h, w)
    (h along metric x), trans (B, Ar, As, 4, 4) mapping sender points into
    the receiver's frame -> (B, Ar, As, C, h, w)."""
    B, As, C, h, w = feats.shape
    Ar = trans.shape[1]
    (x_lo, x_hi), (y_lo, y_hi) = extent_xy
    cx, cy = (x_hi - x_lo) / h, (y_hi - y_lo) / w
    dev = feats.device
    t = trans.to(torch.float64)
    R_inv = torch.linalg.inv(t[..., :2, :2])  # (B, Ar, As, 2, 2)
    t_inv = -(R_inv @ t[..., :2, 3:4])[..., 0]
    mx = x_lo + (torch.arange(h, device=dev, dtype=torch.float64) + 0.5) * cx
    my = y_lo + (torch.arange(w, device=dev, dtype=torch.float64) + 0.5) * cy
    gx, gy = torch.meshgrid(mx, my, indexing="ij")
    sx = R_inv[..., 0, 0, None, None] * gx + R_inv[..., 0, 1, None, None] * gy + t_inv[..., 0, None, None]
    sy = R_inv[..., 1, 0, None, None] * gx + R_inv[..., 1, 1, None, None] * gy + t_inv[..., 1, None, None]
    px = (sx - x_lo) / cx - 0.5  # sender row (h axis)
    py = (sy - y_lo) / cy - 0.5  # sender column (w axis)
    grid = torch.stack([(2 * py + 1) / w - 1, (2 * px + 1) / h - 1], dim=-1).to(torch.float32)
    src = feats[:, None].expand(B, Ar, As, C, h, w).reshape(B * Ar * As, C, h, w)
    out = F.grid_sample(src, grid.reshape(B * Ar * As, h, w, 2), mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.reshape(B, Ar, As, C, h, w)


def forward(ctx: Ctx, fusion, bev: torch.Tensor, trans: Optional[torch.Tensor], mask: torch.Tensor,
            layer: Optional[int]) -> Dict[str, object]:
    """bev (B, A, H, W, Z) float -> cls (B, A, H, W, NA, NC), reg (B, A, H,
    W, NA, code) and the taps (B*A, c, h, w). ``fusion`` (a
    ``fusion/<model>.py`` module) fuses stage ``layer``; None runs each
    agent alone (the teacher)."""
    B, A, H, W, Z = bev.shape
    x = bev.reshape(B * A, H, W, Z).permute(0, 3, 1, 2).float()
    feats = encode(ctx, x)
    if fusion is not None:
        fk = feats[layer]
        fused = fusion.fuse(ctx, fk.reshape((B, A) + tuple(fk.shape[1:])), trans, mask)
        feats[layer] = fused.reshape(fk.shape)
    head_in, taps = decode(ctx, feats)
    cls, reg = heads(ctx, head_in)
    return {"cls": cls.reshape((B, A) + tuple(cls.shape[1:])), "reg": reg.reshape((B, A) + tuple(reg.shape[1:])),
            "taps": taps}


def calibrate_batch_norm(P: Dict[str, torch.Tensor], cfg: Dict, fusion, bev: torch.Tensor, trans, mask,
                         layer: Optional[int]) -> Dict[str, torch.Tensor]:
    """``P`` with every BatchNorm's running statistics set to the batch
    statistics of one float32 forward on ``bev`` (as a trained model's
    settle), so that eval-mode activations are normalized as in
    deployment."""
    out = dict(P)
    with torch.no_grad():
        forward(Ctx(out, cfg, Precision("reference"), train=True, calibrate=True), fusion, bev, trans, mask, layer)
    return out


def anchors(cfg: Dict, device) -> torch.Tensor:
    """(H, W, NA, 5) anchors [cx, cy, w, l, theta] at the cell centres."""
    (x_lo, x_hi), (y_lo, y_hi), _ = cfg["area_extents"]
    vx, vy, _ = cfg["voxel_size"]
    H = int(math.ceil((x_hi - x_lo) / vx - 1e-9))
    W = int(math.ceil((y_hi - y_lo) / vy - 1e-9))
    xs = x_lo + (torch.arange(H, dtype=torch.float32) + 0.5) * vx
    ys = y_lo + (torch.arange(W, dtype=torch.float32) + 0.5) * vy
    cx, cy = torch.meshgrid(xs, ys, indexing="ij")
    sizes = torch.tensor(cfg["anchor_sizes"], dtype=torch.float32)
    NA = sizes.shape[0]
    out = torch.empty(H, W, NA, 5)
    out[..., 0] = cx[..., None]
    out[..., 1] = cy[..., None]
    out[..., 2:] = sizes
    return out.to(device)


# operations of one forward, present frames only: every conv's 2 * Cin *
# Cout * k * k per output cell, the heads' dots; BatchNorm, ReLU and the
# upsample are not counted
def backbone_flops(cfg: Dict) -> float:
    """FLOPs of the STPN and the heads on one frame."""
    (x_lo, x_hi), (y_lo, y_hi), (z_lo, z_hi) = cfg["area_extents"]
    H = int(math.ceil((x_hi - x_lo) / cfg["voxel_size"][0] - 1e-9))
    W = int(math.ceil((y_hi - y_lo) / cfg["voxel_size"][1] - 1e-9))
    Z = int(math.ceil((z_hi - z_lo) / cfg["voxel_size"][2] - 1e-9))
    ch = cfg["backbone_channels"]
    total, cin = 0.0, Z
    for i, c in enumerate(ch):
        cells = (H >> i) * (W >> i)
        total += 2.0 * 9 * cells * (cin * c + c * c)
        cin = c
    for i in reversed(range(len(ch) - 1)):
        cells = (H >> i) * (W >> i)
        total += 2.0 * 9 * cells * ((ch[i + 1] + ch[i]) * ch[i] + ch[i] * ch[i])
    hc = cfg["head_channels"]
    NA = len(cfg["anchor_sizes"])
    total += 2.0 * 9 * H * W * ch[0] * hc
    total += 2.0 * H * W * hc * NA * (cfg["num_classes"] + cfg["box_code_size"])
    return total
