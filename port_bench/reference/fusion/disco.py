"""DiscoNet's fusion (Li et al., NeurIPS 2021, the DiscoGraph), plain.

For receiver i every sender j's map is warped into i's frame; a stack of
1x1 ConvBNRelu scores cat(ego_i, warped_j) per cell (2C -> 128 -> 32 -> 8,
then a linear 8 -> 1); a softmax over the present senders (the self-edge
included) gives the edge weights, and the fused map is the weighted sum of
the warped maps. In training the scorer's BatchNorm counts the rows of
pairs whose receiver and sender are both present.
"""

from __future__ import annotations

import torch

from port_bench.reference.model import conv_bn_relu, warp

# the state-dict prefixes of the fusion's own leaves
PREFIXES = ("weight_net.",)


def fuse(ctx, fk: torch.Tensor, trans: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """fk (B, A, C, h, w), trans (B, A, A, 4, 4), mask (B, A) -> (B, A, C, h, w)."""
    B, A, C, h, w = fk.shape
    warped = warp(fk, trans, ctx.cfg["area_extents"][:2])
    ego = fk[:, :, None].expand(B, A, A, C, h, w)
    x = torch.cat([ego, warped], dim=3).reshape(B * A * A, 2 * C, h, w)
    pair = (mask[:, :, None] & mask[:, None, :]).reshape(-1)
    for k in range(3):
        x = conv_bn_relu(ctx, f"weight_net.ConvBNRelu_{k}", x, rows=pair)
    s = ctx.prec.conv(x, ctx.P["weight_net.Conv_0.weight"], ctx.P["weight_net.Conv_0.bias"], stated="float32")
    s = s.reshape(B, A, A, h, w).masked_fill(~mask[:, None, :, None, None], float("-inf"))
    return (torch.softmax(s, dim=2)[:, :, :, None] * warped).sum(dim=2)


def flops(cfg, fusion_cells: int, channels: int, present: torch.Tensor) -> float:
    """FLOPs of the fusion over the present (receiver, sender) pairs of the
    (B, A) mask ``present``: the bilinear warp (4 taps, 8 per channel and
    cell), the scorer's 1x1 convs and the weighted sum."""
    n = present.sum(dim=1).double()
    pairs = float((n * n).sum())
    C = channels
    scorer = 2.0 * (2 * C * 128 + 128 * 32 + 32 * 8 + 8)
    return pairs * fusion_cells * (8.0 * C + scorer + 2.0 * C)
