"""V2VNet's fusion (Wang et al., ECCV 2020, arXiv:2008.07519), plain.

Three rounds of message passing at the fusion layer, in float32: each round
warps every agent's hidden state into every receiver's frame (round 1 the
stage maps themselves), forms messages ReLU(conv3x3(cat(receiver state,
warped sender state))), averages them over the present senders and updates
the hidden state with a ConvGRU (3x3 convs ``update``, ``reset`` and
``cand`` with biases). The last state is the fused map.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.model import warp

ROUNDS = 3
# the state-dict prefixes of the fusion's own leaves
PREFIXES = ("msg_conv.", "gru.")


def _gru(ctx, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    P, conv = ctx.P, ctx.prec.conv
    hx = torch.cat([h, x], dim=1)
    z = torch.sigmoid(conv(hx, P["gru.update.weight"], P["gru.update.bias"], padding=1, stated="float32"))
    r = torch.sigmoid(conv(hx, P["gru.reset.weight"], P["gru.reset.bias"], padding=1, stated="float32"))
    cand = torch.tanh(conv(torch.cat([r * h, x], dim=1), P["gru.cand.weight"], P["gru.cand.bias"], padding=1,
                           stated="float32"))
    return (1.0 - z) * h + z * cand


def fuse(ctx, fk: torch.Tensor, trans: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """fk (B, A, C, h, w), trans (B, A, A, 4, 4), mask (B, A) -> (B, A, C, h, w)."""
    B, A, C, h, w = fk.shape
    hidden = fk.float()
    m = mask[:, None, :, None, None, None].to(hidden.dtype)
    for _ in range(ROUNDS):
        warped = warp(hidden, trans, ctx.cfg["area_extents"][:2])
        ego = hidden[:, :, None].expand(B, A, A, C, h, w)
        x = torch.cat([ego, warped], dim=3).reshape(B * A * A, 2 * C, h, w)
        msg = F.relu(ctx.prec.conv(x, ctx.P["msg_conv.weight"], ctx.P["msg_conv.bias"], padding=1,
                                   stated="float32")).reshape(B, A, A, C, h, w)
        agg = (msg * m).sum(dim=2) / m.sum(dim=2).clamp(min=1.0)
        hidden = _gru(ctx, hidden.reshape(B * A, C, h, w), agg.reshape(B * A, C, h, w)).reshape(B, A, C, h, w)
    return hidden


def flops(cfg, fusion_cells: int, channels: int, present: torch.Tensor) -> float:
    """FLOPs of the three rounds over the present pairs and receivers: the
    bilinear warp (8 per channel and cell), the message conv of each pair's
    concatenation, the mean over senders and the ConvGRU's three convs; the
    gates' elementwise work is not counted."""
    n = present.sum(dim=1).double()
    pairs, receivers = float((n * n).sum()), float(n.sum())
    C = channels
    conv = 2.0 * 9 * 2 * C * C
    per_round = pairs * fusion_cells * (8.0 * C + conv + C) + receivers * fusion_cells * 3 * conv
    return ROUNDS * per_round
