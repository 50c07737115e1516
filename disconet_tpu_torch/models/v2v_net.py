"""V2VNet: multi-round message passing at the fusion layer with a ConvGRU.

Each round warps every agent's hidden state into every receiver's frame
(round 1 reuses the fusion core's warp of the stage-``layer`` maps), forms
messages ReLU(msg_conv(cat(receiver state, warped sender state))), averages
them over present senders and updates the hidden state with the ConvGRU.
After ``rounds`` rounds (3 by default) the hidden state is the fused map.
Everything here is fp32, as the JAX package's fp32 convs; on the card the
3x3 convs run in 3xTF32 on the tensor cores (``ops.conv3x3_f32x3``).

Under a mesh (``fuse_sharded``) a rank updates its receivers' rows: each
round after the first gathers every agent's hidden state over ``agent``
and ``spatial`` and warps the rank's rows of it, and the 3x3 convs of an
H-sharded strip take a halo row from each neighbour.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from disconet_tpu_torch.models.base import IntermediateFusionModel, masked_sender_reduce
from disconet_tpu_torch.ops.conv3x3 import conv3x3_f32x3
from disconet_tpu_torch.parallel.spatial import halo_exchange


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(N, h, w, C) -> the (N, C, h, w) view, channels_last in memory."""
    return x.permute(0, 3, 1, 2)


def _last(x: torch.Tensor) -> torch.Tensor:
    """(N, C, h, w) -> (N, h, w, C)."""
    return x.permute(0, 2, 3, 1)


def _same_conv(x: torch.Tensor, weight: torch.Tensor, bias, mesh) -> torch.Tensor:
    """The SAME 3x3 conv of (N, C, h, w) ``x``; on a strip of an H-sharded
    grid the neighbours' boundary rows stand in for the H padding."""
    if mesh is not None and mesh.axis_size("spatial") > 1:
        return conv3x3_f32x3(halo_exchange(x, mesh.group("spatial"), 1), weight, bias, pad_h=0)
    return conv3x3_f32x3(x, weight, bias)


class ConvGRU(nn.Module):
    """Convolutional GRU cell: 3x3 convs with a bias, ``update``, ``reset``
    and ``cand``, fp32."""

    def __init__(self, features: int, kernel: int = 3):
        super().__init__()
        pad = kernel // 2
        self.update = nn.Conv2d(2 * features, features, kernel, padding=pad)
        self.reset = nn.Conv2d(2 * features, features, kernel, padding=pad)
        self.cand = nn.Conv2d(2 * features, features, kernel, padding=pad)
        self.mesh = None  # a parallel.Mesh, set by parallel.attach_mesh

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """h, x (N, C, hh, ww) -> the new state (N, C, hh, ww)."""
        conv = lambda m, t: _same_conv(t, m.weight, m.bias, self.mesh)  # noqa: E731
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(conv(self.update, hx))
        r = torch.sigmoid(conv(self.reset, hx))
        cand = torch.tanh(conv(self.cand, torch.cat([r * h, x], dim=1)))
        return (1.0 - z) * h + z * cand


class V2VNet(IntermediateFusionModel):
    """Multi-round GNN fusion with ConvGRU state updates."""

    def __init__(self, config, layer: int = 3, kd_flag: bool = False, task: str = "det", rounds: int = 3):
        super().__init__(config, layer, kd_flag, task)
        C = self.layer_channels
        self.rounds = rounds
        self.msg_conv = nn.Conv2d(2 * C, C, 3, padding=1)
        self.gru = ConvGRU(C)

    def fuse_sharded(self, feats_k, warped, recv_mask, send_mask, trans):
        B, Ar, As, h, w, C = warped.shape
        hidden = feats_k.float()  # (B, Ar, h, w, C)
        wm = self.msg_conv.weight
        for r in range(self.rounds):
            if r > 0:  # poses are static, the states are not
                warped = self.warp_rows(self.gather_senders(hidden), trans, h)
            # msg_conv of cat(receiver, sender) split along its input axis:
            # the receiver's half runs once per receiver, not once per pair
            ego = _last(_same_conv(_nchw(hidden.reshape(B * Ar, h, w, C)), wm[:, :C], self.msg_conv.bias,
                                   self.mesh))
            per = _last(_same_conv(_nchw(warped.reshape(B * Ar * As, h, w, C)), wm[:, C:], None, self.mesh))
            msg = F.relu(per.reshape(B, Ar, As, h, w, C) + ego.reshape(B, Ar, 1, h, w, C))
            agg = masked_sender_reduce(msg, send_mask, "mean")  # (B, Ar, h, w, C)
            new = self.gru(_nchw(hidden.reshape(B * Ar, h, w, C)), _nchw(agg.reshape(B * Ar, h, w, C)))
            hidden = _last(new).reshape(B, Ar, h, w, C)
        return hidden
