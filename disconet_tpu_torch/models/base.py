"""Fusion core: the shared forward of the intermediate-collaboration detectors.

Encode every agent's BEV with the STPN, warp every sender's stage-``layer``
map into every receiver's frame, fuse (the subclass's ``fuse``), put the fused
map in place of the stage-``layer`` skip and decode with the other skips
per agent, then the detection heads. Absent agents are carried by a boolean
``agent_mask``; they still flow through the conv stack as all-zero BEVs, and
the fusion gives them no weight as senders.

In the bf16 compute mode the fusion-layer maps arrive in bf16, so the warp
samples bf16 maps (accumulating in fp32) and returns bf16, as the JAX package
warps at inference on the TPU; the fused map is fp32. The float32 mode warps
fp32 maps, as the JAX package does on the CPU.

The public outputs keep the JAX package's layout: cls (B, A, H, W, NA, NC),
reg (B, A, H, W, NA, code), head_raw (B, A, H, W, NA*(NC + code)).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.models.backbone import make_heads, make_stpn
from disconet_tpu_torch.ops.warp import warp_features


def agents_to_batch(x: torch.Tensor) -> torch.Tensor:
    """(B, A, ...) -> (B*A, ...)."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def batch_to_agents(x: torch.Tensor, batch: int, agents: int) -> torch.Tensor:
    """(B*A, ...) -> (B, A, ...)."""
    return x.reshape((batch, agents) + tuple(x.shape[1:]))


def sender_softmax(scores: torch.Tensor, agent_mask: torch.Tensor) -> torch.Tensor:
    """Per-pixel softmax over the sender axis of (B, Ar, As, h, w), over present
    senders only (self-edge included): absent senders get weight exactly 0."""
    neg = torch.finfo(scores.dtype).min
    m = agent_mask[:, None, :, None, None]
    return torch.softmax(torch.where(m, scores, torch.full_like(scores, neg)), dim=2)


class IntermediateFusionModel(nn.Module):
    """Encode per agent -> fuse at ``layer`` -> decode with skips -> heads."""

    def __init__(self, config: Config, layer: int = 3):
        super().__init__()
        self.config = config
        self.layer = layer
        self.stpn = make_stpn(config)
        self.heads = make_heads(config)

    @property
    def layer_channels(self) -> int:
        ch = self.config.backbone_channels
        return ch[min(self.layer, len(ch) - 1)]

    def fuse(self, feats_k: torch.Tensor, warped: torch.Tensor, agent_mask: torch.Tensor) -> torch.Tensor:
        """feats_k (B, A, h, w, C), warped (B, Ar, As, h, w, C) -> (B, A, h, w, C)."""
        raise NotImplementedError

    def forward(self, bev: torch.Tensor, trans: torch.Tensor, agent_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """bev (B, A, H, W, Z), trans (B, A, A, 4, 4), agent_mask (B, A) bool."""
        B, A, H, W, Z = bev.shape
        # (B*A, Z, H, W) in channels_last memory: a view of the (H, W, Z) grid
        x = agents_to_batch(bev.float()).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        feats = self.stpn.encode(x)

        k = self.layer
        fk = batch_to_agents(feats[k].permute(0, 2, 3, 1), B, A)  # (B, A, h, w, C)
        warped = warp_features(fk, trans, self.config.area_extents[:2])
        fused = self.fuse(fk, warped, agent_mask.to(torch.bool))
        feats = list(feats)
        feats[k] = agents_to_batch(fused).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last
        )
        head_in = self.stpn.decode(feats)
        cls, reg, raw = self.heads(head_in)
        return {
            "cls": batch_to_agents(cls, B, A),
            "reg": batch_to_agents(reg, B, A),
            "head_raw": batch_to_agents(raw, B, A),
        }
