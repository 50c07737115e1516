"""Fusion core: the shared forward of the intermediate-collaboration detectors.

Encode every agent's BEV with the STPN, warp every sender's stage-``layer``
map into every receiver's frame, fuse (the subclass's ``fuse``), put the fused
map in place of the stage-``layer`` skip and decode with the other skips
per agent, then the detection heads. Absent agents are carried by a boolean
``agent_mask``; they still flow through the conv stack as all-zero BEVs, and
the fusion gives them no weight as senders.

With ``store_bf16`` (detection, see ``ConvBNRelu.forward``) the eval-mode
bf16 compute mode's fusion-layer maps arrive in bf16, so the warp samples
bf16 maps (accumulating in fp32) and returns bf16, as the JAX package warps
at inference on the TPU; the fused map is fp32. Elsewhere, training and the
KD teacher included, the maps and the warp are fp32 in either mode, as in
the JAX package's training. The warp's backward is an
``index_add`` into the sampled map (atomics on the card), so its gradient is
not bit-reproducible from run to run there.

The public outputs keep the JAX package's layout: cls (B, A, H, W, NA, NC),
reg (B, A, H, W, NA, code), head_raw (B, A, H, W, NA*(NC + code)) in
``head_raw_dtype``, head_raw_f32 (the same unrounded, fp32) and, with
``kd_flag``, kd_feats: the five KD taps, each (B, A, h, w, c) fp32.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.models.backbone import DetectionHeads, make_heads, make_stpn
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


def bev_to_batch(bev: torch.Tensor) -> torch.Tensor:
    """(B, A, H, W, Z) grids -> (B*A, Z, H, W) fp32 in the channels_last
    memory format: a view of the (H, W, Z) grid."""
    x = agents_to_batch(bev.float()).permute(0, 3, 1, 2)
    return x.contiguous(memory_format=torch.channels_last)


def detection_outputs(
    heads: DetectionHeads, head_in: torch.Tensor, taps: List[torch.Tensor], B: int, A: int, kd_flag: bool
) -> Dict[str, torch.Tensor]:
    """The heads on the (B*A, C, H, W) head input -> the output dict."""
    cls, reg, raw, raw_f32 = heads(head_in)
    out = {
        "cls": batch_to_agents(cls, B, A),
        "reg": batch_to_agents(reg, B, A),
        "head_raw": batch_to_agents(raw, B, A),
        "head_raw_f32": batch_to_agents(raw_f32, B, A),
    }
    if kd_flag:  # (N, c, h, w) -> (B, A, h, w, c), free for channels_last maps
        out["kd_feats"] = [batch_to_agents(t.permute(0, 2, 3, 1).float(), B, A) for t in taps]
    return out


class IntermediateFusionModel(nn.Module):
    """Encode per agent -> fuse at ``layer`` -> decode with skips -> heads."""

    def __init__(self, config: Config, layer: int = 3, kd_flag: bool = False):
        super().__init__()
        self.config = config
        self.layer = layer
        self.kd_flag = kd_flag
        self.stpn = make_stpn(config)
        self.heads = make_heads(config)

    @property
    def layer_channels(self) -> int:
        ch = self.config.backbone_channels
        return ch[min(self.layer, len(ch) - 1)]

    def fuse(self, feats_k: torch.Tensor, warped: torch.Tensor, agent_mask: torch.Tensor) -> torch.Tensor:
        """feats_k (B, A, h, w, C), warped (B, Ar, As, h, w, C) -> (B, A, h, w, C)."""
        raise NotImplementedError

    def forward(
        self, bev: torch.Tensor, trans: torch.Tensor, agent_mask: torch.Tensor, store_bf16: bool = False
    ) -> Dict[str, torch.Tensor]:
        """bev (B, A, H, W, Z), trans (B, A, A, 4, 4), agent_mask (B, A) bool;
        ``store_bf16`` as ``ConvBNRelu.forward``."""
        B, A = bev.shape[:2]
        feats = self.stpn.encode(bev_to_batch(bev), store_bf16)

        k = self.layer
        fk = batch_to_agents(feats[k].permute(0, 2, 3, 1), B, A)  # (B, A, h, w, C)
        warped = warp_features(fk, trans, self.config.area_extents[:2])
        fused = self.fuse(fk, warped, agent_mask.to(torch.bool))
        feats = list(feats)
        feats[k] = agents_to_batch(fused).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last
        )
        head_in, taps = self.stpn.decode(feats, store_bf16)
        return detection_outputs(self.heads, head_in, taps, B, A, self.kd_flag)
