"""The naive fusion baselines, ``--com sum/mean/max/cat/agent``.

Each fuses the warped all-pairs maps of the fusion core: a masked sum, mean
or maximum over present senders; ``cat`` concatenates the senders in slot
order (zeros for absent ones) and projects back with a 3x3 ConvBNRelu;
``agent`` weights each sender by one scalar, scored from the pooled pair.

Under a mesh (``fuse_sharded``) a rank's receivers fuse every gathered
sender at its own rows: ``cat``'s 3x3 projection takes its halo rows and
global statistics from ``ConvBNRelu``, and ``agent``'s spatial mean is over
the whole grid (``Mesh.spatial_mean``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from disconet_tpu_torch.models.backbone import ConvBNRelu
from disconet_tpu_torch.models.base import IntermediateFusionModel, masked_sender_reduce, sender_softmax


class SumFusion(IntermediateFusionModel):
    def fuse_sharded(self, feats_k, warped, recv_mask, send_mask, trans):
        return masked_sender_reduce(warped, send_mask, "sum")


class MeanFusion(IntermediateFusionModel):
    def fuse_sharded(self, feats_k, warped, recv_mask, send_mask, trans):
        return masked_sender_reduce(warped, send_mask, "mean")


class MaxFusion(IntermediateFusionModel):
    def fuse_sharded(self, feats_k, warped, recv_mask, send_mask, trans):
        return masked_sender_reduce(warped, send_mask, "max")


class CatFusion(IntermediateFusionModel):
    """cat(senders in slot order, zeros for absent ones) -> 3x3 ConvBNRelu
    (``config.max_agents`` x C -> C), its BatchNorm statistics over present
    receivers in training."""

    def __init__(self, config, layer: int = 3, kd_flag: bool = False, task: str = "det"):
        super().__init__(config, layer, kd_flag, task)
        C = self.layer_channels
        self.cat_proj = ConvBNRelu(config.max_agents * C, C, bf16=config.compute_dtype == "bfloat16")

    def fuse_sharded(self, feats_k, warped, recv_mask, send_mask, trans):
        B, Ar, As, h, w, C = warped.shape
        if As * C != self.cat_proj.weight.shape[1]:
            raise ValueError(f"CatFusion projects config.max_agents = {self.config.max_agents} sender "
                             f"slots; the batch has {As}")
        m = send_mask[:, None, :, None, None, None].to(warped.dtype)
        # (B, Ar, h, w, As, C): channel j*C + c is sender j's channel c
        x = (warped * m).permute(0, 1, 3, 4, 2, 5).reshape(B * Ar, h, w, As * C)
        out = self.cat_proj(x.permute(0, 3, 1, 2), sample_mask=recv_mask.reshape(B * Ar))
        return out.permute(0, 2, 3, 1).reshape(B, Ar, h, w, C)


class AgentWiseWeightedFusion(IntermediateFusionModel):
    """One scalar weight per sender: a 1x1 ConvBNRelu (2C -> 32, BatchNorm
    statistics over the real pairs) on cat(ego, warped), the spatial mean, a
    ``Dense(1)``, and the softmax over present senders."""

    def __init__(self, config, layer: int = 3, kd_flag: bool = False, task: str = "det"):
        super().__init__(config, layer, kd_flag, task)
        self.score_conv = ConvBNRelu(2 * self.layer_channels, 32, kernel=1,
                                     bf16=config.compute_dtype == "bfloat16")
        self.score_out = nn.Linear(32, 1)

    def fuse_sharded(self, feats_k, warped, recv_mask, send_mask, trans):
        B, Ar, As, h, w, C = warped.shape
        pair_mask = (recv_mask[:, :, None] & send_mask[:, None, :]).reshape(B * Ar * As)
        # the ego half of the 1x1 kernel projects once per receiver
        x = self.score_conv.forward_pair1x1(
            feats_k.reshape(B * Ar, h, w, C), warped.reshape(B * Ar * As, h, w, C), pair_mask
        )
        pooled = x.mean(dim=(1, 2)) if self.mesh is None else self.mesh.spatial_mean(x, (1, 2))
        scores = self.score_out(pooled).reshape(B, Ar, As)
        weights = sender_softmax(scores[..., None, None], send_mask)[..., 0, 0]  # (B, Ar, As)
        return torch.einsum("bij,bijhwc->bihwc", weights, warped)
