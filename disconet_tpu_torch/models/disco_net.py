"""DiscoNet student: per-pixel matrix-valued edge weights (the DiscoGraph).

For receiver i, every sender j's fusion-layer map is warped into i's frame; a
1x1-conv stack scores cat(ego_i, warped_j) per pixel; a per-pixel softmax over
present senders (self-edge included) gives the weights, and the fused map is
the weighted sum. All (B, Ar, As) pairs run as one batch.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from disconet_tpu_torch.models.backbone import ConvBNRelu
from disconet_tpu_torch.models.base import IntermediateFusionModel, sender_softmax


class PixelWeightedFusion(nn.Module):
    """Edge scorer: 1x1 convs 2C -> 128 -> 32 -> 8 (BN + ReLU) -> 1 (linear)."""

    def __init__(self, channels: int, bf16: bool = True):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(2 * channels, 128, kernel=1, bf16=bf16)
        self.ConvBNRelu_1 = ConvBNRelu(128, 32, kernel=1, bf16=bf16)
        self.ConvBNRelu_2 = ConvBNRelu(32, 8, kernel=1, bf16=bf16)
        self.Conv_0 = nn.Conv2d(8, 1, 1)

    def forward(self, ego: torch.Tensor, warped: torch.Tensor, pair_mask: torch.Tensor) -> torch.Tensor:
        """``ego`` (N, h, w, C) per receiver and ``warped`` (N*S, h, w, C)
        (receiver, sender) pairs, channel-last -> scores (N*S, h, w) float32.

        The first conv runs split (``forward_pair1x1``): the ego half of its
        kernel projects once per receiver and cat(ego, warped) is never built.
        ``pair_mask`` (N*S,) marks the real pairs, the rows the BatchNorm
        statistics count in training.
        """
        x = self.ConvBNRelu_0.forward_pair1x1(ego, warped, pair_mask)
        x = self.ConvBNRelu_1.forward_last(x, pair_mask)
        x = self.ConvBNRelu_2.forward_last(x, pair_mask)
        w = self.Conv_0.weight[:, :, 0, 0]  # (1, 8), fp32 as in the JAX model
        return (x.float() @ w.t() + self.Conv_0.bias)[..., 0]


class DiscoNet(IntermediateFusionModel):
    """Intermediate-collaboration student with DiscoGraph fusion."""

    fusion_store_bf16 = True  # the scorer casts to bf16; the sum is fp32

    def __init__(self, config, layer: int = 3, kd_flag: bool = False, task: str = "det"):
        super().__init__(config, layer, kd_flag, task)
        self.weight_net = PixelWeightedFusion(
            self.layer_channels, bf16=config.compute_dtype == "bfloat16"
        )

    def _weights(self, feats_k, warped, recv_mask, send_mask):
        B, Ar, As, h, w, C = warped.shape
        pair_mask = (recv_mask[:, :, None] & send_mask[:, None, :]).reshape(B * Ar * As)
        scores = self.weight_net(
            feats_k.reshape(B * Ar, h, w, C), warped.reshape(B * Ar * As, h, w, C), pair_mask
        ).reshape(B, Ar, As, h, w)
        return sender_softmax(scores, send_mask)

    def fuse_sharded(self, feats_k, warped, recv_mask, send_mask, trans):
        return (self._weights(feats_k, warped, recv_mask, send_mask)[..., None] * warped).sum(dim=2)

    def edge_weights(self, bev, trans, agent_mask, store_bf16: bool = False) -> torch.Tensor:
        """The DiscoGraph's per-pixel edge weights W_j->i, (B, Ar, As, h, w)
        float32 (the JAX model's sown ``edge_weights``): the encoder, the warp
        and the scorer of the forward, without the decoder and the heads. The
        caller sets the mode and the grad mode; ``forward`` never computes
        more for them."""
        _, fk = self.encode(bev, store_bf16)
        mask = agent_mask.to(torch.bool)
        return self._weights(fk, self.warp(fk, trans), mask, mask)
