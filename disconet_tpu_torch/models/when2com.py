"""When2com and Who2com: handshake attention over senders.

Each agent compresses its fusion-layer map into a query and a key
(``_HandshakeEncoder``: two stride-2 ConvBNRelu, a global average pool, a
``Dense``); receiver i attends over senders j with the masked softmax of
attn_w(q_i) . k_j / sqrt(d), and the fused map is the attention-weighted sum
of the senders' values: their maps warped into i's frame (``warp_flag``) or
their own maps. Who2com (``hard_select``) keeps, in eval mode, only the
argmax sender (ties to the lower index), times the mask.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from disconet_tpu_torch.models.backbone import ConvBNRelu
from disconet_tpu_torch.models.base import IntermediateFusionModel


class _HandshakeEncoder(nn.Module):
    """(N, C, h, w) -> (N, out_dim); its BatchNorm statistics are unmasked."""

    def __init__(self, cin: int, out_dim: int, bf16: bool):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(cin, 64, kernel=3, stride=2, bf16=bf16)
        self.ConvBNRelu_1 = ConvBNRelu(64, 32, kernel=3, stride=2, bf16=bf16)
        self.Dense_0 = nn.Linear(32, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ConvBNRelu_1(self.ConvBNRelu_0(x))
        return self.Dense_0(x.float().mean(dim=(2, 3)))


class When2com(IntermediateFusionModel):
    def __init__(self, config, layer: int = 3, kd_flag: bool = False, task: str = "det",
                 warp_flag: bool = True, hard_select: bool = False, query_dim: int = 32, key_dim: int = 32):
        super().__init__(config, layer, kd_flag, task)
        bf16 = config.compute_dtype == "bfloat16"
        self.uses_warp = warp_flag
        self.hard_select = hard_select
        self.key_dim = key_dim
        self.query_net = _HandshakeEncoder(self.layer_channels, query_dim, bf16)
        self.key_net = _HandshakeEncoder(self.layer_channels, key_dim, bf16)
        self.attn_w = nn.Linear(query_dim, key_dim, bias=False)  # score = q W k

    def fuse(self, feats_k, warped, agent_mask, trans):
        B, A, h, w, C = feats_k.shape
        flat = feats_k.reshape(B * A, h, w, C).permute(0, 3, 1, 2)
        q = self.query_net(flat).reshape(B, A, -1)
        k = self.key_net(flat).reshape(B, A, -1)
        scores = torch.einsum("bid,bjd->bij", self.attn_w(q), k) / math.sqrt(float(self.key_dim))
        scores = torch.where(agent_mask[:, None, :], scores, torch.full_like(scores, torch.finfo(scores.dtype).min))
        attn = torch.softmax(scores, dim=2)  # (B, Ar, As)
        if self.hard_select and not self.training:
            attn = F.one_hot(attn.argmax(dim=2), A).to(attn.dtype) * agent_mask[:, None, :]
        if warped is None:  # each sender's own map
            return torch.einsum("bij,bjhwc->bihwc", attn, feats_k)
        return torch.einsum("bij,bijhwc->bihwc", attn, warped)
