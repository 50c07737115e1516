"""When2com and Who2com: handshake attention over senders.

Each agent compresses its fusion-layer map into a query and a key
(``_HandshakeEncoder``: two stride-2 ConvBNRelu, a global average pool, a
``Dense``); receiver i attends over senders j with the masked softmax of
attn_w(q_i) . k_j / sqrt(d), and the fused map is the attention-weighted sum
of the senders' values: their maps warped into i's frame (``warp_flag``) or
their own maps. Who2com (``hard_select``) keeps, in eval mode, only the
argmax sender (ties to the lower index), times the mask.

Under a mesh (``fuse_sharded``) the handshake runs on the rank's strip: its
stride-2 convs take halo rows and global statistics from ``ConvBNRelu``
(so a strip must hold a multiple of 4 rows), and the pool is the whole
grid's (``Mesh.spatial_mean``). The queries stay with their receivers; the
keys, and without ``warp_flag`` the senders' own rows, are gathered over
``agent``.
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
        self.mesh = None  # a parallel.Mesh, set by parallel.attach_mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ConvBNRelu_1(self.ConvBNRelu_0(x)).float()
        return self.Dense_0(x.mean(dim=(2, 3)) if self.mesh is None else self.mesh.spatial_mean(x, (2, 3)))


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

    def fuse_sharded(self, feats_k, warped, recv_mask, send_mask, trans):
        B, Ar, h, w, C = feats_k.shape
        mesh = self.mesh
        if mesh is not None and mesh.axis_size("spatial") > 1 and h % 4:
            raise ValueError(f"When2com's handshake runs two stride-2 convs on each rank's strip: a strip of "
                             f"{h} rows ({h * mesh.axis_size('spatial')} rows over "
                             f"{mesh.axis_size('spatial')} spatial ranks) is not a multiple of 4")
        flat = feats_k.reshape(B * Ar, h, w, C).permute(0, 3, 1, 2)
        q = self.query_net(flat).reshape(B, Ar, -1)
        k = self.key_net(flat).reshape(B, Ar, -1)
        if mesh is not None:
            k = mesh.all_gather(k, "agent", 1)
        As = k.shape[1]
        scores = torch.einsum("bid,bjd->bij", self.attn_w(q), k) / math.sqrt(float(self.key_dim))
        scores = torch.where(send_mask[:, None, :], scores, torch.full_like(scores, torch.finfo(scores.dtype).min))
        attn = torch.softmax(scores, dim=2)  # (B, Ar, As)
        if self.hard_select and not self.training:
            attn = F.one_hot(attn.argmax(dim=2), As).to(attn.dtype) * send_mask[:, None, :]
        if warped is None:  # each sender's own map, at the rank's rows
            own = feats_k if mesh is None else mesh.all_gather(feats_k, "agent", 1)
            return torch.einsum("bij,bjhwc->bihwc", attn, own)
        return torch.einsum("bij,bijhwc->bihwc", attn, warped)
