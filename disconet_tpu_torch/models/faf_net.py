"""FaFNet, the single-agent detector, and TeacherNet.

FaFNet is the STPN and the detection heads with no collaboration, agents
folded into the batch. It is the lowerbound (each agent sees its own BEV) and
the upperbound (fed the holistic early-fusion BEV: the input differs, the
model does not). TeacherNet is FaFNet with the KD taps always on; it runs
frozen, in eval mode, while a student trains.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.models.backbone import make_heads, make_stpn
from disconet_tpu_torch.models.base import bev_to_batch, detection_outputs


class FaFNet(nn.Module):
    """Single-agent model: backbone and heads per (scene, agent) frame."""

    def __init__(self, config: Config, kd_flag: bool = False):
        super().__init__()
        self.config = config
        self.kd_flag = kd_flag
        self.stpn = make_stpn(config)
        self.heads = make_heads(config)

    def forward(
        self,
        bev: torch.Tensor,
        trans: Optional[torch.Tensor] = None,
        agent_mask: Optional[torch.Tensor] = None,
        store_bf16: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """bev (B, A, H, W, Z); ``trans`` and ``agent_mask`` are not read (the
        signature is the fusion models'); ``store_bf16`` as
        ``ConvBNRelu.forward``."""
        B, A = bev.shape[:2]
        head_in, taps = self.stpn.decode(self.stpn.encode(bev_to_batch(bev), store_bf16), store_bf16)
        return detection_outputs(self.heads, head_in, taps, B, A, self.kd_flag)


class TeacherNet(FaFNet):
    """FaFNet over the holistic BEV, returning the KD taps."""

    def __init__(self, config: Config):
        super().__init__(config, kd_flag=True)
