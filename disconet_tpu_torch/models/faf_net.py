"""FaFNet, the single-agent model, and TeacherNet.

FaFNet is the backbone and the task's heads with no collaboration, agents
folded into the batch. It is the lowerbound (each agent sees its own BEV) and
the upperbound (fed the holistic early-fusion BEV: the input differs, the
model does not). TeacherNet is FaFNet with the KD taps always on; it runs
frozen, in eval mode, while a student trains. ``task`` "seg" makes either
the single-agent segmenter (the UNet by default, ``config.seg_backbone``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.models.base import attach_backbone_and_heads, bev_to_batch, head_outputs
from disconet_tpu_torch.utils import profiling


class FaFNet(nn.Module):
    """Single-agent model: backbone and heads per (scene, agent) frame."""

    def __init__(self, config: Config, kd_flag: bool = False, task: str = "det"):
        super().__init__()
        self.config = config
        self.kd_flag = kd_flag
        attach_backbone_and_heads(self, config, task)

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
        with profiling.annotate("model/encode"):
            feats = self.stpn.encode(bev_to_batch(bev), store_bf16)
        with profiling.annotate("model/decode"):
            head_in, taps = self.stpn.decode(feats, store_bf16, head_fp32=self.task == "seg")
            return head_outputs(self, head_in, taps, B, A)


class TeacherNet(FaFNet):
    """FaFNet over the holistic BEV, returning the KD taps."""

    def __init__(self, config: Config, task: str = "det"):
        super().__init__(config, kd_flag=True, task=task)
