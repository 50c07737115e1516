"""UNet backbone of BEV segmentation: the reference seg zoo's topology.

A DoubleConv input block, four 2x2-maxpool + DoubleConv downs (64, 128, 256,
512, 512 channels) and four upsample + concat + DoubleConv ups back to a
64-channel stride-1 map, built from the STPN's blocks (``ConvBNRelu``, the
nearest-upsample ``_DecoderStage``), as the JAX package builds it in place
of the reference's bilinear upsample. ``encode``/``decode`` have the STPN's
interface (stage outputs at strides 1, 2, 4, 8, 16; the head input and the
KD taps), so every fusion model runs on either backbone; a seg model keeps
the attribute name ``stpn`` for it, and the module names ``stages_i`` and
``dec_i``, as the JAX package's ``save_pth`` keys have them.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.models.backbone import _DecoderStage, _EncoderStage, stage


class _DoubleConv(_EncoderStage):
    """Two 3x3 ConvBNRelu at stride 1: the UNet's DoubleConv block."""

    def __init__(self, cin: int, cout: int, bf16: bool):
        super().__init__(cin, cout, 1, bf16)


def _down(block: _DoubleConv, pool: bool, store_bf16: bool, x: torch.Tensor) -> torch.Tensor:
    """One encoder stage: the 2x2 max-pool (stages after the first), then the DoubleConv."""
    return block(F.max_pool2d(x, 2, 2) if pool else x, store_bf16)


class UNet(nn.Module):
    """Stage i > 0 max-pools 2x2 (flax's VALID pool: floor) before its
    DoubleConv. Decoder stage i takes the deeper map and the skip
    ``feats[i]`` and emits ``channels[max(i - 1, 0)]``: 512 + 512 -> 256 ->
    128 -> 64 -> 64. The 64-channel stride-1 output is the head input; the
    taps are the four decoder outputs, coarse to fine."""

    def __init__(self, in_channels: int, channels: Sequence[int], bf16: bool):
        super().__init__()
        self.channels = tuple(channels)
        n = len(self.channels)
        prev = in_channels
        for i, c in enumerate(self.channels):
            self.add_module(f"stages_{i}", _DoubleConv(prev, c, bf16))
            prev = c
        for i in range(n - 1):
            deep = self.channels[-1] if i == n - 2 else self.channels[i]
            self.add_module(f"dec_{i}", _DecoderStage(deep, self.channels[i], self.channels[max(i - 1, 0)], bf16))

    def encode(self, x: torch.Tensor, store_bf16: bool = False, fp32_stage: Optional[int] = None
               ) -> List[torch.Tensor]:
        """As ``STPN.encode``."""
        feats = []
        for i in range(len(self.channels)):
            down = functools.partial(_down, getattr(self, f"stages_{i}"), i > 0, store_bf16 and i != fp32_stage)
            x = stage(down, x)
            feats.append(x)
        return feats

    def decode(self, feats: Sequence[torch.Tensor], store_bf16: bool = False, head_fp32: bool = False
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """As ``STPN.decode``; the last decoder stage's output is the head input."""
        x = feats[-1]
        taps = []
        for i in reversed(range(len(self.channels) - 1)):
            up = functools.partial(getattr(self, f"dec_{i}"), store_bf16=store_bf16 and not (i == 0 and head_fp32))
            x = stage(up, x, feats[i])
            taps.append(x)
        return x, taps


def make_unet(config: Config) -> UNet:
    return UNet(config.bev_shape[2], config.unet_channels, bf16=config.compute_dtype == "bfloat16")


def use_unet(config: Config, task: str) -> bool:
    """Whether a model of ``task`` runs the UNet (``config.seg_backbone``)."""
    return task == "seg" and config.seg_backbone == "unet"
