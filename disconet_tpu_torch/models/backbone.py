"""STPN backbone and detection heads.

The conv stack runs NCHW tensors in the channels_last memory format, so the
head input's (N, H, W, C) view is free and the fusion layer's maps can be
handled channel-last without copies.

``compute_dtype`` "bfloat16" casts conv inputs and weights to bf16 and keeps
accumulation and BatchNorm arithmetic in fp32. A conv's output is bf16, as the
JAX package's bf16 convs return it, and a ConvBNRelu stores its result in
bf16 (see ``ConvBNRelu.forward``). The split 1x1 conv of the fusion scorer and the
detection heads keep their fp32 accumulator unrounded, as the JAX package's
``preferred_element_type=float32`` dots do: they multiply bf16-rounded
operands in fp32 (a product of two bf16 values is exact in fp32, and TF32 is
off). "float32" is the exact mode.

BatchNorm runs on its running statistics only: the batch-statistics branch
(with the fusion scorer's pair mask) belongs to training, which the port does
not have yet, so a module in training mode raises.

Module and parameter names give the JAX package's ``save_pth`` keys, e.g.
``stpn.stages_1.ConvBNRelu_0.weight``, ``...BatchNorm_0.running_var``,
``heads.cls.weight``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from disconet_tpu_torch.config import Config


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and held in fp32."""
    return x.to(torch.bfloat16).float()


def bn_channels_last(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval-mode BatchNorm over the last axis of a channel-last tensor."""
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return (x - bn.running_mean) * scale + bn.bias


class ConvBNRelu(nn.Module):
    """k x k conv (no bias, symmetric k//2 padding) -> BatchNorm -> ReLU.

    BatchNorm is eps 1e-5 and torch momentum 0.1 (flax momentum 0.9).
    """

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, bf16: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = kernel // 2
        self.bf16 = bf16
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.BatchNorm_0 = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)

    def _eval_only(self):
        if self.training:
            raise NotImplementedError(
                "batch-statistics BatchNorm is not ported yet; call .eval()"
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, Cin, H, W) -> (N, Cout, H', W'), bf16 in the bf16 mode.

        In the bf16 mode BatchNorm reads the conv's bf16 output and computes
        in fp32 with fp32 parameters, and the result is stored in bf16: the
        next conv, the scorer's dots and the heads cast it to bf16 anyway, so
        storing it rounded changes no value they see and halves the bytes of
        every elementwise pass. The one other consumer, the pose warp at the
        fusion layer, then samples bf16 maps, as the JAX package does at
        inference on the TPU.
        """
        self._eval_only()
        if self.bf16:
            y = F.conv2d(
                x.to(torch.bfloat16), self.weight.to(torch.bfloat16),
                stride=self.stride, padding=self.padding,
            )
        else:
            y = F.conv2d(x.float(), self.weight, stride=self.stride, padding=self.padding)
        bn = self.BatchNorm_0
        y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
        return F.relu_(y)

    def _dot(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """(..., Cin) x (Cout, Cin) -> (..., Cout) with an fp32 accumulator."""
        if self.bf16:
            return _round_bf16(x) @ _round_bf16(w).t()
        return x.float() @ w.t()

    def forward_last(self, x: torch.Tensor) -> torch.Tensor:
        """1x1 conv on a channel-last (..., Cin) tensor -> (..., Cout)."""
        self._eval_only()
        y = self._dot(x, self.weight[:, :, 0, 0])
        if self.bf16:  # a natural bf16 conv returns bf16
            y = _round_bf16(y)
        return F.relu(bn_channels_last(y, self.BatchNorm_0))

    def forward_pair1x1(self, shared: torch.Tensor, per_item: torch.Tensor) -> torch.Tensor:
        """The 1x1 conv of concat(broadcast(shared), per_item), channel-last.

        ``shared`` (N, h, w, Cs) and ``per_item`` (N*S, h, w, Cp) -> (N*S, h, w, Cout).
        The kernel is split along its input axis, so the shared half projects
        once per group of S rows and the concat is never built.
        """
        self._eval_only()
        Cs = shared.shape[-1]
        w = self.weight[:, :, 0, 0]
        s_proj = self._dot(shared, w[:, :Cs])
        p_proj = self._dot(per_item, w[:, Cs:])
        N, h, wd, Fo = s_proj.shape
        y = (s_proj[:, None] + p_proj.reshape(N, -1, h, wd, Fo)).reshape(-1, h, wd, Fo)
        return F.relu(bn_channels_last(y, self.BatchNorm_0))


class _EncoderStage(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, bf16: bool):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(cin, cout, stride=stride, bf16=bf16)
        self.ConvBNRelu_1 = ConvBNRelu(cout, cout, bf16=bf16)

    def forward(self, x):
        return self.ConvBNRelu_1(self.ConvBNRelu_0(x))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of (N, C, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class _DecoderStage(nn.Module):
    """Upsample 2x, concat the skip, two ConvBNRelu."""

    def __init__(self, c_deep: int, c_skip: int, cout: int, bf16: bool):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(c_deep + c_skip, cout, bf16=bf16)
        self.ConvBNRelu_1 = ConvBNRelu(cout, cout, bf16=bf16)

    def forward(self, x, skip):
        x = torch.cat([upsample2x(x), skip.to(x.dtype)], dim=1)
        return self.ConvBNRelu_1(self.ConvBNRelu_0(x))


class STPN(nn.Module):
    """Staged encoder (strides 1, 2, 4, 8, 16) and skip decoder to the head map."""

    def __init__(self, in_channels: int, channels: Sequence[int], head_channels: int, bf16: bool):
        super().__init__()
        self.channels = tuple(channels)
        prev = in_channels
        for i, c in enumerate(self.channels):
            self.add_module(f"stages_{i}", _EncoderStage(prev, c, 1 if i == 0 else 2, bf16))
            prev = c
        for i in range(len(self.channels) - 1):
            self.add_module(
                f"dec_{i}",
                _DecoderStage(self.channels[i + 1], self.channels[i], self.channels[i], bf16),
            )
        self.head_conv = ConvBNRelu(self.channels[0], head_channels, bf16=bf16)

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """All encoder stages; returns the list of stage outputs."""
        feats = []
        for i in range(len(self.channels)):
            x = getattr(self, f"stages_{i}")(x)
            feats.append(x)
        return feats

    def decode(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """Skip decoder over the stage list -> the (N, head_channels, H, W) head input."""
        x = feats[-1]
        for i in reversed(range(len(self.channels) - 1)):
            x = getattr(self, f"dec_{i}")(x, feats[i])
        return self.head_conv(x)


class DetectionHeads(nn.Module):
    """1x1 cls and reg heads, computed as one product with a class-major layout.

    The parameters are two convs (``cls`` anchor-major, channel a*NC + c;
    ``reg`` channel a*code + k). The packed output puts the cls block
    class-major (channel c*NA + a) ahead of the reg block, a column permutation
    of the same weights, so the NMS reads scores from two contiguous slices.
    """

    def __init__(self, cin: int, num_anchors: int, num_classes: int, code: int,
                 bf16: bool, raw_dtype: torch.dtype):
        super().__init__()
        self.na, self.nc, self.code = num_anchors, num_classes, code
        self.bf16 = bf16
        self.raw_dtype = raw_dtype
        self.cls = nn.Conv2d(cin, num_anchors * num_classes, 1)
        self.reg = nn.Conv2d(cin, num_anchors * code, 1)

    def forward(self, x: torch.Tensor):
        """x (N, C, H, W) -> cls (N, H, W, NA, NC), reg (N, H, W, NA, code),
        both fp32, and the packed (N, H, W, NA*NC + NA*code) tensor in
        ``raw_dtype``."""
        N, C, H, W = x.shape
        NA, NC, code = self.na, self.nc, self.code
        n_cls = NA * NC
        w_cls = self.cls.weight[:, :, 0, 0].reshape(NA, NC, C).transpose(0, 1).reshape(n_cls, C)
        b_cls = self.cls.bias.reshape(NA, NC).t().reshape(n_cls)
        w = torch.cat([w_cls, self.reg.weight[:, :, 0, 0]], dim=0)
        b = torch.cat([b_cls, self.reg.bias])
        x_last = x.permute(0, 2, 3, 1)  # free for channels_last input
        if self.bf16:
            raw = _round_bf16(x_last) @ _round_bf16(w).t()
        else:
            raw = x_last.float() @ w.t()
        raw = raw + b
        cls = raw[..., :n_cls].reshape(N, H, W, NC, NA).transpose(-1, -2)
        reg = raw[..., n_cls:].reshape(N, H, W, NA, code)
        return cls, reg, raw.to(self.raw_dtype)


def make_stpn(config: Config) -> STPN:
    return STPN(
        config.bev_shape[2], config.backbone_channels, config.head_channels,
        bf16=config.compute_dtype == "bfloat16",
    )


def make_heads(config: Config) -> DetectionHeads:
    return DetectionHeads(
        config.head_channels, config.num_anchors, config.num_classes, config.box_code_size,
        bf16=config.compute_dtype == "bfloat16",
        raw_dtype={"bfloat16": torch.bfloat16, "float32": torch.float32}[config.head_raw_dtype],
    )
