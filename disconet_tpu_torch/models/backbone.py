"""STPN backbone and detection heads.

The conv stack runs NCHW tensors in the channels_last memory format, so the
head input's (N, H, W, C) view is free and the fusion layer's maps can be
handled channel-last without copies.

``compute_dtype`` "bfloat16" casts conv inputs and weights to bf16 and keeps
accumulation and BatchNorm arithmetic in fp32. A conv's output is bf16, as the
JAX package's bf16 convs return it. A ConvBNRelu returns fp32, as the JAX
package's does, unless the caller passes ``store_bf16`` in eval mode (the
``predict`` path does), where the bf16 mode stores it in bf16 (see
``ConvBNRelu.forward``). The split 1x1 conv of the fusion scorer and the
detection heads keep their fp32 accumulator unrounded, as the JAX package's
``preferred_element_type=float32`` dots do: they multiply bf16-rounded
operands in fp32 (a product of two bf16 values is exact in fp32, and TF32 is
off). "float32" is the exact mode.

``module.train()`` selects BatchNorm on batch statistics, ``.eval()`` on the
running statistics; one module tree serves both. In training the statistics
are flax's: the biased variance normalizes and updates the running variance
(momentum 0.9 in flax's convention), where ``nn.BatchNorm2d`` would update it
with the unbiased one. The fusion scorer's BatchNorms count only the rows of
real (receiver, sender) pairs (``pair_mask``), and the concatenating
fusion's projection only present receivers (``sample_mask``); the conv
stack's count every row, padded agents' zero BEVs included, as the JAX
package's do.

Module and parameter names give the JAX package's ``save_pth`` keys, e.g.
``stpn.stages_1.ConvBNRelu_0.weight``, ``...BatchNorm_0.running_var``,
``heads.cls.weight``.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from disconet_tpu_torch.config import Config

# flax momentum: running = MOMENTUM * running + (1 - MOMENTUM) * batch statistic
MOMENTUM = 0.9

# per thread: whether ``stage`` rematerializes (set by ``remat_stages``), and
# whether a stage is being recomputed in the backward (no running-statistic
# update). The backward runs on autograd's device thread on the card.
_local = threading.local()


@contextlib.contextmanager
def remat_stages(on: bool = True):
    """Within the block, every ``stage`` run with grad enabled is
    rematerialized (``config.train_remat``; the train steps enter it around
    the forward)."""
    prev = getattr(_local, "remat", False)
    _local.remat = on
    try:
        yield
    finally:
        _local.remat = prev


def stage(fn: Callable[..., torch.Tensor], *args: torch.Tensor) -> torch.Tensor:
    """``fn(*args)``, one stage between two boundaries that the backward keeps.

    Under :func:`remat_stages` with grad enabled it runs under
    ``torch.utils.checkpoint`` (non-reentrant): the backward recomputes the
    stage from ``args`` instead of keeping its intermediates. The recompute
    runs the training-mode BatchNorms a second time on the same values; it
    leaves the running statistics alone, so they update once per step, as
    the JAX package's functional ``batch_stats`` do."""
    if not (getattr(_local, "remat", False) and torch.is_grad_enabled()):
        return fn(*args)
    calls = []

    def run(*a):
        if not calls:
            calls.append(1)
            return fn(*a)
        _local.recompute = True
        try:
            return fn(*a)
        finally:
            _local.recompute = False

    return checkpoint(run, *args, use_reentrant=False)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and held in fp32."""
    return x.to(torch.bfloat16).float()


def bn_channels_last(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval-mode BatchNorm over the last axis of a channel-last tensor."""
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return (x - bn.running_mean) * scale + bn.bias


@torch.no_grad()
def _update_running(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor) -> None:
    if getattr(_local, "recompute", False):  # the stage ran once already this step
        return
    bn.running_mean.mul_(MOMENTUM).add_(mean, alpha=1.0 - MOMENTUM)
    bn.running_var.mul_(MOMENTUM).add_(var, alpha=1.0 - MOMENTUM)


def batch_norm_train(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Batch-statistics BatchNorm of (N, C, H, W) fp32 ``y``; updates ``bn``'s
    running statistics with the biased variance.

    ``F.batch_norm`` normalizes with the biased variance and, given running
    buffers, blends the unbiased one into them. With momentum 1 into fresh
    buffers it hands back the batch mean and the unbiased variance from its
    own reduction, and n/(n-1) is taken off here.
    """
    C = y.shape[1]
    n = y.numel() // C
    mean = torch.zeros(C, device=y.device)
    var = torch.zeros(C, device=y.device)
    out = F.batch_norm(y, mean, var, bn.weight, bn.bias, True, 1.0, bn.eps)
    _update_running(bn, mean, var * ((n - 1) / n))
    return out


def masked_batch_norm_train(x: torch.Tensor, mask: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Batch-statistics BatchNorm over the last axis of a channel-last fp32
    tensor (N, ..., C) whose statistics count only the rows where ``mask``
    (N,) holds; updates ``bn``'s running statistics.

    As the JAX package's ``MaskedBatchNorm``: ``var = E[x^2] - E[x]^2`` over
    ``sum(mask) * prod(spatial)`` elements, with no clip at 0.
    """
    red = tuple(range(x.dim() - 1))
    m = mask.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
    cnt = m.sum() * float(x[0, ..., 0].numel())
    mean = (x * m).sum(red) / cnt
    var = (x.square() * m).sum(red) / cnt - mean.square()
    _update_running(bn, mean, var)
    return bn.weight * (x - mean) * torch.rsqrt(var + bn.eps) + bn.bias


class ConvBNRelu(nn.Module):
    """k x k conv (no bias, symmetric k//2 padding) -> BatchNorm -> ReLU.

    BatchNorm is eps 1e-5, momentum 0.9 in flax's convention (torch's 0.1).
    """

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, bf16: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = kernel // 2
        self.bf16 = bf16
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.BatchNorm_0 = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)

    def forward(
        self, x: torch.Tensor, store_bf16: bool = False, sample_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """(N, Cin, H, W) -> (N, Cout, H', W'), fp32; bf16 in the bf16 mode
        when ``store_bf16`` is set in eval mode. In training with a
        ``sample_mask`` (N,) the BatchNorm statistics count only the rows
        where it holds (the JAX package's ``masked_bn``: the concatenating
        fusion's projection, over present receivers).

        BatchNorm reads the conv's output (bf16 in the bf16 mode) and
        computes in fp32 with fp32 parameters. With ``store_bf16`` (detection,
        ``pipeline.detect``) the eval-mode bf16 mode stores the result in
        bf16: the next conv, the scorer's dots and the heads cast it to bf16
        anyway, so storing it rounded changes no value they see and halves
        the bytes of every elementwise pass. The one other consumer, the pose
        warp at the fusion layer, then samples bf16 maps, as the JAX package
        does at inference on the TPU. Training ignores the flag; the frozen
        teacher and evaluation leave it off, so the KD taps that the feature
        MSE reads at ``kd_weight`` 1e5 are fp32.
        """
        if self.bf16:
            y = F.conv2d(
                x.to(torch.bfloat16), self.weight.to(torch.bfloat16),
                stride=self.stride, padding=self.padding,
            )
        else:
            y = F.conv2d(x.float(), self.weight, stride=self.stride, padding=self.padding)
        bn = self.BatchNorm_0
        if self.training:
            if sample_mask is not None:  # over the channel-last view, then back
                y = masked_batch_norm_train(y.float().permute(0, 2, 3, 1), sample_mask, bn)
                return F.relu(y.permute(0, 3, 1, 2))
            return F.relu_(batch_norm_train(y.float(), bn))
        if not store_bf16:
            y = y.float()
        y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
        return F.relu_(y)

    def _dot(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """(..., Cin) x (Cout, Cin) -> (..., Cout) with an fp32 accumulator."""
        if self.bf16:
            return _round_bf16(x) @ _round_bf16(w).t()
        return x.float() @ w.t()

    def _bn_relu_last(self, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            return F.relu(masked_batch_norm_train(y, mask, self.BatchNorm_0))
        return F.relu(bn_channels_last(y, self.BatchNorm_0))

    def forward_last(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """1x1 conv on a channel-last (N, ..., Cin) tensor -> (N, ..., Cout),
        fp32; in training the BatchNorm statistics count the rows where
        ``mask`` (N,) holds."""
        y = self._dot(x, self.weight[:, :, 0, 0])
        if self.bf16:  # a natural bf16 conv returns bf16
            y = _round_bf16(y)
        return self._bn_relu_last(y, mask)

    def forward_pair1x1(self, shared: torch.Tensor, per_item: torch.Tensor, mask: torch.Tensor,
                        natural: bool = False) -> torch.Tensor:
        """The 1x1 conv of concat(broadcast(shared), per_item), channel-last.

        ``shared`` (N, h, w, Cs) and ``per_item`` (N*S, h, w, Cp) -> (N*S, h, w, Cout).
        The kernel is split along its input axis, so the shared half projects
        once per group of S rows and the concat is never built. ``mask``
        (N*S,) as in :meth:`forward_last`. The sum stays an fp32 accumulator,
        as the JAX package's ``pair1x1`` mode keeps it; ``natural`` rounds it
        to bf16 in the bf16 mode, as the natural conv of the concat returns it.
        """
        Cs = shared.shape[-1]
        w = self.weight[:, :, 0, 0]
        s_proj = self._dot(shared, w[:, :Cs])
        p_proj = self._dot(per_item, w[:, Cs:])
        N, h, wd, Fo = s_proj.shape
        y = (s_proj[:, None] + p_proj.reshape(N, -1, h, wd, Fo)).reshape(-1, h, wd, Fo)
        if natural and self.bf16:
            y = _round_bf16(y)
        return self._bn_relu_last(y, mask)


class _EncoderStage(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, bf16: bool):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(cin, cout, stride=stride, bf16=bf16)
        self.ConvBNRelu_1 = ConvBNRelu(cout, cout, bf16=bf16)

    def forward(self, x, store_bf16: bool = False):
        return self.ConvBNRelu_1(self.ConvBNRelu_0(x, store_bf16), store_bf16)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of (N, C, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class _DecoderStage(nn.Module):
    """Upsample 2x, concat the skip, two ConvBNRelu."""

    def __init__(self, c_deep: int, c_skip: int, cout: int, bf16: bool):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(c_deep + c_skip, cout, bf16=bf16)
        self.ConvBNRelu_1 = ConvBNRelu(cout, cout, bf16=bf16)

    def forward(self, x, skip, store_bf16: bool = False):
        x = torch.cat([upsample2x(x), skip.to(x.dtype)], dim=1)
        return self.ConvBNRelu_1(self.ConvBNRelu_0(x, store_bf16), store_bf16)


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

    def encode(self, x: torch.Tensor, store_bf16: bool = False, fp32_stage: Optional[int] = None
               ) -> List[torch.Tensor]:
        """All encoder stages; returns the list of stage outputs. Stage
        ``fp32_stage`` stores fp32 whatever ``store_bf16`` says (the fusion
        layer of the models that fuse fp32 maps, ``models/base.py``)."""
        feats = []
        for i in range(len(self.channels)):
            block = getattr(self, f"stages_{i}")
            x = stage(functools.partial(block, store_bf16=store_bf16 and i != fp32_stage), x)
            feats.append(x)
        return feats

    def decode(
        self, feats: Sequence[torch.Tensor], store_bf16: bool = False, head_fp32: bool = False
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Skip decoder over the stage list -> (the (N, head_channels, H, W)
        head input, the KD taps): the taps are the decoder stages' outputs
        coarse to fine, then the head input. ``head_fp32`` stores the head
        input fp32 whatever ``store_bf16`` says (the SegHead reads fp32)."""
        x = feats[-1]
        taps = []
        for i in reversed(range(len(self.channels) - 1)):
            x = stage(functools.partial(getattr(self, f"dec_{i}"), store_bf16=store_bf16), x, feats[i])
            taps.append(x)
        head_in = stage(functools.partial(self.head_conv, store_bf16=store_bf16 and not head_fp32), x)
        taps.append(head_in)
        return head_in, taps


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
        both fp32, the packed (N, H, W, NA*NC + NA*code) tensor in
        ``raw_dtype`` (what the NMS reads) and the same unrounded in fp32
        (what the packed loss trains on)."""
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
        return cls, reg, raw.to(self.raw_dtype), raw


class SegHead(nn.Module):
    """1x1 conv with a bias, per BEV cell -> class logits, fp32 on fp32 input."""

    def __init__(self, cin: int, num_classes: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) -> (N, H, W, num_classes) float32."""
        w = self.Conv_0.weight[:, :, 0, 0]
        return x.permute(0, 2, 3, 1).float() @ w.t() + self.Conv_0.bias


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
