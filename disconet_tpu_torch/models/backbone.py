"""STPN backbone and detection heads.

The conv stack runs NCHW tensors in the channels_last memory format, so the
head input's (N, H, W, C) view is free and the fusion layer's maps can be
handled channel-last without copies.

``compute_dtype`` "bfloat16" computes every conv and dot of training and
evaluation as the JAX package's bf16 mode compiles under XLA: the operands are
rounded to bf16 (round to nearest even), the products are exact, the
accumulator and the result are fp32. XLA keeps each bf16 conv's result in
fp32 (``xla_allow_excess_precision`` folds the convert that follows it), and
in the backward it rounds the incoming cotangent to bf16 as an operand of the
dgrad and wgrad, whose results stay fp32 too. The conv is
:func:`conv2d_bf16_operands`; on the card it runs on TF32 tensor cores, which
are exact on bf16-rounded operands. The dots of the fusion scorer and the
detection heads round their operands (:func:`_round_bf16`) and multiply in
fp32; their backward feeds the cotangent on unrounded, as XLA's transpose of
the operand convert does. "float32" is the exact mode.

Inference keeps a deliberate difference: with ``store_bf16`` in eval mode
(``pipeline.predict`` and the predict steps) a conv runs in bf16 on cuDNN and
its ConvBNRelu stores bf16 (see ``ConvBNRelu.forward``); the precision of
inference does not move the detections' mAP, and this path halves the bytes
of ``predict``'s elementwise passes.

Decoder stage 0 (and stage 1 under ``block_out_dec1``) runs in the JAX
package's default block-out layout (``config.block_out``,
``ops/blockspace.py``): its first conv as an up-conv of the half-resolution
map plus a stride-2 4x4 conv of the skip, its second as a stride-2 4x4 conv,
each emitting 2x2 output blocks as channels. The kernels are transformed in
fp32 before the operands round, so a bf16 step computes what the JAX
package's does; XLA rounds each conv of the pair's sum to bf16 and adds in
fp32, and the port does the same. The parameters and ``state_dict`` keys are
the natural layout's.

``config.block_space`` runs encoder stage 0 and decoder stage 0 on the
space-to-depth map instead (``STPN.encode``/``decode``): stage 0's convs as
block-space 3x3 convs, stage 1's stride-2 conv as a 2x2 conv from the blocks
to the natural map, decoder stage 0 on the half-resolution map broadcast to
the four offsets beside the block skip. Their BatchNorms reduce over the four
offsets, so the statistics and parameters are the natural layer's. A
block-space kernel places taps and sums none, so the bf16 forward is the
natural one's; the kernel's backward sums a tap's four places in bf16, as
XLA's transpose of the JAX package's placement does (``ops/blockspace.py``).

The other models reach these convs through ``ConvBNRelu``: the UNet's blocks,
When2com's handshake encoders, ``cat``'s projection and ``agent``'s scorer
(the JAX modules cast to ``compute_dtype`` there). DiscoNet's scorer's last
1x1 conv, V2VNet's message conv and ConvGRU and the ``SegHead`` stay fp32, as
the JAX modules do.

Under a device mesh (``disconet_tpu_torch.parallel``, attached with
``parallel.attach_mesh``) the training BatchNorms take their statistics over
every rank's rows (one all_reduce of the per-channel sum, sum of squares and
count), and with an H-sharded grid every 3x3 conv reads its neighbours'
boundary rows (``parallel.halo_exchange``), so a sharded step computes the
one-process step.

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
from disconet_tpu_torch.ops.blockspace import (
    conv_block_out,
    conv_block_s1,
    conv_block_s2,
    conv_up_block_out,
    depth_to_space,
    space_to_depth,
)
from disconet_tpu_torch.parallel.spatial import halo_exchange

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


class _RoundBF16(torch.autograd.Function):
    """x rounded to bf16 and held in fp32; the backward passes the cotangent
    on as it is (XLA's transpose of an f32 -> bf16 operand convert)."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and held in fp32 (an operand of an fp32 product)."""
    return _RoundBF16.apply(x)


@contextlib.contextmanager
def _tf32_convs(t: torch.Tensor):
    """cuDNN convs of fp32 tensors on TF32 tensor cores within the block, for
    a CUDA ``t``: exact on bf16-rounded operands (their low 16 mantissa bits
    are zero), so the products are the bf16 products at TF32's rate. The
    global flag ``build_model`` sets is put back after."""
    if t.device.type != "cuda":
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Conv2dBF16Operands(torch.autograd.Function):
    """The conv of :func:`conv2d_bf16_operands`. The rounded operands are
    saved as bf16 (half the bytes of fp32) and widened again in the
    backward."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.stride, ctx.padding = stride, padding
        with _tf32_convs(x):
            return F.conv2d(xb.float(), wb.float(), stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gr = g.to(torch.bfloat16).float()
        stride = (ctx.stride,) * 2 if isinstance(ctx.stride, int) else tuple(ctx.stride)
        padding = (ctx.padding,) * 2 if isinstance(ctx.padding, int) else tuple(ctx.padding)
        with _tf32_convs(g):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gr, xb.float(), wb.float(), None, stride, padding, (1, 1), False, (0, 0), 1,
                (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False),
            )
        return gx, gw, None, None


def conv2d_bf16_operands(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """``F.conv2d`` of ``x`` and ``w`` rounded to bf16, exact products, an
    fp32 accumulator and an fp32 result: the JAX package's bf16 conv as XLA
    compiles it. The backward rounds the incoming cotangent to bf16 and
    returns the input and weight gradients in fp32. No host sync, so a CUDA
    graph captures it; ``torch.utils.checkpoint`` recomputes it."""
    return _Conv2dBF16Operands.apply(x, w, stride, padding)


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


def _global_moments(x_sum: torch.Tensor, sq_sum: torch.Tensor, count: torch.Tensor, mesh):
    """(E[x], E[x^2]) per channel over every rank of ``mesh``: one all_reduce
    of the local sums and count, differentiable."""
    C = x_sum.shape[0]
    tot = mesh.all_reduce(torch.cat([x_sum, sq_sum, count.reshape(1).to(x_sum.dtype)]))
    return tot[:C] / tot[-1], tot[C : 2 * C] / tot[-1]


def batch_norm_train(y: torch.Tensor, bn: nn.BatchNorm2d, mesh=None) -> torch.Tensor:
    """Batch-statistics BatchNorm of (N, C, ...) fp32 ``y`` (the block layout's
    (N, C, 4, P, Q) view too); updates ``bn``'s running statistics with the
    biased variance.

    ``F.batch_norm`` normalizes with the biased variance and, given running
    buffers, blends the unbiased one into them. With momentum 1 into fresh
    buffers it hands back the batch mean and the unbiased variance from its
    own reduction, and n/(n-1) is taken off here.

    Under a ``mesh`` the statistics are over every rank's rows, as flax
    computes them: ``var = max(0, E[x^2] - E[x]^2)``.
    """
    C = y.shape[1]
    if mesh is not None:
        red = (0,) + tuple(range(2, y.dim()))
        mean, ex2 = _global_moments(y.sum(red), y.square().sum(red), y.new_tensor(y.numel() // C), mesh)
        var = torch.clamp(ex2 - mean.square(), min=0.0)
        _update_running(bn, mean, var)
        per_c = (C,) + (1,) * (y.dim() - 2)
        scale = (bn.weight * torch.rsqrt(var + bn.eps)).reshape(per_c)
        return (y - mean.reshape(per_c)) * scale + bn.bias.reshape(per_c)
    n = y.numel() // C
    mean = torch.zeros(C, device=y.device)
    var = torch.zeros(C, device=y.device)
    out = F.batch_norm(y, mean, var, bn.weight, bn.bias, True, 1.0, bn.eps)
    _update_running(bn, mean, var * ((n - 1) / n))
    return out


def masked_batch_norm_train(x: torch.Tensor, mask: torch.Tensor, bn: nn.BatchNorm2d, mesh=None) -> torch.Tensor:
    """Batch-statistics BatchNorm over the last axis of a channel-last fp32
    tensor (N, ..., C) whose statistics count only the rows where ``mask``
    (N,) holds; updates ``bn``'s running statistics.

    As the JAX package's ``MaskedBatchNorm``: ``var = E[x^2] - E[x]^2`` over
    ``sum(mask) * prod(spatial)`` elements, with no clip at 0; under a
    ``mesh`` the sums and the count are over every rank.
    """
    red = tuple(range(x.dim() - 1))
    m = mask.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
    cnt = m.sum() * float(x[0, ..., 0].numel())
    if mesh is not None:
        mean, ex2 = _global_moments((x * m).sum(red), (x.square() * m).sum(red), cnt, mesh)
        var = ex2 - mean.square()
    else:
        mean = (x * m).sum(red) / cnt
        var = (x.square() * m).sum(red) / cnt - mean.square()
    _update_running(bn, mean, var)
    return bn.weight * (x - mean) * torch.rsqrt(var + bn.eps) + bn.bias


class ConvBNRelu(nn.Module):
    """k x k conv (no bias, symmetric k//2 padding) -> BatchNorm -> ReLU.

    BatchNorm is eps 1e-5, momentum 0.9 in flax's convention (torch's 0.1).
    ``mesh`` (None, or a ``parallel.Mesh`` set by ``parallel.attach_mesh``)
    makes the training statistics global and, with a spatial axis, exchanges
    halo rows around the k x k conv.

    ``forward``'s ``mode`` selects the conv's layout, as the JAX module's:
    "natural"; "block_out", the 3x3 conv as ``conv_block_out``;
    "block_out_pair", ``x`` = (x_lo, skip) and the 3x3 conv of
    cat(upsample2x(x_lo), skip) as ``conv_up_block_out(x_lo)`` +
    ``conv_block_out(skip)`` with the kernel split along its input axis. The
    block outputs go back to the natural layout before the BatchNorm, whose
    statistics cover the same pixels either way. "block": block input
    (N, 4*Cin, P, Q) and output (N, 4*Cout, P, Q), ``conv_block_s1``, the
    BatchNorm over the four offsets of each channel; "block_to_natural": the
    stride-2 conv of a block input, ``conv_block_s2``, natural output.
    """

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, bf16: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = kernel // 2
        self.bf16 = bf16
        self.mesh = None
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.BatchNorm_0 = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)

    def _conv(self, x: torch.Tensor, store_bf16: bool, weight: Optional[torch.Tensor] = None,
              stride: Optional[int] = None, padding: Optional[int] = None) -> torch.Tensor:
        """The layer's k x k conv in the compute mode, or ``weight`` at
        ``stride`` and ``padding`` (a block-out kernel). On an H-sharded grid
        the strip takes ``padding`` rows from each neighbour (zeros at the
        grid's edges) and the conv pads W only."""
        w = self.weight if weight is None else weight
        stride = self.stride if stride is None else stride
        padding = self.padding if padding is None else padding
        if padding and self.mesh is not None and self.mesh.axis_size("spatial") > 1:
            if stride == 2 and x.shape[2] % 2:
                raise ValueError(f"a stride-2 conv of an H-sharded grid needs even strips, got {x.shape[2]} rows")
            x = halo_exchange(x, self.mesh.group("spatial"), padding)
            padding = (0, padding)
        if not self.bf16:
            return F.conv2d(x.float(), w, stride=stride, padding=padding)
        if store_bf16 and not self.training:  # inference: cuDNN's bf16 conv, bf16 out
            return F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), stride=stride, padding=padding)
        return conv2d_bf16_operands(x, w, stride, padding)

    def _layout_conv(self, x, store_bf16: bool, mode: str) -> torch.Tensor:
        """The conv of ``forward`` in ``mode``'s layout, natural out."""
        if mode == "natural":
            return self._conv(x, store_bf16)
        conv = lambda t, w, stride, padding: self._conv(t, store_bf16, w, stride, padding)  # noqa: E731
        if mode == "block_out":
            return depth_to_space(conv_block_out(x, self.weight, conv))
        if mode == "block":
            return conv_block_s1(x, self.weight, conv, bf16=self.bf16)
        if mode == "block_to_natural":
            return conv_block_s2(x, self.weight, conv, bf16=self.bf16)
        if mode != "block_out_pair":
            raise ValueError(f"unknown conv layout {mode!r}")
        x_lo, skip = x
        c_lo = x_lo.shape[1]
        y = conv_up_block_out(x_lo, self.weight[:, :c_lo], conv)
        z = conv_block_out(skip, self.weight[:, c_lo:], conv)
        if self.bf16 and not (store_bf16 and not self.training):
            y, z = _round_bf16(y), _round_bf16(z)  # as XLA keeps the pair's convs
        return depth_to_space(y + z)

    def forward(
        self, x, store_bf16: bool = False, sample_mask: Optional[torch.Tensor] = None, mode: str = "natural"
    ) -> torch.Tensor:
        """(N, Cin, H, W) -> (N, Cout, H', W'), fp32; bf16 in the bf16 mode
        when ``store_bf16`` is set in eval mode. In training with a
        ``sample_mask`` (N,) the BatchNorm statistics count only the rows
        where it holds (the JAX package's ``masked_bn``: the concatenating
        fusion's projection, over present receivers).

        BatchNorm computes in fp32 with fp32 parameters on the conv's fp32
        result. With ``store_bf16`` (detection, ``pipeline.detect``) the
        eval-mode bf16 mode runs the conv in bf16 and stores the result in
        bf16: the next conv, the scorer's dots and the heads cast it to bf16
        anyway, so storing it rounded changes no value they see and halves
        the bytes of every elementwise pass. The one other consumer, the pose
        warp at the fusion layer, then samples bf16 maps, as the JAX package
        does at inference on the TPU. Training ignores the flag; the frozen
        teacher and evaluation leave it off, so the KD taps that the feature
        MSE reads at ``kd_weight`` 1e5 are fp32.
        """
        y = self._layout_conv(x, store_bf16, mode)
        if mode == "block":  # (N, 4C, P, Q) as (N, C, 4, P, Q): each channel's four offsets
            N, C4, P, Q = y.shape
            z = self._bn_relu(y.reshape(N, 4, C4 // 4, P, Q).transpose(1, 2), sample_mask)
            return z.transpose(1, 2).reshape(N, C4, P, Q)
        return self._bn_relu(y, sample_mask)

    def _bn_relu(self, y: torch.Tensor, sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """BatchNorm and ReLU of the conv's (N, C, ...) result (``forward``)."""
        bn = self.BatchNorm_0
        if self.training:
            if sample_mask is not None:  # over the channel-last view, then back
                y = masked_batch_norm_train(y.permute(0, 2, 3, 1), sample_mask, bn, mesh=self.mesh)
                return F.relu(y.permute(0, 3, 1, 2))
            return F.relu_(batch_norm_train(y, bn, mesh=self.mesh))
        y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
        return F.relu_(y)

    def _dot(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """(..., Cin) x (Cout, Cin) -> (..., Cout) with an fp32 accumulator."""
        if self.bf16:
            return _round_bf16(x) @ _round_bf16(w).t()
        return x.float() @ w.t()

    def _bn_relu_last(self, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            return F.relu(masked_batch_norm_train(y, mask, self.BatchNorm_0, mesh=self.mesh))
        return F.relu(bn_channels_last(y, self.BatchNorm_0))

    def forward_last(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """1x1 conv on a channel-last (N, ..., Cin) tensor -> (N, ..., Cout),
        fp32; in training the BatchNorm statistics count the rows where
        ``mask`` (N,) holds."""
        return self._bn_relu_last(self._dot(x, self.weight[:, :, 0, 0]), mask)

    def forward_pair1x1(self, shared: torch.Tensor, per_item: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The 1x1 conv of concat(broadcast(shared), per_item), channel-last.

        ``shared`` (N, h, w, Cs) and ``per_item`` (N*S, h, w, Cp) -> (N*S, h, w, Cout).
        The kernel is split along its input axis, so the shared half projects
        once per group of S rows and the concat is never built. ``mask``
        (N*S,) as in :meth:`forward_last`. The sum stays an fp32 accumulator,
        as XLA keeps the JAX package's ``pair1x1`` dots and natural 1x1 convs.
        """
        Cs = shared.shape[-1]
        w = self.weight[:, :, 0, 0]
        s_proj = self._dot(shared, w[:, :Cs])
        p_proj = self._dot(per_item, w[:, Cs:])
        N, h, wd, Fo = s_proj.shape
        y = (s_proj[:, None] + p_proj.reshape(N, -1, h, wd, Fo)).reshape(-1, h, wd, Fo)
        return self._bn_relu_last(y, mask)


class _EncoderStage(nn.Module):
    """Two ConvBNRelu; ``mode`` applies to both ("natural", "block" or
    "block_out", the JAX module's), and ``transition`` makes the first
    (stride-2) conv read block space and write the natural map (the stage
    after a block-space stage 0)."""

    def __init__(self, cin: int, cout: int, stride: int, bf16: bool):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(cin, cout, stride=stride, bf16=bf16)
        self.ConvBNRelu_1 = ConvBNRelu(cout, cout, bf16=bf16)

    def forward(self, x, store_bf16: bool = False, mode: str = "natural", transition: bool = False):
        first = "block_to_natural" if transition else mode
        x = self.ConvBNRelu_0(x, store_bf16, mode=first)
        return self.ConvBNRelu_1(x, store_bf16, mode="natural" if transition else mode)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of (N, C, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class _DecoderStage(nn.Module):
    """Upsample 2x, concat the skip, two ConvBNRelu. ``mode`` "block_out":
    the same convs in the block-out layout (the upsample and the concat are
    never built); "block": the skip is in block space, the half-resolution
    ``x`` is broadcast to the four offsets and concatenated with each
    offset's skip channels (the upsample of a block is one source pixel),
    and both convs run in block space; the output stays in block space."""

    def __init__(self, c_deep: int, c_skip: int, cout: int, bf16: bool):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(c_deep + c_skip, cout, bf16=bf16)
        self.ConvBNRelu_1 = ConvBNRelu(cout, cout, bf16=bf16)

    def forward(self, x, skip, store_bf16: bool = False, mode: str = "natural"):
        if mode == "block_out":
            y = self.ConvBNRelu_0((x, skip), store_bf16, mode="block_out_pair")
            return self.ConvBNRelu_1(y, store_bf16, mode="block_out")
        if mode == "block":
            N, Cx, P, Q = x.shape
            xb = x.permute(0, 2, 3, 1)[:, :, :, None, :].expand(N, P, Q, 4, Cx)
            sb = skip.to(x.dtype).permute(0, 2, 3, 1).reshape(N, P, Q, 4, -1)
            x = torch.cat([xb, sb], dim=-1).reshape(N, P, Q, -1).permute(0, 3, 1, 2)
        else:
            x = torch.cat([upsample2x(x), skip.to(x.dtype)], dim=1)
        return self.ConvBNRelu_1(self.ConvBNRelu_0(x, store_bf16, mode=mode), store_bf16, mode=mode)


class STPN(nn.Module):
    """Staged encoder (strides 1, 2, 4, 8, 16) and skip decoder to the head
    map. ``block_out`` runs decoder stage 0 in the block-out layout, and
    stage 1 too with ``block_out_dec1`` (the JAX ``STPN.decode_step``);
    ``block_out_encoder`` encoder stage 0 too. ``block_space`` runs encoder
    stage 0 and decoder stage 0 in block space: the input is
    space-to-depth'ed once, ``feats[0]`` is block-shaped (N, 4*C0, H/2,
    W/2), and decoder stage 0's output goes back by one depth-to-space. It
    rewrites the convs that the block-out modes do, so it excludes them.
    ``head_in_dtype`` "bfloat16" stores the head input in bf16."""

    def __init__(self, in_channels: int, channels: Sequence[int], head_channels: int, bf16: bool,
                 block_out: bool = False, block_out_dec1: bool = False, block_space: bool = False,
                 block_out_encoder: bool = False, head_in_dtype: str = "float32"):
        super().__init__()
        if block_space and (block_out or block_out_encoder):
            raise ValueError("block_space and block_out are alternative rewrites of the same stage-0 convs; "
                             "enable at most one")
        self.channels = tuple(channels)
        self.block_out = block_out
        self.block_out_dec1 = block_out_dec1
        self.block_space = block_space
        self.block_out_encoder = block_out_encoder
        self.head_in_dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[head_in_dtype]
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
            kw = {}
            if self.block_space and i == 0:
                x, kw = space_to_depth(x), {"mode": "block"}
            elif self.block_space and i == 1:
                kw = {"transition": True}
            elif self.block_out_encoder and i == 0:
                kw = {"mode": "block_out"}
            block = getattr(self, f"stages_{i}")
            x = stage(functools.partial(block, store_bf16=store_bf16 and i != fp32_stage, **kw), x)
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
            mode = "natural"
            if self.block_space and i == 0:
                mode = "block"
            elif self.block_out and (i == 0 or (i == 1 and self.block_out_dec1)):
                mode = "block_out"
            dec = functools.partial(getattr(self, f"dec_{i}"), store_bf16=store_bf16, mode=mode)
            x = stage(dec, x, feats[i])
            if mode == "block":
                x = depth_to_space(x)
            taps.append(x)
        head_in = stage(functools.partial(self.head_conv, store_bf16=store_bf16 and not head_fp32), x)
        if self.head_in_dtype != torch.float32:
            head_in = head_in.to(self.head_in_dtype)
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


def make_stpn(config: Config, allow_block: bool = True) -> STPN:
    """The config's STPN. ``allow_block`` False keeps the natural layout
    where ``config.block_space`` asks for block space (fusion at layer 0,
    whose fused map must be addressable by space); an explicit
    ``block_space`` turns the block-out modes off (they rewrite the same
    convs), as the JAX ``make_stpn`` does."""
    block_space = allow_block and config.block_space
    return STPN(
        config.bev_shape[2], config.backbone_channels, config.head_channels,
        bf16=config.compute_dtype == "bfloat16",
        block_out=config.block_out and not block_space,
        block_out_dec1=config.block_out_dec1 and not block_space,
        block_space=block_space, head_in_dtype=config.head_in_dtype,
    )


def make_heads(config: Config) -> DetectionHeads:
    return DetectionHeads(
        config.head_channels, config.num_anchors, config.num_classes, config.box_code_size,
        bf16=config.compute_dtype == "bfloat16",
        raw_dtype={"bfloat16": torch.bfloat16, "float32": torch.float32}[config.head_raw_dtype],
    )
