"""The arithmetic of the reference, and of its control.

The reference computes in float32 with TF32 off. The control is the same
reference one precision step lower than the configuration states, the step
that would tempt a later change: where the configuration computes in
bfloat16 (its convs and dots, ``compute_dtype``), the control computes them
as fp8 training does (both operands in e4m3, the incoming gradient in e5m2,
one scale per tensor; products and sums in float32); where it computes in
float32 (V2VNet's fusion), in bfloat16 the same way. Convs
(:meth:`Precision.conv`) and plain products (:meth:`Precision.matmul`,
:meth:`Precision.linear`: an attention's projections, its QK^T and PV)
round alike. A second control,
``control_fusion``, lowers only what the configuration computes in float32
and keeps the rest exact: V2VNet's fusion alone in bfloat16.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0


def round_to(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` rounded to ``kind`` ("bf16", "e4m3" or "e5m2"; fp8 with one
    scale per tensor) and held in float32."""
    if kind == "bf16":
        return x.to(torch.bfloat16).float()
    dtype, top = (torch.float8_e4m3fn, FP8_MAX) if kind == "e4m3" else (torch.float8_e5m2, FP8_E5M2_MAX)
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Round(torch.autograd.Function):
    """An operand rounded in the forward (e4m3 for fp8); the gradient
    passes through."""

    @staticmethod
    def forward(ctx, x, kind):
        return round_to(x, "e4m3" if kind == "fp8" else kind)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """The identity; the gradient arriving at a product's output rounded."""

    @staticmethod
    def forward(ctx, y, kind):
        ctx.kind = kind
        return y

    @staticmethod
    def backward(ctx, g):
        return round_to(g, "e5m2" if ctx.kind == "fp8" else ctx.kind), None


class Precision:
    """``mode`` "reference" (float32), "control" or "control_fusion"."""

    def __init__(self, mode: str = "reference"):
        if mode not in ("reference", "control", "control_fusion"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def _kind(self, stated: str):
        """The rounding of a product that the configuration computes in
        ``stated`` ("bfloat16" or "float32"): None where it stays exact."""
        if self.mode == "reference" or (self.mode == "control_fusion" and stated != "float32"):
            return None
        return "fp8" if stated == "bfloat16" else "bf16"

    @staticmethod
    def _rounded(product, k, *operands):
        """``product`` of the operands rounded to ``k``, the gradient that
        reaches it rounded before it is used."""
        return _RoundGrad.apply(product(*(_Round.apply(a, k) for a in operands)), k)

    def conv(self, x, w, b=None, stride=1, padding=0, stated="bfloat16"):
        """The conv of a layer that the configuration computes in ``stated``
        ("bfloat16" or "float32")."""
        k = self._kind(stated)
        if k is None:
            return F.conv2d(x, w, b, stride, padding)
        y = self._rounded(lambda x, w: F.conv2d(x, w, None, stride, padding), k, x, w)
        return y if b is None else y + b.reshape(1, -1, 1, 1)

    def matmul(self, a, b, stated="bfloat16"):
        """``a @ b`` (batched as ``torch.matmul``) of a layer that the
        configuration computes in ``stated``."""
        k = self._kind(stated)
        return a @ b if k is None else self._rounded(torch.matmul, k, a, b)

    def linear(self, x, w, b=None, stated="bfloat16"):
        """``x @ w.T + b`` (``F.linear``) of a layer that the configuration
        computes in ``stated``."""
        k = self._kind(stated)
        if k is None:
            return F.linear(x, w, b)
        y = self._rounded(F.linear, k, x, w)
        return y if b is None else y + b


@contextlib.contextmanager
def exact_float32():
    """No TF32 in convs and products within the block; the switches are put back after."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = m.allow_tf32, c.allow_tf32
    m.allow_tf32, c.allow_tf32 = False, False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = prev
