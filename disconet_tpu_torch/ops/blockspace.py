"""Block-out rewrites of a 3x3 conv, the JAX package's ``ops/blockspace.py``
in NCHW: the layout its ``Config.block_out`` (on by default) runs decoder
stage 0 in, and decoder stage 1 under ``block_out_dec1``.

Both rewrites emit each 2x2 block of the natural output as 4*Cout channels,
channel ``t * Cout + c`` with tile ``t = 2*a + b`` for the pixel (2p+a, 2q+b)
(:func:`space_to_depth`'s order; ``F.pixel_shuffle`` reads ``c * 4 + t``):

* :func:`conv_block_out`: a stride-1 3x3 conv of a natural map as a stride-2
  4x4 conv (padding 1) whose kernel places the 3x3 taps at each offset;
* :func:`conv_up_block_out`: a stride-1 3x3 conv of the 2x nearest upsample
  of a half-resolution map as a stride-1 3x3 conv of the half-resolution map,
  the taps that fall on the same source pixel summed into one weight.

In exact arithmetic both equal the natural conv. In bf16 they do not: the
kernel transforms run on the fp32 weights, and only then are the operands
rounded, so a summed weight of the up-conv rounds once where the natural conv
rounds each of its two or four taps. The transforms add the taps in the JAX
package's order, so their fp32 results equal its bit for bit; their backward
is a product with the transform's 0/1 matrix, which the card computes in a
fixed order (a gather's backward would add with atomics).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from disconet_tpu_torch.device import exact_products

Conv = Callable[..., torch.Tensor]


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, 4C, H/2, W/2), channel t*C + c with t = 2*dy + dx.
    The result is channels_last in memory."""
    N, C, H, W = x.shape
    y = x.permute(0, 2, 3, 1).reshape(N, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(N, H // 2, W // 2, 4 * C).permute(0, 3, 1, 2)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """(N, 4C, P, Q) -> (N, C, 2P, 2Q), the inverse of :func:`space_to_depth`.
    The result is channels_last in memory."""
    N, C4, P, Q = x.shape
    C = C4 // 4
    y = x.permute(0, 2, 3, 1).reshape(N, P, Q, 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(N, 2 * P, 2 * Q, C).permute(0, 3, 1, 2)


def _block_out_taps() -> Tuple[int, Dict[Tuple[int, int, int], List[int]]]:
    """(window, {(t, row, col): [tap, ...]}) of ``block_out_weights``: the
    JAX loops, tap = 3*(u+1) + (v+1) of the 3x3 kernel."""
    taps: Dict[Tuple[int, int, int], List[int]] = {}
    for a in range(2):
        for b in range(2):
            t = 2 * a + b
            for u in (-1, 0, 1):
                for v in (-1, 0, 1):
                    taps.setdefault((t, a + u + 1, b + v + 1), []).append(3 * (u + 1) + v + 1)
    return 4, taps


def _up_block_out_taps() -> Tuple[int, Dict[Tuple[int, int, int], List[int]]]:
    """As :func:`_block_out_taps` for ``up_block_out_weights``: the taps of
    output (2p+a, 2q+b) land on source rows (a+u)//2 and columns (b+v)//2,
    listed in the order the JAX loops add them."""
    taps: Dict[Tuple[int, int, int], List[int]] = {}
    for a in range(2):
        for b in range(2):
            t = 2 * a + b
            for u in (-1, 0, 1):
                for v in (-1, 0, 1):
                    taps.setdefault((t, (a + u) // 2 + 1, (b + v) // 2 + 1), []).append(3 * (u + 1) + v + 1)
    return 3, taps


_TAPS = {"block_out": _block_out_taps, "up_block_out": _up_block_out_taps}


@functools.lru_cache(maxsize=None)
def _tables(kind: str, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(index (4*k*k, depth) into the 9 taps and a zero at 9, the 0/1 matrix
    (4*k*k, 9) of the transform, k) on ``device``. Built once per device,
    outside any CUDA graph capture (the train steps warm up first), as
    normal tensors even when the first call is under ``inference_mode``
    (the backward saves the matrix)."""
    k, taps = _TAPS[kind]()
    depth = max(len(v) for v in taps.values())
    with torch.inference_mode(False):
        index = torch.full((4, k, k, depth), 9, dtype=torch.int64)
        matrix = torch.zeros(4, k, k, 9, dtype=torch.float32)
        for (t, i, j), lst in taps.items():
            index[t, i, j, : len(lst)] = torch.tensor(lst)
            for tap in lst:
                matrix[t, i, j, tap] += 1.0
        return index.reshape(4 * k * k, depth).to(device), matrix.reshape(4 * k * k, 9).to(device), k


class _TapTransform(torch.autograd.Function):
    """(..., 9) taps -> (..., 4*k*k) transformed kernel entries: each entry
    sums its taps left to right, as the JAX transform's scatter-adds do; the
    backward multiplies by the 0/1 matrix."""

    @staticmethod
    def forward(ctx, taps, index, matrix):
        ctx.save_for_backward(matrix)
        g = torch.cat([taps, taps.new_zeros(taps.shape[:-1] + (1,))], dim=-1)[..., index]
        out = g[..., 0]
        for d in range(1, g.shape[-1]):
            out = out + g[..., d]
        return out

    @staticmethod
    def backward(ctx, grad):
        (matrix,) = ctx.saved_tensors
        with exact_products(grad):
            return grad @ matrix.to(grad.dtype), None, None


def _transform(w: torch.Tensor, kind: str) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (4*Cout, Cin, k, k), output channel t*Cout + c."""
    cout, cin = w.shape[:2]
    index, matrix, k = _tables(kind, w.device)
    out = _TapTransform.apply(w.reshape(cout, cin, 9), index, matrix)  # (Cout, Cin, 4*k*k)
    return out.reshape(cout, cin, 4, k, k).permute(2, 0, 1, 3, 4).reshape(4 * cout, cin, k, k)


def block_out_weights(w: torch.Tensor) -> torch.Tensor:
    """Stride-1 3x3 kernel (Cout, Cin, 3, 3) -> the stride-2 4x4 kernel
    (4*Cout, Cin, 4, 4) of :func:`conv_block_out`: offset (a, b) reads the
    window rows 2p-1+a+u+1, so the 3x3 taps sit at (a, b) in the 4x4 window
    (9 of 16 taps per offset, the rest zero)."""
    return _transform(w, "block_out")


def up_block_out_weights(w: torch.Tensor) -> torch.Tensor:
    """Stride-1 3x3 kernel (Cout, Cin, 3, 3) over a 2x nearest upsample ->
    the stride-1 3x3 kernel (4*Cout, Cin, 3, 3) of :func:`conv_up_block_out`
    on the half-resolution map; taps on the same source pixel are summed in
    the weights' dtype, in the JAX package's order."""
    return _transform(w, "up_block_out")


def conv_block_out(x: torch.Tensor, w: torch.Tensor, conv: Conv = F.conv2d) -> torch.Tensor:
    """The stride-1 3x3 conv (padding 1) of a natural ``x`` (N, Cin, H, W)
    with ``w`` (Cout, Cin, 3, 3) in block layout (N, 4*Cout, H/2, W/2).
    ``conv(x, weight, stride=, padding=)`` computes the conv (the caller's
    arithmetic); the kernel is transformed before it rounds anything."""
    return conv(x, block_out_weights(w), stride=2, padding=1)


def conv_up_block_out(x_lo: torch.Tensor, w: torch.Tensor, conv: Conv = F.conv2d) -> torch.Tensor:
    """The stride-1 3x3 conv (padding 1) of the 2x nearest upsample of
    ``x_lo`` (N, Cin, P, Q) with ``w`` (Cout, Cin, 3, 3), in block layout
    (N, 4*Cout, P, Q); the upsample is never built."""
    return conv(x_lo, up_block_out_weights(w), stride=1, padding=1)
