"""Block-space rewrites of a 3x3 conv, the JAX package's ``ops/blockspace.py``
in NCHW. A 2x2 block of the natural map is 4*C channels, channel ``t * C + c``
with tile ``t = 2*a + b`` for the pixel (2p+a, 2q+b) (:func:`space_to_depth`'s
order; ``F.pixel_shuffle`` reads ``c * 4 + t``).

Block-out, the layout the JAX package's ``Config.block_out`` (on by default)
runs decoder stage 0 in, and decoder stage 1 under ``block_out_dec1``: natural
input, block output.

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
fixed order.

Block space, the layout of ``Config.block_space`` (off, as in the JAX
package): encoder stage 0 and decoder stage 0 run on the space-to-depth map.

* :func:`conv_block_s1`: a stride-1 3x3 conv in block space, a 3x3 conv
  (4*Cin -> 4*Cout) whose kernel places each tap where an output offset
  reads it (four places per tap, the rest zero);
* :func:`conv_block_s2`: the stride-2 3x3 conv (padding 1) of the natural
  map as a 2x2 conv of the block map, padded one block row and column low
  only: block input, natural half-resolution output (one place per tap).

Every entry of these kernels is one tap or zero, so the rewrite is exact in
bf16 too. The JAX package rounds the kernel to bf16 before it places the
taps, so XLA's transpose of the placement runs in bf16: each place's
cotangent is rounded to bf16 and the places are added in the reverse of the
order they were set, each partial sum rounded to bf16 but the chain's last
(the first tap set, whose sum XLA's excess precision leaves in fp32 for the
kernel's fp32 cotangent). With ``bf16`` the port's backward does the same
(read off JAX's optimized CPU HLO; bit-identical on the CPU).
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


def _tap_split(o: int, u: int) -> Tuple[int, int]:
    """Pixel offset ``o`` (0/1) and kernel tap ``u`` (-1/0/1) -> (block
    shift, offset in the block), the JAX package's ``_tap_split``."""
    t = o + u
    return (t - t % 2) // 2, t % 2


def _block_s1_places() -> List[Tuple[int, Tuple[int, int, int, int]]]:
    """(tap, (t_out, t_in, row, col)) of ``block_weights_s1`` in the order
    the JAX loops set them; tap = 3*(u+1) + (v+1)."""
    places = []
    for a in range(2):
        for b in range(2):
            for u in (-1, 0, 1):
                s, cy = _tap_split(a, u)
                for v in (-1, 0, 1):
                    r, cx = _tap_split(b, v)
                    places.append((3 * (u + 1) + v + 1, (2 * a + b, 2 * cy + cx, s + 1, r + 1)))
    return places


def _block_s2_places() -> List[Tuple[int, Tuple[int, int, int]]]:
    """As :func:`_block_s1_places` for ``block_weights_s2``: (tap, (t_in,
    row, col))."""
    places = []
    for u in (-1, 0, 1):
        s_u, cy = _tap_split(0, u)
        for v in (-1, 0, 1):
            s_v, cx = _tap_split(0, v)
            places.append((3 * (u + 1) + v + 1, (2 * cy + cx, s_u + 1, s_v + 1)))
    return places


_TAPS = {"block_out": _block_out_taps, "up_block_out": _up_block_out_taps}
# the entry grid of each placement: (t_out, t_in, 3, 3) and (t_in, 2, 2)
_PLACES = {"block_s1": (_block_s1_places, (4, 4, 3, 3)), "block_s2": (_block_s2_places, (4, 2, 2))}


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


@functools.lru_cache(maxsize=None)
def _place_tables(kind: str, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(index (E,) of each kernel entry into the 9 taps and a zero at 9, the
    places (9, n) of each tap in the reverse of the JAX set order, the tap
    set first) on ``device``, built as :func:`_tables` builds its tables."""
    fn, dims = _PLACES[kind]
    places = fn()
    with torch.inference_mode(False):
        index = torch.full(dims, 9, dtype=torch.int64)
        by_tap: Dict[int, List[int]] = {}
        for tap, at in reversed(places):
            index[at] = tap
            flat = 0
            for d, i in zip(dims, at):
                flat = flat * d + i
            by_tap.setdefault(tap, []).append(flat)
        place = torch.tensor([by_tap[t] for t in range(9)], dtype=torch.int64)
        return index.reshape(-1).to(device), place.to(device), places[0][0]


class _PlaceTaps(torch.autograd.Function):
    """(..., 9) taps -> (..., E) kernel entries, each a copy of one tap or 0.
    The backward adds each tap's places in the order of ``place``; with
    ``bf16`` (XLA's transpose of JAX's placement of a bf16 kernel) every
    place and partial sum is rounded to bf16 but the last sum of the tap
    ``first``, else the sums are in the cotangent's dtype."""

    @staticmethod
    def forward(ctx, taps, index, place, first, bf16):
        ctx.save_for_backward(place)
        ctx.first, ctx.bf16 = first, bf16
        return torch.cat([taps, taps.new_zeros(taps.shape[:-1] + (1,))], dim=-1)[..., index]

    @staticmethod
    def backward(ctx, grad):
        (place,) = ctx.saved_tensors
        g = grad[..., place]  # (..., 9, places)
        if ctx.bf16:
            g = g.to(torch.bfloat16)
        n = g.shape[-1]
        acc = g[..., 0]
        for k in range(1, n - 1):
            acc = acc + g[..., k]  # bf16: an fp32 sum rounded, as XLA's CPU adds bf16
        if n == 1:
            return acc.to(grad.dtype), None, None, None, None
        out = (acc + g[..., -1]).to(grad.dtype)
        out[..., ctx.first] = acc[..., ctx.first].to(grad.dtype) + g[..., ctx.first, -1].to(grad.dtype)
        return out, None, None, None, None


def _place(w: torch.Tensor, kind: str, bf16: bool) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the kernel entries (Cout, Cin, *dims) of ``kind``."""
    cout, cin = w.shape[:2]
    index, place, first = _place_tables(kind, w.device)
    out = _PlaceTaps.apply(w.reshape(cout, cin, 9), index, place, first, bf16)
    return out.reshape((cout, cin) + _PLACES[kind][1])


def block_weights_s1(w: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Stride-1 3x3 kernel (Cout, Cin, 3, 3) -> the block-space kernel
    (4*Cout, 4*Cin, 3, 3) of :func:`conv_block_s1`: output offset (a, b)
    reads tap (u, v) from block (s, r) = the shift of a+u, b+v at the input
    offset of their remainder (JAX's ``block_weights_s1``). ``bf16``: the
    backward of a bf16 kernel's placement (see the module docstring)."""
    cout, cin = w.shape[:2]
    e = _place(w, "block_s1", bf16)  # (Cout, Cin, t_out, t_in, 3, 3)
    return e.permute(2, 0, 3, 1, 4, 5).reshape(4 * cout, 4 * cin, 3, 3)


def block_weights_s2(w: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Stride-2 3x3 kernel (Cout, Cin, 3, 3) -> (Cout, 4*Cin, 2, 2) of
    :func:`conv_block_s2`: output pixel p reads input pixels 2p-1..2p+1,
    the blocks p-1 (offset 1) and p (offsets 0, 1)."""
    cout, cin = w.shape[:2]
    e = _place(w, "block_s2", bf16)  # (Cout, Cin, t_in, 2, 2)
    return e.permute(0, 2, 1, 3, 4).reshape(cout, 4 * cin, 2, 2)


def conv_block_s1(x: torch.Tensor, w: torch.Tensor, conv: Conv = F.conv2d, bf16: bool = False) -> torch.Tensor:
    """The stride-1 3x3 conv (padding 1) in block space: ``x`` (N, 4*Cin, P,
    Q), ``w`` (Cout, Cin, 3, 3) -> (N, 4*Cout, P, Q), equal to
    space_to_depth(conv(depth_to_space(x), w)). ``conv`` as in
    :func:`conv_block_out`."""
    return conv(x, block_weights_s1(w, bf16), stride=1, padding=1)


def conv_block_s2(x: torch.Tensor, w: torch.Tensor, conv: Conv = F.conv2d, bf16: bool = False) -> torch.Tensor:
    """The stride-2 3x3 conv (padding 1) of depth_to_space(x): ``x`` (N,
    4*Cin, P, Q), ``w`` (Cout, Cin, 3, 3) -> natural (N, Cout, P, Q). The 2x2
    conv pads one block row and column low only; it runs padded by one on
    every side and drops its last row and column, which read the padding
    (or, on an H-sharded strip, the halo row from below) alone."""
    return conv(x, block_weights_s2(w, bf16), stride=1, padding=1)[:, :, :-1, :-1]


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
