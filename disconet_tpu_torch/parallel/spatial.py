"""Spatial (halo-exchange) sharding of BEV convolutions over ``torch.distributed``.

The port's counterpart of the JAX package's ``parallel/spatial.py``. The BEV
grid's H axis is split into strips, one per rank of a group (the ``spatial``
axis of a ``Mesh``), and around each k x k conv a strip takes its
neighbours' boundary rows:

* :func:`halo_exchange` appends the neighbours' ``halo`` boundary rows to a
  strip (zeros at the grid's first and last edge, SAME-conv zero padding);
  its backward sends the halo rows' cotangents back to the ranks they came
  from and adds them there.
* :func:`conv2d_spatial_sharded` is the SAME stride-1 conv of an H-sharded
  strip: VALID on H over the padded strip, SAME on W; equal to the
  unsharded conv's rows of the strip.
* :func:`sharded_conv_fn` binds it to a mesh axis.

Rows move by an all_reduce of every rank's two boundary strips, each in its
own slot of a zero buffer (:func:`gather_slots`): gloo runs all_reduce on
CUDA tensors as well as CPU ones, and nccl runs it on the card; a sum with
zeros is exact. The stride-2 convs of the STPN read one row from above at
the strip's top (output row i reads input rows 2i-1..2i+1), so they run on
the same padded strip with even strips.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def gather_slots(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, stacked by group rank: (n, *t.shape)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    buf = t.new_zeros((n,) + tuple(t.shape))
    buf[r] = t
    dist.all_reduce(buf, group=group)
    return buf


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, halo, dim):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        L = x.shape[dim]
        if L < halo:
            raise ValueError(f"a strip of {L} rows cannot give a halo of {halo}")
        ctx.group, ctx.halo, ctx.dim = group, halo, dim
        edges = gather_slots(torch.stack([x.narrow(dim, 0, halo), x.narrow(dim, L - halo, halo)]), group)
        zeros = torch.zeros_like(edges[0, 0])
        above = edges[r - 1, 1] if r > 0 else zeros  # rank r-1's last rows
        below = edges[r + 1, 0] if r < n - 1 else zeros  # rank r+1's first rows
        return torch.cat([above, x, below], dim)

    @staticmethod
    def backward(ctx, g):
        group, halo, dim = ctx.group, ctx.halo, ctx.dim
        n, r = dist.get_world_size(group), dist.get_rank(group)
        L = g.shape[dim] - 2 * halo
        sent = gather_slots(torch.stack([g.narrow(dim, 0, halo), g.narrow(dim, halo + L, halo)]), group)
        gx = g.narrow(dim, halo, L).clone()
        if r > 0:  # my first rows were rank r-1's bottom halo
            gx.narrow(dim, 0, halo).add_(sent[r - 1, 1])
        if r < n - 1:  # my last rows were rank r+1's top halo
            gx.narrow(dim, L - halo, halo).add_(sent[r + 1, 0])
        return gx, None, None, None


def halo_exchange(x: torch.Tensor, group, halo: int = 1, dim: int = 2) -> torch.Tensor:
    """A strip (..., L, ...) of an H-sharded tensor, H at ``dim``, with its
    neighbours' boundary rows over ``group`` -> (..., halo + L + halo, ...).
    The group's first and last rank get zero rows at the grid's edges.
    Differentiable: the halo rows' cotangents go back to their ranks."""
    return _HaloExchange.apply(x, group, halo, dim)


def conv2d_spatial_sharded(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """SAME stride-1 conv of an H-sharded (N, Cin, L, W) strip with ``w``
    (Cout, Cin, kh, kw), odd kh and kw: the strip's rows of the unsharded
    conv."""
    kh, kw = w.shape[-2:]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"SAME-conv equivalence needs odd kernels, got {kh}x{kw}")
    xp = halo_exchange(x, group, (kh - 1) // 2)
    return F.conv2d(xp, w, padding=(0, (kw - 1) // 2))  # VALID on H (halos), SAME on W


def sharded_conv_fn(mesh, axis: str = "spatial"):
    """``fn(x, w) -> y`` for this rank's strip ``x`` of a grid H-sharded over
    ``mesh``'s ``axis`` (each rank calls it with its own strip)."""
    group = mesh.group(axis)

    def fn(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return conv2d_spatial_sharded(x, w, group)

    return fn
