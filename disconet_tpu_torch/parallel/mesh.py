"""Device mesh and batch sharding over ``torch.distributed``.

The port's counterpart of the JAX package's ``parallel/mesh.py``. There,
GSPMD partitions one program over a mesh of devices; here every rank of a
process group runs the step on its slice of the batch, and the model and
the steps place the collectives that keep the one-process arithmetic:

* ``data`` splits the scenes of a batch, ``agent`` the agents of a scene
  and ``spatial`` the BEV grid's H axis. Rank ``r`` sits at
  ``((d * n_agent) + a) * n_spatial + s``, the row-major order of the JAX
  mesh's device array.
* Parameters, BatchNorm statistics and Adam's state are replicated
  (:func:`replicate_tree` broadcasts them from rank 0); every rank applies
  the same all-reduced gradients.
* Training BatchNorms take their statistics over every rank
  (``models/backbone.py``), the fusion all-gathers the fusion-layer maps
  over ``agent`` and ``spatial`` before the warp (``models/base.py``), a
  3x3 conv of an H-sharded grid exchanges halo rows
  (``parallel/spatial.py``), and the losses' denominators are global
  (``training/det_module.py``).

Every collective is an all_reduce (or a broadcast): gloo runs both on CUDA
tensors as well as CPU ones, nccl on the card. An all_gather is an
all_reduce of each rank's slice in its own slot of a zero buffer, exact;
its backward all-reduces the cotangent and keeps the rank's own slice.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from disconet_tpu_torch.parallel.spatial import gather_slots

AXES = ("data", "agent", "spatial")

# batch fields carrying the BEV H axis at dim 2, shardable over 'spatial'
# (bit-packing touches only the trailing Z axis, so packed grids qualify too)
_SPATIAL_KEYS = frozenset(
    {"bev", "bev_teacher", "bev_packed", "bev_teacher_packed",
     "label_one_hot", "reg_target", "reg_mask", "seg_label"}
)

Spec = Tuple[Optional[str], ...]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, t.shape[dim]
        slots = gather_slots(t, group)  # (n, *t.shape)
        return torch.cat(list(slots.unbind(0)), dim)

    @staticmethod
    def backward(ctx, g):
        full = g.contiguous().clone()
        dist.all_reduce(full, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return full.narrow(ctx.dim, r * ctx.n, ctx.n), None, None


class Mesh:
    """This rank's place in a (data, agent, spatial) mesh of ranks.

    ``shape`` maps each kept axis to its size: ``data`` always, trailing
    size-1 axes dropped as the JAX mesh drops them. ``coords`` gives this
    rank's index on every axis (0 on a dropped one). ``device`` is where the
    rank's tensors live. A mesh built without a process group (``make_mesh``
    with ``rank`` and ``world_size``) lays out batches and has no
    collectives."""

    def __init__(self, shape: Dict[str, int], rank: int, device: torch.device, groups=None):
        self.shape = dict(shape)
        self.rank = rank
        self.device = device
        self._groups = groups
        n_agent, n_spatial = self.axis_size("agent"), self.axis_size("spatial")
        d, rem = divmod(rank, n_agent * n_spatial)
        a, s = divmod(rem, n_spatial)
        self.coords = {"data": d, "agent": a, "spatial": s}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    @property
    def gathers_senders(self) -> bool:
        """Whether the fusion's senders live on other ranks."""
        return self.axis_size("agent") > 1 or self.axis_size("spatial") > 1

    def group(self, axis: str = "world"):
        """The process group of ``axis`` that holds this rank ("world": all)."""
        if self._groups is None:
            raise RuntimeError("this mesh was built without a process group: it has no collectives")
        return self._groups[axis]

    def all_reduce(self, t: torch.Tensor, axis: str = "world") -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axis`` (every rank by
        default), differentiable (its backward sums the cotangents over the
        same ranks); ``t`` itself where the axis has size 1."""
        if axis != "world" and self.axis_size(axis) == 1:
            return t
        return _AllReduce.apply(t, self.group(axis))

    def spatial_mean(self, x: torch.Tensor, dims: Tuple[int, int]) -> torch.Tensor:
        """The mean of ``x`` over ``dims``, its H-sharded rows and its
        columns, over the whole grid: the strip's sums all-reduced over
        ``spatial`` over the global count (every strip has as many rows)."""
        n = self.axis_size("spatial")
        if n == 1:
            return x.mean(dim=dims)
        count = math.prod(x.shape[d] for d in dims) * n
        return self.all_reduce(x.sum(dim=dims), "spatial") / count

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The ranks' ``t`` of ``axis`` concatenated along ``dim`` in axis
        order, differentiable (its backward is a reduce-scatter); ``t``
        itself where the axis has size 1."""
        if self.axis_size(axis) == 1:
            return t
        if t.dtype == torch.bool:
            return _AllGather.apply(t.to(torch.uint8), self.group(axis), dim).bool()
        return _AllGather.apply(t, self.group(axis), dim)

    def local(self, t: torch.Tensor, agent_dim: int = 1, row_dim: int = 2) -> torch.Tensor:
        """This rank's agents and rows of a tensor that every rank holds
        whole, (B, A, H, ...) by default."""
        for axis, dim in (("agent", agent_dim), ("spatial", row_dim)):
            n = self.axis_size(axis)
            if n > 1:
                size = t.shape[dim] // n
                t = t.narrow(dim, self.coords[axis] * size, size)
        return t


def _axis_groups(sizes: Dict[str, int], rank: int) -> Dict[str, object]:
    """One ``dist.new_group`` per line of each axis longer than 1 (every
    rank creates every group, in one order); this rank's line of each."""
    shape = [sizes[a] for a in AXES]
    ranks = np.arange(math.prod(shape)).reshape(shape)
    groups = {"world": dist.group.WORLD}
    for i, axis in enumerate(AXES):
        if shape[i] == 1:
            continue
        lines = np.moveaxis(ranks, i, -1).reshape(-1, shape[i])
        for line in lines:
            g = dist.new_group([int(x) for x in line])
            if rank in line:
                groups[axis] = g
    return groups


def make_mesh(
    n_data: Optional[int] = None,
    n_agent: int = 1,
    n_spatial: int = 1,
    device: Optional[Union[str, torch.device]] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> Mesh:
    """The mesh over the default process group: ``data`` always, plus
    ``agent`` and/or ``spatial`` when sized > 1; ``n_data`` defaults to the
    world size over the other axes, and the axes' product must be the world
    size. ``device``: this rank's (CUDA unless named).

    Without an initialized process group, ``rank`` and ``world_size`` give a
    mesh that only lays out batches (:func:`shard_batch`, no collectives)."""
    from disconet_tpu_torch.device import resolve_device

    with_group = dist.is_available() and dist.is_initialized()
    if with_group:
        rank, world_size = dist.get_rank(), dist.get_world_size()
    elif rank is None or world_size is None:
        raise ValueError("make_mesh needs an initialized process group, or rank and world_size")
    if n_data is None:
        n_data = world_size // (n_agent * n_spatial)
    if n_data * n_agent * n_spatial != world_size:
        raise ValueError(f"mesh {n_data} x {n_agent} x {n_spatial} does not cover a world of {world_size} ranks")
    sizes = {"data": n_data, "agent": n_agent, "spatial": n_spatial}
    shape = [(a, sizes[a]) for a in AXES]
    # trailing size-1 axes stay out of the mesh, as the JAX mesh leaves them
    while len(shape) > 1 and shape[-1][1] == 1:
        shape.pop()
    groups = _axis_groups(sizes, rank) if with_group else None
    return Mesh(dict(shape), rank, resolve_device(device), groups)


def batch_sharding(mesh: Mesh, spatial_dim: Optional[int] = None) -> Spec:
    """The spec of a scene batch: scenes over ``data``, agents over ``agent``
    when sized > 1 and, with ``spatial_dim``, that dimension (the BEV H
    axis) over ``spatial``; trailing unsharded dimensions dropped."""
    n = (spatial_dim + 1) if spatial_dim is not None else 2
    spec: list = [None] * n
    spec[0] = "data"
    if mesh.axis_size("agent") > 1:
        spec[1] = "agent"
    if spatial_dim is not None and mesh.axis_size("spatial") > 1:
        spec[spatial_dim] = "spatial"
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def replicated(mesh: Mesh) -> Spec:
    """The spec of a tensor every rank holds whole."""
    return ()


def _spec_for(arr: np.ndarray, key: str, mesh: Mesh) -> Spec:
    """As the JAX ``shard_batch``: each axis applied only where the
    dimension divides; otherwise the field is replicated there."""
    n_agent, n_spatial = mesh.axis_size("agent"), mesh.axis_size("spatial")
    if arr.ndim < 1 or arr.shape[0] % mesh.axis_size("data") != 0:
        return replicated(mesh)
    spec: list = [None] * min(arr.ndim, 3)
    spec[0] = "data"
    if n_agent > 1 and arr.ndim > 1 and arr.shape[1] % n_agent == 0:
        spec[1] = "agent"
    if n_spatial > 1 and key in _SPATIAL_KEYS and arr.ndim > 2 and arr.shape[2] % n_spatial == 0:
        spec[2] = "spatial"
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _host_fields(batch):
    """(key, array) of the fields that go to the device, as
    ``batch_to_device`` ships them: ragged list fields and, with sparse
    targets, the dense ones left out."""
    from disconet_tpu_torch.training.det_module import _DENSE_TARGET_KEYS, _DEVICE_KEYS

    sparse = "reg_pos_idx" in batch
    for k in _DEVICE_KEYS:
        if k in batch and not isinstance(batch[k], list) and not (sparse and k in _DENSE_TARGET_KEYS):
            yield k, np.asarray(batch[k])


def batch_specs(batch: Dict[str, np.ndarray], mesh: Mesh) -> Dict[str, Spec]:
    """The spec of every field :func:`shard_batch` ships."""
    return {k: _spec_for(arr, k, mesh) for k, arr in _host_fields(batch)}


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh):
    """Host batch -> this rank's slice on ``mesh.device``: scenes over
    ``data``, agents over ``agent``, the BEV H axis of the spatial fields over
    ``spatial`` (:func:`batch_specs`). Binary grids ship bit-packed and the
    sparse path drops the dense targets (``batch_to_device``). The grids
    must split over every axis of the mesh: a field replicated where the
    JAX layout would leave it whole keeps the one-process values there,
    but a replicated grid would be trained on once per rank."""
    from disconet_tpu_torch.training.det_module import batch_to_device

    want = batch_sharding(mesh, 2 if mesh.axis_size("spatial") > 1 else None)
    for k in ("bev", "bev_teacher"):
        # a replicated grid would count its rows once per rank in the steps
        if k in batch and _spec_for(np.asarray(batch[k]), k, mesh) != want:
            raise ValueError(f"{k} {np.shape(batch[k])} does not split over the mesh {mesh.shape}")
    local = {}
    for k, arr in _host_fields(batch):
        for dim, axis in enumerate(_spec_for(arr, k, mesh)):
            if axis is not None:
                n = arr.shape[dim] // mesh.axis_size(axis)
                arr = arr.take(np.arange(mesh.coords[axis] * n, (mesh.coords[axis] + 1) * n), axis=dim)
        local[k] = arr
    return batch_to_device(local, mesh.device)


def _tensors_of(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from itertools.chain(tree.parameters(), tree.buffers())
    elif isinstance(tree, torch.optim.Optimizer):
        for state in tree.state.values():
            yield from (v for v in state.values() if isinstance(v, torch.Tensor))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors_of(v)


@torch.no_grad()
def replicate_tree(tree, mesh: Mesh):
    """Rank 0's values in every tensor of ``tree`` on every rank, in place: a
    module's parameters and buffers, an optimizer's state, or tensors in
    lists, tuples and dicts. Returns ``tree``."""
    for t in _tensors_of(tree):
        buf = t.detach().to(mesh.device)
        dist.broadcast(buf, src=0, group=mesh.group())
        if buf.data_ptr() != t.data_ptr():
            t.copy_(buf)
    return tree


def attach_mesh(module: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Give every submodule of ``module`` that reads a mesh (``ConvBNRelu``,
    the fusion models) ``mesh``; None detaches it. Returns ``module``."""
    for m in module.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh
    return module
