"""Detection training, evaluation and prediction steps of the port.

The JAX package's steps are pure jitted functions of a train state. Here the
model holds its parameters and BatchNorm running statistics, a
``torch.optim.Adam`` holds the moments, and each builder returns a step
function over a device batch:

* ``train_step(batch)``: with KD, the frozen teacher's forward (eval mode,
  no graph) on ``bev_teacher``, or the batch's rows of the teacher's
  precomputed taps (:func:`precompute_teacher_feats`, gathered by
  ``frame_idx``); the student's training forward, which
  updates its BatchNorm running statistics; focal + smooth-L1 (+ kd_weight x
  the KD feature MSE); backward; one Adam step. Returns the metrics
  ``loss``, ``cls_loss``, ``reg_loss``, (``kd_loss``) and ``grad_norm`` as
  0-dim device tensors, so a step does not wait for the device.
* ``eval_step(batch)``: the eval-mode forward and the losses.
* ``predict_step(batch)``: the eval-mode forward, the scores and the rotated
  NMS (per class when ``num_classes`` > 2), keep masked by ``agent_mask``.

Absent agents are out of the classification loss, the regression mask and the
KD loss; the fusion's sender softmax masks them separately.

:func:`prefetch_to_device` copies host batches to the card ahead of the
steps, and :func:`pipeline_one_deep` dispatches batch n+1 before batch n's
outputs are fetched, for the evaluation loop.
"""

from __future__ import annotations

import functools
import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.device import resolve_device
from disconet_tpu_torch.ops.bitpack import pack_bev_np, unpack_bev
from disconet_tpu_torch.models.backbone import remat_stages
from disconet_tpu_torch.models.faf_net import TeacherNet
from disconet_tpu_torch.ops.boxes import make_anchors
from disconet_tpu_torch.ops.losses import (
    kd_feature_loss,
    packed_det_losses,
    softmax_focal_loss,
    weighted_smooth_l1,
)
from disconet_tpu_torch.ops.nms import multiclass_nms_decode
from disconet_tpu_torch.parallel.mesh import attach_mesh, replicate_tree
from disconet_tpu_torch.pipeline import detect
from disconet_tpu_torch.utils import profiling

Batch = Dict[str, torch.Tensor]

_DEVICE_KEYS = (
    "bev",
    "bev_teacher",
    "bev_packed",
    "bev_teacher_packed",
    "label_one_hot",
    "reg_target",
    "reg_mask",
    "reg_pos_idx",
    "reg_pos_target",
    "reg_pos_cls",
    "trans",
    "agent_mask",
    "frame_idx",
    "seg_label",
)
# the dense targets are redundant when the sparse encoding is present
_DENSE_TARGET_KEYS = ("label_one_hot", "reg_target", "reg_mask")
# binary grids ship bit-packed over z; the steps unpack on the device
_PACK_KEYS = ("bev", "bev_teacher")


def get_bev(batch: Batch, key: str, config: Config) -> torch.Tensor:
    """The BEV grid ``key`` of a device batch, unpacked from ``key_packed``
    unless the dense ``key`` is there (the dense entry wins)."""
    if key in batch:
        return batch[key]
    return unpack_bev(batch[key + "_packed"], config.bev_shape[-1])


def get_bev_np(batch: Dict[str, np.ndarray], key: str, config: Config) -> np.ndarray:
    """:func:`get_bev` of a host batch: the dense (B, A, H, W, Z) uint8 grid."""
    if key in batch:
        return batch[key]
    return unpack_bev(torch.from_numpy(batch[key + "_packed"]), config.bev_shape[-1]).numpy()


def batch_to_device(
    batch: Dict[str, np.ndarray], device: Optional[Union[str, torch.device]] = None
) -> Batch:
    """Host batch of numpy arrays -> tensors on ``device`` (CUDA unless the
    caller names another). uint8/bool BEV grids ship bit-packed; the dense
    targets are left out when the sparse ones are there.

    To the card each array goes through pinned memory as an asynchronous
    copy on the current stream: the host returns before the bytes land, and
    work queued after it on that stream sees them."""
    dev = resolve_device(device)
    sparse = "reg_pos_idx" in batch
    out = {}
    for k in _DEVICE_KEYS:
        if k not in batch or (sparse and k in _DENSE_TARGET_KEYS):
            continue
        arr, key = np.asarray(batch[k]), k
        if k in _PACK_KEYS and arr.dtype in (np.uint8, np.bool_):
            arr, key = pack_bev_np(arr), k + "_packed"
        t = torch.from_numpy(np.ascontiguousarray(arr))
        out[key] = t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t
    return out


def create_train_state(model: nn.Module, lr: float = 1e-3) -> torch.optim.Adam:
    """The optimizer over ``model``'s parameters: Adam(lr), betas (0.9,
    0.999), eps 1e-8, no weight decay, no schedule (the update of
    ``optax.adam``). The model itself holds the rest of the training state.

    On the card Adam is ``capturable``: its step count lives on the device,
    so a CUDA graph can hold its update (:func:`make_train_step_multi`)."""
    on_card = next(model.parameters()).device.type == "cuda"
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                            capturable=on_card)


def _local_sites(batch: Batch, out, config: Config, mesh) -> Batch:
    """``batch`` with its positive sites (the grid's, (h*W + w)*NA + a) made
    sites of this rank's rows of an H-sharded head map; sites of other rows
    become the local sentinel."""
    H, W = out["reg"].shape[2:4]
    n_local = H * W * config.num_anchors
    idx = batch["reg_pos_idx"].long() - mesh.coords["spatial"] * n_local
    ok = (idx >= 0) & (idx < n_local)
    return {**batch, "reg_pos_idx": torch.where(ok, idx, torch.full_like(idx, n_local))}


def _losses(out, batch: Batch, config: Config, teacher_out=None, mesh=None):
    """(loss, metrics) of one forward's outputs, fp32.

    Three target encodings, equal in value: the packed path (sparse targets,
    ``config.packed_loss``) reads the fp32 packed head tensor; the sparse view
    path scatters the positives into dense labels over the cls/reg views; the
    dense path reads ``label_one_hot``/``reg_target``/``reg_mask``.

    Under a ``mesh`` every denominator is summed over the ranks, so the loss
    and each metric are this rank's share of the global ones.
    """
    gsum = mesh.all_reduce if mesh is not None else None
    if mesh is not None and mesh.axis_size("spatial") > 1 and "reg_pos_idx" in batch:
        batch = _local_sites(batch, out, config, mesh)
    agent_mask = batch["agent_mask"].float()  # (B, A)
    if "reg_pos_idx" in batch and "head_raw_f32" in out and config.packed_loss:
        cls_loss, reg_loss = packed_det_losses(
            out["head_raw_f32"],
            batch["reg_pos_idx"],
            batch["reg_pos_target"],
            agent_mask,
            num_anchors=config.num_anchors,
            num_classes=config.num_classes,
            box_code_size=config.box_code_size,
            pos_cls=batch.get("reg_pos_cls"),
            gamma=config.focal_gamma,
            sigma=config.smooth_l1_sigma,
            global_sum=gsum,
        )
        return _finish_losses(cls_loss, reg_loss, out, config, teacher_out, agent_mask, gsum)

    am = agent_mask[:, :, None, None, None]
    cls_mask = am.expand(out["cls"].shape[:-1])
    if "reg_pos_idx" in batch:
        B, A, H, W, NA, code = out["reg"].shape
        n_flat = H * W * NA
        idx = batch["reg_pos_idx"].long().clamp(max=n_flat)  # sentinel n_flat
        valid = (idx < n_flat).float()
        # one spare slot takes the sentinels, then is cut off
        if "reg_pos_cls" in batch:
            cls_map = torch.zeros((B, A, n_flat + 1), dtype=torch.long, device=idx.device)
            cls_map.scatter_(2, idx, batch["reg_pos_cls"].long())
            classes = torch.arange(out["cls"].shape[-1], device=idx.device)
            # a comparison, not F.one_hot, which checks its indices on the host
            label = (cls_map[..., :n_flat].reshape(B, A, H, W, NA, 1) == classes).float()
        else:
            pos = torch.zeros((B, A, n_flat + 1), device=idx.device).scatter_(2, idx, 1.0)
            pos = pos[..., :n_flat].reshape(B, A, H, W, NA)
            label = torch.stack([1.0 - pos, pos], dim=-1)
        cls_loss = softmax_focal_loss(out["cls"], label, gamma=config.focal_gamma, mask=cls_mask, global_sum=gsum)
        pred_flat = out["reg"].reshape(B, A, n_flat, code).float()
        safe = idx.clamp(max=n_flat - 1)
        pred_pos = torch.gather(pred_flat, 2, safe[..., None].expand(-1, -1, -1, code))
        reg_loss = weighted_smooth_l1(
            pred_pos, batch["reg_pos_target"], (valid * agent_mask[:, :, None])[..., None],
            sigma=config.smooth_l1_sigma, global_sum=gsum,
        )
    else:
        cls_loss = softmax_focal_loss(
            out["cls"], batch["label_one_hot"], gamma=config.focal_gamma, mask=cls_mask, global_sum=gsum
        )
        reg_mask = batch["reg_mask"].float() * am
        reg_loss = weighted_smooth_l1(
            out["reg"], batch["reg_target"], reg_mask[..., None], sigma=config.smooth_l1_sigma, global_sum=gsum
        )
    return _finish_losses(cls_loss, reg_loss, out, config, teacher_out, agent_mask, gsum)


def _finish_losses(cls_loss, reg_loss, out, config: Config, teacher_out, agent_mask, gsum=None):
    """The weighted total, with the KD term when the teacher's taps are given."""
    loss = config.cls_weight * cls_loss + config.reg_weight * reg_loss
    metrics = {"cls_loss": cls_loss, "reg_loss": reg_loss}
    if teacher_out is not None:
        kd = 0.0
        for sf, tf in zip(out["kd_feats"], teacher_out["kd_feats"]):
            kd = kd + kd_feature_loss(sf, tf.detach(), mask=agent_mask, global_sum=gsum)
        kd = kd / len(out["kd_feats"])
        metrics["kd_loss"] = kd
        loss = loss + config.kd_weight * kd
    metrics["loss"] = loss
    return loss, metrics


def _teacher_out(teacher: Optional[nn.Module], kd_flag: bool, batch: Batch, config: Config):
    """The frozen teacher's outputs on ``bev_teacher``, or None without KD."""
    if not (kd_flag and teacher is not None):
        return None
    teacher.eval()
    with torch.no_grad():
        return teacher(get_bev(batch, "bev_teacher", config), None, batch["agent_mask"])


def _all_reduce_grads(model: nn.Module, mesh) -> None:
    """Every parameter's gradient summed over the ranks of ``mesh``, in one
    all_reduce: the gradient of the global loss, whose shares the ranks
    backpropagated."""
    params = [p for p in model.parameters() if p.requires_grad]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    with torch.no_grad():
        flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        for p, g in zip(params, flat.split([g.numel() for g in grads])):
            if p.grad is None:
                p.grad = g.view_as(p).clone()
            else:
                p.grad.copy_(g.view_as(p))


def make_train_step(
    model: nn.Module,
    config: Config,
    optimizer: torch.optim.Optimizer,
    teacher: Optional[nn.Module] = None,
    kd_flag: bool = False,
    kd_from_cache: Optional[Sequence[torch.Tensor]] = None,
    mesh=None,
) -> Callable[[Batch], Batch]:
    """The training step of ``model`` with ``optimizer`` (see
    :func:`create_train_state`). With ``kd_flag`` and a ``teacher`` (a
    TeacherNet, never given to the optimizer) the loss adds the KD term.

    ``kd_from_cache``: the teacher's taps of every frame, the tables of
    :func:`precompute_teacher_feats`. Given with ``kd_flag``, the step reads
    the batch's rows by ``frame_idx`` instead of running the teacher: the
    frozen teacher's taps are the same every epoch.

    ``config.train_remat`` runs the forward under ``remat_stages``: the
    backward recomputes each stage from its boundary.

    ``mesh`` (a ``parallel.Mesh``; the batch is this rank's
    ``parallel.shard_batch``) is attached to the model and the teacher
    (``parallel.attach_mesh``): the BatchNorm statistics, the fusion and the
    losses' denominators are global, the gradients are summed over the
    ranks before Adam, and the metrics are the global ones. The KD tables
    are whole on every rank; the step reads its agents' and rows' part.

    The step's spans (``utils/profiling.py``): ``train/kd`` (the cache's rows
    or the teacher's forward, with KD), ``train/forward`` (the forward and
    the losses), ``train/backward`` and ``train/update`` (the all-reduce,
    the gradient norm and Adam)."""
    if mesh is not None:
        attach_mesh(model, mesh)
        if teacher is not None:
            attach_mesh(teacher, mesh)

    def kd_taps(batch: Batch):
        if kd_from_cache is None:
            return _teacher_out(teacher, kd_flag, batch, config)
        idx = batch["frame_idx"].long()
        rows = [t.index_select(0, idx) for t in kd_from_cache]
        return {"kd_feats": rows if mesh is None else [mesh.local(r) for r in rows]}

    def train_step(batch: Batch) -> Batch:
        teacher_out = None
        if kd_flag and (kd_from_cache is not None or teacher is not None):
            with profiling.annotate("train/kd"):
                teacher_out = kd_taps(batch)
        with profiling.annotate("train/forward"):
            model.train()
            with remat_stages(config.train_remat):
                out = model(get_bev(batch, "bev", config), batch["trans"], batch["agent_mask"])
            loss, metrics = _losses(out, batch, config, teacher_out, mesh)
        with profiling.annotate("train/backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with profiling.annotate("train/update"):
            if mesh is not None:
                _all_reduce_grads(model, mesh)
                metrics = {k: mesh.all_reduce(v.detach()) for k, v in metrics.items()}
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            metrics["grad_norm"] = torch.nn.utils.get_total_norm(grads)
            optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def stack_host_batches(batches: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """K same-shaped host batches -> one superbatch whose every leaf gains a
    leading K axis, for :func:`make_train_step_multi`. Only array leaves
    stack: list-valued keys (``gt_boxes``) never go to the card and are
    dropped."""
    keys = [k for k in batches[0] if isinstance(batches[0][k], np.ndarray)]
    return {k: np.stack([b[k] for b in batches]) for k in keys}


def _group_len(stacked: Batch) -> int:
    return next(iter(stacked.values())).shape[0]


def _run_each(step: Callable[[Batch], Batch], stacked: Batch) -> Batch:
    """``step`` on each row of a stacked batch in turn; metrics stacked (K,)."""
    rows = [step({k: v[i] for k, v in stacked.items()}) for i in range(_group_len(stacked))]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


class _StepGraph:
    """K train steps over a stacked batch, captured as one CUDA graph.

    The whole-network capture recipe: a few steps on a side stream warm up
    what is built on first use (cuDNN plans, Adam's state, autograd's
    buffers); the parameters, BatchNorm statistics and Adam's state are then
    put back as they were, the gradients dropped, and the K steps captured,
    reading a static copy of the batch. Their gradients, activations and
    metrics live in the graph's private pool. A replay copies the next
    superbatch into the static input and runs the K steps with one launch.

    Two runs of the same steps from one seed are bit-identical, at every
    fusion grid (the warp's backward adds in a fixed order, ``ops/warp.py``)."""

    WARMUP = 3

    def __init__(self, step: Callable[[Batch], Batch], model: nn.Module, optimizer: torch.optim.Optimizer,
                 stacked: Batch):
        if not all(g.get("capturable") for g in optimizer.param_groups):
            raise ValueError("a CUDA graph of train steps needs a capturable optimizer (create_train_state "
                             "on the card)")
        self.layout, self.steps = _layout(stacked), _group_len(stacked)
        self.inputs = {k: v.clone() for k, v in stacked.items()}
        rows = [{k: v[i] for k, v in self.inputs.items()} for i in range(_group_len(stacked))]
        saved = _snapshot(model, optimizer)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(self.WARMUP):
                step(rows[i % len(rows)])
        torch.cuda.current_stream().wait_stream(side)
        _restore(saved, optimizer)
        optimizer.zero_grad(set_to_none=True)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the prefetch thread may copy the next batch meanwhile
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            outs = [step(r) for r in rows]
            self.metrics = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def __call__(self, stacked: Batch) -> Batch:
        for k, v in self.inputs.items():
            v.copy_(stacked[k], non_blocking=True)
        self.graph.replay()
        return {k: v.clone() for k, v in self.metrics.items()}


def _layout(stacked: Batch):
    """The keys, per-step shapes and dtypes of a stacked batch."""
    return tuple(sorted((k, tuple(v.shape[1:]), v.dtype) for k, v in stacked.items()))


def _snapshot(model: nn.Module, optimizer: torch.optim.Optimizer):
    """(tensor, its copy) of every parameter, buffer and optimizer state
    tensor, and the parameters that had no optimizer state yet."""
    state = [t for p in model.parameters() for t in optimizer.state.get(p, {}).values()
             if isinstance(t, torch.Tensor)]
    tensors = list(model.parameters()) + list(model.buffers()) + state
    fresh = [p for p in model.parameters() if not optimizer.state.get(p)]
    return [(t, t.detach().clone()) for t in tensors], fresh


@torch.no_grad()
def _restore(saved, optimizer: torch.optim.Optimizer) -> None:
    """Put the tensors of :func:`_snapshot` back in place. Adam's state that
    the warm-up created starts at zero (step 0, zero moments), which is the
    state Adam creates on its first step."""
    copies, fresh = saved
    for t, c in copies:
        t.copy_(c)
    for p in fresh:
        for t in optimizer.state.get(p, {}).values():
            if isinstance(t, torch.Tensor):
                t.zero_()


def multi_step(step: Callable[[Batch], Batch], model: nn.Module, optimizer: torch.optim.Optimizer
               ) -> Callable[[Batch], Batch]:
    """K optimizer steps of ``step`` per call over a stacked batch (every
    leaf with a leading K axis): the same K sequential steps, parameters,
    Adam's state and BatchNorm statistics threaded through, metrics stacked
    (K,) per key.

    On the card the first call captures its K steps as one CUDA graph
    (:class:`_StepGraph`) and every call replays it; a failed capture
    raises. A group of another length (an epoch's shorter tail) runs as
    single steps. On the CPU the steps run one by one."""
    graphs = []

    def run(stacked: Batch) -> Batch:
        if next(iter(stacked.values())).device.type != "cuda":
            return _run_each(step, stacked)
        if not graphs:
            graphs.append(_StepGraph(step, model, optimizer, stacked))
        g = graphs[0]
        if _layout(stacked) != g.layout:
            raise ValueError(f"a batch of another layout than the captured steps': {_layout(stacked)} vs {g.layout}")
        return g(stacked) if _group_len(stacked) == g.steps else _run_each(step, stacked)

    return run


def make_train_step_multi(
    model: nn.Module,
    config: Config,
    optimizer: torch.optim.Optimizer,
    teacher: Optional[nn.Module] = None,
    kd_flag: bool = False,
    kd_from_cache: Optional[Sequence[torch.Tensor]] = None,
) -> Callable[[Batch], Batch]:
    """K steps of :func:`make_train_step` per dispatch over a stacked batch
    (:func:`stack_host_batches`, then :func:`batch_to_device`), as the JAX
    package's ``lax.scan`` of the step: on the card one CUDA graph of the K
    steps (:func:`multi_step`). Returns the metrics stacked (K,) per key."""
    step = make_train_step(model, config, optimizer, teacher=teacher, kd_flag=kd_flag,
                           kd_from_cache=kd_from_cache)
    return multi_step(step, model, optimizer)


def teacher_feat_bytes(config: Config, n_frames: int, dtype: torch.dtype = torch.bfloat16,
                       batch_size: int = 1) -> int:
    """Bytes of the KD feature cache of ``n_frames`` scene-frames: TeacherNet's
    five taps for ``config.max_agents`` agents a frame, with the tables padded
    to whole batches of ``batch_size`` as :func:`precompute_teacher_feats`
    allocates them. The shapes come from a forward on the meta device (no
    memory, no arithmetic)."""
    n_rows = -(-n_frames // batch_size) * batch_size
    with torch.device("meta"):
        teacher = TeacherNet(config).eval()
        bev = torch.empty((1, config.max_agents) + tuple(config.bev_shape))
        with torch.no_grad():
            taps = teacher(bev, None, torch.ones((1, config.max_agents), dtype=torch.bool))["kd_feats"]
    per_frame = sum(t[0].numel() for t in taps)
    return per_frame * n_rows * torch.empty((), dtype=dtype).element_size()


def precompute_teacher_feats(
    teacher: nn.Module,
    dataset,
    config: Config,
    batch_size: int = 4,
    dtype: torch.dtype = torch.bfloat16,
    num_workers: int = 2,
    mesh=None,
):
    """One eval pass of the frozen ``teacher`` over ``dataset``, in order, on
    the teacher's device -> the KD tables: one (N_pad, A, h, w, c) tensor per
    tap, row i the taps of ``dataset[i]`` (``frame_idx`` i), N_pad =
    len(dataset) rounded up to whole batches (the padding rows are never
    read). For ``make_train_step(kd_from_cache=...)``.

    Each batch's rows are written into tables allocated up front: holding
    the batches and concatenating at the end would double the peak memory
    over the size :func:`teacher_feat_bytes` gives. ``dtype`` bfloat16 halves
    the tables; float32 gives the re-forward's taps exactly.

    With a ``mesh`` every rank holds the tables whole, as the JAX package
    replicates them: each rank runs the pass (the teacher has no mesh
    attached yet, so it runs whole batches) and rank 0's tables are
    broadcast."""
    from disconet_tpu_torch.data.dataset import BatchIterator, pad_batch_to

    if any(getattr(m, "mesh", None) is not None for m in teacher.modules()):
        raise ValueError("precompute_teacher_feats runs the teacher on whole batches: build the tables "
                         "before a step attaches the mesh")
    dev = next(teacher.parameters()).device
    teacher.eval()
    n = len(dataset)
    loader = BatchIterator(dataset, batch_size, shuffle=False, drop_last=False, num_workers=num_workers)
    tables, order, offset = None, [], 0
    for batch in loader:
        order.extend(np.asarray(batch["frame_idx"]).tolist())
        batch = pad_batch_to(batch, batch_size, config.max_agents)
        d = batch_to_device(
            {k: batch[k] for k in ("bev_teacher", "bev_teacher_packed", "agent_mask") if k in batch}, dev
        )
        with torch.no_grad():
            rows = teacher(get_bev(d, "bev_teacher", config), None, d["agent_mask"])["kd_feats"]
        if tables is None:
            n_pad = -(-n // batch_size) * batch_size
            tables = [torch.zeros((n_pad,) + tuple(r.shape[1:]), dtype=dtype, device=dev) for r in rows]
        for t, r in zip(tables, rows):
            t[offset : offset + batch_size].copy_(r)
        offset += batch_size
    if order != list(range(n)):
        raise RuntimeError("the teacher pass did not visit the dataset in order")
    if mesh is not None:
        replicate_tree(tables, mesh)
    return tuple(tables)


def make_eval_step(
    model: nn.Module, config: Config, teacher: Optional[nn.Module] = None, kd_flag: bool = False
) -> Callable[[Batch], Batch]:
    """The validation step: the eval-mode forward and the losses, no update."""

    def eval_step(batch: Batch) -> Batch:
        teacher_out = _teacher_out(teacher, kd_flag, batch, config)
        model.eval()
        with torch.no_grad():
            out = model(get_bev(batch, "bev", config), batch["trans"], batch["agent_mask"])
            return _losses(out, batch, config, teacher_out)[1]

    return eval_step


def _whole_rows(model: nn.Module, mesh, bev, trans, agent_mask, store_bf16: bool = False):
    """The model's head outputs on a rank's strip, all-gathered over the
    ``spatial`` axis into whole maps (in fp32, exact, then back)."""
    out = model(bev, trans, agent_mask, store_bf16=store_bf16)
    return {k: mesh.all_gather(out[k].float(), "spatial", 2).to(out[k].dtype)
            for k in ("cls", "reg", "head_raw") if k in out}


def make_predict_step(model: nn.Module, config: Config, mesh=None) -> Callable:
    """The inference step: forward, scores, rotated NMS with the IoU kernel on
    the card. Returns boxes (B, A, K, 5), scores (B, A, K) and keep (B, A, K),
    false for absent agents; K = ``config.nms_top_k``. ``config.packed_nms``
    selects the binary candidates on logits (``pipeline.detect``). With
    ``num_classes`` > 2 the NMS runs per class (:func:`ops.nms.multiclass_nms_decode`) and
    the step returns ``(boxes, scores, keep, labels)`` with K' =
    (num_classes - 1) * K slots an agent.

    ``mesh`` is attached to the model; each rank predicts for its scenes
    and agents of a ``parallel.shard_batch``. Under a ``spatial`` axis the
    head outputs are all-gathered over it before the NMS, which reads whole
    maps, so the ranks of a strip's line return the same detections."""
    net = model
    if mesh is not None:
        attach_mesh(model, mesh)
        if mesh.axis_size("spatial") > 1:
            net = functools.partial(_whole_rows, model, mesh)
    anchors = torch.from_numpy(make_anchors(config)).to(next(model.parameters()).device)

    def predict_step(batch: Batch):
        model.eval()
        with torch.inference_mode():
            mask = batch["agent_mask"].bool()
            bev = get_bev(batch, "bev", config)
            if config.num_classes == 2:
                boxes, scores, keep = detect(net, bev, batch["trans"], mask, anchors, config)
                return boxes, scores, keep & mask[:, :, None]
            out = net(bev, batch["trans"], mask, store_bf16=True)
            B, A = bev.shape[:2]
            boxes, scores, keep, labels = multiclass_nms_decode(
                out["reg"].flatten(0, 1), out["cls"].flatten(0, 1), anchors,
                iou_threshold=config.nms_iou_threshold, score_threshold=config.score_threshold,
                top_k=config.nms_top_k,
            )
            KT = (config.num_classes - 1) * config.nms_top_k
            return (boxes.reshape(B, A, KT, 5), scores.reshape(B, A, KT),
                    keep.reshape(B, A, KT) & mask[:, :, None], labels.reshape(B, A, KT))

    return predict_step


def pipeline_one_deep(batches: Iterable, dispatch: Callable) -> Iterator:
    """One-deep prediction pipeline for the evaluation loop: dispatch batch
    n+1's device work before fetching batch n's outputs, so the host's work
    on batch n overlaps the device's on n+1. Yields (batch, outputs), the
    tuple of tensors that ``dispatch(batch)`` returned as numpy arrays."""

    def fetch(outs):
        return tuple(t.cpu().numpy() for t in outs)

    pending = None
    for b in batches:
        fut = dispatch(b)
        if pending is not None:
            yield pending[0], fetch(pending[1])
        pending = (b, fut)
    if pending is not None:
        yield pending[0], fetch(pending[1])


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


_DONE = object()


def prefetch_to_device(
    batches: Iterable,
    device: Optional[Union[str, torch.device]] = None,
    to_device: Optional[Callable] = None,
    depth: int = 2,
) -> Iterator:
    """Copy host batches to ``device`` on a worker thread, up to ``depth``
    ahead of the consumer, in order.

    ``to_device(batch)`` (default :func:`batch_to_device` to ``device``) runs
    on the worker; whatever it returns is yielded. On the card it runs on a
    side stream, and its copies are asynchronous from pinned memory. The
    consumer's current stream waits on an event recorded after them, and
    every tensor of the result is marked as used on that stream, so a step
    never reads a batch still being copied and the allocator never hands
    its memory to the side stream while a step may still read it. An error
    of the worker (or of ``batches``) is raised in the consumer; leaving the
    loop early stops and joins the worker."""
    dev = resolve_device(device)
    if to_device is None:
        def to_device(b):
            return batch_to_device(b, dev)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def work():
        try:
            for b in batches:
                if stop.is_set():
                    return
                if side is None:
                    item = (to_device(b), None)
                else:
                    with torch.cuda.stream(side):
                        out = to_device(b)
                        ready = torch.cuda.Event()
                        ready.record(side)
                    item = (out, ready)
                if not put(item):
                    return
            put(_DONE)
        except BaseException as e:  # noqa: BLE001 -- re-raised by the consumer
            put(e)

    worker = threading.Thread(target=work, daemon=True)
    worker.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            out, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(ready)
                for t in _tensors(out):
                    if t.device.type == "cuda":
                        t.record_stream(stream)
            yield out
    finally:
        stop.set()
        worker.join()
