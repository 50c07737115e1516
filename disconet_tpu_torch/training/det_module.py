"""Detection training, evaluation and prediction steps of the port.

The JAX package's steps are pure jitted functions of a train state. Here the
model holds its parameters and BatchNorm running statistics, a
``torch.optim.Adam`` holds the moments, and each builder returns a step
function over a device batch:

* ``train_step(batch)``: with KD, the frozen teacher's forward (eval mode,
  no graph) on ``bev_teacher``; the student's training forward, which
  updates its BatchNorm running statistics; focal + smooth-L1 (+ kd_weight x
  the KD feature MSE); backward; one Adam step. Returns the metrics
  ``loss``, ``cls_loss``, ``reg_loss``, (``kd_loss``) and ``grad_norm`` as
  0-dim device tensors, so a step does not wait for the device.
* ``eval_step(batch)``: the eval-mode forward and the losses.
* ``predict_step(batch)``: the eval-mode forward, the packed scores and the
  rotated NMS (binary classes), keep masked by ``agent_mask``.

Absent agents are out of the classification loss, the regression mask and the
KD loss; the fusion's sender softmax masks them separately.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.device import resolve_device
from disconet_tpu_torch.ops.bitpack import pack_bev_np, unpack_bev
from disconet_tpu_torch.ops.boxes import make_anchors
from disconet_tpu_torch.ops.losses import (
    kd_feature_loss,
    packed_det_losses,
    softmax_focal_loss,
    weighted_smooth_l1,
)
from disconet_tpu_torch.pipeline import detect

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


def batch_to_device(
    batch: Dict[str, np.ndarray], device: Optional[Union[str, torch.device]] = None
) -> Batch:
    """Host batch of numpy arrays -> tensors on ``device`` (CUDA unless the
    caller names another). uint8/bool BEV grids ship bit-packed; the dense
    targets are left out when the sparse ones are there."""
    dev = resolve_device(device)
    sparse = "reg_pos_idx" in batch
    out = {}
    for k in _DEVICE_KEYS:
        if k not in batch or (sparse and k in _DENSE_TARGET_KEYS):
            continue
        arr, key = np.asarray(batch[k]), k
        if k in _PACK_KEYS and arr.dtype in (np.uint8, np.bool_):
            arr, key = pack_bev_np(arr), k + "_packed"
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    return out


def create_train_state(model: nn.Module, lr: float = 1e-3) -> torch.optim.Adam:
    """The optimizer over ``model``'s parameters: Adam(lr), betas (0.9,
    0.999), eps 1e-8, no weight decay, no schedule (the update of
    ``optax.adam``). The model itself holds the rest of the training state."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


def _losses(out, batch: Batch, config: Config, teacher_out=None):
    """(loss, metrics) of one forward's outputs, fp32.

    Three target encodings, equal in value: the packed path (sparse targets,
    ``config.packed_loss``) reads the fp32 packed head tensor; the sparse view
    path scatters the positives into dense labels over the cls/reg views; the
    dense path reads ``label_one_hot``/``reg_target``/``reg_mask``.
    """
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
        )
        return _finish_losses(cls_loss, reg_loss, out, config, teacher_out, agent_mask)

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
            label = F.one_hot(cls_map[..., :n_flat].reshape(B, A, H, W, NA), out["cls"].shape[-1]).float()
        else:
            pos = torch.zeros((B, A, n_flat + 1), device=idx.device).scatter_(2, idx, 1.0)
            pos = pos[..., :n_flat].reshape(B, A, H, W, NA)
            label = torch.stack([1.0 - pos, pos], dim=-1)
        cls_loss = softmax_focal_loss(out["cls"], label, gamma=config.focal_gamma, mask=cls_mask)
        pred_flat = out["reg"].reshape(B, A, n_flat, code).float()
        safe = idx.clamp(max=n_flat - 1)
        pred_pos = torch.gather(pred_flat, 2, safe[..., None].expand(-1, -1, -1, code))
        reg_loss = weighted_smooth_l1(
            pred_pos, batch["reg_pos_target"], (valid * agent_mask[:, :, None])[..., None],
            sigma=config.smooth_l1_sigma,
        )
    else:
        cls_loss = softmax_focal_loss(
            out["cls"], batch["label_one_hot"], gamma=config.focal_gamma, mask=cls_mask
        )
        reg_mask = batch["reg_mask"].float() * am
        reg_loss = weighted_smooth_l1(
            out["reg"], batch["reg_target"], reg_mask[..., None], sigma=config.smooth_l1_sigma
        )
    return _finish_losses(cls_loss, reg_loss, out, config, teacher_out, agent_mask)


def _finish_losses(cls_loss, reg_loss, out, config: Config, teacher_out, agent_mask):
    """The weighted total, with the KD term when the teacher's taps are given."""
    loss = config.cls_weight * cls_loss + config.reg_weight * reg_loss
    metrics = {"cls_loss": cls_loss, "reg_loss": reg_loss}
    if teacher_out is not None:
        kd = 0.0
        for sf, tf in zip(out["kd_feats"], teacher_out["kd_feats"]):
            kd = kd + kd_feature_loss(sf, tf.detach(), mask=agent_mask)
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


def make_train_step(
    model: nn.Module,
    config: Config,
    optimizer: torch.optim.Optimizer,
    teacher: Optional[nn.Module] = None,
    kd_flag: bool = False,
) -> Callable[[Batch], Batch]:
    """The training step of ``model`` with ``optimizer`` (see
    :func:`create_train_state`). With ``kd_flag`` and a ``teacher`` (a
    TeacherNet, never given to the optimizer) the loss adds the KD term."""

    def train_step(batch: Batch) -> Batch:
        teacher_out = _teacher_out(teacher, kd_flag, batch, config)
        model.train()
        out = model(get_bev(batch, "bev", config), batch["trans"], batch["agent_mask"])
        loss, metrics = _losses(out, batch, config, teacher_out)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        metrics["grad_norm"] = torch.nn.utils.get_total_norm(grads)
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


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


def make_predict_step(model: nn.Module, config: Config) -> Callable:
    """The inference step: forward, packed scores, rotated NMS with the IoU
    kernel on the card. Returns boxes (B, A, K, 5), scores (B, A, K) and keep
    (B, A, K), false for absent agents; K = ``config.nms_top_k``. Binary
    classes only (the multi-class NMS is not ported)."""
    if config.num_classes != 2:
        raise NotImplementedError("the multi-class predict step is not ported")
    anchors = torch.from_numpy(make_anchors(config)).to(next(model.parameters()).device)

    def predict_step(batch: Batch):
        model.eval()
        with torch.inference_mode():
            mask = batch["agent_mask"].bool()
            boxes, scores, keep = detect(
                model, get_bev(batch, "bev", config), batch["trans"], mask, anchors, config
            )
            return boxes, scores, keep & mask[:, :, None]

    return predict_step
