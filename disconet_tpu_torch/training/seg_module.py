"""Segmentation training and evaluation of the port (the reference's
``SegModule``): cross-entropy over per-cell class logits, masked over present
agents, and per-class IoU / mIoU.

As in ``det_module``, the model holds its parameters and BatchNorm running
statistics and a ``torch.optim.Adam`` (:func:`create_seg_train_state`) holds
the moments; each ``make_*`` function returns a step function over a device batch
(``training.batch_to_device`` ships ``seg_label`` with the bit-packed grids).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.models.backbone import remat_stages
from disconet_tpu_torch.training.det_module import Batch, create_train_state, get_bev, multi_step

# the same optimizer as detection; the name reads as the seg CLI's
create_seg_train_state = create_train_state


def _seg_loss(out, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"loss", "acc"}): the cross-entropy and the accuracy of the
    argmax, each averaged over the cells of present agents (the count
    clamped at 1)."""
    logits = out["seg"].float()  # (B, A, H, W, C)
    labels = batch["seg_label"].long()
    w = batch["agent_mask"].float()[:, :, None, None].expand(labels.shape)
    ce = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None])[..., 0]
    denom = w.sum().clamp(min=1.0)
    loss = (ce * w).sum() / denom
    acc = ((logits.argmax(dim=-1) == labels).float() * w).sum() / denom
    return loss, {"loss": loss, "acc": acc}


def make_seg_train_step(model: nn.Module, config: Config, optimizer: torch.optim.Optimizer
                        ) -> Callable[[Batch], Batch]:
    """The seg training step: the training-mode forward (BatchNorm on batch
    statistics, running statistics updated), the loss, backward and one
    Adam step. Returns ``loss`` and ``acc`` as 0-dim device tensors.
    ``config.train_remat`` rematerializes the stages, as the det step."""

    def train_step(batch: Batch) -> Batch:
        model.train()
        with remat_stages(config.train_remat):
            out = model(get_bev(batch, "bev", config), batch["trans"], batch["agent_mask"])
        loss, metrics = _seg_loss(out, batch)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_seg_train_step_multi(model: nn.Module, config: Config, optimizer: torch.optim.Optimizer
                              ) -> Callable[[Batch], Batch]:
    """K seg steps per dispatch over a stacked batch, the seg counterpart of
    ``det_module.make_train_step_multi`` (one CUDA graph of the K steps on
    the card); metrics stacked (K,) per key."""
    return multi_step(make_seg_train_step(model, config, optimizer), model, optimizer)


def make_seg_predict_step(model: nn.Module, config: Config) -> Callable[[Batch], torch.Tensor]:
    """The seg inference step: the eval-mode forward and the argmax class per
    cell, (B, A, H, W) int64. The bf16 mode stores its maps in bf16
    (``store_bf16``) but the head input, which the SegHead reads in fp32."""

    def predict(batch: Batch) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            out = model(get_bev(batch, "bev", config), batch["trans"], batch["agent_mask"].bool(), store_bf16=True)
            return out["seg"].argmax(dim=-1)

    return predict


def iou_per_class(pred: np.ndarray, label: np.ndarray, num_classes: int, mask=None) -> Dict:
    """Per-class IoU and their mean over the classes that occur in ``pred``
    or ``label`` (a class in neither is NaN and left out of the mean; mIoU
    0 when none occurs), over the cells where ``mask`` holds."""
    pred = np.asarray(pred)
    if mask is not None:
        keep = np.broadcast_to(np.asarray(mask), pred.shape).astype(bool).reshape(-1)
    pred = pred.reshape(-1)
    label = np.asarray(label).reshape(-1)
    if mask is not None:
        pred, label = pred[keep], label[keep]
    ious = {}
    present = []
    for c in range(num_classes):
        inter = np.sum((pred == c) & (label == c))
        union = np.sum((pred == c) | (label == c))
        if union > 0:
            ious[c] = float(inter / union)
            present.append(ious[c])
        else:
            ious[c] = float("nan")
    return {"iou": ious, "miou": float(np.mean(present)) if present else 0.0}
