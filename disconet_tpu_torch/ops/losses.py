"""Detection and distillation losses, fp32.

The port's copies of the JAX package's losses: the softmax focal loss over
one-hot targets, the masked smooth-L1 regression loss, the same two read
straight from the packed head tensor at sparse positive sites, and the KD
per-pixel feature MSE. Every denominator is the JAX package's: ``max(sum(mask),
1)`` for the masked means, ``sum(agent_mask) * H*W*NA`` for the packed focal
loss and ``sum(mask) * (size / mask.size)`` for KD.

``global_sum`` (a rank's ``Mesh.all_reduce``) makes every denominator the
sum over the ranks of a mesh: each rank's loss is then its share of the
global loss, and the shares and their gradients add up to the global ones.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


GlobalSum = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _count(n: torch.Tensor, global_sum: GlobalSum) -> torch.Tensor:
    """A denominator: ``n`` summed over the ranks where ``global_sum`` is
    given, at least 1."""
    return torch.clamp(global_sum(n) if global_sum is not None else n, min=1.0)


def _focal(logp: torch.Tensor, gamma: float) -> torch.Tensor:
    """-(1 - p)^gamma * log p from log p."""
    return -((1.0 - torch.exp(logp)) ** gamma) * logp


def softmax_focal_loss(
    logits: torch.Tensor,
    one_hot: torch.Tensor,
    gamma: float = 2.0,
    mask: Optional[torch.Tensor] = None,
    global_sum: GlobalSum = None,
) -> torch.Tensor:
    """Softmax focal loss over (..., C) logits and one-hot targets; the mean
    over elements, weighted by ``mask`` (...,) when given."""
    log_p = torch.log_softmax(logits.float(), dim=-1)
    per_elem = torch.sum(-one_hot.float() * ((1.0 - torch.exp(log_p)) ** gamma) * log_p, dim=-1)
    if mask is None:
        if global_sum is None:
            return per_elem.mean()
        return per_elem.sum() / _count(per_elem.new_tensor(float(per_elem.numel())), global_sum)
    mask = mask.float()
    return torch.sum(per_elem * mask) / _count(mask.sum(), global_sum)


def weighted_smooth_l1(
    pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, sigma: float = 3.0,
    global_sum: GlobalSum = None,
) -> torch.Tensor:
    """Masked smooth-L1: 0.5 (sigma d)^2 where |d| < 1/sigma^2, else
    |d| - 0.5/sigma^2; the mean over elements where ``mask`` is nonzero."""
    d = pred.float() - target.float()
    abs_d = d.abs()
    s2 = sigma * sigma
    loss = torch.where(abs_d < 1.0 / s2, 0.5 * s2 * d * d, abs_d - 0.5 / s2)
    mask = torch.broadcast_to(mask, loss.shape).float()
    return torch.sum(loss * mask) / _count(mask.sum(), global_sum)


def packed_det_losses(
    raw: torch.Tensor,
    pos_idx: torch.Tensor,
    pos_target: torch.Tensor,
    agent_mask: torch.Tensor,
    *,
    num_anchors: int,
    num_classes: int,
    box_code_size: int,
    pos_cls: Optional[torch.Tensor] = None,
    gamma: float = 2.0,
    sigma: float = 3.0,
    global_sum: GlobalSum = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Focal cls and masked smooth-L1 reg losses from the packed head tensor,
    equal to the two losses over the (B, A, H, W, NA, .) views.

    The focal loss is a dense pass that counts every anchor as background,
    corrected at the listed positive sites; the reg predictions are gathered
    at those sites. Layout (``DetectionHeads``): lane ``c*NA + a`` holds the
    class-``c`` logit of anchor ``a``, lane ``NA*NC + a*code + j`` its reg code
    ``j``; a site is ``(h*W + w)*NA + a``, and ``H*W*NA`` is the padding
    sentinel. Valid sites must be unique per (b, a): the correction sums per
    site.

    Args:
        raw: (B, A, H, W, NA*NC + NA*code), fp32.
        pos_idx: (B, A, P) integer sites.
        pos_target: (B, A, P, code) reg deltas at those sites.
        agent_mask: (B, A) present agents.
        pos_cls: (B, A, P) class of each positive; None means class 1.

    Returns:
        (cls_loss, reg_loss), fp32 scalars.
    """
    B, A, H, W, L = raw.shape
    NA, NC, code = num_anchors, num_classes, box_code_size
    if L != NA * NC + NA * code:
        raise ValueError(f"packed head tensor has {L} lanes, expected {NA * NC + NA * code}")
    raw = raw.float()
    am = agent_mask.float()

    ls = [raw[..., c * NA : (c + 1) * NA] for c in range(NC)]
    m = ls[0]
    for lg in ls[1:]:
        m = torch.maximum(m, lg)
    lse = m + torch.log(sum(torch.exp(lg - m) for lg in ls))
    neg = _focal(ls[0] - lse, gamma)  # every anchor as background
    dense_sum = torch.sum(neg.sum(dim=(2, 3, 4)) * am)
    denom_cls = _count(am.sum() * (H * W * NA), global_sum)

    n_flat = H * W * NA
    idx = pos_idx.long()
    P = idx.shape[-1]
    valid = (idx < n_flat).float() * am[:, :, None]
    safe = idx.clamp(max=n_flat - 1)
    pix, a_id = torch.div(safe, NA, rounding_mode="floor"), safe % NA
    rows = torch.gather(raw.reshape(B, A, H * W, L), 2, pix[..., None].expand(B, A, P, L))
    lanes = torch.arange(max(NC, code), device=raw.device)
    cls_lanes = a_id[..., None] + lanes[:NC] * NA
    site_logp = torch.log_softmax(torch.gather(rows, 3, cls_lanes), dim=-1)  # (B, A, P, NC)
    y = pos_cls.long() if pos_cls is not None else torch.ones_like(safe)
    logp_y = torch.gather(site_logp, 3, y[..., None])[..., 0]
    corr = torch.sum((_focal(logp_y, gamma) - _focal(site_logp[..., 0], gamma)) * valid)
    cls_loss = (dense_sum + corr) / denom_cls

    reg_lanes = NA * NC + a_id[..., None] * code + lanes[:code]
    pred_pos = torch.gather(rows, 3, reg_lanes)  # (B, A, P, code)
    reg_loss = weighted_smooth_l1(pred_pos, pos_target, valid[..., None], sigma=sigma, global_sum=global_sum)
    return cls_loss, reg_loss


def kd_feature_loss(
    student_feats: torch.Tensor,
    teacher_feats: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    global_sum: GlobalSum = None,
) -> torch.Tensor:
    """Per-pixel MSE between student and teacher maps. ``mask`` (broadcast
    over the leading dims) leaves padded agents out. The caller detaches the
    teacher's maps."""
    d = student_feats.float() - teacher_feats.float()
    sq = d * d
    if mask is None:
        if global_sum is None:
            return sq.mean()
        return sq.sum() / _count(sq.new_tensor(float(sq.numel())), global_sum)
    mask = mask.float().reshape(tuple(mask.shape) + (1,) * (sq.dim() - mask.dim()))
    return torch.sum(sq * mask) / _count(mask.sum() * (sq.numel() / max(mask.numel(), 1)), global_sum)
