"""Plain reference of the training step, and the comparison of the
program's first steps with it.

One step: (with knowledge distillation) the frozen teacher's taps from its
weights and the teacher's grids, eval mode; the student's training forward
(its BatchNorms on batch statistics); the losses; the gradients; one Adam
step. The losses, as DiscoNet trains them:

* focal loss (gamma 2) of the 2-way softmax over every anchor of every
  present agent, one-hot on the positive anchor sites, the mean over them;
* smooth-L1 (sigma 3) of the deltas at the positive sites of present
  agents, the mean over their elements;
* knowledge distillation: the mean squared difference of each of the five
  taps (decoder stages and head input) over present agents, averaged over
  the taps;
* total = cls_weight * cls + reg_weight * reg (+ kd_weight * kd).

Adam: betas (0.9, 0.999), eps 1e-8 added to the bias-corrected root, no
weight decay.

:func:`compare_steps` gives the numbers a cell's limits choose from, each
a gap of norms against the reference's:

* ``loss_gap``, the relative gap of the first step's loss, and
  ``loss_terms_gap``, the worst of its terms' (cls, reg, kd);
* ``grad_gap_median`` (and, a reading, ``grad_gap`` of the worst leaf):
  the gap between the norm of a leaf's first gradient (as Adam got it: its
  first moment after one step over 1 - beta1) and the reference's, against
  the larger of the reference's norm of that leaf and of the median leaf;
* ``fusion_grad_gap``: the same of the fusion's parameters together (the
  fusion reference's ``PREFIXES``), against the reference's norm of them;
* ``change_gap``: the worst leaf's gap of its change after the checked
  steps, parameters and BatchNorm statistics, measured as the gradients.

Leaves whose reference gradient is under a thousandth of the median leaf's
(a bias that a normalization or a softmax cancels) move by round-off alone
and are left out of all but the loss. The later steps' losses are
readings only: Adam's first steps move each weight by about the learning
rate times the sign of its gradient, so round-off in near-zero gradients
moves them apart whatever the arithmetic.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from port_bench.reference.model import BUFFER_SUFFIXES, Ctx, forward
from port_bench.reference.precision import Precision

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
NEGLIGIBLE_GRAD = 1e-3


def is_buffer(name: str) -> bool:
    return name.endswith(BUFFER_SUFFIXES)


def dense_batch(batch: Dict[str, np.ndarray], cfg: Dict, device) -> Dict[str, torch.Tensor]:
    """A host batch of the training pool on ``device``, grids unpacked."""
    Z = int(np.ceil((cfg["area_extents"][2][1] - cfg["area_extents"][2][0]) / cfg["voxel_size"][2] - 1e-9))
    out = {}
    for k, v in batch.items():
        if k.endswith("_packed"):
            out[k[: -len("_packed")]] = torch.from_numpy(np.unpackbits(v, axis=-1)[..., :Z]).to(device).float()
        else:
            out[k] = torch.from_numpy(np.asarray(v)).to(device)
    return out


def losses(out, batch, cfg: Dict, teacher_taps: Optional[List[torch.Tensor]]):
    cls, reg = out["cls"], out["reg"]  # (B, A, H, W, NA, 2), (B, A, H, W, NA, code)
    B, A, H, W, NA, NC = cls.shape
    code = reg.shape[-1]
    am = batch["agent_mask"].float()
    n_flat = H * W * NA
    idx = batch["reg_pos_idx"].long()
    valid = (idx < n_flat).float() * am[:, :, None]
    pos = torch.zeros(B, A, n_flat + 1, device=cls.device).scatter_(2, idx.clamp(max=n_flat), 1.0)[..., :n_flat]
    label = torch.stack([1.0 - pos, pos], dim=-1).reshape(B, A, H, W, NA, 2)
    logp = torch.log_softmax(cls, dim=-1)
    per = -(label * (1.0 - logp.exp()) ** cfg["focal_gamma"] * logp).sum(-1)
    mask = am[:, :, None, None, None].expand(per.shape)
    cls_loss = (per * mask).sum() / mask.sum().clamp(min=1.0)
    pred = torch.gather(reg.reshape(B, A, n_flat, code), 2, idx.clamp(max=n_flat - 1)[..., None].expand(-1, -1, -1, code))
    d = pred - batch["reg_pos_target"].float()
    s2 = cfg["smooth_l1_sigma"] ** 2
    sl1 = torch.where(d.abs() < 1.0 / s2, 0.5 * s2 * d * d, d.abs() - 0.5 / s2)
    w = valid[..., None].expand(sl1.shape)
    reg_loss = (sl1 * w).sum() / w.sum().clamp(min=1.0)
    loss = cfg["cls_weight"] * cls_loss + cfg["reg_weight"] * reg_loss
    metrics = {"cls_loss": cls_loss, "reg_loss": reg_loss}
    if teacher_taps is not None:
        kd = 0.0
        m = am.reshape(-1)
        for s, t in zip(out["taps"], teacher_taps):
            sq = (s - t) ** 2
            mm = m.reshape((-1,) + (1,) * (sq.dim() - 1))
            kd = kd + (sq * mm).sum() / (m.sum() * float(np.prod(sq.shape[1:]))).clamp(min=1.0)
        kd = kd / len(out["taps"])
        metrics["kd_loss"] = kd
        loss = loss + cfg["kd_weight"] * kd
    metrics["loss"] = loss
    return loss, metrics


def run_steps(weights: Dict[str, torch.Tensor], cfg: Dict, fusion, layer: int, batches: Sequence[Dict],
              lr: float, prec: Precision, teacher: Optional[Dict[str, torch.Tensor]] = None,
              half_batch: bool = False):
    """The reference's first ``len(batches)`` steps from ``weights`` (the
    student's state dict, not changed). ``half_batch`` plants a fault: each
    step sees only the first half of its scenes. Returns the per-step
    metrics, the first gradients by leaf and the state after the steps."""
    state = {k: v.detach().clone().float() for k, v in weights.items() if not k.endswith("num_batches_tracked")}
    params = [k for k in state if not is_buffer(k)]
    for k in params:
        state[k].requires_grad_(True)
    m = {k: torch.zeros_like(state[k]) for k in params}
    v = {k: torch.zeros_like(state[k]) for k in params}
    per_step, first_grads = [], None
    for t, batch in enumerate(batches, start=1):
        if half_batch:
            half = batch["agent_mask"].shape[0] // 2
            batch = {k: x[:half] for k, x in batch.items()}
        taps = None
        if teacher is not None:
            with torch.no_grad():
                tctx = Ctx(dict(teacher), cfg, prec, train=False)
                taps = forward(tctx, None, batch["bev_teacher"], None, batch["agent_mask"], None)["taps"]
        ctx = Ctx(state, cfg, prec, train=True)
        out = forward(ctx, fusion, batch["bev"], batch["trans"].float(), batch["agent_mask"].bool(), layer)
        loss, metrics = losses(out, batch, cfg, taps)
        grads = torch.autograd.grad(loss, [state[k] for k in params])
        per_step.append({k: float(x.detach()) for k, x in metrics.items()})
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in zip(params, grads)}
        with torch.no_grad():
            b1, b2 = BETAS
            for k, g in zip(params, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k] / (1 - b2 ** t)).sqrt() + ADAM_EPS
                state[k].sub_(lr / (1 - b1 ** t) * m[k] / denom)
    final = {k: x.detach() for k, x in ctx.P.items()}
    return per_step, first_grads, final


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keys: Sequence[str]) -> torch.Tensor:
    """Each leaf's gap of norms, against the larger of its reference norm
    and the median leaf's."""
    pn = torch.stack([prog[k].double().norm() for k in keys])
    rn = torch.stack([ref[k].double().norm() for k in keys])
    return (pn - rn).abs() / torch.maximum(rn, rn.median())


def _norms(prog, ref, keys, i) -> List[float]:
    med = float(torch.stack([ref[k].double().norm() for k in keys]).median())
    return [float(prog[keys[i]].double().norm()), float(ref[keys[i]].double().norm()), med]


def _group_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keys: Sequence[str]) -> float:
    """The gap of the norm of ``keys`` taken together, against the reference's."""
    if not keys:
        return 0.0
    pn = torch.stack([prog[k].double().norm() for k in keys]).norm()
    rn = torch.stack([ref[k].double().norm() for k in keys]).norm()
    return float((pn - rn).abs() / rn.clamp(min=1e-30))


def compare_steps(prog_steps: List[Dict[str, float]], prog_grads: Dict[str, torch.Tensor],
                  prog_change: Dict[str, torch.Tensor], ref_steps: List[Dict[str, float]],
                  ref_grads: Dict[str, torch.Tensor], ref_change: Dict[str, torch.Tensor],
                  fusion_prefixes: Sequence[str] = ()) -> Dict[str, float]:
    """The numbers, and readings beside them; ``*_change`` are each leaf's
    state after the checked steps minus before."""
    loss = [abs(p["loss"] - r["loss"]) / max(abs(r["loss"]), 1e-30) for p, r in zip(prog_steps, ref_steps)]
    gnorm = {k: float(g.double().norm()) for k, g in ref_grads.items()}
    med = float(np.median(list(gnorm.values())))
    moving = [k for k, n in gnorm.items() if n >= NEGLIGIBLE_GRAD * med]
    leaves = moving + [k for k in ref_change if is_buffer(k)]
    grad = _leaf_gaps(prog_grads, ref_grads, moving)
    change = _leaf_gaps(prog_change, ref_change, leaves)
    parts = {f"{k}_gap": abs(prog_steps[0][k] - ref_steps[0][k]) / max(abs(ref_steps[0][k]), 1e-30)
             for k in ref_steps[0] if k != "loss"}
    fusion = [k for k in moving if k.startswith(tuple(fusion_prefixes))]
    return {
        "loss_gap": loss[0],
        "loss_terms_gap": max(parts.values()),
        "grad_gap_median": float(grad.median()),
        "fusion_grad_gap": _group_gap(prog_grads, ref_grads, fusion),
        "change_gap": float(change.max()),
        # readings
        "grad_gap": float(grad.max()),
        **parts,
        "grad_worst_leaf": moving[int(grad.argmax())],
        "change_worst_leaf": leaves[int(change.argmax())],
        # that leaf's change norm, the program's and the reference's, and the median leaf's reference one
        "change_worst_norms": _norms(prog_change, ref_change, leaves, int(change.argmax())),
        **{f"loss_gap_step{i + 1}": v for i, v in enumerate(loss)},
    }
