"""Fusion core: the shared forward of the intermediate-collaboration models.

Encode every agent's BEV with the backbone, warp every sender's
stage-``layer`` map into every receiver's frame, fuse (the subclass's
``fuse``), put the fused map in place of the stage-``layer`` skip and decode
with the other skips per agent, then the task's heads. Absent agents are
carried by a boolean ``agent_mask``; they still flow through the conv stack
(and its unmasked BatchNorm statistics) as all-zero BEVs, and the fusion
gives them no weight as senders. Only the scorers of ``cat`` and ``agent``
(and DiscoNet's) mask their BatchNorm statistics.

``task`` "det" gives the detection heads, "seg" a ``SegHead`` over the
backbone that ``config.seg_backbone`` names (the UNet or the STPN); the
attribute is ``stpn`` either way, as in the JAX package's key layout.

With ``store_bf16`` (inference, see ``ConvBNRelu.forward``) the eval-mode
bf16 compute mode stores its maps in bf16. DiscoNet's fusion-layer map is
stored so too, so its warp samples bf16 maps (accumulating in fp32), as the
JAX package warps at inference on the TPU; its scorer casts to bf16 anyway.
``config.warp_dtype`` "float32" keeps that map fp32 (the JAX ``warp_dtype``).
Every other fusion model keeps the fusion-layer map fp32
(``fusion_store_bf16`` False): V2VNet's hidden state, When2com's unwarped
values and the naive sums, means and maxima read it as the JAX package's do.
Training and the KD teacher store fp32 throughout. The warp is the JAX
package's dispatch (``warp_all_pairs``): the product with the dense tap
matrix at fusion grids of up to 1024 cells (every layer of the 64-grid and
layer 3 of the 256-grid), the gather above that; the backward of either
repeats bit for bit on the card (``ops/warp.py``).

Under a device mesh (``parallel.attach_mesh``) a rank holds its scenes,
agents and BEV rows. With an agent or a spatial axis the fusion-layer maps
and the agent mask are all-gathered before the warp, which reads every
sender's whole map, and the rank warps and fuses for its own receivers'
rows (``_warp_and_fuse``); the all_gather's backward sums the senders'
gradients back onto their ranks. Every model fuses through
``fuse_sharded``, which takes the receivers' and the senders' masks apart;
one process calls it with the same mask twice. What a model reads beyond
its rows (a 3x3 conv's halo, a spatial mean, V2VNet's re-warped state,
When2com's keys) it takes through the mesh there.

The public outputs keep the JAX package's layout: for "det" cls (B, A, H, W,
NA, NC), reg (B, A, H, W, NA, code), head_raw (B, A, H, W, NA*(NC + code)) in
``head_raw_dtype`` and head_raw_f32 (the same unrounded, fp32); for "seg"
seg (B, A, H, W, num_seg_classes) fp32; with ``kd_flag``, kd_feats: the KD
taps, each (B, A, h, w, c) fp32.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.models.backbone import SegHead, make_heads, make_stpn, stage
from disconet_tpu_torch.models.unet import make_unet, use_unet
from disconet_tpu_torch.ops.warp import warp_features, warp_features_matmul
from disconet_tpu_torch.utils import profiling

TASKS = ("det", "seg")

# fusion grids up to this many cells warp by the tap-matrix product (the JAX
# package's ``warp_all_pairs``: its (Ar, As, cells, cells) matrix stays small)
MATMUL_WARP_CELLS = 1024


def agents_to_batch(x: torch.Tensor) -> torch.Tensor:
    """(B, A, ...) -> (B*A, ...)."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def batch_to_agents(x: torch.Tensor, batch: int, agents: int) -> torch.Tensor:
    """(B*A, ...) -> (B, A, ...)."""
    return x.reshape((batch, agents) + tuple(x.shape[1:]))


def warp_all_pairs(feats: torch.Tensor, trans: torch.Tensor, extent_xy: Tuple,
                   rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Every sender's map in every receiver's frame: feats (B, As, h, w, C),
    trans (B, Ar, As, 4, 4) -> (B, Ar, As, h, w, C), zeros outside each
    sender's field of view; ``rows`` computes only those receiver rows. The
    tap-matrix product of ``ops/warp.py`` while h*w <= ``MATMUL_WARP_CELLS``,
    else the gather, as the JAX package dispatches."""
    impl = warp_features_matmul if feats.shape[2] * feats.shape[3] <= MATMUL_WARP_CELLS else warp_features
    with profiling.annotate("model/warp"):
        return impl(feats, trans, extent_xy, rows)


def sender_softmax(scores: torch.Tensor, agent_mask: torch.Tensor) -> torch.Tensor:
    """Per-pixel softmax over the sender axis of (B, Ar, As, h, w), over present
    senders only (self-edge included): absent senders get weight exactly 0."""
    neg = torch.finfo(scores.dtype).min
    m = agent_mask[:, None, :, None, None]
    return torch.softmax(torch.where(m, scores, torch.full_like(scores, neg)), dim=2)


def masked_sender_reduce(warped: torch.Tensor, agent_mask: torch.Tensor, op: str) -> torch.Tensor:
    """sum, mean (over present senders, the count clamped at 1) or max (absent
    senders at ``finfo.min``) over the sender axis of (B, Ar, As, h, w, C)."""
    m = agent_mask[:, None, :, None, None, None]
    if op == "sum":
        return (warped * m.to(warped.dtype)).sum(dim=2)
    if op == "mean":
        mf = m.to(warped.dtype)
        return (warped * mf).sum(dim=2) / mf.sum(dim=2).clamp(min=1.0)
    if op == "max":
        neg = torch.full_like(warped, torch.finfo(warped.dtype).min)
        return torch.where(m, warped, neg).amax(dim=2)
    raise ValueError(op)


def bev_to_batch(bev: torch.Tensor) -> torch.Tensor:
    """(B, A, H, W, Z) grids -> (B*A, Z, H, W) fp32 in the channels_last
    memory format: a view of the (H, W, Z) grid."""
    x = agents_to_batch(bev.float()).permute(0, 3, 1, 2)
    return x.contiguous(memory_format=torch.channels_last)


def attach_backbone_and_heads(model: nn.Module, config: Config, task: str, allow_block: bool = True) -> None:
    """``model.stpn`` (the UNet for seg with ``seg_backbone`` "unet", else the
    STPN, in block space where ``config.block_space`` and ``allow_block``
    say so) and ``model.heads`` (det) or ``model.seg_head`` (seg)."""
    if task not in TASKS:
        raise ValueError(f"task must be one of {TASKS}, got {task!r}")
    model.task = task
    if use_unet(config, task):
        model.stpn = make_unet(config)
        head_in = config.unet_channels[0]
    else:
        model.stpn = make_stpn(config, allow_block)
        head_in = config.head_channels
    if task == "det":
        model.heads = make_heads(config)
    else:
        model.seg_head = SegHead(head_in, config.num_seg_classes)


def head_outputs(model: nn.Module, head_in: torch.Tensor, taps: List[torch.Tensor], B: int, A: int
                 ) -> Dict[str, torch.Tensor]:
    """The task's heads on the (B*A, C, H, W) head input -> the output dict."""
    if model.task == "det":
        cls, reg, raw, raw_f32 = model.heads(head_in)
        out = {
            "cls": batch_to_agents(cls, B, A),
            "reg": batch_to_agents(reg, B, A),
            "head_raw": batch_to_agents(raw, B, A),
            "head_raw_f32": batch_to_agents(raw_f32, B, A),
        }
    else:
        out = {"seg": batch_to_agents(model.seg_head(head_in), B, A)}
    if model.kd_flag:  # (N, c, h, w) -> (B, A, h, w, c), free for channels_last maps
        out["kd_feats"] = [batch_to_agents(t.permute(0, 2, 3, 1).float(), B, A) for t in taps]
    return out


class IntermediateFusionModel(nn.Module):
    """Encode per agent -> fuse at ``layer`` -> decode with skips -> heads."""

    # store the fusion-layer map in bf16 under store_bf16 (DiscoNet only)
    fusion_store_bf16 = False

    def __init__(self, config: Config, layer: int = 3, kd_flag: bool = False, task: str = "det"):
        super().__init__()
        self.config = config
        self.layer = layer
        self.kd_flag = kd_flag
        self.mesh = None  # a parallel.Mesh, set by parallel.attach_mesh
        # whether fuse reads the warped maps (When2com without warp_flag does not)
        self.uses_warp = True
        # fusion at layer 0 replaces stage 0's map, which must stay addressable by space
        attach_backbone_and_heads(self, config, task, allow_block=layer != 0)

    @property
    def layer_channels(self) -> int:
        """Channels of the fused map at this model's ``layer``, on its backbone."""
        ch = self.config.unet_channels if use_unet(self.config, self.task) else self.config.backbone_channels
        return ch[min(self.layer, len(ch) - 1)]

    def fuse(self, feats_k: torch.Tensor, warped: Optional[torch.Tensor], agent_mask: torch.Tensor,
             trans: torch.Tensor) -> torch.Tensor:
        """feats_k (B, A, h, w, C), warped (B, Ar, As, h, w, C) or None,
        agent_mask (B, A) bool, trans (B, A, A, 4, 4) for a re-warp
        -> (B, A, h, w, C): the one-process fusion."""
        return self.fuse_sharded(feats_k, warped, agent_mask, agent_mask, trans)

    def fuse_sharded(self, feats_k: torch.Tensor, warped: Optional[torch.Tensor], recv_mask: torch.Tensor,
                     send_mask: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
        """The fusion of a rank's own receivers and rows: feats_k (B, Ar, h,
        w, C), warped (B, Ar, As, h, w, C) or None, the receivers' (B, Ar)
        and the senders' (B, As) masks, the receivers' poses trans (B, Ar,
        As, 4, 4) -> (B, Ar, h, w, C). Without a mesh Ar = As and h is the
        whole map."""
        raise NotImplementedError

    def encode(self, bev: torch.Tensor, store_bf16: bool = False):
        """The encoder's maps (B*A, C, h, w) per stage and the fusion layer's
        map (B, A, h, w, C)."""
        B, A = bev.shape[:2]
        k = self.layer
        bf16_fusion = self.fusion_store_bf16 and self.config.warp_dtype == "bfloat16"
        feats = self.stpn.encode(bev_to_batch(bev), store_bf16, None if bf16_fusion else k)
        return feats, batch_to_agents(feats[k].permute(0, 2, 3, 1), B, A)

    def warp(self, fk: torch.Tensor, trans: torch.Tensor) -> Optional[torch.Tensor]:
        """The all-pairs warp (B, Ar, As, h, w, C) of the fusion layer's map,
        or None where ``fuse`` does not read it."""
        return warp_all_pairs(fk, trans, self.config.area_extents[:2]) if self.uses_warp else None

    def gather_senders(self, x: torch.Tensor) -> torch.Tensor:
        """A rank's (B, Ar, h, w, C) maps -> every sender's whole map (B, As,
        H, w, C), all-gathered over ``agent`` and ``spatial``; ``x`` itself
        without a mesh."""
        mesh = self.mesh
        if mesh is None:
            return x
        return mesh.all_gather(mesh.all_gather(x, "agent", 1), "spatial", 2)

    def warp_rows(self, senders: torch.Tensor, trans: torch.Tensor, h: int) -> torch.Tensor:
        """The whole maps of every sender (B, As, H, w, C) warped into the
        rank's receivers' frames (``trans`` (B, Ar, As, 4, 4)) at its ``h``
        rows -> (B, Ar, As, h, w, C)."""
        rows = None
        if self.mesh is not None and self.mesh.axis_size("spatial") > 1:
            r0 = self.mesh.coords["spatial"] * h
            rows = (r0, r0 + h)
        return warp_all_pairs(senders, trans, self.config.area_extents[:2], rows=rows)

    def _warp_and_fuse(self, fk: torch.Tensor, agent_mask: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
        """The fusion of this rank's maps. Under a mesh with agent or spatial
        axes the senders' maps and masks are all-gathered (the warp reads the
        whole map of every agent) and the rank fuses its own receivers'
        rows; ``trans`` holds its receivers' rows already."""
        mesh = self.mesh
        if mesh is None or not mesh.gathers_senders:
            warped = self.warp(fk, trans)
            with profiling.annotate("model/fuse"):
                return self.fuse(fk, warped, agent_mask, trans)
        send_mask = mesh.all_gather(agent_mask, "agent", 1)
        warped = self.warp_rows(self.gather_senders(fk), trans, fk.shape[2]) if self.uses_warp else None
        with profiling.annotate("model/fuse"):
            return self.fuse_sharded(fk, warped, agent_mask, send_mask, trans)

    def forward(
        self, bev: torch.Tensor, trans: torch.Tensor, agent_mask: torch.Tensor, store_bf16: bool = False
    ) -> Dict[str, torch.Tensor]:
        """bev (B, A, H, W, Z), trans (B, A, A, 4, 4), agent_mask (B, A) bool;
        ``store_bf16`` as ``ConvBNRelu.forward``. The warp and the fusion are
        one ``stage``: under ``train_remat`` the backward recomputes them from
        the fusion layer's map."""
        B, A = bev.shape[:2]
        k = self.layer
        with profiling.annotate("model/encode"):
            feats, fk = self.encode(bev, store_bf16)
        fuse = functools.partial(self._warp_and_fuse, agent_mask=agent_mask.to(torch.bool), trans=trans)
        fused = stage(fuse, fk)
        with profiling.annotate("model/decode"):
            feats = list(feats)
            feats[k] = agents_to_batch(fused).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last
            )
            head_in, taps = self.stpn.decode(feats, store_bf16, head_fp32=self.task == "seg")
            return head_outputs(self, head_in, taps, B, A)
