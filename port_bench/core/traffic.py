"""The traffic generators: every input of a run, made from ``--seed``.

Frozen copies of the program's generators, so that a change to the program
cannot change the inputs it is measured on:

* :func:`planar_poses` is ``disconet_tpu_torch/pipeline.py::example_batch``'s
  pose draw (lines 104-120): random planar rigid poses per agent,
  ``trans[b, i, j] = inv(pose_i) @ pose_j``;
* :func:`predict_pool` draws points uniformly in the extent, as
  ``chip_smoke.py::_points`` (lines 369-375) does, on the device;
* :func:`train_pool` follows ``pipeline.example_train_batch`` (lines
  124-159): uint8 occupancy grids for the student and the teacher, agent
  (1, A-1) absent, a few car-sized boxes a frame. It draws the boxes'
  positive anchor sites and their regression targets straight from the seed
  instead of through the host's target assignment, which takes seconds a
  batch.

A mix's file gives the sizes; the same seed gives the same inputs.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from port_bench.core.weights import stream_seed


def _extent(cfg: Dict) -> np.ndarray:
    return np.asarray(cfg["area_extents"], np.float64)


def grid_dims(cfg: Dict):
    """(H, W, Z) cells: ceil(extent / voxel), float32 extents (the program's rule)."""
    ext = _extent(cfg).astype(np.float32).astype(np.float64)
    vs = np.asarray(cfg["voxel_size"], np.float32).astype(np.float64)
    return tuple(int(d) for d in np.ceil((ext[:, 1] - ext[:, 0]) / vs - 1e-9))


def planar_poses(rng: np.random.Generator, batch: int, agents: int, xy_m: float) -> np.ndarray:
    """(B, A, A, 4, 4) float32 relative poses of random planar rigid poses."""
    trans = np.tile(np.eye(4, dtype=np.float32), (batch, agents, agents, 1, 1))
    for b in range(batch):
        poses = []
        for _ in range(agents):
            th = rng.uniform(-np.pi, np.pi)
            c, s = np.cos(th), np.sin(th)
            T = np.eye(4, dtype=np.float32)
            T[:2, :2] = [[c, -s], [s, c]]
            T[:2, 3] = rng.uniform(-xy_m, xy_m, 2)
            poses.append(T)
        for i in range(agents):
            inv = np.linalg.inv(poses[i])
            for j in range(agents):
                trans[b, i, j] = inv @ poses[j]
    return trans


def agent_mask(batch: int, agents: int, absent: List[List[int]]) -> np.ndarray:
    mask = np.ones((batch, agents), bool)
    for b, a in absent:
        if b < batch and a < agents:
            mask[b, a] = False
    return mask


def predict_pool(cfg: Dict, mix: Dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    """``mix["pool"]`` host batches of points (B, A, N, 3) float32 (an
    absent agent's rows are NaN: no returns), poses and the agent mask."""
    B, A, N = mix["batch"], mix["agents"], mix["points_per_agent"]
    rng = np.random.default_rng(stream_seed(seed, 10))
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 11))
    lo = torch.tensor(_extent(cfg)[:, 0], dtype=torch.float32, device=device)
    hi = torch.tensor(_extent(cfg)[:, 1], dtype=torch.float32, device=device)
    pool = []
    for _ in range(mix["pool"]):
        mask = agent_mask(B, A, mix["absent"])
        u = torch.rand((B, A, N, 3), generator=gen, device=device)
        pts = lo + u * (hi - lo)
        pts[torch.from_numpy(~mask).to(device)] = float("nan")
        pool.append({"points": pts.cpu().numpy(), "trans": planar_poses(rng, B, A, mix["pose_xy_m"]),
                     "agent_mask": mask})
    return pool


def pack_z(grid: torch.Tensor) -> torch.Tensor:
    """(..., Z) bool -> (..., ceil(Z/8)) uint8, ``np.packbits`` bit order
    (the first voxel is the high bit of the first byte)."""
    z = grid.shape[-1]
    nb = -(-z // 8)
    g = torch.nn.functional.pad(grid.to(torch.uint8), (0, nb * 8 - z))
    g = g.reshape(tuple(grid.shape[:-1]) + (nb, 8))
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=grid.device)
    return (g * w).sum(-1, dtype=torch.uint8)


def _sparse_targets(rng, cfg: Dict, mask: np.ndarray, boxes: int, max_pos: int):
    """Positive anchor sites ((h*W + w)*NA + a, padded with H*W*NA) and
    their (dx, dy, dw, dl, sin, cos) targets, per (scene, agent): each box
    a car (w 1.8-2.2 m, l 4-5 m) at a random cell 3 m or more inside the
    extent, heading near anchor 0 or 1; its positives are the 3x3 cells
    around it at that anchor."""
    H, W, _ = grid_dims(cfg)
    NA = len(cfg["anchor_sizes"])
    ext = _extent(cfg)
    vx, vy = cfg["voxel_size"][0], cfg["voxel_size"][1]
    inset = int(math.ceil(3.0 / vx))
    n_flat = H * W * NA
    B, A = mask.shape
    idx = np.full((B, A, max_pos), n_flat, np.int32)
    tgt = np.zeros((B, A, max_pos, 6), np.float32)
    for b in range(B):
        for a in range(A):
            if not mask[b, a]:
                continue
            sites = {}
            for _ in range(boxes):
                h, w = rng.integers(inset, H - inset), rng.integers(inset, W - inset)
                anc = int(rng.integers(0, 2))
                aw, al, ath = cfg["anchor_sizes"][anc]
                cx = ext[0, 0] + (h + 0.5 + rng.uniform(-0.5, 0.5)) * vx
                cy = ext[1, 0] + (w + 0.5 + rng.uniform(-0.5, 0.5)) * vy
                gw, gl = rng.uniform(1.8, 2.2), rng.uniform(4.0, 5.0)
                th = ath + rng.uniform(-0.3, 0.3)
                da = math.sqrt(aw * aw + al * al)
                for dh in (-1, 0, 1):
                    for dw in (-1, 0, 1):
                        ax = ext[0, 0] + (h + dh + 0.5) * vx
                        ay = ext[1, 0] + (w + dw + 0.5) * vy
                        site = ((h + dh) * W + (w + dw)) * NA + anc
                        sites[site] = ((cx - ax) / da, (cy - ay) / da, math.log(gw / aw), math.log(gl / al),
                                       math.sin(th), math.cos(th))
            keys = sorted(sites)[:max_pos]
            idx[b, a, :len(keys)] = keys
            tgt[b, a, :len(keys)] = [sites[k] for k in keys]
    return idx, tgt


def train_pool(cfg: Dict, mix: Dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    """``mix["pool"]`` host training batches as the program's loader gives
    them: bit-packed grids ``bev_packed`` (and ``bev_teacher_packed``),
    poses, the agent mask, sparse targets and ``frame_idx`` (the rows of
    the KD tables)."""
    B, A = mix["batch"], mix["agents"]
    H, W, Z = grid_dims(cfg)
    rng = np.random.default_rng(stream_seed(seed, 20))
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 21))
    pool = []
    for k in range(mix["pool"]):
        mask = agent_mask(B, A, mix["absent"])
        present = torch.from_numpy(mask).to(device)[:, :, None, None, None]
        grids = {}
        for key, occ in zip(("bev_packed", "bev_teacher_packed"), mix["occupancy"]):
            g = (torch.rand((B, A, H, W, Z), generator=gen, device=device) < occ) & present
            grids[key] = pack_z(g).cpu().numpy()
        idx, tgt = _sparse_targets(rng, cfg, mask, mix["boxes_per_frame"], cfg["max_pos_anchors"])
        pool.append({**grids, "trans": planar_poses(rng, B, A, mix["pose_xy_m"]), "agent_mask": mask,
                     "reg_pos_idx": idx, "reg_pos_target": tgt,
                     "frame_idx": np.arange(k * B, (k + 1) * B, dtype=np.int32)})
    return pool
