"""Synthetic V2X scenes, written in the on-disk schema.

The port's own copy of the JAX package's generator: the same seed writes the
same frames, byte for byte. A scene is a small world with:

* a road band and N vehicles (oriented boxes) scattered on it;
* 2..max_agents agents (agent 0 = RSU: fixed pose near the road);
* per agent, a LiDAR-ish cloud: points on vehicle surfaces whose density
  falls off with range (and, with ``occlusion``, with the share of the
  vehicle's azimuth that closer vehicles leave visible), plus sparse ground
  returns.

``generate_dataset`` writes ``{root}/agent{i}/{scene}_{frame}/0.npy``, so the
loader reads synthetic and real data by one code path. The grids are
voxelized on the host, by the plain voxelizer on CPU tensors (bit-exact with
the JAX package's numpy voxelizer).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from disconet_tpu_torch.config import VEHICLE_CLASS_SIZES, Config
from disconet_tpu_torch.data import schema
from disconet_tpu_torch.data.targets import assign_targets
from disconet_tpu_torch.ops.boxes import box_corners_np, make_anchors
from disconet_tpu_torch.ops.voxelize import voxelize_occupy_plain


def voxelize_np(points: np.ndarray, config: Config) -> np.ndarray:
    """(N, 3) points -> (H, W, Z) float32 occupancy on the host."""
    pts = torch.from_numpy(np.ascontiguousarray(points, dtype=np.float32))
    return voxelize_occupy_plain(pts, config.voxel_size, config.area_extents).numpy()


def _pose_2d(x: float, y: float, yaw: float) -> np.ndarray:
    """4x4 homogeneous pose (agent -> world) for a planar agent."""
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
    T[0, 3], T[1, 3] = x, y
    return T


def _inv_pose(T: np.ndarray) -> np.ndarray:
    R = T[:3, :3]
    inv = np.eye(4, dtype=np.float32)
    inv[:3, :3] = R.T
    inv[:3, 3] = -R.T @ T[:3, 3]
    return inv


def _world_to_agent_boxes(boxes_w: np.ndarray, T_wa: np.ndarray) -> np.ndarray:
    """World-frame boxes (G, 5) -> agent frame given the agent's pose T_wa."""
    if len(boxes_w) == 0:
        return boxes_w.reshape(0, 5)
    T_aw = _inv_pose(T_wa)
    yaw = np.arctan2(T_wa[1, 0], T_wa[0, 0])
    out = boxes_w.copy()
    pts = np.concatenate(
        [boxes_w[:, :2], np.zeros((len(boxes_w), 1)), np.ones((len(boxes_w), 1))], axis=1
    )
    pa = (T_aw @ pts.T).T
    out[:, 0:2] = pa[:, 0:2]
    out[:, 4] = boxes_w[:, 4] - yaw
    return out


def _sample_vehicle_points(rng: np.random.Generator, box: np.ndarray, n: int) -> np.ndarray:
    """LiDAR-ish returns on a vehicle: perimeter walls + roof, world frame (n, 3)."""
    corners = box_corners_np(box[None])[0]  # (4, 2)
    t = rng.uniform(0.0, 4.0, size=n)
    edge = np.minimum(t.astype(np.int64), 3)
    frac = (t - edge)[:, None]
    a = corners[edge]
    b = corners[(edge + 1) % 4]
    xy = a + frac * (b - a)
    # 70% wall points (z in [-1.5, 0.2]), 30% roof (z ~ 0.2)
    z = np.where(
        rng.uniform(size=n) < 0.7,
        rng.uniform(-1.5, 0.2, size=n),
        rng.normal(0.2, 0.05, size=n),
    )
    return np.concatenate([xy, z[:, None]], axis=1)


def _union_len(segs: List[Tuple[float, float]]) -> float:
    """Total length of a union of 1-D intervals."""
    if not segs:
        return 0.0
    segs = sorted(segs)
    total, cur_lo, cur_hi = 0.0, segs[0][0], segs[0][1]
    for lo, hi in segs[1:]:
        if lo > cur_hi:
            total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    return total + (cur_hi - cur_lo)


def _angular_interval(sensor: np.ndarray, box: np.ndarray) -> Tuple[float, float]:
    """The [lo, hi] azimuth interval a box subtends from ``sensor``, unwrapped
    around the first corner so the ±π seam cannot split it."""
    corners = box_corners_np(box[None])[0]  # (4, 2)
    ang = np.arctan2(corners[:, 1] - sensor[1], corners[:, 0] - sensor[0])
    ang = ang[0] + np.angle(np.exp(1j * (ang - ang[0])))
    return float(ang.min()), float(ang.max())


def shadow_segments(
    sensor: np.ndarray, boxes: np.ndarray
) -> List[Tuple[float, float, List[Tuple[float, float]]]]:
    """Per box: its azimuth interval ``(lo, hi)`` from ``sensor`` plus the
    sub-segments of that interval shadowed by *closer* boxes.

    The LiDAR occlusion model of V2X-Sim scenes in 2D: a vehicle whose angular
    extent is covered by nearer vehicles returns no points to this sensor;
    only a *different* agent (or the RSU) sees it, which is the signal
    collaborative fusion exists to recover."""
    G = len(boxes)
    if G == 0:
        return []
    d = np.hypot(boxes[:, 0] - sensor[0], boxes[:, 1] - sensor[1])
    ivals = [_angular_interval(sensor, b) for b in boxes]
    out = []
    for k in range(G):
        lo, hi = ivals[k]
        mid = 0.5 * (lo + hi)
        segs = []
        for m in range(G):
            if m == k or d[m] >= d[k]:
                continue
            mlo, mhi = ivals[m]
            # re-center m's interval onto k's branch of the circle
            shift = 2.0 * np.pi * np.round((mid - 0.5 * (mlo + mhi)) / (2.0 * np.pi))
            s, e = max(lo, mlo + shift), min(hi, mhi + shift)
            if e > s:
                segs.append((s, e))
        out.append((lo, hi, segs))
    return out


def visible_fractions(sensor: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Fraction of each box's azimuth interval NOT shadowed by a closer box
    (see ``shadow_segments``)."""
    frac = np.ones(len(boxes), dtype=np.float32)
    for k, (lo, hi, segs) in enumerate(shadow_segments(sensor, boxes)):
        width = hi - lo
        if width > 1e-9:
            frac[k] = max(0.0, 1.0 - _union_len(segs) / width)
    return frac


def _sample_ground_points(rng: np.random.Generator, center: np.ndarray, n: int, radius: float) -> np.ndarray:
    r = radius * np.sqrt(rng.uniform(0.05, 1.0, size=n))
    a = rng.uniform(0, 2 * np.pi, size=n)
    xy = center[None, :] + np.stack([r * np.cos(a), r * np.sin(a)], axis=1)
    z = rng.normal(-1.9, 0.05, size=n)
    return np.concatenate([xy, z[:, None]], axis=1)


def _agent_cloud(
    rng: np.random.Generator,
    sensor: np.ndarray,
    boxes_world: np.ndarray,
    max_range: float,
    points_per_vehicle: int,
    ground_points: int,
    occlusion: bool,
) -> np.ndarray:
    """One agent's LiDAR-ish cloud (world frame): sparse ground returns plus
    per-vehicle surface returns whose density falls with range — and, with
    ``occlusion``, with the visible fraction of the vehicle's azimuth interval
    (closer vehicles shadow farther ones; a fully shadowed vehicle returns
    nothing, so only collaboration can recover it)."""
    pts = [_sample_ground_points(rng, sensor, ground_points, max_range * 0.7)]
    shadows = shadow_segments(sensor, boxes_world) if occlusion else None
    for k, box in enumerate(boxes_world):
        d = np.hypot(box[0] - sensor[0], box[1] - sensor[1])
        if d > max_range:
            continue
        n = int(points_per_vehicle * min(1.0, (12.0 / max(d, 3.0)) ** 1.5))
        if not occlusion:
            pts.append(_sample_vehicle_points(rng, box, max(6, n)))
            continue
        # spatially-correct shadowing: sample the surface at the unshadowed
        # density, then reject returns whose azimuth a closer vehicle covers —
        # partially occluded vehicles keep only the visible sliver of points
        cand = _sample_vehicle_points(rng, box, max(1, n))
        lo, hi, segs = shadows[k]
        if segs:
            mid = 0.5 * (lo + hi)
            ang = np.arctan2(cand[:, 1] - sensor[1], cand[:, 0] - sensor[0])
            ang = mid + np.angle(np.exp(1j * (ang - mid)))
            keep = np.ones(len(cand), dtype=bool)
            for s, e in segs:
                keep &= ~((ang >= s) & (ang <= e))
            cand = cand[keep]
        if len(cand) < 3:  # (near-)fully shadowed: no returns at all
            continue
        pts.append(cand)
    return np.concatenate(pts, axis=0).astype(np.float32)


def generate_scene(
    seed: int,
    config: Config,
    num_agents: Optional[int] = None,
    num_vehicles: Optional[int] = None,
    points_per_vehicle: int = 220,
    ground_points: int = 1500,
    occlusion: bool = False,
) -> Dict:
    """One world + agents + per-agent clouds and gt. Returns a raw scene dict.

    Keys: ``boxes_world`` (G,5), ``agent_poses`` (A,4,4), ``points`` list of
    (Ni,3) world-frame clouds attributed to each agent's sensor, ``num_agents``.
    """
    rng = np.random.default_rng(seed)
    (x_lo, x_hi), (y_lo, y_hi), _ = config.area_extents
    world_half = 0.75 * (x_hi - x_lo)  # world a bit larger than one agent's view

    A = int(num_agents if num_agents is not None else rng.integers(2, config.max_agents + 1))
    # occluded scenes default denser: shadowing needs traffic (measured: at
    # G~8 only ~2% of in-range boxes are fully hidden, at G~16 ~7.6% plus
    # ~57% losing half their returns — enough signal for fusion to matter)
    G = int(num_vehicles if num_vehicles is not None
            else rng.integers(12, 20) if occlusion else rng.integers(6, 14))

    # road band through the world, vehicles placed along it + some off-road
    road_y = rng.uniform(-0.3, 0.3) * world_half
    road_w = rng.uniform(8.0, 14.0)
    # multi-class (config.num_classes > 2): class id -> size distribution, so
    # classes are separable and a detector can learn them; the reference task
    # is binary (vehicle)
    C = config.num_classes
    if C - 1 > len(VEHICLE_CLASS_SIZES):
        raise ValueError(
            f"synthetic generator supports at most {len(VEHICLE_CLASS_SIZES) + 1} "
            f"classes (bg + {len(VEHICLE_CLASS_SIZES)}), got num_classes={C}"
        )
    boxes, classes = [], []
    for g in range(G):
        on_road = rng.uniform() < 0.7
        cx = rng.uniform(-world_half, world_half)
        if on_road:
            cy = road_y + rng.uniform(-road_w / 2 + 1.0, road_w / 2 - 1.0)
            theta = rng.normal(0.0, 0.15) + (0.0 if rng.uniform() < 0.5 else np.pi)
        else:
            cy = rng.uniform(-world_half, world_half)
            theta = rng.uniform(-np.pi, np.pi)
        cls = int(rng.integers(1, C)) if C > 2 else 1
        (w_lo, w_hi), (l_lo, l_hi) = VEHICLE_CLASS_SIZES[cls - 1]
        w = rng.uniform(w_lo, w_hi)
        l = rng.uniform(l_lo, l_hi)
        boxes.append([cx, cy, w, l, theta])
        classes.append(cls)
    boxes_world = np.asarray(boxes, dtype=np.float32)
    classes_world = np.asarray(classes, dtype=np.int32)

    # agents: slot 0 is the RSU (fixed, near road center); 1.. are vehicles' ego
    poses = []
    for a in range(A):
        if a == 0:
            poses.append(_pose_2d(0.0, road_y + road_w / 2 + 2.0, -np.pi / 2))
        else:
            ax = rng.uniform(-0.6 * world_half, 0.6 * world_half)
            ay = road_y + rng.uniform(-road_w / 2 + 1.0, road_w / 2 - 1.0)
            poses.append(_pose_2d(ax, ay, rng.normal(0.0, 0.4)))
    agent_poses = np.stack(poses)  # (A, 4, 4)

    # per-agent clouds (world frame); density falls with range from the sensor
    max_range = 0.9 * (x_hi - x_lo)
    clouds = [
        _agent_cloud(rng, agent_poses[a][:2, 3], boxes_world, max_range,
                     points_per_vehicle, ground_points, occlusion)
        for a in range(A)
    ]

    return {
        "boxes_world": boxes_world,
        "classes_world": classes_world,
        "agent_poses": agent_poses,
        "points": clouds,
        "num_agents": A,
        "road": (road_y, road_w),
        "occlusion": occlusion,
    }


def _seg_label(config: Config, boxes_agent: np.ndarray, road_y_agent_fn, bev2d: np.ndarray) -> np.ndarray:
    """Per-cell semantic labels: 0 bg, 1 vehicle, 2 road, 3 terrain."""
    H, W = config.map_dims
    (x_lo, _), (y_lo, _), _ = config.area_extents
    vx, vy, _ = config.voxel_size
    xs = x_lo + (np.arange(H) + 0.5) * vx
    ys = y_lo + (np.arange(W) + 0.5) * vy
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    lab = np.full((H, W), 3, dtype=np.int32)  # terrain by default
    road_mask = road_y_agent_fn(gx, gy)
    lab[road_mask] = 2
    # vehicles: rasterize rotated boxes by point-in-box test on cell centers
    for box in boxes_agent:
        cx, cy, w, l, th = box
        dx, dyy = gx - cx, gy - cy
        c, s = np.cos(-th), np.sin(-th)
        u = c * dx - s * dyy
        v = s * dx + c * dyy
        lab[(np.abs(u) <= w / 2) & (np.abs(v) <= l / 2)] = 1
    return lab


def scene_to_frames(scene: Dict, config: Config, anchors: np.ndarray | None = None) -> List[Dict]:
    """Raw scene -> one frame dict of the schema per agent."""
    if anchors is None:
        anchors = make_anchors(config)
    A = scene["num_agents"]
    MA = config.max_agents
    poses = scene["agent_poses"]
    road_y, road_w = scene["road"]
    frames = []
    merged_world = np.concatenate(scene["points"], axis=0)

    for i in range(A):
        T_wi = poses[i]
        T_iw = _inv_pose(T_wi)

        def to_agent(pts_w: np.ndarray) -> np.ndarray:
            homo = np.concatenate([pts_w, np.ones((len(pts_w), 1), np.float32)], axis=1)
            return (T_iw @ homo.T).T[:, :3]

        pts_i = to_agent(scene["points"][i])
        pts_teacher = to_agent(merged_world)

        bev = voxelize_np(pts_i, config)
        bev_teacher = voxelize_np(pts_teacher, config)

        boxes_i = _world_to_agent_boxes(scene["boxes_world"], T_wi)
        (x_lo, x_hi), (y_lo, y_hi), _ = config.area_extents
        inside = (
            (boxes_i[:, 0] >= x_lo) & (boxes_i[:, 0] < x_hi)
            & (boxes_i[:, 1] >= y_lo) & (boxes_i[:, 1] < y_hi)
        )
        track_ids = np.nonzero(inside)[0].astype(np.int32)  # world box index = identity
        boxes_i = boxes_i[inside]
        classes_i = np.asarray(
            scene.get("classes_world", np.ones(len(inside), np.int32))
        )[inside].astype(np.int32)

        tgt = assign_targets(
            boxes_i, config, anchors=anchors,
            gt_classes=classes_i if config.num_classes > 2 else None,
        )

        trans = np.zeros((MA, 4, 4), dtype=np.float32)
        for j in range(A):
            trans[j] = T_iw @ poses[j]  # T[i <- j]

        yaw_i = np.arctan2(T_wi[1, 0], T_wi[0, 0])

        def road_mask_fn(gx, gy, _T=T_wi, _yaw=yaw_i):
            c, s = np.cos(_yaw), np.sin(_yaw)
            wy = s * gx + c * gy + _T[1, 3]
            return np.abs(wy - road_y) <= road_w / 2

        frames.append(
            {
                "padded_voxel_points": bev[None].astype(np.float32),
                "padded_voxel_points_teacher": bev_teacher[None].astype(np.float32),
                "label_one_hot": tgt["label_one_hot"],
                "reg_target": tgt["reg_target"],
                "reg_loss_mask": tgt["reg_loss_mask"],
                # anchors_map omitted: a function of Config (9.4 MB dense a
                # frame); real data has it and the loader reads both
                "vis_maps": bev.max(axis=-1).astype(np.float32),
                "gt_max_iou": tgt["gt_max_iou"],
                "gt_boxes": boxes_i.astype(np.float32),
                "gt_classes": classes_i,
                "gt_track_ids": track_ids,
                "target_agent_id": np.int32(i),
                "num_agent": np.int32(A),
                "trans_matrices": trans,
                "seg_label": _seg_label(config, boxes_i, road_mask_fn, bev.max(-1)),
            }
        )
    return frames


def generate_dataset(
    root: str,
    config: Config,
    num_scenes: int = 2,
    frames_per_scene: int = 4,
    seed: int = 0,
    num_agents: Optional[int] = None,
    occlusion: bool = False,
) -> Tuple[int, int]:
    """Write a synthetic dataset in the reference directory layout.

    Frames within a scene reuse the world but advance vehicles along their heading
    (a crude motion model) so tracking has something to associate.
    """
    anchors = make_anchors(config)
    n_files = 0
    for s in range(num_scenes):
        scene = generate_scene(seed * 1000 + s, config, num_agents=num_agents,
                               occlusion=occlusion)
        for f in range(frames_per_scene):
            frames = scene_to_frames(scene, config, anchors=anchors)
            for i, fr in enumerate(frames):
                schema.save_frame(root, i, s, f, fr)
                n_files += 1
            # advance vehicles ~1 m along heading and resample their returns
            bw = scene["boxes_world"]
            bw[:, 0] += np.cos(bw[:, 4]) * 1.0
            bw[:, 1] += np.sin(bw[:, 4]) * 1.0
            scene["points"] = _resample_points(scene, config)
    return n_files, num_scenes * frames_per_scene


def _resample_points(scene: Dict, config: Config) -> List[np.ndarray]:
    rng = np.random.default_rng(int(abs(scene["boxes_world"][:, 0].sum() * 100)) % (2**31))
    (x_lo, x_hi), _, _ = config.area_extents
    max_range = 0.9 * (x_hi - x_lo)
    return [
        _agent_cloud(rng, scene["agent_poses"][a][:2, 3], scene["boxes_world"],
                     max_range, 220, 1500, scene.get("occlusion", False))
        for a in range(scene["num_agents"])
    ]
