"""V2X-Sim (nuScenes-format) walker: the port's own copy of the JAX
package's ``data/nuscenes_walker.py``, writing the same frames.

V2X-Sim 2.0 ships as a nuScenes-format release where each scene carries the
LiDAR sweeps of up to 6 agents (agent 0 = RSU) as separate sensor channels
(``LIDAR_TOP_id_{i}``). This module walks those tables and writes the
per-agent frame dicts of ``data/schema.py``, the files the synthetic
generator writes, so the loader reads both by one code path.

Requires ``nuscenes-devkit``; every entry point gates its import with a
clear error. The walk follows the public nuScenes schema (sample ->
sample_data -> ego_pose / calibrated_sensor, prev-chained sweeps):

* ``sweeps=N`` follows the ``sample_data['prev']`` chain and merges up to N
  sweeps into the keyframe's sensor frame, each through its own ego pose;
* ``DET_CATEGORIES`` lists the nuScenes category prefixes that count as the
  foreground vehicle class (every ``vehicle.*`` subcategory, spelled out);
* gt boxes are BEV 5-dof (x, y, along-heading extent, across, yaw): the
  pipeline (anchors, codec, NMS, mAP) is BEV-only.

Grids are voxelized on the host by the port's plain voxelizer
(``data/synthetic.py::voxelize_np``), bit-exact with the JAX package's numpy
voxelizer.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.data import schema
from disconet_tpu_torch.data.synthetic import voxelize_np
from disconet_tpu_torch.data.targets import assign_targets
from disconet_tpu_torch.ops.boxes import make_anchors

# nuScenes category-name prefixes that are detection foreground ("vehicle"
# class of the binary det task). Prefix match: an annotation counts iff its
# category_name starts with one of these. The reference filters on the
# "vehicle" substring; this spells out the same set, so that an audit of a
# real release is a one-line edit.
DET_CATEGORIES: Tuple[str, ...] = (
    "vehicle.car",
    "vehicle.truck",
    "vehicle.bus",
    "vehicle.trailer",
    "vehicle.construction",
    "vehicle.emergency",
    "vehicle.motorcycle",
    "vehicle.bicycle",
)

# Per-point semantic id -> seg class id (8 BEV classes: 0 bg, 1 vehicle,
# 2 road, 3 terrain, 4 sidewalk, 5 building, 6 pedestrian, 7 vegetation).
# V2X-Sim 2.0's seg release carries a per-point semantic label in the 4th
# LiDAR channel (the slot nuScenes uses for intensity); raw ids outside the
# map fold to background. Identity for 0..7 by default.
SEG_POINT_LABEL_MAP: Dict[int, int] = {i: i for i in range(8)}

# Split boundaries at scene granularity (V2X-Sim 2.0: 100 scenes), as the
# JAX package's walker sets them.
SPLIT_SCENE_RANGES: Dict[str, Tuple[int, int]] = {
    "train": (0, 80),
    "val": (80, 90),
    "test": (90, 100),
}


def _require_devkit():
    try:
        from nuscenes.nuscenes import NuScenes  # noqa: F401

        return NuScenes
    except ImportError as e:
        raise ImportError(
            "nuscenes-devkit is required to walk a real V2X-Sim release "
            "(pip install nuscenes-devkit). For offline development use the "
            "synthetic generator (python -m disconet_tpu_torch.tools.det.create_data_det "
            "--mode synthetic)."
        ) from e


def _quat_to_rot(q: List[float]) -> np.ndarray:
    """nuScenes [w, x, y, z] quaternion -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def _pose_to_matrix(pose: Dict) -> np.ndarray:
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = _quat_to_rot(pose["rotation"])
    T[:3, 3] = np.asarray(pose["translation"], dtype=np.float64)
    return T


def _yaw_from_quat(q: List[float]) -> float:
    w, x, y, z = q
    return float(np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z)))


def is_det_category(category_name: str, categories: Sequence[str] = DET_CATEGORIES) -> bool:
    return any(category_name.startswith(c) for c in categories)


class NuscenesDataset:
    """Thin wrapper over the nuScenes tables of a V2X-Sim release.

    Iterates (scene_idx, frame_idx) and exposes per-agent LiDAR points (sensor
    frame, sweep-aggregated), per-point raw labels (4th LiDAR channel), global
    sensor poses, and global-frame gt boxes filtered by the category map.
    """

    LIDAR_CHANNEL = "LIDAR_TOP_id_{agent}"

    def __init__(
        self,
        dataroot: str,
        version: str = "v2.0-mini",
        max_agents: int = 6,
        sweeps: int = 1,
        categories: Sequence[str] = DET_CATEGORIES,
    ):
        NuScenes = _require_devkit()
        self.nusc = NuScenes(version=version, dataroot=dataroot, verbose=False)
        self.max_agents = max_agents
        self.sweeps = max(1, int(sweeps))
        self.categories = tuple(categories)

    def _sensor_pose(self, sd: Dict) -> np.ndarray:
        """sensor -> global: T_global_ego @ T_ego_sensor."""
        cal = self.nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        ego = self.nusc.get("ego_pose", sd["ego_pose_token"])
        return _pose_to_matrix(ego) @ _pose_to_matrix(cal)

    def _load_sweeps(self, sd_token: str):
        """Aggregate up to ``self.sweeps`` sweeps into the keyframe sensor frame.

        Returns (points (N,3) in the keyframe sensor frame, raw per-point
        labels (N,) from the 4th LiDAR channel, keyframe T_world_sensor).
        """
        from nuscenes.utils.data_classes import LidarPointCloud

        key_sd = self.nusc.get("sample_data", sd_token)
        T_ws_key = self._sensor_pose(key_sd)
        T_key_w = np.linalg.inv(T_ws_key)

        pts_out, lab_out = [], []
        sd, T_key_sweep = key_sd, np.eye(4)
        for _ in range(self.sweeps):
            pc = LidarPointCloud.from_file(
                os.path.join(self.nusc.dataroot, sd["filename"])
            )
            pts = pc.points[:3].T.astype(np.float64)
            labels = (
                pc.points[3] if pc.points.shape[0] > 3 else np.zeros(pts.shape[0])
            )
            homo = np.c_[pts, np.ones(len(pts))]
            pts_out.append((T_key_sweep @ homo.T).T[:, :3])
            lab_out.append(np.asarray(labels, dtype=np.float32))
            prev = sd.get("prev", "")
            if not prev:
                break
            sd = self.nusc.get("sample_data", prev)
            T_key_sweep = T_key_w @ self._sensor_pose(sd)
        return (
            np.concatenate(pts_out).astype(np.float32),
            np.concatenate(lab_out),
            T_ws_key,
        )

    def frames(self) -> Iterator[Tuple[int, int, Dict]]:
        for s_idx, scene in enumerate(self.nusc.scene):
            token = scene["first_sample_token"]
            f_idx = 0
            while token:
                sample = self.nusc.get("sample", token)
                agents = {}
                for a in range(self.max_agents):
                    chan = self.LIDAR_CHANNEL.format(agent=a)
                    if chan not in sample["data"]:
                        continue
                    pts, labels, T_ws = self._load_sweeps(sample["data"][chan])
                    agents[a] = {"points": pts, "point_labels": labels, "T_ws": T_ws}
                boxes = []
                for ann_token in sample["anns"]:
                    ann = self.nusc.get("sample_annotation", ann_token)
                    if not is_det_category(ann["category_name"], self.categories):
                        continue
                    yaw = _yaw_from_quat(ann["rotation"])
                    # nuScenes ann["size"] is [width, length, height] with
                    # *length* along the heading; the framework box code puts
                    # the along-heading extent in slot 2 (ops/boxes.py corners:
                    # dx = +/- w/2 rotated by theta). slot2 <- length,
                    # slot3 <- width — swapping these rotates every gt
                    # footprint 90 degrees relative to the vehicle.
                    along, across = ann["size"][1], ann["size"][0]
                    boxes.append([*ann["translation"][:2], along, across, yaw])
                yield s_idx, f_idx, {
                    "agents": agents,
                    "boxes_world": np.asarray(boxes, dtype=np.float32).reshape(-1, 5),
                }
                token = sample["next"]
                f_idx += 1


def _boxes_world_to_agent(
    boxes_world: np.ndarray, T_iw: np.ndarray, T_ws: np.ndarray, extents
) -> np.ndarray:
    """Global 5-dof BEV boxes -> agent frame, cropped to the BEV extents."""
    (x_lo, x_hi), (y_lo, y_hi), _ = extents
    boxes = boxes_world.copy()
    if len(boxes):
        yaw_i = np.arctan2(T_ws[1, 0], T_ws[0, 0])
        homo = np.c_[boxes[:, :2], np.zeros(len(boxes)), np.ones(len(boxes))]
        pa = (T_iw @ homo.T).T
        boxes[:, :2] = pa[:, :2]
        boxes[:, 4] -= yaw_i
        inside = (
            (boxes[:, 0] >= x_lo) & (boxes[:, 0] < x_hi)
            & (boxes[:, 1] >= y_lo) & (boxes[:, 1] < y_hi)
        )
        boxes = boxes[inside]
    return boxes


def _rasterize_boxes(lab: np.ndarray, boxes: np.ndarray, config: Config, class_id: int):
    """Paint rotated BEV boxes into a per-cell label grid (point-in-box test)."""
    H, W = config.map_dims
    (x_lo, _), (y_lo, _), _ = config.area_extents
    vx, vy, _ = config.voxel_size
    xs = x_lo + (np.arange(H) + 0.5) * vx
    ys = y_lo + (np.arange(W) + 0.5) * vy
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    for box in boxes:
        cx, cy, w, l, th = box[:5]
        dx, dy = gx - cx, gy - cy
        c, s = np.cos(-th), np.sin(-th)
        u = c * dx - s * dy
        v = s * dx + c * dy
        lab[(np.abs(u) <= w / 2) & (np.abs(v) <= l / 2)] = class_id


def _seg_label_from_points(
    pts: np.ndarray, raw_labels: np.ndarray, config: Config
) -> np.ndarray:
    """Per-cell semantic label = most common mapped point label in the cell.

    Cells with no points stay background (0). Raw ids map through
    :data:`SEG_POINT_LABEL_MAP`; unmapped ids fold to background.
    """
    H, W = config.map_dims
    (x_lo, _), (y_lo, _), _ = config.area_extents
    vx, vy, _ = config.voxel_size
    n_cls = config.num_seg_classes

    mapped = np.zeros(len(raw_labels), dtype=np.int64)
    raw_int = np.rint(raw_labels).astype(np.int64)
    for rid, sid in SEG_POINT_LABEL_MAP.items():
        mapped[raw_int == rid] = sid

    ix = np.floor((pts[:, 0] - x_lo) / vx).astype(np.int64)
    iy = np.floor((pts[:, 1] - y_lo) / vy).astype(np.int64)
    ok = (ix >= 0) & (ix < H) & (iy >= 0) & (iy < W)
    counts = np.zeros((H, W, n_cls), dtype=np.int32)
    np.add.at(counts, (ix[ok], iy[ok], mapped[ok]), 1)
    # argmax of an all-zero count row is already 0 == background, so empty
    # cells need no special-casing.
    lab = counts.argmax(axis=-1).astype(np.int32)
    return lab


def _scene_filter(s_idx: int, scenes, scene_range) -> bool:
    if scenes is not None:
        return s_idx in scenes
    if scene_range is not None:
        lo, hi = scene_range
        return lo <= s_idx < hi
    return True


def create_data_from_nuscenes(
    dataroot: str,
    savepath: str,
    config: Config,
    version: str = "v2.0-mini",
    scenes: Optional[List[int]] = None,
    scene_range: Optional[Tuple[int, int]] = None,
    sweeps: int = 1,
    categories: Sequence[str] = DET_CATEGORIES,
) -> int:
    """Walk a V2X-Sim release and dump per-agent DET frame dicts.

    For each frame: per-agent BEV from its own sensor-frame cloud (sweep-
    aggregated), holistic teacher BEV from all agents' clouds merged into that
    agent's frame, anchor targets from global boxes transformed into the agent
    frame, and the (max_agents, 4, 4) ``trans_matrices`` with T[this <- j].
    """
    ds = NuscenesDataset(
        dataroot, version=version, max_agents=config.max_agents,
        sweeps=sweeps, categories=categories,
    )
    anchors = make_anchors(config)
    n_files = 0

    for s_idx, f_idx, fr in ds.frames():
        if not _scene_filter(s_idx, scenes, scene_range):
            continue
        agents = fr["agents"]
        merged_world = np.concatenate(
            [
                (a["T_ws"] @ np.c_[a["points"], np.ones(len(a["points"]))].T).T[:, :3]
                for a in agents.values()
            ]
        )
        for i, ai in agents.items():
            T_iw = np.linalg.inv(ai["T_ws"])

            def to_agent(pts_w):
                return (T_iw @ np.c_[pts_w, np.ones(len(pts_w))].T).T[:, :3]

            bev = voxelize_np(ai["points"], config)
            bev_teacher = voxelize_np(to_agent(merged_world), config)
            boxes = _boxes_world_to_agent(
                fr["boxes_world"], T_iw, ai["T_ws"], config.area_extents
            )
            tgt = assign_targets(boxes, config, anchors=anchors)
            trans = np.tile(np.eye(4, dtype=np.float32), (config.max_agents, 1, 1))
            for j, aj in agents.items():
                trans[j] = (T_iw @ aj["T_ws"]).astype(np.float32)
            schema.save_frame(
                savepath, i, s_idx, f_idx,
                {
                    "padded_voxel_points": bev[None].astype(np.float32),
                    "padded_voxel_points_teacher": bev_teacher[None].astype(np.float32),
                    "label_one_hot": tgt["label_one_hot"],
                    "reg_target": tgt["reg_target"],
                    "reg_loss_mask": tgt["reg_loss_mask"],
                    "anchors_map": tgt["anchors_map"],
                    "vis_maps": bev.max(axis=-1).astype(np.float32),
                    "gt_max_iou": tgt["gt_max_iou"],
                    "gt_boxes": boxes.astype(np.float32),
                    "target_agent_id": np.int32(i),
                    "num_agent": np.int32(len(agents)),
                    "trans_matrices": trans,
                },
                # real V2X-Sim dumps are the parity data source: keep dense
                # fp32 targets exactly as the reference writes them (the lossy
                # f16/binary-label compression exists only for the synthetic
                # test fixtures, schema.py)
                compress=False,
            )
            n_files += 1
    return n_files


def create_seg_data_from_nuscenes(
    dataroot: str,
    savepath: str,
    config: Config,
    version: str = "v2.0-mini",
    scenes: Optional[List[int]] = None,
    scene_range: Optional[Tuple[int, int]] = None,
    sweeps: int = 1,
    categories: Sequence[str] = DET_CATEGORIES,
) -> int:
    """Walk a V2X-Sim release and dump per-agent SEG frame dicts.

    ``seg_label`` per cell = most common per-point semantic label (4th LiDAR
    channel, :data:`SEG_POINT_LABEL_MAP`) with gt vehicle boxes rasterized on
    top as class 1 (the reference's ``gen_2d_grid_gt``).
    """
    ds = NuscenesDataset(
        dataroot, version=version, max_agents=config.max_agents,
        sweeps=sweeps, categories=categories,
    )
    n_files = 0
    for s_idx, f_idx, fr in ds.frames():
        if not _scene_filter(s_idx, scenes, scene_range):
            continue
        agents = fr["agents"]
        for i, ai in agents.items():
            T_iw = np.linalg.inv(ai["T_ws"])
            bev = voxelize_np(ai["points"], config)
            lab = _seg_label_from_points(ai["points"], ai["point_labels"], config)
            boxes = _boxes_world_to_agent(
                fr["boxes_world"], T_iw, ai["T_ws"], config.area_extents
            )
            _rasterize_boxes(lab, boxes, config, class_id=1)
            trans = np.tile(np.eye(4, dtype=np.float32), (config.max_agents, 1, 1))
            for j, aj in agents.items():
                trans[j] = (T_iw @ aj["T_ws"]).astype(np.float32)
            schema.save_frame(
                savepath, i, s_idx, f_idx,
                {
                    "padded_voxel_points": bev[None].astype(np.float32),
                    "seg_label": lab,
                    "target_agent_id": np.int32(i),
                    "num_agent": np.int32(len(agents)),
                    "trans_matrices": trans,
                },
                compress=False,
            )
            n_files += 1
    return n_files
