"""On-disk frame schema: one ``.npy`` dict per agent per frame.

The reference's ``V2XSimDet`` loads ``{root}/agent{i}/{scene}_{frame}/0.npy``.
The port's own copy of the JAX package's schema: what either package writes,
the other reads, byte for byte.

Shapes (H, W, Z = BEV grid, A = anchors per cell, MA = max agents):

=========================== ============================== =========================
key                          shape                          meaning
=========================== ============================== =========================
padded_voxel_points          (1, H, W, Z) float32/bool      student BEV occupancy
padded_voxel_points_teacher  (1, H, W, Z) float32/bool      holistic (all-agent) BEV
label_one_hot                (H, W, A, num_classes) f32     per-anchor cls target
reg_target                   (H, W, A, code) f32            per-anchor box deltas
reg_loss_mask                (H, W, A) bool                 positive-anchor mask
anchors_map                  (H, W, A, 6) f32               (cx, cy, w, l, sin, cos);
                                                            omitted by the synthetic
                                                            generator (derivable)
vis_maps                     (H, W) f32                     visibility / occupancy 2D
gt_max_iou                   (G, 2) f32                     per-gt (best anchor IoU,
                                                            flat anchor idx)
gt_boxes                     (G, 5) f32                     gt boxes in agent frame
target_agent_id              () int                         this agent's index
num_agent                    () int                         agents present in scene
trans_matrices               (MA, 4, 4) f32                 T[this <- j] poses
=========================== ============================== =========================

The leading ``1`` on the voxel tensors is the temporal dim; the loader
squeezes it. ``trans_matrices[j]`` maps sender-j homogeneous coordinates into
THIS agent's frame. Segmentation frames add ``seg_label`` (H, W) int32.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

FRAME_KEYS = (
    "padded_voxel_points",
    "padded_voxel_points_teacher",
    "label_one_hot",
    "reg_target",
    "reg_loss_mask",
    "anchors_map",
    "vis_maps",
    "gt_max_iou",
    "gt_boxes",
    "target_agent_id",
    "num_agent",
    "trans_matrices",
)


def frame_dir(root: str, agent: int, scene: int, frame: int) -> str:
    """The reference layout: ``{root}/agent{i}/{scene}_{frame}``."""
    return os.path.join(root, f"agent{agent}", f"{scene}_{frame}")


def _compress_value(key: str, val):
    """Size-aware encoding for synthetic data.

    Real V2X-Sim dumps store every key dense (~15 MB a frame). Binary grids
    go to packbits, and the per-anchor targets (zero but at positive anchors)
    to a sparse {indices, values, shape} record; :func:`load_frame` reverses
    both, so consumers always see the dense schema.
    """
    if key in ("padded_voxel_points", "padded_voxel_points_teacher"):
        arr = np.asarray(val)
        return {
            "__packed__": np.packbits(arr.astype(bool), axis=None),
            "shape": arr.shape,
        }
    if key == "label_one_hot":
        # (position, class id) of every foreground anchor: any num_classes
        arr = np.asarray(val)
        cls = np.argmax(arr, axis=-1)
        nz = np.nonzero(cls > 0)
        return {
            "__sparse_cls__": np.stack(nz, axis=-1).astype(np.int32),
            "cls": cls[nz].astype(np.int16),
            "shape": arr.shape,
            "dtype": str(arr.dtype),
        }
    if key in ("reg_target", "reg_loss_mask"):
        arr = np.asarray(val)
        if key == "reg_loss_mask":
            nz = np.nonzero(arr)
        else:
            nz = np.nonzero(np.any(arr != 0, axis=-1))
        idx = np.stack(nz, axis=-1).astype(np.int32)
        return {
            "__sparse__": idx,
            "values": arr[nz].astype(np.float16) if arr.dtype != bool else None,
            "shape": arr.shape,
            "dtype": str(arr.dtype),
        }
    return val


def _decompress_value(key: str, val):
    if isinstance(val, dict) and "__packed__" in val:
        shape = tuple(val["shape"])
        n = int(np.prod(shape))
        bits = np.unpackbits(val["__packed__"], count=n)
        return bits.reshape(shape).astype(np.float32)
    if isinstance(val, dict) and "__sparse_cls__" in val:
        shape = tuple(val["shape"])
        arr = np.zeros(shape, np.float32)
        arr[..., 0] = 1.0
        pos = tuple(val["__sparse_cls__"].T)
        arr[pos + (val["cls"].astype(np.int64),)] = 1.0
        arr[pos + (np.zeros(len(val["cls"]), np.int64),)] = 0.0
        return arr
    if isinstance(val, dict) and "__sparse__" in val:
        shape = tuple(val["shape"])
        dtype = np.dtype(val["dtype"])
        arr = np.zeros(shape, dtype=np.float32 if dtype != bool else bool)
        idx = tuple(val["__sparse__"].T)
        if val["values"] is None:
            arr[idx] = True
        else:
            arr[idx] = val["values"].astype(arr.dtype)
        if key == "label_one_hot":
            # background channel is the complement of the vehicle channel
            arr[..., 0] = 1.0 - arr[..., 1]
        return arr.astype(dtype if dtype != np.float16 else np.float32)
    return val


def save_frame(
    root: str, agent: int, scene: int, frame: int, data: Dict[str, np.ndarray], compress: bool = True
) -> str:
    """Write one agent's frame dict to ``frame_dir(...)/0.npy``; returns the path."""
    d = frame_dir(root, agent, scene, frame)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "0.npy")
    if compress:
        data = {k: _compress_value(k, v) for k, v in data.items()}
    np.save(path, np.asarray(data, dtype=object), allow_pickle=True)
    return path


def load_frame(path: str) -> Dict[str, np.ndarray]:
    """Load one agent's frame dict, dense (real V2X-Sim) or compressed
    (synthetic). The file is unpickled: load only datasets you trust."""
    raw = np.load(path, allow_pickle=True)
    if isinstance(raw, np.ndarray) and raw.dtype == object:
        raw = raw.item()
    if not isinstance(raw, dict):
        raise ValueError(f"frame file {path} did not contain a dict")
    return {k: _decompress_value(k, v) for k, v in raw.items()}


def list_frames(agent_root: str):
    """Sorted (scene, frame, path) triples under one ``agent{i}/`` root."""
    out = []
    if not os.path.isdir(agent_root):
        return out
    for name in os.listdir(agent_root):
        full = os.path.join(agent_root, name, "0.npy")
        if "_" in name and os.path.isfile(full):
            s, f = name.split("_", 1)
            try:
                out.append((int(s), int(f), full))
            except ValueError:
                continue
    out.sort()
    return out
