"""Detection and segmentation datasets, collation and a batching iterator.

The port's own copy of the JAX package's loader. Differences from the
reference loader, by design:

* one item is a whole scene-frame (all agents stacked and padded to
  ``config.max_agents``), not one agent: the agent axis is a tensor axis;
* absent agents are an explicit boolean ``agent_mask``;
* ``rsu=False`` (``--rsu 0``) drops agent 0 at index time, as the
  reference's ``dataset_roots`` slicing does.

Batches are dicts of numpy arrays; ``training.batch_to_device`` ships them.
``BatchIterator`` shuffles, batches and loads ahead on a thread.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
import warnings
from typing import Dict, List, Sequence

import numpy as np

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.data import schema
from disconet_tpu_torch.ops.bitpack import pack_bev_np


class V2XSimDet:
    """Detection dataset over the on-disk schema (``data/schema.py``).

    Args:
        root: dataset root containing ``agent{i}/`` subdirs (or a list of those
            subdir paths, mirroring the reference's ``dataset_roots``).
        config: geometry config (defines padding shapes).
        rsu: include agent 0 (the road-side unit). ``--rsu 0`` drops it.
        bound: '' (normal), 'lowerbound' (per-agent, no teacher needed) or
            'upperbound' (student consumes the holistic teacher BEV): the
            reference's ``--bound`` flag.
    """

    def __init__(
        self,
        root,
        config: Config,
        rsu: bool = True,
        bound: str = "",
        keep_gt_boxes: bool = True,
        dense_targets: bool = True,
        cache_items: int = 0,
        pack_bits: bool = True,
    ):
        """``dense_targets=False`` skips the reference's dense (H, W, A, code)
        target tensors: the train step reads the sparse encoding, and items
        without the dense ones are small enough to cache. ``cache_items`` > 0
        keeps that many assembled items in memory, so later epochs skip the
        decoding (about 0.1 s a scene-frame at the 256 grid). ``pack_bits``
        (default) stores the binary BEV grids bit-packed over z
        (``ops/bitpack.py``) as ``bev_packed`` / ``bev_teacher_packed``: 6.5x
        smaller cache, collate and transfer; the steps unpack on the device
        (``training/det_module.get_bev``)."""
        self.config = config
        self.rsu = rsu
        self.bound = bound
        self.keep_gt_boxes = keep_gt_boxes
        self.dense_targets = dense_targets
        self.cache_items = cache_items
        self.pack_bits = pack_bits
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        if isinstance(root, (list, tuple)):
            agent_roots = list(root)
        else:
            agent_roots = [f"{root}/agent{i}" for i in range(config.max_agents)]
        if not rsu:
            agent_roots = agent_roots[1:]
        self.agent_roots = agent_roots

        # index: (scene, frame) -> {agent_slot: path}
        index: Dict[tuple, Dict[int, str]] = {}
        for slot, ar in enumerate(agent_roots):
            for scene, frame, path in schema.list_frames(ar):
                index.setdefault((scene, frame), {})[slot] = path
        self.keys = sorted(index)
        self.index = index

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if i in self._cache:
            return self._cache[i]
        item = self._build_item(i)
        if self.cache_items and len(self._cache) < self.cache_items:
            self._cache[i] = item
        return item

    def _build_item(self, i: int) -> Dict[str, np.ndarray]:
        cfg = self.config
        MA = cfg.max_agents
        H, W = cfg.map_dims
        Z = cfg.grid_size[2]
        A, C, code = cfg.num_anchors, cfg.num_classes, cfg.box_code_size

        # binary tensors stay uint8/bool end to end: exact values, 4x less
        # host memory and transfer; the steps cast to f32 on the device
        bev = np.zeros((MA, H, W, Z), np.uint8)
        bev_teacher = np.zeros((MA, H, W, Z), np.uint8)
        P = cfg.max_pos_anchors
        n_flat = H * W * A
        pos_idx = np.full((MA, P), n_flat, np.int32)  # sentinel = out of range
        pos_target = np.zeros((MA, P, code), np.float32)
        if self.dense_targets:
            label = np.zeros((MA, H, W, A, C), np.uint8)
            label[..., 0] = 1
            reg_target = np.zeros((MA, H, W, A, code), np.float32)
            reg_mask = np.zeros((MA, H, W, A), bool)
        trans = np.tile(np.eye(4, dtype=np.float32), (MA, MA, 1, 1))
        agent_mask = np.zeros((MA,), bool)
        gt_boxes: List[np.ndarray] = [np.zeros((0, 5), np.float32)] * MA
        gt_classes: List[np.ndarray] = [np.zeros((0,), np.int32)] * MA
        if C > 2:  # per-positive class ids for the sparse on-device labels
            pos_cls = np.zeros((MA, P), np.int32)

        frames = self.index[self.keys[i]]
        for slot, path in frames.items():
            fr = schema.load_frame(path)
            self._read_agent(fr, slot, bev, bev_teacher, trans)
            fr_mask = np.asarray(fr["reg_loss_mask"], bool)
            fr_reg = np.asarray(fr["reg_target"], np.float32)
            nz = np.nonzero(fr_mask.reshape(-1))[0]
            if len(nz) > P:
                # silent truncation would diverge from the dense/reference
                # targets; extremely dense frames need a bigger budget
                warnings.warn(
                    f"{path}: {len(nz)} positive anchors exceed "
                    f"max_pos_anchors={P}; excess positives are dropped — "
                    "raise config.max_pos_anchors for this dataset"
                )
                nz = nz[:P]
            pos_idx[slot, : len(nz)] = nz
            pos_target[slot, : len(nz)] = fr_reg.reshape(-1, code)[nz]
            if C > 2:
                # recover each positive's class from the stored one-hot (the
                # npy contract carries dense labels; only positives ship)
                lab_flat = np.asarray(fr["label_one_hot"]).reshape(-1, C)
                pos_cls[slot, : len(nz)] = np.argmax(lab_flat[nz], axis=-1)
            if self.dense_targets:
                label[slot] = np.asarray(fr["label_one_hot"]).astype(np.uint8)
                reg_target[slot] = fr_reg
                reg_mask[slot] = fr_mask
            agent_mask[slot] = True
            if self.keep_gt_boxes and "gt_boxes" in fr:
                gt_boxes[slot] = np.asarray(fr["gt_boxes"], np.float32).reshape(-1, 5)
                # per-gt class ids (multi-class eval); frames without the key
                # (binary reference data) are all class 1
                gt_classes[slot] = (
                    np.asarray(fr["gt_classes"], np.int32).reshape(-1)
                    if "gt_classes" in fr
                    else np.ones((len(gt_boxes[slot]),), np.int32)
                )

        # sparse positive-anchor targets are always present (the train step
        # rebuilds dense masks on the device, training/det_module._losses);
        # the dense reference tensors only with dense_targets=True
        if self.pack_bits:
            bev_keys = {"bev_packed": pack_bev_np(bev),
                        "bev_teacher_packed": pack_bev_np(bev_teacher)}
        else:
            bev_keys = {"bev": bev, "bev_teacher": bev_teacher}
        out = {
            **bev_keys,
            "reg_pos_idx": pos_idx,
            "reg_pos_target": pos_target,
            "trans": trans,
            "agent_mask": agent_mask,
            "num_agent": np.int32(agent_mask.sum()),
            # dataset position: the key into per-frame device caches (the
            # frozen teacher's KD features, training/det_module.py)
            "frame_idx": np.int32(i),
            "scene_frame": np.asarray(self.keys[i], np.int32),
            "gt_boxes": gt_boxes,
            "gt_classes": gt_classes,
        }
        if C > 2:
            out["reg_pos_cls"] = pos_cls
        if self.dense_targets:
            out["label_one_hot"] = label
            out["reg_target"] = reg_target
            out["reg_mask"] = reg_mask
        return out

    def _read_agent(self, fr, slot: int, bev, bev_teacher, trans) -> None:
        """One agent's grids and pose row of a loaded frame ``fr`` into ``slot``."""
        student = np.asarray(fr["padded_voxel_points"])
        teacher = np.asarray(fr.get("padded_voxel_points_teacher", fr["padded_voxel_points"]))
        if student.ndim == 4:  # squeeze the temporal dim (schema.py)
            student, teacher = student[0], teacher[0]
        if self.bound == "upperbound":
            student = teacher  # early fusion: holistic input
        bev[slot] = student.astype(np.uint8)
        bev_teacher[slot] = teacher.astype(np.uint8)
        # stored trans row j maps agent j -> THIS agent; drop the rsu column
        # offset when agent 0 was excluded so slots align.
        tm = np.asarray(fr["trans_matrices"], np.float32)
        off = 0 if self.rsu else 1
        n = min(self.config.max_agents, tm.shape[0] - off)
        trans[slot, :n] = tm[off : off + n]


class V2XSimSeg(V2XSimDet):
    """Segmentation dataset: the BEV grids, per-cell class labels
    ``seg_label`` (max_agents, H, W) int32, poses and the agent mask, with
    ``rsu``, ``bound``, ``cache_items`` and ``pack_bits`` as in
    :class:`V2XSimDet`."""

    # overriding _build_item (not __getitem__) keeps the base item cache live
    def _build_item(self, i: int) -> Dict[str, np.ndarray]:
        cfg = self.config
        MA = cfg.max_agents
        H, W = cfg.map_dims
        Z = cfg.grid_size[2]
        bev = np.zeros((MA, H, W, Z), np.uint8)
        bev_teacher = np.zeros((MA, H, W, Z), np.uint8)
        seg = np.zeros((MA, H, W), np.int32)
        trans = np.tile(np.eye(4, dtype=np.float32), (MA, MA, 1, 1))
        agent_mask = np.zeros((MA,), bool)

        for slot, path in self.index[self.keys[i]].items():
            fr = schema.load_frame(path)
            self._read_agent(fr, slot, bev, bev_teacher, trans)
            seg[slot] = np.asarray(fr["seg_label"], np.int32)
            agent_mask[slot] = True

        if self.pack_bits:
            bev_keys = {"bev_packed": pack_bev_np(bev), "bev_teacher_packed": pack_bev_np(bev_teacher)}
        else:
            bev_keys = {"bev": bev, "bev_teacher": bev_teacher}
        return {
            **bev_keys,
            "seg_label": seg,
            "trans": trans,
            "agent_mask": agent_mask,
            "num_agent": np.int32(agent_mask.sum()),
            "scene_frame": np.asarray(self.keys[i], np.int32),
        }


_RAGGED_KEYS = ("gt_boxes", "gt_classes")  # host-only, per-agent ragged lists


def collate_det(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack scene-frames into a batch; gt_boxes/gt_classes stay ragged lists."""
    out: Dict[str, np.ndarray] = {}
    for k in items[0]:
        if k in _RAGGED_KEYS:
            out[k] = [it[k] for it in items]  # ragged, host-only (mAP eval)
        else:
            out[k] = np.stack([it[k] for it in items])
    return out


def pad_batch_to(batch: Dict[str, np.ndarray], size: int, max_agents: int) -> Dict[str, np.ndarray]:
    """Pad a ragged tail batch to ``size`` scene-frames in place (one batch
    shape for every step). Padded rows get all-zero tensors, in particular an all-False
    ``agent_mask``, which every consumer (losses, fusion softmax, eval
    accumulation) already excludes. ``gt_boxes`` (ragged host list) pads with
    empty per-agent lists."""
    have = batch["agent_mask"].shape[0]
    if have == size:
        return batch
    pad = size - have
    for k, v in list(batch.items()):
        if k == "gt_boxes":
            batch[k] = v + [[np.zeros((0, 5), np.float32)] * max_agents] * pad
        elif k == "gt_classes":
            batch[k] = v + [[np.zeros((0,), np.int32)] * max_agents] * pad
        else:
            batch[k] = np.concatenate([v, np.repeat(np.zeros_like(v[-1:]), pad, axis=0)])
    return batch


class BatchIterator:
    """Shuffling, batching iterator over a dataset that loads ahead.

    The order of an epoch is ``default_rng(seed)``'s shuffle, drawn anew
    each epoch from one generator, as the JAX package draws it. Drops the
    last partial batch unless ``drop_last`` is false. A producer thread
    keeps up to 2 collated batches ready, loading each batch's items on
    ``num_workers`` threads (numpy IO releases the GIL): the reference CLI's
    ``--nworker``. An error in the producer reaches the consumer; leaving the
    loop early stops and joins the producer.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        nb = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            # every outcome reaches the consumer, which would otherwise wait
            # on q.get() forever
            try:
                with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(nb):
                        idx = order[b * self.batch_size : (b + 1) * self.batch_size]
                        items = list(pool.map(self.dataset.__getitem__, (int(i) for i in idx)))
                        if not put(collate_det(items)):
                            return
                put(None)
            except BaseException as e:  # noqa: BLE001 -- re-raised by the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
