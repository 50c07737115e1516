"""Create segmentation data in the on-disk schema (the reference's
``tools/seg/create_data_seg.py``).

    python -m disconet_tpu_torch.tools.seg.create_data_seg --data DIR \
        --mode synthetic --scenes 8 --frames 10 [--grid 256] [--occlusion 1]

The synthetic generator writes ``seg_label`` beside the detection targets,
so ``--mode synthetic`` writes the files of the detection generator (and of
the JAX package's CLI for the same flags) under ``{data}/{split}/``.
``--mode nuscenes`` walks a V2X-Sim release under ``--root`` as the det CLI
does, writing ``seg_label`` from the points' semantic labels with the gt
vehicles painted on top (``nuscenes_walker.create_seg_data_from_nuscenes``).
"""

from __future__ import annotations

import argparse
import os

from disconet_tpu_torch.config import Config, tiny_config
from disconet_tpu_torch.data.synthetic import generate_dataset
from disconet_tpu_torch.tools.det.create_data_det import from_nuscenes


def main(argv=None):
    p = argparse.ArgumentParser(description="Create per-agent segmentation npy data")
    p.add_argument("--root", type=str, default="", help="V2X-Sim release root (nuscenes mode)")
    p.add_argument("--data", "--savepath", dest="savepath", type=str, required=True,
                   help="output dataset root (agent{i}/ dirs)")
    p.add_argument("--split", type=str, default="train", choices=["train", "val", "test"])
    p.add_argument("--mode", type=str, default="synthetic", choices=["synthetic", "nuscenes"])
    p.add_argument("--scenes", type=int, default=8, help="synthetic: number of scenes")
    p.add_argument("--frames", type=int, default=10, help="synthetic: frames per scene")
    p.add_argument("--seed", type=int, default=None, help="synthetic: rng seed (default: by split)")
    p.add_argument("--occlusion", type=int, default=0,
                   help="synthetic: 1 = LiDAR shadowing (closer vehicles occlude farther "
                        "ones per agent, so some gt boxes are visible only to neighbors)")
    p.add_argument("--grid", type=int, default=256)
    p.add_argument("--version", type=str, default="v2.0-mini", help="nuscenes: release version string")
    p.add_argument("--sweeps", type=int, default=1, help="nuscenes: LiDAR sweeps to aggregate per frame")
    p.add_argument("--scene_begin", type=int, default=None,
                   help="nuscenes: first scene index (default: by split, SPLIT_SCENE_RANGES)")
    p.add_argument("--scene_end", type=int, default=None,
                   help="nuscenes: one past the last scene index (default: by split)")
    args = p.parse_args(argv)

    cfg = Config(split=args.split) if args.grid == 256 else tiny_config(args.grid, split=args.split)
    out = os.path.join(args.savepath, args.split)
    if args.mode == "nuscenes":
        return from_nuscenes(args, cfg, out, "create_seg_data_from_nuscenes")
    seed = args.seed if args.seed is not None else {"train": 0, "val": 10_000, "test": 20_000}[args.split]
    n_files, n_frames = generate_dataset(
        out, cfg, num_scenes=args.scenes, frames_per_scene=args.frames, seed=seed,
        occlusion=bool(args.occlusion),
    )
    print(f"wrote {n_files} agent-frames ({n_frames} scene-frames) under {out}")


if __name__ == "__main__":
    main()
