"""Create segmentation data in the on-disk schema (the reference's
``tools/seg/create_data_seg.py``).

    python -m disconet_tpu_torch.tools.seg.create_data_seg --data DIR \
        --mode synthetic --scenes 8 --frames 10 [--grid 256] [--occlusion 1]

The synthetic generator writes ``seg_label`` beside the detection targets,
so ``--mode synthetic`` writes the files of the detection generator (and of
the JAX package's CLI for the same flags) under ``{data}/{split}/``.
``--mode nuscenes`` (a V2X-Sim release walked with ``nuscenes-devkit``) is
not ported.
"""

from __future__ import annotations

import argparse
import os

from disconet_tpu_torch.config import Config, tiny_config
from disconet_tpu_torch.data.synthetic import generate_dataset


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
    p.add_argument("--scene_begin", type=int, default=None, help="nuscenes: first scene index")
    p.add_argument("--scene_end", type=int, default=None, help="nuscenes: one past the last scene index")
    args = p.parse_args(argv)

    if args.mode == "nuscenes":
        raise SystemExit(
            "--mode nuscenes is not ported (ROADMAP.md Queue 1, item 11): it needs "
            "nuscenes-devkit; use --mode synthetic, or the JAX package's "
            "tools/seg/create_data_seg.py, whose output the port reads"
        )
    cfg = Config(split=args.split) if args.grid == 256 else tiny_config(args.grid, split=args.split)
    out = os.path.join(args.savepath, args.split)
    seed = args.seed if args.seed is not None else {"train": 0, "val": 10_000, "test": 20_000}[args.split]
    n_files, n_frames = generate_dataset(
        out, cfg, num_scenes=args.scenes, frames_per_scene=args.frames, seed=seed,
        occlusion=bool(args.occlusion),
    )
    print(f"wrote {n_files} agent-frames ({n_frames} scene-frames) under {out}")


if __name__ == "__main__":
    main()
