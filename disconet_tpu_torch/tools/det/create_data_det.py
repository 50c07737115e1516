"""Create detection data in the on-disk schema (the reference's
``tools/det/create_data_det.py``).

    python -m disconet_tpu_torch.tools.det.create_data_det --data DIR \
        --mode synthetic --scenes 8 --frames 10 [--grid 256] [--occlusion 1] \
        [--num_classes 2..4]

    python -m disconet_tpu_torch.tools.det.create_data_det --data DIR \
        --mode nuscenes --root V2X-Sim-2.0 --version v2.0-mini --split train \
        [--sweeps 1] [--scene_begin 0 --scene_end 80]

``--mode synthetic`` writes procedural V2X scenes under ``{data}/{split}/``,
the same files the JAX package's CLI writes for the same flags. ``--mode
nuscenes`` walks a V2X-Sim release in nuScenes format under ``--root``
(``data/nuscenes_walker.py``; needs ``nuscenes-devkit``, and exits naming
it where it is missing), the split's scenes by ``SPLIT_SCENE_RANGES`` unless
``--scene_begin``/``--scene_end`` say otherwise.
"""

from __future__ import annotations

import argparse
import os

from disconet_tpu_torch.config import Config, tiny_config
from disconet_tpu_torch.data.synthetic import generate_dataset


def from_nuscenes(args, cfg: Config, out: str, walker: str) -> None:
    """``--mode nuscenes``: check ``--root`` and the devkit, then run the
    walker's ``walker`` function over the split's scene range."""
    if not args.root or not os.path.isdir(args.root):
        raise SystemExit(f"--mode nuscenes needs --root pointing at a V2X-Sim release directory (got {args.root!r}).")
    try:
        import nuscenes  # noqa: F401
    except ImportError:
        raise SystemExit(
            "nuscenes-devkit is not installed in this environment; the V2X-Sim walker needs it. "
            "Use --mode synthetic, or install nuscenes-devkit and re-run."
        ) from None
    from disconet_tpu_torch.data import nuscenes_walker

    lo, hi = nuscenes_walker.SPLIT_SCENE_RANGES[args.split]
    if args.scene_begin is not None:
        lo = args.scene_begin
    if args.scene_end is not None:
        hi = args.scene_end
    n_files = getattr(nuscenes_walker, walker)(args.root, out, cfg, version=args.version,
                                               scene_range=(lo, hi), sweeps=args.sweeps)
    print(f"wrote {n_files} agent-frames (scenes [{lo}, {hi})) under {out}")


def main(argv=None):
    p = argparse.ArgumentParser(description="Create per-agent detection npy data")
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
    p.add_argument("--num_classes", type=int, default=2,
                   help="synthetic: detection classes incl. background (2 = "
                        "binary vehicle; 3-4 adds size-separable truck/bus and "
                        "motorcycle classes with per-gt class labels)")
    p.add_argument("--version", type=str, default="v2.0-mini", help="nuscenes: release version string")
    p.add_argument("--sweeps", type=int, default=1, help="nuscenes: LiDAR sweeps to aggregate per frame")
    p.add_argument("--scene_begin", type=int, default=None,
                   help="nuscenes: first scene index (default: by split, SPLIT_SCENE_RANGES)")
    p.add_argument("--scene_end", type=int, default=None,
                   help="nuscenes: one past the last scene index (default: by split)")
    args = p.parse_args(argv)

    over = {"split": args.split}
    if args.num_classes != 2:
        over["num_classes"] = args.num_classes
    cfg = Config(**over) if args.grid == 256 else tiny_config(args.grid, **over)
    out = os.path.join(args.savepath, args.split)
    if args.mode == "nuscenes":
        return from_nuscenes(args, cfg, out, "create_data_from_nuscenes")
    seed = args.seed if args.seed is not None else {"train": 0, "val": 10_000, "test": 20_000}[args.split]
    n_files, n_frames = generate_dataset(
        out, cfg, num_scenes=args.scenes, frames_per_scene=args.frames, seed=seed,
        occlusion=bool(args.occlusion),
    )
    print(f"wrote {n_files} agent-frames ({n_frames} scene-frames) under {out}")


if __name__ == "__main__":
    main()
