"""Evaluate collaborative detection (the reference's ``tools/det/test_codet.py``).

    python -m disconet_tpu_torch.tools.det.test_codet --data <root> --com disco \
        --resume logs/disco_kd/epoch_100.pth --rsu 0 [--tracking] --logpath logs

Prints mAP@0.5 / mAP@0.7 per agent and overall in the JAX package's table
layout (and a per-class table for ``--num_classes`` > 2). ``--tracking``
dumps per-agent, per-scene detection files under
``{logpath}/{mode}/{no_rsu|with_rsu}/{split}/det_dumps/``. Runs on the card
unless ``--device cpu``: batches are copied ahead on a worker thread and
batch n+1's predict is dispatched before batch n's outputs are read. The
rotated NMS runs the IoU kernel on every batch. Every ``--com`` evaluates,
with ``--warp_flag`` and ``--gru_rounds`` as in training. ``--warp_dtype
float32`` keeps DiscoNet's fusion-layer map fp32 at inference (bf16 by
default). ``--visualization 1`` (needs matplotlib) writes pngs under
``{logpath}/vis``: each present agent of the first batch's scene-frames
(``s{scene}_f{frame}_a{agent}.png``) and, for DiscoNet, the edge weights
into each present receiver of the first scene-frame
(``edge_w_s{scene}_f{frame}_a{agent}.png``).
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from collections import defaultdict

import numpy as np
import torch

from disconet_tpu_torch.config import Config, default_fusion_layer, tiny_config
from disconet_tpu_torch.data.dataset import BatchIterator, V2XSimDet, pad_batch_to
from disconet_tpu_torch.device import resolve_device
from disconet_tpu_torch.evaluation import eval_map, eval_map_multiclass
from disconet_tpu_torch.checkpoint import restore_or_die
from disconet_tpu_torch.ops.late_fusion import late_fusion
from disconet_tpu_torch.tools.det.train_codet import build
from disconet_tpu_torch.training import (
    batch_to_device,
    get_bev,
    make_predict_step,
    pipeline_one_deep,
    prefetch_to_device,
)
from disconet_tpu_torch.training.det_module import get_bev_np
from disconet_tpu_torch.utils import visualization as vis
from disconet_tpu_torch.utils.pose_noise import perturb_trans


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate collaborative detection (PyTorch port)")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--com", type=str, default="")
    p.add_argument("--bound", type=str, default="")
    p.add_argument("--resume", type=str, default="", help=".pth or ckpt dir")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--rsu", type=int, default=1)
    p.add_argument("--tracking", action="store_true", help="dump MOT-style det files")
    p.add_argument("--split", type=str, default="test",
                   help="split label of the tracking-dump directory "
                        "({logpath}/{mode}/{no_rsu|with_rsu}/{split}/det_dumps)")
    p.add_argument("--apply_late_fusion", type=int, default=0,
                   help="late collaboration: merge neighbors' boxes into each agent")
    p.add_argument("--logpath", type=str, default="logs")
    p.add_argument("--visualization", type=int, default=0)
    p.add_argument("--layer", type=int, default=None,
                   help="fusion layer index (default: config.default_fusion_layer "
                        "for --grid; must match the checkpoint's training value)")
    p.add_argument("--warp_flag", type=int, default=1)
    p.add_argument("--grid", type=int, default=256)
    p.add_argument("--num_classes", type=int, default=2,
                   help="detection classes incl. background; >2 runs per-class "
                        "NMS and prints a per-class AP table")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--score_threshold", type=float, default=None,
                   help="override config score threshold (default 0.3)")
    p.add_argument("--pose_noise_std", type=float, default=0.0,
                   help="test-time pose noise: translation std [m]")
    p.add_argument("--warp_dtype", type=str, default=None, choices=["bfloat16", "float32"],
                   help="inference warp dtype override")
    p.add_argument("--pose_noise_rot_std", type=float, default=0.0,
                   help="test-time pose noise: rotation std [rad]")
    p.add_argument("--gru_rounds", type=int, default=0, help="--com v2v only: ConvGRU rounds")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.layer is None:
        args.layer = default_fusion_layer(args.grid)
        if args.layer != 3:
            print(f"--layer auto: {args.layer} (fusion map >=16x16 at "
                  f"--grid {args.grid}; pass --layer 3 for the reference index)")
    return args


def main(argv=None):
    """Returns {"mAP@0.5", "mAP@0.7", "scenes_per_s"}: the last is the rate of
    the evaluation loop (loading, predict and the host's mAP bookkeeping)."""
    args = parse_args(argv)
    if args.visualization:
        vis.require_matplotlib()
    dev = resolve_device(args.device)
    over = {"fusion_layer": args.layer}
    if args.warp_dtype:
        over["warp_dtype"] = args.warp_dtype
    if args.num_classes != 2:
        over["num_classes"] = args.num_classes
    if args.score_threshold is not None:
        over["score_threshold"] = args.score_threshold
    cfg = Config(**over) if args.grid == 256 else tiny_config(args.grid, **over)
    multiclass = cfg.num_classes > 2
    if multiclass and args.apply_late_fusion:
        raise SystemExit("--apply_late_fusion is binary-only (class labels "
                         "would not survive the cross-agent merge)")

    dataset = V2XSimDet(args.data, cfg, rsu=bool(args.rsu), bound=args.bound,
                        dense_targets=False, cache_items=64)
    if len(dataset) == 0:
        raise SystemExit(f"no frames found under {args.data}")
    loader = BatchIterator(dataset, args.batch, shuffle=False, drop_last=False)

    model = build(args, cfg, dev)
    if args.resume:
        epoch, resolved = restore_or_die(args.resume, model)
        print(f"loaded checkpoint from {resolved} (epoch {epoch})")
    else:
        print("WARNING: evaluating a randomly initialized model (--resume not given)")
    predict = make_predict_step(model, cfg)

    dets = defaultdict(list)  # agent slot -> per frame (boxes, scores[, labels])
    gts = defaultdict(list)
    track_rows = defaultdict(list)  # (agent, scene) -> rows
    noise_rng = np.random.default_rng(args.seed)  # local: reruns of main() reproduce

    def prepared_batches():
        for batch in loader:
            pad_batch_to(batch, args.batch, cfg.max_agents)
            if args.pose_noise_std > 0 or args.pose_noise_rot_std > 0:
                batch["trans"] = perturb_trans(
                    batch["trans"], args.pose_noise_std, args.pose_noise_rot_std, noise_rng
                )
            yield batch

    # the host batch rides along, so the loop reads gt_boxes, agent_mask and
    # scene_frame without fetching them back from the device
    pairs = prefetch_to_device(prepared_batches(), dev, to_device=lambda b: (b, batch_to_device(b, dev)))
    predictions = pipeline_one_deep(pairs, lambda hb_db: predict(hb_db[1]))

    n_frames = 0
    t0 = time.perf_counter()
    vis_dir = os.path.join(args.logpath, "vis")
    for i, ((batch, dev_batch), pred) in enumerate(predictions):
        (boxes, scores, keep), labels = pred[:3], (pred[3] if multiclass else None)
        B = int(np.sum(np.any(batch["agent_mask"], axis=1)))
        if args.visualization and i == 0:
            os.makedirs(vis_dir, exist_ok=True)
            if args.com == "disco":
                _render_edge_weights(vis_dir, model, cfg, batch, dev_batch)
            bev = get_bev_np(batch, "bev", cfg)
            for b in range(B):
                scene, frame = (int(x) for x in batch["scene_frame"][b])
                for a in np.flatnonzero(batch["agent_mask"][b]):
                    k = keep[b, a]
                    vis.save(vis.render_bev(cfg, bev[b, a], batch["gt_boxes"][b][a], boxes[b, a][k], scores[b, a][k]),
                             os.path.join(vis_dir, f"s{scene}_f{frame}_a{a}.png"))
        for b in range(B):
            scene, frame = (int(x) for x in batch["scene_frame"][b])
            if args.apply_late_fusion:
                raw = [(boxes[b, a][keep[b, a]], scores[b, a][keep[b, a]]) for a in range(cfg.max_agents)]
            for a in range(cfg.max_agents):
                if not batch["agent_mask"][b, a]:
                    continue
                if args.apply_late_fusion:
                    d_boxes, d_scores = late_fusion(raw, batch["trans"][b], a, iou_threshold=cfg.nms_iou_threshold)
                else:
                    k = keep[b, a]
                    d_boxes, d_scores = boxes[b, a][k], scores[b, a][k]
                if multiclass:
                    dets[a].append((d_boxes, d_scores, labels[b, a][keep[b, a]]))
                    gts[a].append((batch["gt_boxes"][b][a], batch["gt_classes"][b][a]))
                else:
                    dets[a].append((d_boxes, d_scores))
                    gts[a].append(batch["gt_boxes"][b][a])
                if args.tracking:
                    for bb, sc in zip(d_boxes, d_scores):
                        track_rows[(a, scene)].append(
                            f"{frame},{bb[0]:.3f},{bb[1]:.3f},{bb[2]:.3f},{bb[3]:.3f},{bb[4]:.4f},{sc:.4f}"
                        )
            n_frames += 1
    loop_s = time.perf_counter() - t0

    # mAP table: per agent and overall (the reference's layout); multi-class
    # configs score per class and add a per-class table
    if multiclass:
        def _eval(d, g, thr):
            return eval_map_multiclass(d, g, iou_thr=thr, num_classes=cfg.num_classes)
    else:
        def _eval(d, g, thr):
            return eval_map(d, g, iou_thr=thr)

    print(f"\nEvaluated {n_frames} scene-frames, mode '{args.com or args.bound or 'lowerbound'}', rsu={args.rsu}")
    overall = {}
    header = f"{'agent':>8} | {'mAP@0.5':>8} | {'mAP@0.7':>8} | {'#gt':>6} | {'#det':>6}"
    print(header)
    print("-" * len(header))
    all_dets, all_gts = [], []
    for a in sorted(dets):
        all_dets += dets[a]
        all_gts += gts[a]
        ap50, d50 = _eval(dets[a], gts[a], 0.5)
        ap70, _ = _eval(dets[a], gts[a], 0.7)
        print(f"{a:>8} | {ap50:8.4f} | {ap70:8.4f} | {d50['num_gts']:>6} | {d50['num_dets']:>6}")
    ap50, d50 = _eval(all_dets, all_gts, 0.5)
    ap70, d70 = _eval(all_dets, all_gts, 0.7)
    print("-" * len(header))
    print(f"{'average':>8} | {ap50:8.4f} | {ap70:8.4f} | {d50['num_gts']:>6} | {d50['num_dets']:>6}")
    overall["mAP@0.5"], overall["mAP@0.7"] = ap50, ap70
    overall["scenes_per_s"] = n_frames / loop_s

    if multiclass:
        header = f"{'class':>8} | {'AP@0.5':>8} | {'AP@0.7':>8} | {'#gt':>6} | {'#det':>6}"
        print("\n" + header)
        print("-" * len(header))
        for c in range(1, cfg.num_classes):
            p5, p7 = d50["per_class"][c], d70["per_class"][c]
            print(f"{c:>8} | {p5['ap']:8.4f} | {p7['ap']:8.4f} | "
                  f"{p5['num_gts']:>6} | {p5['num_dets']:>6}")

    if args.tracking:
        # {logpath}/{mode}/{no_rsu|with_rsu}/{split}/det_dumps, the layout the
        # tracking tools compose
        mode = args.com or args.bound or "lowerbound"
        rsu_dir = "with_rsu" if args.rsu else "no_rsu"
        det_dir = os.path.join(args.logpath, mode, rsu_dir, args.split, "det_dumps")
        os.makedirs(det_dir, exist_ok=True)
        # files are written only for (agent, scene) pairs with a detection, so
        # a previous run's leftovers would leak into the tracking scores
        for stale in glob.glob(os.path.join(det_dir, "det_agent*_scene*.txt")):
            os.remove(stale)
        for (a, scene), rows in track_rows.items():
            with open(os.path.join(det_dir, f"det_agent{a}_scene{scene}.txt"), "w") as f:
                f.write("\n".join(rows) + "\n")
        print(f"tracking dumps: {len(track_rows)} files under {det_dir}")
    if args.visualization:
        print(f"visualization: pngs under {vis_dir}")
    return overall


def _render_edge_weights(vis_dir, model, cfg, batch, dev_batch) -> None:
    """DiscoNet's edge weights into each present receiver of the batch's
    first scene-frame, one png a receiver."""
    with torch.inference_mode():
        w = model.edge_weights(get_bev(dev_batch, "bev", cfg), dev_batch["trans"], dev_batch["agent_mask"],
                               store_bf16=True)[0].cpu().numpy()  # (Ar, As, h, w)
    scene, frame = (int(x) for x in batch["scene_frame"][0])
    mask = batch["agent_mask"][0].astype(bool)
    for recv in np.flatnonzero(mask):
        vis.save(vis.render_edge_weights(w[recv], mask, int(recv)),
                 os.path.join(vis_dir, f"edge_w_s{scene}_f{frame}_a{recv}.png"))


if __name__ == "__main__":
    main()
