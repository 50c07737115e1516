"""Evaluate BEV segmentation: per-class IoU and mIoU (the reference's
``tools/seg/test_codet.py``).

    python -m disconet_tpu_torch.tools.seg.test_codet --data <root> --com disco \
        --resume logs_seg/disco_seg --batch 4

Prints the JAX package's table: one row per class (``n/a`` for a class in
neither the predictions nor the labels), then the mIoU over the cells of
present agents. Runs on the card unless ``--device cpu``: batches are copied
ahead on a worker thread and batch n+1's predict is dispatched before batch
n's classes are read. ``--visualization 1`` (needs matplotlib) writes the
predicted and true classes of each present agent of the first scene-frame
as ``{logpath}/vis/seg_s{scene}_f{frame}_a{agent}.png``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from disconet_tpu_torch.checkpoint import restore_or_die
from disconet_tpu_torch.config import default_fusion_layer
from disconet_tpu_torch.data.dataset import BatchIterator, V2XSimSeg, pad_batch_to
from disconet_tpu_torch.device import resolve_device
from disconet_tpu_torch.tools.det.train_codet import build
from disconet_tpu_torch.tools.seg.train_codet import seg_config
from disconet_tpu_torch.training import batch_to_device, pipeline_one_deep, prefetch_to_device
from disconet_tpu_torch.training.seg_module import iou_per_class, make_seg_predict_step
from disconet_tpu_torch.utils import visualization as vis

CLASS_NAMES = ["background", "vehicle", "road", "terrain", "sidewalk", "building", "pedestrian", "vegetation"]


def main(argv=None):
    """Returns {"iou": {class: IoU}, "miou", "scenes_per_s"}: the last is the
    rate of the evaluation loop (loading and predict)."""
    p = argparse.ArgumentParser(description="Evaluate collaborative BEV segmentation (PyTorch port)")
    p.add_argument("--data", required=True)
    p.add_argument("--com", type=str, default="")
    p.add_argument("--bound", type=str, default="")
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--rsu", type=int, default=1)
    p.add_argument("--layer", type=int, default=None,
                   help="fusion layer index (default: config.default_fusion_layer; "
                        "must match the checkpoint's training value)")
    p.add_argument("--seg_backbone", type=str, default="unet", choices=["unet", "stpn"],
                   help="seg architecture: reference-topology UNet or the det STPN pyramid + 1x1 SegHead")
    p.add_argument("--grid", type=int, default=256)
    p.add_argument("--visualization", type=int, default=0,
                   help="render pred-vs-gt seg panels for the first batch")
    p.add_argument("--logpath", type=str, default="logs", help="--visualization output dir")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.layer is None:
        args.layer = default_fusion_layer(args.grid)
        if args.layer != 3:
            print(f"--layer auto: {args.layer} (fusion map >=16x16 at "
                  f"--grid {args.grid}; pass --layer 3 for the reference index)")
    if args.visualization:
        vis.require_matplotlib()
    dev = resolve_device(args.device)
    cfg = seg_config(args)
    dataset = V2XSimSeg(args.data, cfg, rsu=bool(args.rsu), bound=args.bound)
    if len(dataset) == 0:
        raise SystemExit(f"no frames under {args.data}")
    loader = BatchIterator(dataset, args.batch, shuffle=False, drop_last=False)

    model = build(args, cfg, dev, task="seg")
    if args.resume:
        epoch, resolved = restore_or_die(args.resume, model)
        print(f"loaded epoch {epoch} from {resolved}")
    else:
        print("WARNING: evaluating a randomly initialized model")
    predict = make_seg_predict_step(model, cfg)

    def prepared_batches():
        for batch in loader:
            yield pad_batch_to(batch, args.batch, cfg.max_agents)

    # the host batch rides along: the loop reads seg_label and agent_mask
    # without fetching them back from the device
    pairs = prefetch_to_device(prepared_batches(), dev, to_device=lambda b: (b, batch_to_device(b, dev)))
    predictions = pipeline_one_deep(pairs, lambda hb_db: (predict(hb_db[1]),))

    preds, labels, masks = [], [], []
    n_frames = 0
    t0 = time.perf_counter()
    for (batch, _), (pr,) in predictions:
        m = batch["agent_mask"][:, :, None, None]  # padded rows are all-False: excluded
        preds.append(pr)
        labels.append(batch["seg_label"])
        masks.append(np.broadcast_to(m, pr.shape))
        if args.visualization and n_frames == 0:
            _render_seg_frame(args.logpath, cfg, batch, pr)
        n_frames += int(np.sum(np.any(batch["agent_mask"], axis=1)))
    loop_s = time.perf_counter() - t0

    res = iou_per_class(np.concatenate(preds), np.concatenate(labels), cfg.num_seg_classes,
                        mask=np.concatenate(masks))
    print(f"\n{'class':>12} | IoU")
    print("-" * 22)
    for c, v in res["iou"].items():
        name = CLASS_NAMES[c] if c < len(CLASS_NAMES) else str(c)
        print(f"{name:>12} | {v:.4f}" if v == v else f"{name:>12} |    n/a")
    print("-" * 22)
    print(f"{'mIoU':>12} | {res['miou']:.4f}")
    res["scenes_per_s"] = n_frames / loop_s
    return res


def _render_seg_frame(logpath, cfg, batch, pr) -> None:
    """Predicted vs true classes of each present agent of the batch's first
    scene-frame, one png an agent under ``{logpath}/vis``."""
    out_dir = os.path.join(logpath, "vis")
    os.makedirs(out_dir, exist_ok=True)
    scene, frame = (int(x) for x in batch["scene_frame"][0])
    for a in np.flatnonzero(batch["agent_mask"][0]):
        vis.save(vis.render_seg(pr[0, a], batch["seg_label"][0, a], num_classes=cfg.num_seg_classes,
                                class_names=CLASS_NAMES),
                 os.path.join(out_dir, f"seg_s{scene}_f{frame}_a{a}.png"))


if __name__ == "__main__":
    main()
