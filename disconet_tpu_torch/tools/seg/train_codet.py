"""Train BEV semantic segmentation (the reference's ``tools/seg/train_codet.py``).

    python -m disconet_tpu_torch.tools.seg.train_codet --data <root> --com disco \
        --rsu 1 --batch 4 --nepoch 100 --logpath logs_seg --auto_resume_path logs_seg

The flags, defaults, log layout (``{logpath}/{com or bound}_seg/``) and
printed lines are the JAX package's seg CLI's, plus ``--device`` (the card
unless ``--device cpu``). ``--seg_backbone`` picks the UNet (default) or the
STPN with a SegHead; ``--layer`` defaults by ``--grid`` as in detection. Every
``--ckpt_every`` epochs (and the last) it saves ``{logdir}/ckpt/{N}.pth``
(model, BatchNorm statistics, Adam; the newest ``--ckpt_keep`` kept).
``--resume`` takes a ``.pth`` file, a ``ckpt/`` directory or the log
directory holding one; ``--auto_resume_path`` continues from
``{path}/{mode}/ckpt``. ``--debug_nans 1`` (the port's, as the det CLI's)
runs autograd's anomaly mode and stops at the first step whose loss or a
gradient is not finite. ``--steps_per_dispatch K`` and ``--remat 1`` as in
the det CLI: K steps a dispatch over K stacked batches (one CUDA graph on
the card, ``training.make_seg_train_step_multi``), stages rematerialized in
the backward (``config.train_remat``).
"""

from __future__ import annotations

import argparse
import os
import time

from disconet_tpu_torch.checkpoint import CheckpointIO, restore_or_die
from disconet_tpu_torch.config import Config, default_fusion_layer, tiny_config
from disconet_tpu_torch.data.dataset import BatchIterator, V2XSimSeg
from disconet_tpu_torch.device import resolve_device
from disconet_tpu_torch.tools.det.train_codet import last_floats, build, dispatch_groups, run_dispatch, steps_per_dispatch
from disconet_tpu_torch.training import MetricLogger, prefetch_to_device
from disconet_tpu_torch.training.det_module import multi_step
from disconet_tpu_torch.training.seg_module import create_seg_train_state, make_seg_train_step
from disconet_tpu_torch.utils import profiling


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train collaborative BEV segmentation (PyTorch port)")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--com", type=str, default="")
    p.add_argument("--bound", type=str, default="")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--nepoch", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--layer", type=int, default=None,
                   help="fusion layer index (default: config.default_fusion_layer; "
                        "resuming a checkpoint requires the value it was "
                        "trained with)")
    p.add_argument("--seg_backbone", type=str, default="unet", choices=["unet", "stpn"],
                   help="seg architecture: reference-topology UNet or the det STPN pyramid + 1x1 SegHead")
    p.add_argument("--rsu", type=int, default=1)
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--auto_resume_path", type=str, default="")
    p.add_argument("--logpath", type=str, default="logs_seg")
    p.add_argument("--log", action="store_true")
    p.add_argument("--nworker", type=int, default=2)
    p.add_argument("--grid", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--remat", type=int, default=0,
                   help="rematerialize intra-stage activations in the backward pass")
    p.add_argument("--steps_per_dispatch", type=int, default=1, help="optimizer steps per device call")
    p.add_argument("--ckpt_every", type=int, default=1, help="save checkpoints every N epochs")
    p.add_argument("--ckpt_keep", type=int, default=5, help="ckpt/ checkpoints retained (0 = keep all)")
    p.add_argument("--debug_nans", type=int, default=0, help="stop at the first non-finite loss or gradient")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.layer is None:
        args.layer = default_fusion_layer(args.grid)
        if args.layer != 3:
            print(f"--layer auto: {args.layer} (fusion map >=16x16 at "
                  f"--grid {args.grid}; pass --layer 3 for the reference index)")
    return args


def mode_name(args) -> str:
    return (args.com or args.bound or "lowerbound") + "_seg"


def seg_config(args) -> Config:
    over = dict(fusion_layer=args.layer, seg_backbone=args.seg_backbone)
    if getattr(args, "remat", 0):  # test_codet shares this, without the flag
        over["train_remat"] = True
    return Config(**over) if args.grid == 256 else tiny_config(args.grid, **over)


def main(argv=None):
    args = parse_args(argv)
    with profiling.nan_checks(args.debug_nans):
        return _train(args)


def _train(args):
    K = steps_per_dispatch(args)
    dev = resolve_device(args.device)
    cfg = seg_config(args)

    dataset = V2XSimSeg(args.data, cfg, rsu=bool(args.rsu), bound=args.bound, cache_items=256)
    if len(dataset) == 0:
        raise SystemExit(f"no frames under {args.data}")
    loader = BatchIterator(dataset, args.batch, shuffle=True, seed=args.seed, num_workers=args.nworker)
    if len(loader) == 0:  # drop_last: fewer frames than --batch -> no batches
        raise SystemExit(f"dataset has {len(dataset)} scene-frames, fewer than --batch {args.batch}")
    print(f"dataset: {len(dataset)} scene-frames, {len(loader)} batches/epoch")

    model = build(args, cfg, dev, task="seg")
    optimizer = create_seg_train_state(model, lr=args.lr)
    logdir = os.path.join(args.logpath, mode_name(args))
    ckpt_io = CheckpointIO(os.path.join(logdir, "ckpt"), max_to_keep=args.ckpt_keep or None)
    start_epoch = 0
    if args.resume:
        start_epoch = restore_or_die(args.resume, model, optimizer)[0]
    elif args.auto_resume_path:
        auto = os.path.join(args.auto_resume_path, mode_name(args), "ckpt")
        epoch = CheckpointIO(auto).restore(model, optimizer)
        if epoch is not None:
            start_epoch = epoch
            print(f"auto-resumed from epoch {epoch} at {auto}")

    logger = MetricLogger(logdir, log=args.log)
    train_step = make_seg_train_step(model, cfg, optimizer)
    train_k = multi_step(train_step, model, optimizer) if K > 1 else None
    step = 0
    for epoch in range(start_epoch + 1, args.nepoch + 1):
        t_ep = time.perf_counter()
        waited = 0.0  # seconds the loop waited for its next device batch
        metrics = None
        batches = prefetch_to_device(dispatch_groups(loader, K), dev)
        while True:
            t0 = time.perf_counter()
            dev_batch = next(batches, None)
            waited += time.perf_counter() - t0
            if dev_batch is None:
                break
            step, metrics = run_dispatch(train_k, train_step, model, step, dev_batch, K, args.debug_nans)
            if step % args.log_every == 0:
                logger.write(step, last_floats(metrics), prefix=f"epoch {epoch}")
        final = last_floats(metrics)  # waits for the epoch's device work
        dt = time.perf_counter() - t_ep
        logger.write(step, {**final, "scenes_per_sec": len(loader) * args.batch / dt,
                            "loader_wait_share": waited / dt}, prefix=f"epoch {epoch} done")
        if epoch % args.ckpt_every == 0 or epoch == args.nepoch:
            ckpt_io.save(epoch, model, optimizer, loss=final["loss"])
    logger.close()
    print(f"seg training complete, checkpoints in {logdir}")


if __name__ == "__main__":
    main()
