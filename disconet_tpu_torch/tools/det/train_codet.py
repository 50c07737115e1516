"""Train collaborative detection (the reference's ``tools/det/train_codet.py``).

    python -m disconet_tpu_torch.tools.det.train_codet --data <root> --com disco \
        --kd_flag 1 --resume_teacher logs/upperbound/epoch_100.pth --rsu 1 \
        --batch 4 --nepoch 100 --logpath logs --auto_resume_path logs

The flags, defaults, log layout (``{logpath}/{mode}[_kd]/``) and printed
lines are the JAX package's CLI's. Runs on the card unless ``--device cpu``.
Each epoch saves ``{logdir}/ckpt/{N}.pth`` (model, BatchNorm statistics,
Adam; the newest ``--ckpt_keep`` kept) and, with ``--save_pth 1``, an
``{logdir}/epoch_{N}.pth`` export that is never pruned. ``--resume`` and
``--resume_teacher`` take a ``.pth`` file, a ``ckpt/`` directory or the log
directory holding one; the JAX package's orbax directories are not read.

Every ``--com`` of the JAX CLI trains, with ``--warp_flag`` (when2com,
who2com) and ``--gru_rounds`` (v2v); the log directory does not name them,
as in the JAX CLI. ``--visualization 1`` (needs matplotlib) renders, at each
checkpointed epoch, the first present agent of the first batch with the
model's detections (``{logdir}/vis/epoch_{N}_a{agent}.png``).
``--debug_nans 1`` runs autograd's anomaly mode and stops at the first step
whose loss or a gradient is not finite, naming the step and the value.
``--steps_per_dispatch K`` runs K optimizer steps per dispatch over K
stacked batches, on the card one CUDA graph of the K steps
(``training.make_train_step_multi``); an epoch's shorter tail group runs as
single steps, and ``step`` advances by each group's length. With
``--debug_nans 1`` every step of a group is checked on its own, without the
graph. ``--remat 1`` rematerializes each stage in the backward
(``config.train_remat``).

Under ``torchrun`` (a world of more than one rank) the run is data, agent
and spatial parallel over ``torch.distributed``, as the JAX CLI's mesh:

    torchrun --nproc_per_node 2 -m disconet_tpu_torch.tools.det.train_codet \
        --data <root> --com disco --mesh_agent 2 --dist_backend gloo ...

``n_data`` is the world size over ``--mesh_agent`` x ``--mesh_spatial``.
``--dist_backend`` is the caller's choice, required under ``torchrun``:
``nccl`` needs a card per rank (rank i on ``cuda:LOCAL_RANK``); ``gloo``
runs CPU tensors (``--device cpu``) and CUDA ones, ranks sharing the cards
(``cuda:LOCAL_RANK % device_count``). A rank that finds no device of the
kind ``--device`` names exits. Every rank reads the same batches and trains
on its slice (``parallel.shard_batch``); rank 0 alone prints and writes logs
and checkpoints, a resume broadcasts rank 0's loaded state, and the KD
tables are whole on every rank. Every ``--com`` runs under all three axes.
``--steps_per_dispatch`` > 1 and ``--visualization 1`` are single-device
only.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import time

import numpy as np
import torch

from disconet_tpu_torch.checkpoint import CheckpointIO, restore_or_die, save_pth
from disconet_tpu_torch.config import Config, default_fusion_layer, tiny_config
from disconet_tpu_torch.data.dataset import BatchIterator, V2XSimDet
from disconet_tpu_torch.device import resolve_device
from disconet_tpu_torch.models.build import build_model
from disconet_tpu_torch.parallel import replicate_tree, shard_batch
from disconet_tpu_torch.training import (
    MetricLogger,
    batch_to_device,
    create_train_state,
    make_predict_step,
    make_train_step,
    precompute_teacher_feats,
    prefetch_to_device,
    stack_host_batches,
    teacher_feat_bytes,
)
from disconet_tpu_torch.training.det_module import get_bev_np, multi_step
from disconet_tpu_torch.utils import profiling, visualization as vis


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train collaborative detection (PyTorch port)")
    # --- reference flags ---
    p.add_argument("--data", type=str, required=True, help="dataset root (agent{i}/ dirs)")
    p.add_argument("--com", type=str, default="", help="''|when2com|who2com|v2v|disco|sum|mean|max|cat|agent")
    p.add_argument("--bound", type=str, default="", help="lowerbound|upperbound (with --com '')")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--nepoch", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--kd_flag", type=int, default=0)
    p.add_argument("--kd_weight", type=float, default=100000.0)
    p.add_argument("--layer", type=int, default=None,
                   help="fusion layer index (default: the reference's 3 at --grid >= 128; "
                        "smaller grids drop it to keep the fusion map >= 16x16)")
    p.add_argument("--rsu", type=int, default=1)
    p.add_argument("--resume", type=str, default="", help=".pth or ckpt dir to resume the student")
    p.add_argument("--resume_teacher", type=str, default="", help="teacher checkpoint (--kd_flag 1)")
    p.add_argument("--auto_resume_path", type=str, default="", help="scan for the latest epoch checkpoint")
    p.add_argument("--logpath", type=str, default="logs")
    p.add_argument("--log", action="store_true", help="write {logdir}/log.txt (and TensorBoard where installed)")
    p.add_argument("--nworker", type=int, default=2, help="loader threads")
    p.add_argument("--visualization", type=int, default=0)
    p.add_argument("--warp_flag", type=int, default=1, help="when2com: warp values")
    p.add_argument("--warp_dtype", type=str, default=None, choices=["bfloat16", "float32"],
                   help="inference warp dtype; training warps are always float32")
    p.add_argument("--gru_rounds", type=int, default=0, help="--com v2v only: ConvGRU rounds")
    # --- additions of the JAX package ---
    p.add_argument("--grid", type=int, default=256, help="BEV grid cells (256 = reference)")
    p.add_argument("--num_classes", type=int, default=2,
                   help="detection classes incl. background (2 = the binary vehicle task)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_pth", type=int, default=1, help="also export {logdir}/epoch_N.pth")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--remat", type=int, default=0, help="rematerialize activations in the backward")
    p.add_argument("--steps_per_dispatch", type=int, default=1, help="optimizer steps per device call")
    p.add_argument("--profile", type=int, default=0,
                   help="trace N steady-state steps with torch.profiler to {logdir}/profile/trace.json")
    p.add_argument("--debug_nans", type=int, default=0, help="stop at the first NaN")
    p.add_argument("--save_best", type=int, default=0,
                   help="track the min end-of-epoch train loss and export {logdir}/best.pth "
                        "with that epoch's weights (written at --ckpt_every boundaries)")
    p.add_argument("--ckpt_every", type=int, default=1, help="save checkpoints every N epochs")
    p.add_argument("--ckpt_keep", type=int, default=5,
                   help="ckpt/ checkpoints retained (0 = keep all; epoch_N.pth exports are never pruned)")
    p.add_argument("--cache_items", type=int, default=256, help="in-memory dataset item cache")
    p.add_argument("--max_pos", type=int, default=0,
                   help="override config.max_pos_anchors (0 = config default 2048)")
    p.add_argument("--kd_cache", type=int, default=1,
                   help="precompute the frozen teacher's KD features once on the device and "
                        "gather them per step (1) or re-forward the teacher every step (0); "
                        "off when the tables exceed --kd_cache_gb")
    p.add_argument("--kd_cache_gb", type=float, default=4.0, help="device memory budget of the KD cache (bf16)")
    p.add_argument("--mesh_agent", type=int, default=1, help="mesh axis size sharding the agent dim")
    p.add_argument("--mesh_spatial", type=int, default=1, help="mesh axis size sharding the BEV H dim")
    # --- the port's ---
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dist_backend", type=str, default=None, choices=["gloo", "nccl"],
                   help="torch.distributed backend of a torchrun world (required there)")
    args = p.parse_args(argv)
    if args.layer is None:
        args.layer = default_fusion_layer(args.grid)
        if args.layer != 3:
            print(f"--layer auto: {args.layer} (fusion map >=16x16 at "
                  f"--grid {args.grid}; pass --layer 3 for the reference index)")
    return args


def make_config(args) -> Config:
    over = dict(kd_weight=args.kd_weight, fusion_layer=args.layer)
    if getattr(args, "remat", 0):
        over["train_remat"] = True
    if args.warp_dtype:
        over["warp_dtype"] = args.warp_dtype
    if args.num_classes != 2:
        over["num_classes"] = args.num_classes
    if args.max_pos:
        over["max_pos_anchors"] = args.max_pos
    return Config(**over) if args.grid == 256 else tiny_config(args.grid, **over)


def mode_name(args) -> str:
    return (args.com or args.bound or "lowerbound") + ("_kd" if args.kd_flag else "")


def build(args, cfg, device, kd_flag=False, task="det"):
    """``build_model`` for ``--com``/``--bound`` with ``--layer`` and, where
    the CLI has them, ``--seed``, ``--warp_flag`` and ``--gru_rounds``; an
    unknown ``--com`` or a misplaced ``--gru_rounds`` exits."""
    try:
        return build_model(args.com or args.bound, cfg, layer=args.layer, device=device,
                           seed=getattr(args, "seed", 0),
                           kd_flag=kd_flag, warp_flag=bool(getattr(args, "warp_flag", 1)), task=task,
                           gru_rounds=getattr(args, "gru_rounds", 0))
    except ValueError as e:
        raise SystemExit(str(e)) from None


def load_student_ckpt(args, model, optimizer) -> int:
    """Resume priority: --resume (.pth or ckpt dir) > --auto_resume_path >
    fresh. Returns the epoch the run continues after."""
    if args.resume:
        if args.resume.endswith(".pth"):
            epoch, _ = restore_or_die(args.resume, model)
            print("NOTE: .pth resume restores params/batch_stats only — Adam "
                  "moments restart from zero (use the ckpt dir to resume them)")
            return epoch
        return restore_or_die(args.resume, model, optimizer)[0]
    if args.auto_resume_path:
        auto_dir = os.path.join(args.auto_resume_path, mode_name(args), "ckpt")
        epoch = CheckpointIO(auto_dir).restore(model, optimizer)
        if epoch is not None:
            print(f"auto-resumed from epoch {epoch} at {auto_dir}")
            return epoch
    return 0


def last_floats(metrics):
    """Step metrics -> floats; a K-step dispatch stacks them (K,) per key,
    and the last step's are logged."""
    return {k: float(v.reshape(-1)[-1]) for k, v in metrics.items()}


def dispatch_groups(batches, k: int):
    """Host batches as they are (``k`` 1), or stacked ``k`` at a time
    (``stack_host_batches``), the epoch's tail as a shorter group."""
    if k == 1:
        yield from batches
        return
    group = []
    for b in batches:
        group.append(b)
        if len(group) == k:
            yield stack_host_batches(group)
            group = []
    if group:
        yield stack_host_batches(group)


def steps_per_dispatch(args, world_size: int = 1) -> int:
    """``--steps_per_dispatch`` (at least 1); exits where the run is on more
    than one rank or the mesh flags ask for it, as the JAX CLI does."""
    k = max(1, args.steps_per_dispatch)
    if k > 1 and (world_size > 1 or getattr(args, "mesh_agent", 1) > 1 or getattr(args, "mesh_spatial", 1) > 1):
        raise SystemExit("--steps_per_dispatch > 1 is single-device only (the mesh path shards per-batch)")
    return k


def init_mesh(args):
    """(the device, the mesh or None). Under ``torchrun`` the process group
    of ``--dist_backend`` and the (data, agent, spatial) mesh over it, with
    the rank's device; else ``--device`` and no mesh."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        if args.mesh_agent > 1 or args.mesh_spatial > 1:
            raise SystemExit("--mesh_agent/--mesh_spatial > 1 needs that many ranks: run under torchrun")
        return resolve_device(args.device), None
    import torch.distributed as dist

    from disconet_tpu_torch.parallel import make_mesh

    if args.dist_backend is None:
        raise SystemExit("a torchrun world needs --dist_backend gloo or nccl")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(args.device)
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise SystemExit(f"rank {os.environ.get('RANK')}: --device cuda, but no CUDA device is visible")
        if args.dist_backend == "nccl" and local >= n_cards:
            raise SystemExit(f"nccl needs a card per rank: local rank {local}, {n_cards} card(s); "
                             "use --dist_backend gloo to share them")
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
    elif args.dist_backend == "nccl":
        raise SystemExit("--dist_backend nccl runs CUDA tensors only: pass --device cuda or --dist_backend gloo")
    dist.init_process_group(args.dist_backend)
    return dev, make_mesh(n_agent=args.mesh_agent, n_spatial=args.mesh_spatial, device=dev)


def run_dispatch(step_k, step1, model, step: int, batch, k: int, debug_nans: bool):
    """One dispatch: ``step_k`` on a stacked group, or ``step1`` on a batch
    (``k`` 1). Under ``--debug_nans`` each step runs and is checked on its
    own. Returns (the step count after it, its metrics)."""
    if k == 1:
        step += 1
        return step, (profiling.checked_step(step1, model, step, batch) if debug_nans else step1(batch))
    n = next(iter(batch.values())).shape[0]
    if not debug_nans:
        return step + n, step_k(batch)
    rows = []
    for i in range(n):
        step += 1
        rows.append(profiling.checked_step(step1, model, step, {key: v[i] for key, v in batch.items()}))
    return step, {key: torch.stack([r[key] for r in rows]) for key in rows[0]}


def main(argv=None):
    args = parse_args(argv)
    steps_per_dispatch(args)
    dev, mesh = init_mesh(args)
    try:
        with contextlib.ExitStack() as stack:
            if mesh is not None and mesh.rank != 0:  # rank 0 alone prints
                stack.enter_context(contextlib.redirect_stdout(stack.enter_context(open(os.devnull, "w"))))
            stack.enter_context(profiling.nan_checks(args.debug_nans))
            return _train(args, dev, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args, dev, mesh):
    K = steps_per_dispatch(args, 1 if mesh is None else mesh.size)
    if args.visualization:
        if mesh is not None:
            raise SystemExit("--visualization 1 is single-device only")
        vis.require_matplotlib()
    lead = mesh is None or mesh.rank == 0  # the rank that prints and writes
    cfg = make_config(args)

    dataset = V2XSimDet(args.data, cfg, rsu=bool(args.rsu), bound=args.bound,
                        dense_targets=False, cache_items=args.cache_items)
    if len(dataset) == 0:
        raise SystemExit(f"no frames found under {args.data}")
    loader = BatchIterator(dataset, args.batch, shuffle=True, seed=args.seed, num_workers=args.nworker)
    if len(loader) == 0:  # drop_last: fewer frames than --batch -> no batches
        raise SystemExit(f"dataset has {len(dataset)} scene-frames, fewer than --batch {args.batch}")
    print(f"dataset: {len(dataset)} scene-frames, {len(loader)} batches/epoch")

    model = build(args, cfg, dev, kd_flag=bool(args.kd_flag))
    optimizer = create_train_state(model, lr=args.lr)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model '{mode_name(args)}': {n_params / 1e6:.2f}M params on {dev}")

    teacher = None
    if args.kd_flag:
        teacher = build_model("teacher", cfg, device=dev, seed=args.seed + 1)
        if args.resume_teacher:
            # restore_or_die: a mistyped path must fail, not distil from a
            # random teacher at kd_weight 1e5
            restore_or_die(args.resume_teacher, teacher)
            print(f"loaded frozen teacher from {args.resume_teacher}")
        else:
            print("WARNING: --kd_flag 1 without --resume_teacher: distilling against a random teacher")

    logdir = os.path.join(args.logpath, mode_name(args))
    os.makedirs(logdir, exist_ok=True)
    ckpt_io = CheckpointIO(os.path.join(logdir, "ckpt"), max_to_keep=args.ckpt_keep or None)
    start_epoch = load_student_ckpt(args, model, optimizer)
    if mesh is not None:  # every rank starts from rank 0's weights and state
        replicate_tree([model, optimizer, teacher], mesh)
        print(f"mesh: {mesh.shape} over {mesh.size} ranks ({args.dist_backend}, {dev})")
    logger = MetricLogger(logdir, log=args.log and lead)

    kd_cache = None
    if args.kd_flag and args.kd_cache:
        nbytes = teacher_feat_bytes(cfg, len(dataset), batch_size=args.batch)
        if nbytes <= args.kd_cache_gb * 2**30:
            t0 = time.perf_counter()
            kd_cache = precompute_teacher_feats(teacher, dataset, cfg, batch_size=args.batch,
                                                num_workers=args.nworker, mesh=mesh)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            print(f"KD cache: {nbytes / 2**20:.0f} MiB of teacher features "
                  f"precomputed in {time.perf_counter() - t0:.1f}s — the per-step "
                  f"teacher forward and bev_teacher transfer are gone")
        else:
            print(f"KD cache disabled: table would be {nbytes / 2**30:.2f} GiB "
                  f"> --kd_cache_gb {args.kd_cache_gb}; re-forwarding per step")
    train_step = make_train_step(model, cfg, optimizer, teacher=teacher, kd_flag=bool(args.kd_flag),
                                 kd_from_cache=kd_cache, mesh=mesh)
    to_device = None if mesh is None else functools.partial(shard_batch, mesh=mesh)
    # K steps a dispatch: one CUDA graph on the card (make_train_step_multi)
    train_k = multi_step(train_step, model, optimizer) if K > 1 else None

    def host_batches():
        for batch in loader:
            if not args.kd_flag or kd_cache is not None:  # skip the dead copy
                batch.pop("bev_teacher", None)
                batch.pop("bev_teacher_packed", None)
            yield batch

    step = 0
    prof = None
    profile_done = False
    # --save_best: the min end-of-epoch loss's weights, held on the host and
    # written at checkpoint boundaries
    best = {"loss": float("inf"), "epoch": None, "snap": None, "written": None} if args.save_best else None
    for epoch in range(start_epoch + 1, args.nepoch + 1):
        t_ep = time.perf_counter()
        waited = 0.0  # seconds the loop waited for its next device batch
        last, metrics = {}, None
        batches = prefetch_to_device(dispatch_groups(host_batches(), K), dev, to_device=to_device)
        while True:
            t0 = time.perf_counter()
            dev_batch = next(batches, None)
            waited += time.perf_counter() - t0
            if dev_batch is None:
                break
            # >=: with K > 1 `step` advances by K and may jump past 2
            if args.profile and lead and not profile_done and prof is None and step >= 2:
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                prof = profile(activities=activities)
                prof.__enter__()
            step, metrics = run_dispatch(train_k, train_step, model, step, dev_batch, K, args.debug_nans)
            if prof is not None and step >= 2 + args.profile:
                _end_profile(prof, dev, logdir)
                prof, profile_done = None, True
            if step % args.log_every == 0:
                last = last_floats(metrics)
                logger.write(step, last, prefix=f"epoch {epoch}")
        final = last_floats(metrics)  # waits for the epoch's device work
        last = last or final
        dt = time.perf_counter() - t_ep
        logger.write(step, {**last, "scenes_per_sec": len(loader) * args.batch / dt,
                            "loader_wait_share": waited / dt}, prefix=f"epoch {epoch} done")
        if best is not None and lead:
            ep_loss = last.get("loss")
            if ep_loss is not None and np.isfinite(ep_loss) and ep_loss < best["loss"]:
                best.update(loss=float(ep_loss), epoch=epoch,
                            snap={k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
        if lead and (epoch % args.ckpt_every == 0 or epoch == args.nepoch):
            if best is not None and best["snap"] is not None and best["epoch"] != best["written"]:
                _write_best(logdir, best)
            ckpt_io.save(epoch, model, optimizer, loss=last.get("loss", 0.0))
            if args.save_pth:
                save_pth(os.path.join(logdir, f"epoch_{epoch}.pth"), model, optimizer, epoch,
                         loss=last.get("loss", 0.0))
            if args.visualization:
                _render_train_panel(cfg, model, dataset, args.batch, dev, logdir, epoch)
    if prof is not None:  # the run ended before 2 + --profile steps
        _end_profile(prof, dev, logdir)
    logger.close()
    print(f"training complete: {args.nepoch} epochs, checkpoints in {logdir}")


def _end_profile(prof, dev, logdir: str) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof.__exit__(None, None, None)
    out = os.path.join(logdir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    print(f"profiler trace written to {out}")


def _render_train_panel(cfg, model, dataset, batch_size: int, dev, logdir: str, epoch: int) -> None:
    """The first present agent of the dataset's first batch with the model's
    detections and the gt, as ``{logdir}/vis/epoch_{epoch}_a{agent}.png``."""
    batch = next(iter(BatchIterator(dataset, batch_size, shuffle=False)))
    boxes, scores, keep = (t.cpu().numpy() for t in make_predict_step(model, cfg)(batch_to_device(batch, dev))[:3])
    mask = batch["agent_mask"][0].astype(bool)
    if not mask.any():
        return
    a = int(np.flatnonzero(mask)[0])
    k = keep[0, a]
    out_dir = os.path.join(logdir, "vis")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"epoch_{epoch}_a{a}.png")
    vis.save(vis.render_bev(cfg, get_bev_np(batch, "bev", cfg)[0, a], batch["gt_boxes"][0][a],
                            boxes[0, a][k], scores[0, a][k]), path)
    print(f"visualization: {path}")


def _write_best(logdir: str, best: dict) -> None:
    """(Re)write {logdir}/best.pth from the best epoch's snapshot. The printed
    line is the record a harness parses for the checkpoint of a run."""
    path = os.path.join(logdir, "best.pth")
    save_pth(path, best["snap"], None, best["epoch"], loss=best["loss"])
    best["written"] = best["epoch"]
    print(f"best checkpoint: epoch {best['epoch']} loss={best['loss']:.5f} -> {path}", flush=True)


if __name__ == "__main__":
    main()
