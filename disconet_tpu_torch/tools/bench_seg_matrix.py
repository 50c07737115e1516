"""Segmentation-quality protocol of the port, the counterpart of the JAX
package's ``tools/bench_seg_matrix.py``.

    python -m disconet_tpu_torch.tools.bench_seg_matrix --root build/seg_quality \
        --configs disco lowerbound upperbound --seeds 0 1 2 --out results/port_seg_matrix.json
    python -m disconet_tpu_torch.tools.bench_seg_matrix --out results/port_seg_matrix.json --summarize

The JAX tool's protocol: the data of ``create_data_seg --occlusion 1`` at
``--grid 64``, 24 train and 24 val scenes of 8 frames (the files the det
generator writes for the same flags); each (config, seed) cell trains
through the port's seg ``train_codet`` with ``--seg_backbone`` the
``--backbone`` (the UNet by default, as the JAX matrix measured; ``stpn``
the detection pyramid with a SegHead, its cells under ``logs/stpn/``) and the
fusion layer pinned at 2 (the configs of ``CONFIGS``), ``--nepoch`` 100 at
``--batch`` 4, 8 optimizer steps a dispatch, the final epoch's checkpoint
only, and evaluates it on the val split through the seg ``test_codet``,
whose mIoU and per-class IoU it keeps. An interrupted cell's training
resumes from its last checkpoint.

Results accumulate in ``--out`` under the JAX matrix's keys
(``disco/seed0``); a key already there is skipped. Every cell carries the
stamp of ``bench_quality``'s cells (card, commit, source digest, seconds).
``--summarize`` prints the port's cells beside the JAX matrix's
(``results/seg_matrix.json``): each config's seeds, JAX's range and the
range rule's verdict, the port's mean against JAX's (``ordering_stats``),
and the JAX tool's ``SEG_ORDERINGS`` on both packages' seeds.

The CLIs run as ``python -m`` processes, or in this process with
``--inprocess`` (the tests). ``--device`` passes through; the card by default.
"""

from __future__ import annotations

import argparse
import os
import re
import time

from disconet_tpu_torch.tools.bench_quality import (
    REPO,
    card,
    epoch_loss_stats,
    git_commit,
    load_results,
    ordering_stats,
    record,
    run_cli,
    source_digest,
    stamp,
    summarize as summarize_cells,
)

JAX_MATRIX = os.path.join(REPO, "results", "seg_matrix.json")

# config -> seg CLI flags, as the JAX protocol's: the fusion layer pinned at 2
# (a >= 16x16 fusion map at the 64-grid)
CONFIGS = {
    "lowerbound": ["--bound", "lowerbound", "--layer", "2"],
    "upperbound": ["--bound", "upperbound", "--layer", "2"],
    "disco": ["--com", "disco", "--layer", "2"],
    "v2v": ["--com", "v2v", "--layer", "2"],
    "when2com": ["--com", "when2com", "--layer", "2"],
}

# the JAX tool's ordering claims (hi, lo), each checked against its own noise
SEG_ORDERINGS = [
    ("upperbound", "lowerbound"), ("disco", "lowerbound"),
    ("upperbound", "disco"),
    ("v2v", "lowerbound"), ("when2com", "lowerbound"),
    ("disco", "v2v"), ("disco", "when2com"), ("v2v", "when2com"),
]

# optimizer steps a dispatch, as the JAX tool's command line fixes them
STEPS_PER_DISPATCH = 8

MIOU_RE = re.compile(r"mIoU \|\s+([\d.]+)")
CLASS_RE = re.compile(r"^\s*(\w+) \|\s+([\d.]+)\s*$", re.M)


def generate(args) -> None:
    """The protocol's splits, skipped where they already exist."""
    for split in ("train", "val"):
        out = os.path.join(args.root, split)
        if os.path.isdir(out) and os.listdir(out):
            continue
        os.makedirs(args.root, exist_ok=True)
        run_cli("seg.create_data_seg", ["--data", args.root, "--split", split, "--scenes", str(args.scenes),
                                        "--frames", str(args.frames), "--grid", str(args.grid),
                                        "--occlusion", str(args.occlusion)],
                os.path.join(args.root, "gen.log"), args.inprocess)


def run_cell(args, name: str, seed: int, results: dict) -> None:
    key = f"{name}/seed{seed}"
    if key in results:
        print(f"[skip] {key}", flush=True)
        return
    logpath = os.path.join(args.root, "logs", *(["stpn"] if args.backbone == "stpn" else []), f"seed{seed}")
    os.makedirs(logpath, exist_ok=True)
    log_file = os.path.join(logpath, f"{name}_seg.log")
    flags = list(CONFIGS[name])
    common = [*flags, "--seg_backbone", args.backbone, "--grid", str(args.grid), "--batch", str(args.batch),
              "--device", args.device]
    # the seg CLI logs under (com or bound) + "_seg", the config's name
    ckpt_dir = os.path.join(logpath, f"{name}_seg", "ckpt")
    t0 = time.perf_counter()
    seconds = {}
    if not os.path.exists(os.path.join(ckpt_dir, f"{args.nepoch}.pth")):
        run_cli("seg.train_codet", ["--data", os.path.join(args.root, "train"), *common,
                                    "--nepoch", str(args.nepoch), "--seed", str(seed), "--logpath", logpath,
                                    "--auto_resume_path", logpath, "--ckpt_every", str(args.nepoch),
                                    "--ckpt_keep", "1", "--steps_per_dispatch", str(STEPS_PER_DISPATCH)],
                log_file, args.inprocess)
        seconds["train_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out = run_cli("seg.test_codet", ["--data", os.path.join(args.root, "val"), *common, "--resume", ckpt_dir],
                  log_file, args.inprocess)
    m = MIOU_RE.search(out)
    if not m:
        raise RuntimeError(f"no mIoU table for {key} (see {log_file})")
    seconds["eval_s"] = time.perf_counter() - t1
    seconds["wall_s"] = time.perf_counter() - t0
    cell = {"mIoU": float(m.group(1)), "iou": {c: float(v) for c, v in CLASS_RE.findall(out) if c != "mIoU"}}
    cell.update(epoch_loss_stats(log_file))
    cell["prov"] = {**stamp(args, flags, seconds), "backbone": args.backbone}
    record(args.out, key, cell, results)
    print(f"[done] {key}: mIoU {cell['mIoU']}", flush=True)


def _seeds(cells: dict, name: str) -> list:
    return [v["mIoU"] for k, v in sorted(cells.items()) if k.split("/")[0] == name and "mIoU" in v]


def _fmt(s) -> str:
    if s is None:
        return "no cells"
    noise = "-" if s["noise"] is None else f"{s['noise']:.4f}"
    return f"{s['gap']:+.4f} (noise {noise}, n={s['n_hi']} vs {s['n_lo']}) {s['verdict']}"


def _ordering(cells: dict, hi: str, lo: str):
    a, b = _seeds(cells, hi), _seeds(cells, lo)
    return ordering_stats(a, b) if a and b else None


def summarize(results: dict, reference: dict) -> dict:
    """Print the port's cells beside the JAX matrix's (``bench_quality``'s
    table: the range rule and each config's ``ordering_stats`` against
    JAX), then ``SEG_ORDERINGS`` on each package's seeds; returns {"rows":
    the table's rows, "orderings": [(hi, lo, port stats, JAX stats)]}."""
    rows = summarize_cells(results, reference, metrics=("mIoU",))
    print(f"\n{'ordering (mIoU)':<26} {'port':<48} JAX")
    orderings = []
    for hi, lo in SEG_ORDERINGS:
        port = _ordering(results, hi, lo)
        if port is not None:
            ref = _ordering(reference, hi, lo)
            print(f"{hi + ' > ' + lo:<26} {_fmt(port):<48} {_fmt(ref)}")
            orderings.append((hi, lo, port, ref))
    return {"rows": rows, "orderings": orderings}


def main(argv=None):
    p = argparse.ArgumentParser(description="Segmentation-quality protocol of the PyTorch port")
    p.add_argument("--root", type=str, default="build/seg_quality", help="data and logs")
    p.add_argument("--out", type=str, default="results/port_seg_matrix.json")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--configs", type=str, nargs="+", default=["disco", "lowerbound", "upperbound"],
                   choices=sorted(CONFIGS))
    p.add_argument("--backbone", type=str, default="unet", choices=["unet", "stpn"],
                   help="the seg train_codet's --seg_backbone (the JAX matrix measured the UNet)")
    p.add_argument("--nepoch", type=int, default=100)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--grid", type=int, default=64)
    p.add_argument("--scenes", type=int, default=24, help="scenes per split")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--occlusion", type=int, default=1)
    p.add_argument("--summarize", action="store_true", help="only print the table against the JAX matrix")
    p.add_argument("--commit", type=str, default="", help="stamped on each cell (default: git HEAD)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--inprocess", action="store_true", help="run the CLIs in this process")
    args = p.parse_args(argv)

    results = load_results(args.out)
    if args.summarize:
        return summarize(results, load_results(JAX_MATRIX))
    args.card = card() if args.device == "cuda" else args.device
    args.commit = args.commit or git_commit()
    args.source_sha1 = source_digest()
    args.steps_per_dispatch = STEPS_PER_DISPATCH  # for the stamp
    print(f"card: {args.card}; commit {args.commit}, sources {args.source_sha1}", flush=True)
    generate(args)
    for seed in args.seeds:
        for name in args.configs:
            run_cell(args, name, seed, results)
    return summarize(results, load_results(JAX_MATRIX))


if __name__ == "__main__":
    main()
