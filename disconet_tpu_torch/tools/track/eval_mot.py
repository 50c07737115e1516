"""CLEAR-MOT of SORT's tracks against the dataset's ground truth (the
reference's ``make eval``).

    python -m disconet_tpu_torch.tools.track.eval_mot --data <root> --tracks DIR \
        [--rsu 1] [--iou_threshold 0.5]

Reads ``sort``'s ``track_agent{a}_scene{s}.txt`` and the ground truth
(``gt_boxes``, ``gt_track_ids``) from the dataset's frames, and prints MOTA,
MOTP and the counts per agent slot and summed over slots: the JAX package's
table. Slot ``a`` reads ``agent{a}`` under ``--data``, ``agent{a + 1}`` with
``--rsu 0`` (the RSU, agent 0, was dropped). An empty track file is a
sequence with no hypotheses.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
from collections import defaultdict

import numpy as np

from disconet_tpu_torch.data import schema
from disconet_tpu_torch.evaluation.mot import clear_mot

SUM_KEYS = ("misses", "false_positives", "id_switches", "num_gt", "matches",
            "MT", "PT", "ML", "FRAG", "num_trajectories")


def load_tracks(path):
    """Track file rows frame,id,cx,cy,w,l,theta,score -> {frame: (boxes, ids)}."""
    out = defaultdict(lambda: ([], []))
    if os.path.getsize(path) == 0:
        return out
    for r in np.loadtxt(path, delimiter=",").reshape(-1, 8):
        out[int(r[0])][0].append(r[2:7])
        out[int(r[0])][1].append(int(r[1]))
    return out


def main(argv=None):
    """Prints the table; returns {"MOTA", "MOTP"} of its summed row."""
    p = argparse.ArgumentParser(description="CLEAR-MOT eval of SORT outputs (PyTorch port)")
    p.add_argument("--data", required=True, help="dataset root (for gt)")
    p.add_argument("--tracks", required=True, help="dir with track_agent{a}_scene{s}.txt")
    p.add_argument("--rsu", type=int, default=1)
    p.add_argument("--from_agent", type=int, default=0)
    p.add_argument("--to_agent", type=int, default=6)
    p.add_argument("--iou_threshold", type=float, default=0.5)
    p.add_argument("--grid", type=int, default=256, help="accepted as the JAX tool does; the gt is metric")
    args = p.parse_args(argv)

    track_files = sorted(glob.glob(os.path.join(args.tracks, "track_agent*_scene*.txt")))
    if not track_files:
        raise SystemExit(f"no track files under {args.tracks}")

    per_agent = {}
    for path in track_files:
        m = re.match(r"track_agent(\d+)_scene(\d+)\.txt", os.path.basename(path))
        slot, scene = int(m.group(1)), int(m.group(2))
        if not (args.from_agent <= slot < args.to_agent):
            continue
        agent_dir = slot if args.rsu else slot + 1
        frames = [(f, pth) for s, f, pth in schema.list_frames(os.path.join(args.data, f"agent{agent_dir}"))
                  if s == scene]
        if not frames:
            continue
        hyp = load_tracks(path)
        gt_seq, hyp_seq = [], []
        for f, pth in sorted(frames):
            fr = schema.load_frame(pth)
            gt_seq.append((np.asarray(fr.get("gt_boxes", np.zeros((0, 5)))),
                           np.asarray(fr.get("gt_track_ids", np.arange(len(fr.get("gt_boxes", [])))))))
            boxes, ids = hyp[f]
            hyp_seq.append((np.asarray(boxes).reshape(-1, 5), np.asarray(ids, int)))
        per_agent.setdefault(slot, []).append(clear_mot(gt_seq, hyp_seq, iou_threshold=args.iou_threshold))

    header = (f"{'agent':>6} | {'MOTA':>8} | {'MOTP':>8} | {'miss':>6} | {'fp':>6} | "
              f"{'idsw':>5} | {'MT':>4} | {'PT':>4} | {'ML':>4} | {'frag':>5} | {'#gt':>6}")
    print(header)
    print("-" * len(header))

    def row(label, tot):
        mota = 1.0 - (tot["misses"] + tot["false_positives"] + tot["id_switches"]) / max(tot["num_gt"], 1)
        motp = tot["iou_sum"] / max(tot["matches"], 1)
        print(f"{label:>6} | {mota:8.4f} | {motp:8.4f} | {int(tot['misses']):>6} | "
              f"{int(tot['false_positives']):>6} | {int(tot['id_switches']):>5} | "
              f"{int(tot['MT']):>4} | {int(tot['PT']):>4} | {int(tot['ML']):>4} | "
              f"{int(tot['FRAG']):>5} | {int(tot['num_gt']):>6}")
        return mota, motp

    agg = defaultdict(float)
    for slot in sorted(per_agent):
        tot = defaultdict(float)
        for r in per_agent[slot]:
            for k in SUM_KEYS:
                tot[k] += r[k]
            tot["iou_sum"] += r["MOTP"] * r["matches"]
        row(str(slot), tot)
        for k, v in tot.items():
            agg[k] += v
    print("-" * len(header))
    mota, motp = row("avg", agg)
    return {"MOTA": mota, "MOTP": motp}


if __name__ == "__main__":
    main()
