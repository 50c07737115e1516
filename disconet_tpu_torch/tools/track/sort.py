"""SORT over BEV detections (the reference's ``tools/track/sort.py``).

    python -m disconet_tpu_torch.tools.track.sort --det_logs_path DIR [--out DIR] \
        [--max_age 3] [--min_hits 2] [--iou_threshold 0.1]

Host numpy and scipy, the JAX package's tool line for line: per frame, every
track's constant-velocity Kalman filter predicts forward, a detection x track
rotated-IoU matrix (float64) is matched by the Hungarian method, matched
tracks update, the unmatched detections spawn new tracks, tracks unseen for
more than ``max_age`` frames retire, and tracks with ``min_hits`` hits emit a
row. The state is a BEV box [cx, cy, w, l, theta, vx, vy].

Input: the dumps of ``test_codet --tracking`` (``det_agent{a}_scene{s}.txt``,
rows ``frame,cx,cy,w,l,theta,score``). Output: ``track_agent{a}_scene{s}.txt``,
rows ``frame,track_id,cx,cy,w,l,theta,1.0``. Track ids come from a
class-level counter, so they depend on every track the process made before.
"""

from __future__ import annotations

import argparse
import glob
import os
import re

import numpy as np
from scipy.optimize import linear_sum_assignment

from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix_np


class KalmanBoxTracker:
    """Constant-velocity Kalman filter over a BEV box."""

    count = 0

    def __init__(self, box: np.ndarray):
        self.x = np.zeros(7)  # [cx, cy, w, l, theta, vx, vy]
        self.x[:5] = box
        self.P = np.diag([1.0, 1.0, 1.0, 1.0, 1.0, 100.0, 100.0])
        self.F = np.eye(7)
        self.F[0, 5] = 1.0  # cx += vx
        self.F[1, 6] = 1.0  # cy += vy
        self.Q = np.diag([0.05, 0.05, 0.01, 0.01, 0.02, 0.5, 0.5])
        self.H = np.zeros((5, 7))
        self.H[:5, :5] = np.eye(5)
        self.R = np.diag([0.2, 0.2, 0.1, 0.1, 0.1])
        KalmanBoxTracker.count += 1
        self.id = KalmanBoxTracker.count
        self.hits = 1
        self.time_since_update = 0
        self.age = 0

    def predict(self) -> np.ndarray:
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        self.age += 1
        self.time_since_update += 1
        return self.x[:5]

    def update(self, box: np.ndarray):
        z = np.asarray(box, np.float64)
        y = z - self.H @ self.x
        y[4] = (y[4] + np.pi / 2) % np.pi - np.pi / 2  # a BEV box is pi-symmetric
        S = self.H @ self.P @ self.H.T + self.R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        self.P = (np.eye(7) - K @ self.H) @ self.P
        self.hits += 1
        self.time_since_update = 0

    @property
    def box(self) -> np.ndarray:
        return self.x[:5]


class Sort:
    """The SORT association loop."""

    def __init__(self, max_age: int = 3, min_hits: int = 2, iou_threshold: float = 0.1):
        self.max_age = max_age
        self.min_hits = min_hits
        self.iou_threshold = iou_threshold
        self.trackers: list[KalmanBoxTracker] = []
        self.frame_count = 0

    def update(self, dets: np.ndarray):
        """dets (N, 6) [cx, cy, w, l, theta, score] -> (M, 7) rows
        [cx, cy, w, l, theta, score, track_id] of the confirmed tracks."""
        self.frame_count += 1
        preds = np.array([t.predict() for t in self.trackers]).reshape(-1, 5)

        matched, unmatched_dets = [], list(range(len(dets)))
        if len(preds) and len(dets):
            iou = rotated_iou_matrix_np(dets[:, :5], preds)  # (N, T)
            row, col = linear_sum_assignment(-iou)
            # new tracks spawn in this order: the unassigned rows, then the
            # rows assigned below the threshold; the ids follow it
            unmatched_dets = [i for i in range(len(dets)) if i not in row]
            for r, c in zip(row, col):
                if iou[r, c] >= self.iou_threshold:
                    matched.append((r, c))
                else:
                    unmatched_dets.append(r)

        for r, c in matched:
            self.trackers[c].update(dets[r, :5])
        for i in unmatched_dets:
            self.trackers.append(KalmanBoxTracker(dets[i, :5]))

        out, alive = [], []
        for t in self.trackers:
            if t.time_since_update <= self.max_age:
                alive.append(t)
                if t.time_since_update == 0 and (t.hits >= self.min_hits or self.frame_count <= self.min_hits):
                    out.append(np.concatenate([t.box, [1.0], [t.id]]))
        self.trackers = alive
        return np.asarray(out).reshape(-1, 7)


def run_file(det_path: str, out_path: str, max_age: int, min_hits: int, iou_thr: float) -> int:
    """Track one dump file into ``out_path``; returns the rows written."""
    rows = np.loadtxt(det_path, delimiter=",").reshape(-1, 7)
    frames = rows[:, 0].astype(int)
    tracker = Sort(max_age=max_age, min_hits=min_hits, iou_threshold=iou_thr)
    n = 0
    with open(out_path, "w") as f:
        for fr in range(frames.min(), frames.max() + 1) if len(rows) else []:
            for t in tracker.update(rows[frames == fr][:, 1:7]):  # cx,cy,w,l,theta,score
                f.write(f"{fr},{int(t[6])},{t[0]:.3f},{t[1]:.3f},{t[2]:.3f},{t[3]:.3f},{t[4]:.4f},1.0\n")
                n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="SORT over BEV detection dumps (PyTorch port)")
    p.add_argument("--det_logs_path", required=True, help="dir with det_agent{a}_scene{s}.txt")
    p.add_argument("--out", default="", help="output dir (default: det_logs_path/../tracks)")
    p.add_argument("--from_agent", type=int, default=0)
    p.add_argument("--to_agent", type=int, default=6, help="exclusive upper bound")
    p.add_argument("--max_age", type=int, default=3)
    p.add_argument("--min_hits", type=int, default=2)
    p.add_argument("--iou_threshold", type=float, default=0.1)
    args = p.parse_args(argv)

    out_dir = args.out or os.path.join(os.path.dirname(args.det_logs_path.rstrip("/")), "tracks")
    os.makedirs(out_dir, exist_ok=True)
    n_files = 0
    for path in sorted(glob.glob(os.path.join(args.det_logs_path, "det_agent*_scene*.txt"))):
        m = re.match(r"det_agent(\d+)_scene(\d+)\.txt", os.path.basename(path))
        agent = int(m.group(1))
        if not (args.from_agent <= agent < args.to_agent):
            continue
        out_path = os.path.join(out_dir, f"track_agent{agent}_scene{m.group(2)}.txt")
        n = run_file(path, out_path, args.max_age, args.min_hits, args.iou_threshold)
        print(f"{os.path.basename(path)} -> {os.path.basename(out_path)}: {n} track rows")
        n_files += 1
    if n_files == 0:
        raise SystemExit(f"no det dumps matched under {args.det_logs_path}")
    print(f"tracked {n_files} (agent, scene) files into {out_dir}")


if __name__ == "__main__":
    main()
