"""Training logs: the port's copies of the JAX package's ``AverageMeter`` and
``MetricLogger`` (the reference's ``AverageMeter.py`` and in-CLI logging).

The log file is always written with ``--log``; TensorBoard scalars only
where ``tensorboard`` is installed."""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional


class AverageMeter:
    """Running average, as the reference's ``AverageMeter``."""

    def __init__(self, name: str = "", fmt: str = ":.4f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {format(self.val, self.fmt[1:])} ({format(self.avg, self.fmt[1:])})"


class MetricLogger:
    """stdout + logfile + optional TensorBoard scalars (``--log``/``--logpath``)."""

    def __init__(self, logpath: Optional[str] = None, log: bool = False, tag: str = "train"):
        self.file = None
        self.tb = None
        if logpath and log:
            os.makedirs(logpath, exist_ok=True)
            self.file = open(os.path.join(logpath, "log.txt"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(os.path.join(logpath, "tb", tag))
        self.t0 = time.time()

    def write(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        line = f"[{time.time() - self.t0:8.1f}s] {prefix} step {step}: " + "  ".join(
            f"{k}={float(v):.5f}" for k, v in metrics.items()
        )
        print(line)
        sys.stdout.flush()
        if self.file:
            self.file.write(line + "\n")
            self.file.flush()
        if self.tb:
            # prefix stays a human-readable stdout label only: folding it into
            # the tag (e.g. 'epoch 3/loss') would fragment each metric into
            # per-epoch one-segment TB curves instead of one continuous curve
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), step)

    def close(self):
        if self.file:
            self.file.close()
        if self.tb:
            self.tb.close()
