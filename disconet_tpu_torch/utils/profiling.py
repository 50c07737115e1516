"""Profiling and debug aids, the counterparts of the JAX package's
``utils/profiling.py``.

* :func:`trace` records a ``torch.profiler`` trace (CPU and, on the card,
  CUDA activity) of its block into ``logdir`` (a Chrome trace, viewed with
  ``chrome://tracing`` or Perfetto; TensorBoard's profile plugin reads the
  same directory), and :func:`annotate` names a region of it
  (``record_function``), as ``jax.profiler``'s trace and
  ``TraceAnnotation`` do.
* The debug mode of the training CLIs, the counterpart of the JAX package's
  ``enable_nan_checks`` (``jax_debug_nans``).

``--debug_nans 1`` turns on autograd's anomaly mode, which names the backward
function that made a NaN, and checks after every step that the loss and every
gradient are finite; the run stops at the first step that fails, naming the
step and the first non-finite value. The host sync each step is the debug
mode's own cost.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Dict

import torch
import torch.nn as nn


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` and write its trace to a
    file under ``logdir`` (made if missing); yields ``logdir``. CUDA
    activity is recorded where the card is available."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir


def annotate(name: str):
    """A named region of the trace: ``with annotate("fuse"): ...``."""
    return torch.profiler.record_function(name)


def nan_checks(enabled: bool):
    """A context that runs autograd's anomaly mode when ``enabled`` and
    restores the previous mode after."""
    return torch.autograd.set_detect_anomaly(True) if enabled else contextlib.nullcontext()


def first_nonfinite(metrics: Dict[str, torch.Tensor], model: nn.Module):
    """The name of the first non-finite step metric (in the step's order,
    ``grad_norm`` aside) or gradient (in parameter order), or None."""
    for k, v in metrics.items():
        if k != "grad_norm" and not math.isfinite(float(v)):
            return k
    for name, p in model.named_parameters():
        if p.grad is not None and not bool(torch.isfinite(p.grad).all()):
            return f"gradient of {name}"
    return None


def checked_step(step_fn, model: nn.Module, step: int, batch):
    """``step_fn(batch)`` under ``--debug_nans``: exits naming ``step`` (1-based)
    and the first non-finite value, or the backward function that anomaly
    mode caught."""
    try:
        metrics = step_fn(batch)
    except RuntimeError as e:
        if "nan" not in str(e).lower():
            raise
        raise SystemExit(f"--debug_nans: step {step}: {str(e).splitlines()[0]}") from None
    bad = first_nonfinite(metrics, model)
    if bad is not None:
        raise SystemExit(f"--debug_nans: step {step}: non-finite {bad}")
    return metrics
