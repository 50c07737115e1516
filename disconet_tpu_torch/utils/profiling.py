"""Profiling and debug aids, the counterparts of the JAX package's
``utils/profiling.py``.

* The program's spans and counters. :func:`annotate` opens a span named
  after a layer (``"predict/inputs"``, ``"model/warp"``, ``"train/backward"``,
  ...) where that layer's work happens, and :func:`count` adds to a named
  counter (``"h2d_bytes/pageable"``, ``"sync/<site>"`` for each blocking
  read of a device value). Both do nothing unless recording is on, which
  it is inside :func:`recording` and while a ``torch.profiler`` is active;
  off, :func:`annotate` returns one shared no-op context after two global
  reads, allocating nothing. On, a span adds its count and host
  nanoseconds (``time.perf_counter_ns``) to an in-memory table, and a
  counter its amount to another; :func:`snapshot` returns both tables and
  clears them. Under an active profiler a span also opens
  ``record_function(name)``, so the trace puts the program's spans on the
  timeline of the device's operations. Spans hold no tensor and launch
  nothing. Inside a captured CUDA graph a span or a counter records once,
  at capture: the graph's replays run no Python.
* :func:`trace` records a ``torch.profiler`` trace (CPU and, on the card,
  CUDA activity) of its block, the program's spans included, into
  ``logdir/trace.json`` (a Chrome trace, viewed with ``chrome://tracing``
  or Perfetto), as ``jax.profiler``'s trace and ``TraceAnnotation`` do.
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
import threading
import time
import types
from typing import Dict, Iterator

import torch
import torch.autograd.profiler as _profiler
import torch.nn as nn

# the recorder: the depth of nested ``recording()`` blocks, and the tables
# (span name -> [count, host ns]; counter name -> amount), written under
# the lock (autograd's thread runs the recomputed spans of a remat backward)
_depth = 0
_spans: Dict[str, list] = {}
_counters: Dict[str, int] = {}
_lock = threading.Lock()

# the module whose ``_is_profiler_enabled`` is True while a ``torch.profiler``
# is active: a private name of torch, read at each span; where a torch lacks
# it, only ``recording()`` turns the recorder on, and a test fails
_profiler_state = (_profiler if hasattr(_profiler, "_is_profiler_enabled")
                   else types.SimpleNamespace(_is_profiler_enabled=False))


def active() -> bool:
    """Whether spans and counters record now: inside :func:`recording` or
    while a ``torch.profiler`` is active."""
    return bool(_depth or _profiler_state._is_profiler_enabled)


# the span of a recorder that is off: one shared context that does nothing
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _profiler_state._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        with _lock:
            row = _spans.get(self.name)
            if row is None:
                _spans[self.name] = [1, dt]
            else:
                row[0] += 1
                row[1] += dt
        return False


def annotate(name: str):
    """The program's span ``name`` around a block: ``with annotate("model/warp"): ...``."""
    if _depth or _profiler_state._is_profiler_enabled:
        return _Span(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while recording; nothing otherwise."""
    if _depth or _profiler_state._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Records the program's spans and counters inside the block (blocks nest)."""
    global _depth
    with _lock:
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1


def snapshot() -> Dict[str, Dict]:
    """The tables recorded since the last snapshot, cleared:
    ``{"spans": {name: {"count", "host_ns"}}, "counters": {name: amount}}``."""
    with _lock:
        spans = {k: {"count": c, "host_ns": t} for k, (c, t) in _spans.items()}
        counters = dict(_counters)
        _spans.clear()
        _counters.clear()
    return {"spans": spans, "counters": counters}


def format_snapshot(tables: Dict[str, Dict]) -> str:
    """The tables of :func:`snapshot` as lines of text: each span's count,
    host ms in all and per count, then each counter."""
    lines = [f"{'span':<24} {'count':>8} {'host ms':>12} {'ms each':>10}"]
    for name, row in sorted(tables["spans"].items()):
        ms = row["host_ns"] / 1e6
        lines.append(f"{name:<24} {row['count']:>8} {ms:>12.3f} {ms / row['count']:>10.4f}")
    lines += [f"{name:<24} {value:>8}" for name, value in sorted(tables["counters"].items())]
    return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler``, recording the program's
    spans and counters, and write its Chrome trace to ``logdir/trace.json``
    (``logdir`` made if missing); yields ``logdir``. CUDA activity is
    recorded where the card is available, and the card is synchronised
    before the profiler stops. The tables stay for :func:`snapshot`."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with recording(), profile(activities=activities) as prof:
        yield logdir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
