"""The benchmark's spans and the reduction of a profiler trace to numbers.

Spans are ``record_function`` ranges: the benchmark's own, which it opens
around its calls into the program's layers (``call``/``step``,
``voxelize``, ``iou``, ``model``, ``fusion``, ``loader``), and the
program's, which ``disconet_tpu_torch/utils/profiling.py`` opens inside
its layers while a profiler is active (``model/warp``, ``train/backward``,
...). A traced run profiles two short phases after its timed window with
``torch.profiler``: one with host (CPU) and CUDA activity, which ties the
device's work to the spans, and one with CUDA activity alone, which the
profiler's own host work stretches far less.
Each writes its Chrome trace to a temporary file, reduced here. Every
``user_annotation`` range of the trace is a span, so a span that a later
version of the program opens is read by a metric file alone:

* every device operation (kernel, memcpy, memset) is tied to the host call
  that launched it by its correlation id, and so to the spans that were
  open on that thread when it was launched: a span's device time
  (:meth:`TraceSummary.device_s`) is the summed duration of the operations
  launched inside it (the arithmetic of ``chip_smoke.py::_device_ms``,
  lines 257-281, per span instead of per call);
* it is also tied to the spans that the main thread (the one that opened
  most spans) held at the launch, from whichever thread
  (:meth:`TraceSummary.device_s_during`): the backward's operations, which
  autograd's thread launches while the main thread waits in
  ``train/backward``, get that span's time;
* ``busy_s`` is the union of the device operations' intervals, and the
  gaps between them are the idle time, each labelled by the innermost span
  and the outermost host operation open on the main thread when it began.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Opens named ``record_function`` ranges around calls into the program."""

    def __init__(self):
        self._hooks = []

    @staticmethod
    def wrap(name: str, fn: Callable) -> Callable:
        """``fn`` inside a range called ``name``."""

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    def around_forward(self, name: str, module: torch.nn.Module) -> None:
        """A range called ``name`` around every forward of ``module`` (a
        forward pre-hook opens it, a forward hook closes it)."""
        stack = []

        def pre(mod, args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out):
            stack.pop().__exit__(None, None, None)

        self._hooks += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]

    def around_method(self, name: str, obj, method: str) -> bool:
        """A range called ``name`` around ``obj.method``, wrapped on the
        instance; False (and nothing wrapped) where ``obj`` has no such
        method."""
        fn = getattr(obj, method, None)
        if fn is None:
            return False
        setattr(obj, method, self.wrap(name, fn))
        self._hooks.append(_Restore(obj, method))
        return True

    def remove(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []


class _Restore:
    def __init__(self, obj, method):
        self.obj, self.method = obj, method

    def remove(self):
        if self.method in vars(self.obj):
            delattr(self.obj, self.method)


def union_length(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(total length of the union, the merged intervals) of (start, end) pairs."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


def open_at(ranges: List[Tuple[float, float, str]], times: List[Tuple[float, object]]) -> Dict[object, List[str]]:
    """For each (time, key) of ``times``: the names of the ``ranges``
    (start, end, name) of one thread open at that time, outermost first.
    One sweep; ranges of one thread nest, and a range that starts or ends
    at the queried time counts as open."""
    events = [(s, 0, i) for i, (s, _, _) in enumerate(ranges)]
    events += [(e, 2, i) for i, (_, e, _) in enumerate(ranges)]
    events += [(t, 1, k) for k, (t, _) in enumerate(times)]
    events.sort(key=lambda ev: (ev[0], ev[1]))
    open_: List[int] = []
    out: Dict[object, List[str]] = {}
    for _, kind, i in events:
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            if i in open_:
                open_.remove(i)
        else:
            out[times[i][1]] = [ranges[j][2] for j in sorted(open_, key=lambda j: ranges[j][0])]
    return out


class TraceSummary:
    """What a profiled phase's Chrome trace says, reduced."""

    def __init__(self, events: List[dict], window_s: float):
        launches: Dict[int, Tuple[int, float]] = {}
        spans_by_tid: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
        ops_by_tid: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                device.append((ts, ts + dur, e.get("name", "?"), cat, (e.get("args") or {}).get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (e.get("tid"), ts)
            elif cat == "user_annotation":
                spans_by_tid[e.get("tid")].append((ts, ts + dur, e.get("name", "?")))
            elif cat == "cpu_op":
                ops_by_tid[e.get("tid")].append((ts, ts + dur, e.get("name", "?")))
        self.window_s = window_s
        main_tid = max(spans_by_tid, key=lambda t: len(spans_by_tid[t])) if spans_by_tid else None
        # the spans open at each launch: on the launching thread, and on the main thread
        held_by_corr: Dict[int, List[str]] = {}
        queries: Dict[int, List[Tuple[float, int]]] = defaultdict(list)
        for corr, (tid, t) in launches.items():
            if tid in spans_by_tid:
                queries[tid].append((t, corr))
        for tid, q in queries.items():
            held_by_corr.update(open_at(spans_by_tid[tid], q))
        held_by_main = open_at(spans_by_tid[main_tid], [(t, corr) for corr, (_, t) in launches.items()]) \
            if main_tid is not None else {}
        # device seconds per op name, and per (spans open at launch, category)
        self.op_s: Dict[str, float] = defaultdict(float)
        self.path_cat_s: Dict[Tuple[Tuple[str, ...], str], float] = defaultdict(float)
        self.during_cat_s: Dict[Tuple[Tuple[str, ...], str], float] = defaultdict(float)
        for s, e, name, cat, corr in device:
            d = (e - s) / 1e6
            self.op_s[name[:160]] += d
            self.path_cat_s[(tuple(held_by_corr.get(corr, ())), cat)] += d
            self.during_cat_s[(tuple(held_by_main.get(corr, ())), cat)] += d
        busy_us, merged = union_length([(s, e) for s, e, *_ in device])
        self.busy_s = busy_us / 1e6
        # idle gaps between device work, labelled by what the main thread
        # was doing when each began
        self.idle: Dict[str, float] = defaultdict(float)
        gaps = [(e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:])]
        q = [(e0, i) for i, (e0, _) in enumerate(gaps)]
        in_span = open_at(spans_by_tid.get(main_tid, []), q) if main_tid is not None else {}
        top_ops = _outermost(ops_by_tid.get(main_tid, []))
        in_op = open_at(top_ops, q) if main_tid is not None else {}
        for i, (e0, s1) in enumerate(gaps):
            sp, op = in_span.get(i, []), in_op.get(i, [])
            label = f"{sp[-1] if sp else 'outside spans'}: {op[0] if op else 'python'}"
            self.idle[label] += (s1 - e0) / 1e6

    @staticmethod
    def _sum(table, span: str, outside: Iterable[str], exclude_cats: Iterable[str]) -> float:
        outside, exclude_cats = set(outside), set(exclude_cats)
        return sum(d for (path, cat), d in table.items()
                   if span in path and not outside.intersection(path) and cat not in exclude_cats)

    def device_s(self, span: str, outside: Iterable[str] = (), exclude_cats: Iterable[str] = ()) -> float:
        """Device seconds launched inside ``span`` (nested spans included)
        and in none of the spans ``outside``, leaving out the categories
        ``exclude_cats`` (of ``DEVICE_CATS``)."""
        return self._sum(self.path_cat_s, span, outside, exclude_cats)

    def device_s_during(self, span: str, outside: Iterable[str] = (), exclude_cats: Iterable[str] = ()) -> float:
        """Device seconds of the operations launched, from any thread, while
        the main thread held ``span`` (nested spans included) and none of
        ``outside``, leaving out the categories ``exclude_cats``."""
        return self._sum(self.during_cat_s, span, outside, exclude_cats)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def _outermost(ranges: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """The ranges of one thread that no other range holds."""
    out, end = [], float("-inf")
    for r in sorted(ranges):
        if r[0] >= end:
            out.append(r)
            end = r[1]
    return out


@contextlib.contextmanager
def profiled(device: torch.device, host_ops: bool = True):
    """Profile the block; yields a list that holds the :class:`TraceSummary`
    once the block has ended. The device is synchronised at both ends and
    the block's wall time is the window. ``host_ops`` False records the
    device's activity alone (on a CPU run, which has none, the host's)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = ([ProfilerActivity.CPU] if host_ops or not cuda else []) + ([ProfilerActivity.CUDA] if cuda else [])
    holder: List[TraceSummary] = []
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield holder
        sync()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    holder.append(TraceSummary(events, window))
