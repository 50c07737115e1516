"""What a traced run can read of the program's own spans and counters
(``disconet_tpu_torch/utils/profiling.py``).

The program records while a ``torch.profiler`` is active, so the two
profiled phases of a traced run leave its tables behind
(:func:`recorder_tables`) and put its spans (``PROGRAM_SPANS``) into the
trace beside the benchmark's. A trace reduced with those names
(:class:`ProgramTrace`) also ties each device operation to the spans that
the main thread held when the operation was launched, from whichever
thread (:meth:`ProgramTrace.device_s_during`): the backward's operations,
which autograd's thread launches while the main thread waits in
``train/backward``, get that span's time.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from port_bench.core.trace import DEVICE_CATS, TraceSummary, open_at

PROGRAM_SPANS = ("predict/inputs", "predict/voxelize", "model/encode", "model/warp", "model/fuse", "model/decode",
                 "nms/select", "nms/suppress", "train/kd", "train/forward", "train/backward", "train/update")


def recorder_tables(readings: Dict) -> Optional[Dict]:
    """The program's tables (spans and counters) of the run's profiled
    phases, taken once (the program's ``snapshot`` clears them) and kept in
    ``readings``; None where the program has no recorder."""
    if "recorder" not in readings:
        try:
            from disconet_tpu_torch.utils.profiling import snapshot
        except ImportError:  # a program without the recorder
            readings["recorder"] = None
        else:
            readings["recorder"] = snapshot()
    return readings["recorder"]


class ProgramTrace(TraceSummary):
    """:class:`TraceSummary`, and the device seconds by the spans that the
    main thread (the one that opened most spans) held at each launch."""

    def __init__(self, events: List[dict], window_s: float, span_names: Iterable[str]):
        span_names = set(span_names)
        super().__init__(events, window_s, span_names)
        launch_ts: Dict[int, float] = {}
        spans_by_tid: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                device.append((dur / 1e6, cat, corr))
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launch_ts[corr] = ts
            elif cat == "user_annotation" and e.get("name") in span_names:
                spans_by_tid[e.get("tid")].append((ts, ts + dur, e["name"]))
        held: Dict[int, List[str]] = {}
        if spans_by_tid:
            main = max(spans_by_tid, key=lambda t: len(spans_by_tid[t]))
            held = open_at(spans_by_tid[main], [(t, corr) for corr, t in launch_ts.items()])
        self.during_cat_s: Dict[Tuple[Tuple[str, ...], str], float] = defaultdict(float)
        for d, cat, corr in device:
            self.during_cat_s[(tuple(held.get(corr, ())), cat)] += d

    def device_s_during(self, span: str, outside: Iterable[str] = (), exclude_cats: Iterable[str] = ()) -> float:
        """Device seconds of the operations launched, from any thread, while
        the main thread held ``span`` (nested spans included) and none of
        ``outside``, leaving out the categories ``exclude_cats``."""
        outside, exclude_cats = set(outside), set(exclude_cats)
        return sum(d for (path, cat), d in self.during_cat_s.items()
                   if span in path and not outside.intersection(path) and cat not in exclude_cats)
