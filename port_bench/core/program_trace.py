"""What a traced run can read of the program's own counters and span
tables (``disconet_tpu_torch/utils/profiling.py``).

The program records while a ``torch.profiler`` is active, so the two
profiled phases of a traced run leave its tables behind
(:func:`recorder_tables`): each span's count and host nanoseconds, each
counter's amount. Its spans also go into the trace beside the benchmark's,
where ``core/trace.py`` reads their device time.
"""

from __future__ import annotations

from typing import Dict, Optional


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
