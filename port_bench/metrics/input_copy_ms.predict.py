"""Host ms a predict call spends copying its inputs to the card, under the
profiler: the program's ``predict/inputs`` span (``pipeline.predict``'s
copies of the host arrays), its host nanoseconds over its count in the
recorder's tables of the traced run's profiled calls
(``core/program_trace.py``). One of those phases records every host
operation, so the reading carries the profiler's cost of the span's few
operations besides the copy; ``probe_spans.py`` reads the span with no
profiler active beside it."""

from port_bench.core.program_trace import recorder_tables


def read(r):
    if r.get("kind") != "predict":
        return None
    tables = recorder_tables(r)
    row = (tables or {}).get("spans", {}).get("predict/inputs")
    if not row or not row["count"]:
        return None
    return row["host_ns"] / row["count"] / 1e6
