"""Blocking host reads of device values a predict call makes: the sum of
the program's ``sync/*`` counters (the NMS fixpoint's ``bool`` per step,
``sync/nms.suppress``) over the count of its ``predict/inputs`` span, one a
call, in the recorder's tables of the traced run's profiled calls
(``core/program_trace.py``). The benchmark's own copies of the outputs are
not counted."""

from port_bench.core.program_trace import recorder_tables


def read(r):
    if r.get("kind") != "predict":
        return None
    tables = recorder_tables(r)
    calls = (tables or {}).get("spans", {}).get("predict/inputs", {}).get("count")
    if not calls:
        return None
    return sum(v for k, v in tables["counters"].items() if k.startswith("sync/")) / calls
