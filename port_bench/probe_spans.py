"""The program's spans and counters in one cell, read as a later benchmark
would read them, and what recording them costs.

    python3 port_bench/probe_spans.py --workload <cell> --seed <n> [--seconds 10] [--pairs 2]

One process on the card. First a traced run of the cell by its mix's
``drivers/<kind>.py``, whose trace (``core/trace.py``) gives each of the
program's spans' device ms a call or step
(launched inside it, and launched from any thread while the main thread
held it), the share of the device time that the program's spans (those of
the recorder's tables) cover,
the idle gaps labelled by the program's innermost span, and the
recorder's tables. Then ``--pairs`` pairs of the cell's untraced window
run in turns without and with ``profiling.recording()`` (off, on, on, off,
...) on the same seed: ``recording_overhead`` is the on windows' time a
call or step over the off windows', less 1, in %, and the on windows'
``predict/inputs`` host ms a call, with no profiler active, stands beside
the traced run's (which ``input_copy_ms.predict`` reads); ``--pairs 0``
leaves them out. Last, the host
cost of one span and of one counter, on and off. Prints one JSON object
as the last line of standard output.
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
os.environ.setdefault("OMP_NUM_THREADS", "2")

import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402

import torch  # noqa: E402

from port_bench.core import trace as trace_mod  # noqa: E402
from port_bench.core.program_trace import recorder_tables  # noqa: E402
from port_bench.core.registry import load_cell  # noqa: E402

# per kind: the span a call or step runs in, and the metric's name -> (span, launched from any thread)
LAYERS = {
    "predict": ("call", {"input_copy_device_ms": ("predict/inputs", False), "voxelize_ms": ("predict/voxelize", False),
                         "encode_ms": ("model/encode", False), "warp_ms": ("model/warp", False),
                         "fuse_ms": ("model/fuse", False), "decode_ms": ("model/decode", False),
                         "select_ms": ("nms/select", False), "suppress_ms": ("nms/suppress", False)}),
    "train": ("step", {"kd_ms": ("train/kd", False), "forward_ms": ("train/forward", False),
                       "backward_ms": ("train/backward", True), "backward_launched_inside_ms": ("train/backward", False),
                       "update_ms": ("train/update", True), "warp_ms": ("model/warp", True)}),
}


def traced(cell, drv, seed: int, seconds: float, device) -> dict:
    """The traced run with the program's spans: per-layer device ms, cover, idle, tables."""
    out = drv.run(cell, seed, seconds, True, device, time.perf_counter(), {}, log=lambda *a: None)
    r = out["readings"]
    kind = r["kind"]
    n = r["profiled_calls"] if kind == "predict" else r["profiled_steps"]
    t = r["trace"]
    outer, layers = LAYERS[kind]
    res = {"per_layer": {}, "profiled": n}
    for name, (span, during) in layers.items():
        dev = t.device_s_during(span) if during else t.device_s(span)
        res["per_layer"][name] = 1e3 * dev / n
    if kind == "predict":
        res["per_layer"]["fuse_outside_warp_ms"] = 1e3 * t.device_s("model/fuse", outside=("model/warp",)) / n
    # the device time of the calls or steps, and the part no program span held
    tables = recorder_tables(r) or {"spans": {}, "counters": {}}
    program_spans = set(tables["spans"])
    total = t.device_s_during(outer)
    uncovered = {cat: sum(d for (path, c), d in t.during_cat_s.items()
                          if c == cat and outer in path and not set(path) & program_spans)
                 for cat in trace_mod.DEVICE_CATS}
    # a predict call's outputs come back by the benchmark's .cpu(), outside the program
    outputs = uncovered["gpu_memcpy"] if kind == "predict" else 0.0
    res["device_ms"] = 1e3 * total / n
    res["uncovered_ms"] = {k: 1e3 * v / n for k, v in uncovered.items()}
    res["cover"] = 1.0 - (sum(uncovered.values()) - outputs) / (total - outputs) if total > outputs else None
    res["idle_ms"] = {k: 1e3 * v / n for k, v in sorted(t.idle.items(), key=lambda kv: -kv[1])[:12]}
    res["busy_ms"] = 1e3 * r["device_trace"].busy_s / n
    res["recorder"] = tables
    calls = tables["spans"].get("predict/inputs" if kind == "predict" else "train/forward", {}).get("count", 0)
    if calls:
        res["per_call"] = {"spans": {k: v["count"] / calls for k, v in tables["spans"].items()},
                           "host_ms": {k: v["host_ns"] / 1e6 / calls for k, v in tables["spans"].items()},
                           "counters": {k: v / calls for k, v in tables["counters"].items()}}
    res["readers"] = {m.name: cell.reader(m.name).read(r) for m in cell.per_layer}
    res["end_to_end"] = out["end_to_end"]
    res["checks"] = out["checks"]
    return res


def overhead(cell, drv, seed: int, seconds: float, pairs: int, device) -> dict:
    """Untraced windows in turns, off, on, on, off, ...: ms a call or step."""
    from disconet_tpu_torch.utils import profiling

    ms = {"off": [], "on": []}
    inputs_ms = []  # host ms a call in ``predict/inputs`` with no profiler active
    order = [m for i in range(pairs) for m in (("off", "on") if i % 2 == 0 else ("on", "off"))]
    for mode in order:
        rec = profiling.recording() if mode == "on" else contextlib.nullcontext()
        with rec:
            out = drv.run(cell, seed, seconds, False, device, time.perf_counter(), {}, log=lambda *a: None)
        row = profiling.snapshot()["spans"].get("predict/inputs")
        if row:
            inputs_ms.append(row["host_ns"] / row["count"] / 1e6)
        e2e = out["end_to_end"]
        rate = e2e.get("predict_scenes_per_s") or e2e["train_scenes_per_s"]
        ms[mode].append(1e3 * cell.traffic["batch"] / rate)
    off, on = statistics.median(ms["off"]), statistics.median(ms["on"])
    return {"ms_off": ms["off"], "ms_on": ms["on"], "recording_overhead": 100.0 * (on / off - 1.0), "order": order,
            "input_copy_ms_recording_only": inputs_ms}


def unit_costs(n: int = 200_000) -> dict:
    """Host ns of one span and one counter, recording off and on."""
    from disconet_tpu_torch.utils import profiling

    def per(fn):
        t0 = time.perf_counter_ns()
        fn()
        return (time.perf_counter_ns() - t0) / n

    def spans():
        for _ in range(n):
            with profiling.annotate("probe/span"):
                pass

    def counts():
        for _ in range(n):
            profiling.count("probe/count")

    def empty():
        for _ in range(n):
            pass

    base = per(empty)
    res = {"span_off_ns": per(spans) - base, "count_off_ns": per(counts) - base}
    with profiling.recording():
        res["span_on_ns"] = per(spans) - base
        res["count_on_ns"] = per(counts) - base
    profiling.snapshot()
    return res


def main(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--pairs", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_spans: no CUDA device; the probe runs only on the card", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    drv = cell.driver()
    device = torch.device("cuda")
    res = {"workload": cell.name, "seed": args.seed, "card": torch.cuda.get_device_name(device)}
    res["traced"] = traced(cell, drv, args.seed, args.seconds, device)
    if args.pairs:
        res["overhead"] = overhead(cell, drv, args.seed, args.seconds, args.pairs, device)
    res["unit_costs"] = unit_costs()
    print(json.dumps(res, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
