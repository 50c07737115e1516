"""The voxelize kernel's share of its roofline, in %: the least time of a
call (every point read, every grid written, over the HBM rate;
``core/peaks.py``) over the device time launched in the benchmark's
``voxelize`` span, per profiled call. Bound by bytes."""

from port_bench.core.peaks import voxelize_bound_s


def read(r):
    t = r.get("trace")
    if r.get("kind") != "predict" or t is None:
        return None
    dev = t.device_s("voxelize") / r["profiled_calls"]
    if dev <= 0:
        return None
    return 100.0 * voxelize_bound_s(r["points_per_call"], r["frames_per_call"], r["grid_cells"]) / dev
