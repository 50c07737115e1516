"""The reading of the program's own spans and counters
(``core/program_trace.py``) and the readers of its metrics, on synthetic
Chrome events and tables."""

import sys
import types

import pytest

from port_bench.core.program_trace import ProgramTrace, recorder_tables
from port_bench.core.registry import load_cell
from port_bench.core.trace import TraceSummary
from port_bench.tests.test_port_bench_counts import _x

US = 1e-6
NAMES = ("step", "train/forward", "train/backward", "train/update")


def events():
    """A step on thread 1: forward (launches 1, 2), backward (thread 1 waits
    while thread 2, autograd's, launches 3 and 4), update (launch 5); a
    copy launched by thread 3 (a loader) during the update."""
    ev = [_x("step", "user_annotation", 1, 0, 100), _x("train/forward", "user_annotation", 1, 0, 30),
          _x("train/backward", "user_annotation", 1, 30, 50), _x("train/update", "user_annotation", 1, 80, 20),
          _x("aten::conv2d", "cpu_op", 1, 2, 10)]
    for corr, (tid, ts) in enumerate([(1, 5), (1, 20), (2, 35), (2, 60), (1, 85), (3, 90)], start=1):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", tid, ts, 1, corr))
    ev += [_x("fwd1", "kernel", 7, 6, 4, 1), _x("fwd2", "kernel", 7, 21, 6, 2), _x("bwd1", "kernel", 7, 36, 10, 3),
           _x("bwd2", "kernel", 7, 61, 12, 4), _x("adam", "kernel", 7, 86, 3, 5), _x("copy", "gpu_memcpy", 8, 91, 2, 6)]
    return ev


def test_device_s_during_gives_other_threads_launches_to_the_main_threads_span():
    t = ProgramTrace(events(), 1e-4, NAMES)
    assert t.device_s("train/backward") == 0.0  # launched where no span is open
    assert t.device_s_during("train/backward") == pytest.approx(22 * US)
    assert t.device_s_during("train/forward") == pytest.approx(10 * US)
    assert t.device_s_during("train/update") == pytest.approx(5 * US)
    assert t.device_s_during("train/update", exclude_cats=("gpu_memcpy",)) == pytest.approx(3 * US)
    assert t.device_s_during("step", outside=("train/backward",)) == pytest.approx(15 * US)
    assert t.device_s_during("step") == pytest.approx(37 * US)


def test_the_accepted_reductions_read_as_before():
    for names in (NAMES, ("step",)):
        base, prog = TraceSummary(events(), 1e-4, names), ProgramTrace(events(), 1e-4, names)
        assert prog.busy_s == base.busy_s and dict(prog.idle) == dict(base.idle)
        assert dict(prog.path_cat_s) == dict(base.path_cat_s) and prog.breakdown() == base.breakdown()
        for span in names:
            assert prog.device_s(span) == base.device_s(span)


TABLES = {"spans": {"predict/inputs": {"count": 4, "host_ns": 12_000_000}, "nms/suppress": {"count": 4, "host_ns": 1}},
          "counters": {"sync/nms.suppress": 30, "sync/other": 2, "h2d_bytes/pageable": 100}}


def test_new_readers():
    cell = load_cell("disconet.predict.b4")
    r = {"kind": "predict", "recorder": TABLES}
    assert cell.reader("input_copy_ms.predict").read(r) == pytest.approx(3.0)
    assert cell.reader("host_syncs.predict").read(r) == pytest.approx(8.0)


@pytest.mark.parametrize("readings", [{"kind": "train", "recorder": TABLES}, {"kind": "predict", "recorder": None},
                                      {"kind": "predict", "recorder": {"spans": {}, "counters": {}}}])
@pytest.mark.parametrize("metric", ["input_copy_ms.predict", "host_syncs.predict"])
def test_new_readers_read_nothing_outside_their_cells(readings, metric):
    assert load_cell("disconet.predict.b4").reader(metric).read(readings) is None


def test_recorder_tables_of_a_program_without_the_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "disconet_tpu_torch.utils.profiling", types.ModuleType("profiling"))
    r = {"kind": "predict"}
    assert recorder_tables(r) is None and r["recorder"] is None
    assert load_cell("disconet.predict.b4").reader("host_syncs.predict").read({"kind": "predict"}) is None


def test_recorder_tables_are_taken_once():
    from disconet_tpu_torch.utils import profiling

    profiling.snapshot()
    with profiling.recording():
        profiling.count("sync/x", 3)
    r = {}
    assert recorder_tables(r)["counters"] == {"sync/x": 3}
    assert recorder_tables(r)["counters"] == {"sync/x": 3} and profiling.snapshot()["counters"] == {}
