"""The reading of the program's own spans and counters: every span of a
trace, the program's included, by :class:`TraceSummary` (``core/trace.py``)
and the recorder's tables (``core/program_trace.py``), and the readers of
their metrics, on synthetic Chrome events and tables."""

import sys
import types

import pytest

from port_bench.core.program_trace import recorder_tables
from port_bench.core.registry import load_cell
from port_bench.core.trace import TraceSummary
from port_bench.tests.test_port_bench_counts import _x

US = 1e-6


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
    t = TraceSummary(events(), 1e-4)
    assert t.device_s("train/backward") == 0.0  # launched where no span is open
    assert t.device_s_during("train/backward") == pytest.approx(22 * US)
    assert t.device_s_during("train/forward") == pytest.approx(10 * US)
    assert t.device_s_during("train/update") == pytest.approx(5 * US)
    assert t.device_s_during("train/update", exclude_cats=("gpu_memcpy",)) == pytest.approx(3 * US)
    assert t.device_s_during("step", outside=("train/backward",)) == pytest.approx(15 * US)
    assert t.device_s_during("step") == pytest.approx(37 * US)


def test_a_span_of_no_list_gets_its_device_time():
    """A span that a later program opens (``fusion/xyz``), inside the
    forward, with a kernel launched on the main thread and one from a
    second thread while the main thread holds it."""
    ev = events() + [_x("fusion/xyz", "user_annotation", 1, 15, 10)]
    t = TraceSummary(ev, 1e-4)
    assert t.device_s("fusion/xyz") == pytest.approx(6 * US)  # fwd2, launched at 20 inside it
    assert t.device_s("train/forward", outside=("fusion/xyz",)) == pytest.approx(4 * US)
    ev += [_x("cudaLaunchKernel", "cuda_runtime", 2, 22, 1, 9), _x("side", "kernel", 7, 40, 7, 9)]
    t = TraceSummary(ev, 1e-4)
    assert t.device_s("fusion/xyz") == pytest.approx(6 * US)  # thread 2 held no span
    assert t.device_s_during("fusion/xyz") == pytest.approx(13 * US)
    assert t.idle  # the gaps are labelled by the innermost span, whatever its name


def test_more_spans_leave_the_benchmarks_readings_as_they_were():
    """The program's spans and torch's own annotations add names to a
    launch's path; what a span of the benchmark reads stays the same."""
    bare = [e for e in events() if e["cat"] != "user_annotation" or e["name"] == "step"]
    extra = events() + [_x("Optimizer.step#Adam.step", "user_annotation", 1, 84, 10)]
    base, more = TraceSummary(bare, 1e-4), TraceSummary(extra, 1e-4)
    assert more.busy_s == base.busy_s and more.breakdown()["device_ops"] == base.breakdown()["device_ops"]
    assert sum(more.idle.values()) == pytest.approx(sum(base.idle.values()))
    for cats in ((), ("gpu_memcpy",)):
        assert more.device_s("step", exclude_cats=cats) == base.device_s("step", exclude_cats=cats)
    assert more.device_s_during("train/update") == pytest.approx(5 * US)


@pytest.mark.parametrize("cell", ["disconet.train_kd.b4", "v2vnet.train.b4"])
def test_the_step_readers(cell):
    ev = events() + [_x("train/kd", "user_annotation", 1, -10, 8),  # the KD rows, before the forward
                     _x("cudaLaunchKernel", "cuda_runtime", 1, -8, 1, 9), _x("rows", "kernel", 7, -7, 3, 9)]
    r = {"kind": "train", "trace": TraceSummary(ev, 1e-4), "profiled_steps": 2}
    c = load_cell(cell)
    got = {m.name: c.reader(m.name).read(r) for m in c.per_layer
           if m.name in ("forward_ms.train", "backward_ms.train", "update_ms.train", "kd_ms.train")}
    assert got.pop("forward_ms.train") == pytest.approx(1e3 * 10 * US / 2)
    assert got.pop("backward_ms.train") == pytest.approx(1e3 * 22 * US / 2)
    assert got.pop("update_ms.train") == pytest.approx(1e3 * 5 * US / 2)  # the loader's copy counts
    if cell == "disconet.train_kd.b4":
        assert got.pop("kd_ms.train") == pytest.approx(1e3 * 3 * US / 2)
    assert not got
    for m in ("forward_ms.train", "backward_ms.train", "update_ms.train", "kd_ms.train"):
        assert c.reader(m).read({"kind": "predict", "trace": r["trace"], "profiled_calls": 2}) is None
        assert c.reader(m).read({"kind": "train", "profiled_steps": 2}) is None


def test_warp_ms_predict():
    ev = [_x("call", "user_annotation", 1, 0, 100), _x("fusion", "user_annotation", 1, 10, 40),
          _x("model/warp", "user_annotation", 1, 12, 10), _x("model/fuse", "user_annotation", 1, 30, 15)]
    for corr, ts in enumerate([5, 15, 35], start=1):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", 1, ts, 1, corr))
    ev += [_x("vox", "kernel", 7, 6, 2, 1), _x("taps", "kernel", 7, 16, 8, 2), _x("softmax", "kernel", 7, 36, 4, 3)]
    r = {"kind": "predict", "trace": TraceSummary(ev, 1e-4), "profiled_calls": 2, "fusion_span": True}
    for cell in ("disconet.predict.b4", "disconet.predict.b16", "v2vnet.predict.b4"):
        c = load_cell(cell)
        assert c.reader("warp_ms.predict").read(r) == pytest.approx(1e3 * 8 * US / 2)
        assert c.reader("warp_ms.predict").read(r) <= c.reader("fusion_ms.predict").read(r)
    assert load_cell("disconet.predict.b4").reader("warp_ms.predict").read({"kind": "train", "trace": r["trace"]}) \
        is None
    r["trace"] = TraceSummary([e for e in ev if e["name"] != "model/warp"], 1e-4)
    assert load_cell("disconet.predict.b4").reader("warp_ms.predict").read(r) is None


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
