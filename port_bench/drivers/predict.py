"""Driver of the ``predict`` mixes: a closed loop of ``pipeline.predict``.

One call in flight: each call runs ``predict(model, points, trans,
agent_mask, anchors, cfg)`` on a batch of host arrays (the program copies
them to the card) and copies its boxes, scores and keep flags back to the
host; the next call starts when that is done. The loop cycles through a
pool of distinct batches made from the seed. A call's latency runs from its
start to its outputs on the host.

After the window, a sample of the served calls drawn from the seed is
judged against the plain reference (``reference/detect.py``), once the
program's state is freed.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import numpy as np
import torch

from port_bench.core.harness import SmiSampler, percentile
from port_bench.core.model import forward_flops, port_config
from port_bench.core.trace import Spans, profiled
from port_bench.core.traffic import grid_dims, predict_pool
from port_bench.core.weights import seeded_state, stream_seed, unit_keys
from port_bench.reference import detect as ref_detect
from port_bench.reference.model import Ctx, anchors as ref_anchors, calibrate_batch_norm
from port_bench.reference.precision import Precision, exact_float32


class _Reservoir:
    """A uniform sample of ``size`` of the calls, drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.items, self.seen = size, np.random.default_rng(seed), [], 0

    def offer(self, item):
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def _lowest_first(top_k):
    """``top_k`` (the program's ranking of candidates) ranking the lowest first."""

    def lowest(x, k):
        _, idx = top_k(-x, k)
        return torch.gather(x, -1, idx), idx

    return lowest


def _faulty(predict, faults):
    """``predict`` with the planted faults of a test (``options["faults"]``)."""
    if not faults:
        return predict

    def run(model, points, trans, mask, anchors, cfg, **kw):
        from disconet_tpu_torch.ops import nms

        ranked = nms._top_k_stable
        if "reversed_ranking" in faults:
            nms._top_k_stable = _lowest_first(ranked)
        try:
            if "half_batch" in faults:
                half = points.shape[0] // 2
                outs = predict(model, points[:half], trans[:half], mask[:half], anchors, cfg, **kw)
                outs = tuple(torch.cat([o, o[: points.shape[0] - half]]) for o in outs)
            else:
                outs = predict(model, points, trans, mask, anchors, cfg, **kw)
        finally:
            nms._top_k_stable = ranked
        boxes, scores, keep = outs
        if "alter_answer" in faults:
            boxes = boxes.clone()
            boxes[0, 0, 0, 0] += 1.0
        if "flip_keep" in faults:
            keep = keep.clone()
            keep[0, 0, 0] = ~keep[0, 0, 0]
        if "wrong_frame_scores" in faults:  # each frame served with the next frame's scores
            scores = scores.flatten(0, 1).roll(1, 0).reshape(scores.shape)
        return boxes, scores, keep

    return run


def predict_weights(cell, model, seed: int, pool, device):
    """The seeded weights of the program's ``model``, BatchNorm statistics
    settled on the pool's first batch."""
    cfgd = cell.config["config"]
    b = pool[0]
    with exact_float32():
        bev = ref_detect.voxelize(torch.from_numpy(b["points"]).to(device), cfgd)
        state = seeded_state(model.state_dict(), seed, 1, device, unit_keys(model))
        return calibrate_batch_norm(state, cfgd, cell.fusion_reference(), bev, torch.from_numpy(b["trans"]).to(device),
                                    torch.from_numpy(b["agent_mask"]).to(device), cell.config["layer"])


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float, options: Dict,
        log=print) -> Dict:
    from disconet_tpu_torch.models.build import build_model
    from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix
    from disconet_tpu_torch.ops.voxelize import voxelize_occupy
    from disconet_tpu_torch.pipeline import predict as port_predict

    mix, cfgd, layer = cell.traffic, cell.config["config"], cell.config["layer"]
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)

    # set-up: the program's model with the benchmark's weights, the pool, warm calls
    cfg = port_config(cfgd)
    model = build_model(cell.config["model"], cfg, layer=layer, device=device)
    pool = predict_pool(cfgd, mix, seed, device)
    weights = predict_weights(cell, model, seed, pool, device)
    model.load_state_dict(weights)
    anchors = ref_anchors(cfgd, "cpu").numpy()
    predict = _faulty(port_predict, options.get("faults", ()))

    def call(i, **kw):
        b = pool[i % len(pool)]
        boxes, scores, keep = predict(model, b["points"], b["trans"], b["agent_mask"], anchors, cfg, **kw)
        return boxes.cpu(), scores.cpu(), keep.cpu()

    for i in range(mix["warm_calls"]):
        call(i)
    sync()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # the window
    sample = _Reservoir(mix["calls_compared"], stream_seed(seed, 30))
    lat, ends, calls = [], [], 0
    with SmiSampler(device.index or 0) if cuda else contextlib.nullcontext() as smi:
        t0 = time.perf_counter()
        while True:
            c0 = time.perf_counter()
            host = call(calls)
            c1 = time.perf_counter()
            lat.append(c1 - c0)
            ends.append(c1 - t0)
            sample.offer((calls % len(pool), host))
            calls += 1
            if c1 - t0 >= seconds:
                break
        window = c1 - t0
    for line in getattr(smi, "samples", []):
        log(f"card: {line}")
    log(f"predict: {calls} calls in {window:.3f} s, p50 {percentile(lat, 50) * 1e3:.3f} ms, "
        f"p95 {percentile(lat, 95) * 1e3:.3f} ms, max {max(lat) * 1e3:.3f} ms, setup {setup_s:.3f} s")
    n = max(int(seconds // 5), 1)  # the last slice takes the call that closes the window
    slices = np.bincount(np.minimum(np.asarray(ends) // 5, n - 1).astype(int), minlength=n)
    log(f"predict: calls in each 5 s of the window: {slices.tolist()}")

    readings = {"kind": "predict", "timed_window_s": window, "timed_calls": calls,
                "flops_per_call": forward_flops(cell, pool[0]["agent_mask"])}
    if trace:
        spans, iou_boxes = Spans(), []

        def iou_seen(a, b):
            iou_boxes.append(a.detach().clone())
            with torch.profiler.record_function("iou"):
                return rotated_iou_matrix(a, b)

        spans.around_forward("model", model)
        readings["fusion_span"] = spans.around_method("fusion", model, "_warp_and_fuse")
        n = mix["profile_calls"]
        with profiled(device) as holder:
            for i in range(n):
                with torch.profiler.record_function("call"):
                    call(i, voxelize=Spans.wrap("voxelize", voxelize_occupy), iou=iou_seen)
        spans.remove()
        with profiled(device, host_ops=False) as quiet:
            for i in range(n):
                call(i)
        log(f"predict: {window / calls * 1e3:.3f} ms a call in the window, traced {holder[0].window_s / n * 1e3:.3f} "
            f"with host operations, {quiet[0].window_s / n * 1e3:.3f} without")
        readings.update(trace=holder[0], device_trace=quiet[0], profiled_calls=n, iou_boxes=iou_boxes,
                        points_per_call=int(np.prod(pool[0]["points"].shape[:-1])),
                        frames_per_call=int(np.prod(pool[0]["points"].shape[:2])),
                        grid_cells=int(np.prod(grid_dims(cfgd))))
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # the check, after the program's state is freed
    del model
    if cuda:
        torch.cuda.empty_cache()
    checks = check(cell, weights, pool, sample.items, device)
    return {"end_to_end": {"predict_scenes_per_s": calls * mix["batch"] / window,
                           "predict_p95_ms": percentile(lat, 95) * 1e3,
                           "setup_s": setup_s},
            "attempted": calls, "failed": 0, "memory_peak_bytes": max(setup_peak, window_peak),
            "checks": checks, "readings": readings}


def check(cell, weights, pool, sampled, device) -> Dict[str, float]:
    """The widest of each number over the sampled calls (the reference once
    per distinct batch among them)."""
    cfgd, layer = cell.config["config"], cell.config["layer"]
    fusion = cell.fusion_reference()
    anchors = ref_anchors(cfgd, device)
    K = cfgd["nms_top_k"]
    refs, worst = {}, {}
    with exact_float32():
        for idx, (boxes, scores, keep) in sampled:
            if idx not in refs:
                refs[idx] = ref_detect.reference_candidates(
                    lambda: Ctx(dict(weights), cfgd, Precision("reference"), train=False), fusion, pool[idx], anchors,
                    cfgd, layer, K, device)
            rs, rtop, rb = refs[idx]
            Fr = rs.shape[0]
            got = ref_detect.compare_call(boxes.reshape(Fr, K, 5).to(device), scores.reshape(Fr, K).to(device),
                                          keep.reshape(Fr, K).to(device), rs, rtop, rb, cfgd)
            for k, v in got.items():  # the widest over the sampled calls
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


def control(cell, seed: int, device: torch.device, calls: int = 8) -> Dict[str, float]:
    """The control's numbers: the reference in lower precision put in the
    program's place (its best candidates, thresholded, and greedy NMS),
    judged against the reference on ``calls`` batches of the cell's pool,
    or on as many as a run compares where that is fewer."""
    cfgd, layer, mix = cell.config["config"], cell.config["layer"], cell.traffic
    calls = min(calls, mix["calls_compared"])
    from disconet_tpu_torch.models.build import build_model

    model = build_model(cell.config["model"], port_config(cfgd), layer=layer, device="cpu")
    pool = predict_pool(cfgd, mix, seed, device)
    weights = predict_weights(cell, model, seed, pool, device)
    fusion = cell.fusion_reference()
    anchors = ref_anchors(cfgd, device)
    K = cfgd["nms_top_k"]
    sampled = []
    with exact_float32():
        for i in range(calls):
            b = pool[i % len(pool)]
            s, top, bx = ref_detect.reference_candidates(
                lambda: Ctx(dict(weights), cfgd, Precision("control"), train=False), fusion, b, anchors, cfgd,
                layer, K, device)
            bx, s = ref_detect.served(s, top, bx, cfgd["score_threshold"])
            keep = ref_detect.greedy_keep(bx, s, cfgd["nms_iou_threshold"])
            sampled.append((i % len(pool), (bx.cpu(), s.cpu(), keep.cpu())))
    return check(cell, weights, pool, sampled, device)
