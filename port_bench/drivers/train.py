"""Driver of the ``train`` mixes: one optimizer step per call.

Set-up builds one training object as the training CLI does: the program's
model with the benchmark's weights, (with KD) the teacher and its tables of
taps (``precompute_teacher_feats``), Adam (``create_train_state``) and the
step (``make_train_step``). Batches come from a pool of distinct host
batches made from the seed, through ``prefetch_to_device``. The first
``checked_steps`` steps run through that same step and feed, on batches
that all differ, and are judged against the reference after the window;
then the object trains on through a few warm steps and the window.

The window's rate is steps x batch over the window's wall time, which ends
once the device has finished every step the host launched in it.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Dict

import torch

from port_bench.core.harness import SmiSampler
from port_bench.core.model import forward_flops, port_config
from port_bench.core.trace import Spans, profiled
from port_bench.core.traffic import train_pool
from port_bench.core.weights import seeded_state, unit_keys
from port_bench.reference import train as ref_train
from port_bench.reference.model import calibrate_batch_norm
from port_bench.reference.precision import Precision, exact_float32

BETA1 = 0.9


def _host_batches(pool, keep_teacher: bool):
    """The pool's batches forever, as the CLI's loader hands them on (the
    teacher's grid dropped where no step reads it)."""
    for b in itertools.cycle(pool):
        yield b if keep_teacher else {k: v for k, v in b.items() if k != "bev_teacher_packed"}


def _faulty(step, model, faults, fusion_prefixes):
    """``step`` with the planted faults of a test (``options["faults"]``)."""
    if not faults:
        return step

    def run(batch):
        if "half_batch" in faults:
            half = batch["agent_mask"].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        keep = None
        if "unchanged_state" in faults:
            keep = {k: v.detach().clone() for k, v in model.state_dict().items()}
        elif "fusion_unmoved" in faults:  # the fusion's parameters put back after each step
            keep = {k: p.detach().clone() for k, p in model.named_parameters() if k.startswith(fusion_prefixes)}
        metrics = step(batch)
        if keep is not None:
            model.load_state_dict(keep, strict=False)
        if "alter_answer" in faults:  # the step's losses, off by 10%
            metrics = {k: v * 1.1 if k.endswith("loss") else v for k, v in metrics.items()}
        return metrics

    return run


def train_weights(cell, model, seed: int, pool, device, teacher: bool = False):
    """The seeded weights of the program's ``model``: of the student, its
    BatchNorm statistics where BatchNorm starts them (mean 0, variance 1) as
    in training from scratch; or of the teacher, which runs in eval mode,
    its statistics settled on the pool's first batch of its grids."""
    state = seeded_state(model.state_dict(), seed, 2 if teacher else 1, device, unit_keys(model))
    if not teacher:
        return state
    b = ref_train.dense_batch(pool[0], cell.config["config"], device)
    with exact_float32():
        return calibrate_batch_norm(state, cell.config["config"], None, b["bev_teacher"], None, b["agent_mask"],
                                    None)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float, options: Dict,
        log=print) -> Dict:
    from disconet_tpu_torch.models.build import build_model
    from disconet_tpu_torch.training import (
        create_train_state, make_train_step, precompute_teacher_feats, prefetch_to_device,
    )

    mix, cfgd, layer = cell.traffic, cell.config["config"], cell.config["layer"]
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    kd = bool(mix["kd"])

    cfg = port_config(cfgd)
    model = build_model(cell.config["model"], cfg, layer=layer, device=device, kd_flag=kd)
    teacher = teacher_weights = tables = None
    pool = train_pool(cfgd, mix, seed, device)
    weights = train_weights(cell, model, seed, pool, device)
    model.load_state_dict(weights)
    B = mix["batch"]
    if kd:
        teacher = build_model("teacher", cfg, device=device)
        teacher_weights = train_weights(cell, teacher, seed, pool, device, teacher=True)
        teacher.load_state_dict(teacher_weights)
        if mix["kd_cache"]:
            frames = [{k: b[k][i] for k in ("bev_teacher_packed", "agent_mask", "frame_idx")}
                      for b in pool for i in range(B)]
            tables = precompute_teacher_feats(teacher, frames, cfg, batch_size=B, num_workers=1)
    optimizer = create_train_state(model, lr=mix["lr"])
    step = make_train_step(model, cfg, optimizer, teacher=None if tables is not None else teacher, kd_flag=kd,
                           kd_from_cache=tables)
    step = _faulty(step, model, options.get("faults", ()), tuple(cell.fusion_reference().PREFIXES))
    feed = prefetch_to_device(_host_batches(pool, kd and tables is None), device, depth=mix["prefetch_depth"])

    # the checked steps: the first steps of this object, through its own feed
    checked, first_grads = [], None
    for t in range(mix["checked_steps"]):
        checked.append(step(next(feed)))
        if t == 0:
            first_grads = {}
            for name, p in model.named_parameters():
                st = optimizer.state.get(p, {})
                first_grads[name] = (st["exp_avg"] / (1 - BETA1)).detach().clone() if "exp_avg" in st \
                    else torch.zeros_like(p)
    after = {k: v.detach().clone() for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    checked = [{k: float(v) for k, v in m.items()} for m in checked]
    for _ in range(mix["warm_steps"]):
        step(next(feed))
    sync()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # the window
    waits, losses, steps = [], [], 0
    with SmiSampler(device.index or 0) if cuda else contextlib.nullcontext() as smi:
        t0 = time.perf_counter()
        while True:
            w0 = time.perf_counter()
            batch = next(feed)
            w1 = time.perf_counter()
            waits.append(w1 - w0)
            losses.append(step(batch)["loss"])
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        window = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    for line in getattr(smi, "samples", []):
        log(f"card: {line}")
    log(f"train: {steps} steps in {window:.3f} s ({window / steps * 1e3:.3f} ms a step), "
        f"peak {window_peak / 2**30:.3f} GiB, setup {setup_s:.3f} s, {failed} non-finite losses")

    readings = {"kind": "train", "timed_window_s": window, "timed_steps": steps,
                "fwd_flops_per_step": forward_flops(cell, pool[0]["agent_mask"]),
                "loader_wait_s": waits}
    if trace:
        spans = Spans()
        spans.around_forward("model", model)
        readings["fusion_span"] = spans.around_method("fusion", model, "_warp_and_fuse")
        n = mix["profile_steps"]
        with profiled(device) as holder:
            for _ in range(n):
                with torch.profiler.record_function("loader"):
                    batch = next(feed)
                with torch.profiler.record_function("step"):
                    step(batch)
        spans.remove()
        with profiled(device, host_ops=False) as quiet:
            for _ in range(n):
                step(next(feed))
        log(f"train: {window / steps * 1e3:.3f} ms a step in the window, traced {holder[0].window_s / n * 1e3:.3f} "
            f"with host operations, {quiet[0].window_s / n * 1e3:.3f} without")
        readings.update(trace=holder[0], device_trace=quiet[0], profiled_steps=n)
    feed.close()

    # the check, after the program's state is freed
    del model, optimizer, step, teacher, tables, feed
    if cuda:
        torch.cuda.empty_cache()
    change = {k: after[k] - weights[k].float() for k in after}
    del after
    checks = check(cell, weights, teacher_weights, pool, checked, first_grads, change, device)
    return {"end_to_end": {"train_scenes_per_s": steps * B / window, "train_peak_gib": window_peak / 2**30,
                           "setup_s": setup_s},
            "attempted": steps, "failed": failed, "memory_peak_bytes": max(setup_peak, window_peak),
            "checks": checks, "readings": readings}


def reference_steps(cell, weights, teacher_weights, pool, device, prec: Precision, half_batch: bool = False):
    """The reference's checked steps from ``weights`` on the pool's first
    batches: (per-step metrics, first gradients, change of every leaf)."""
    cfgd, mix = cell.config["config"], cell.traffic
    batches = [ref_train.dense_batch(pool[i % len(pool)], cfgd, device) for i in range(mix["checked_steps"])]
    with exact_float32():
        steps, grads, final = ref_train.run_steps(weights, cfgd, cell.fusion_reference(), cell.config["layer"],
                                                  batches, mix["lr"], prec, teacher=teacher_weights,
                                                  half_batch=half_batch)
    change = {k: final[k] - weights[k].float() for k in final}
    return steps, grads, change


def check(cell, weights, teacher_weights, pool, prog_steps, prog_grads, prog_change, device) -> Dict[str, float]:
    ref = reference_steps(cell, weights, teacher_weights, pool, device, Precision("reference"))
    return ref_train.compare_steps(prog_steps, prog_grads, prog_change, *ref,
                                   fusion_prefixes=cell.fusion_reference().PREFIXES)


# what the reference put in the program's place computes, by ``fault``: the
# control, the control of the float32 parts alone, a fault planted
CONTROLS = {"": ("control", False), "control_fusion": ("control_fusion", False), "half_batch": ("reference", True)}


def control(cell, seed: int, device: torch.device, fault: str = "") -> Dict[str, float]:
    """The numbers of the reference in the program's place: computed in the
    control's precision (``fault`` "control_fusion": only the parts that
    the configuration computes in float32 lowered), or (``fault``
    "half_batch") with half of each batch left out."""
    from disconet_tpu_torch.models.build import build_model

    cfgd, mix = cell.config["config"], cell.traffic
    cfg = port_config(cfgd)
    pool = train_pool(cfgd, mix, seed, device)
    weights = train_weights(cell, build_model(cell.config["model"], cfg, layer=cell.config["layer"], device="cpu",
                                              kd_flag=bool(mix["kd"])), seed, pool, device)
    teacher_weights = None
    if mix["kd"]:
        teacher_weights = train_weights(cell, build_model("teacher", cfg, device="cpu"), seed, pool, device,
                                        teacher=True)
    mode, half = CONTROLS[fault]
    got = reference_steps(cell, weights, teacher_weights, pool, device, Precision(mode), half_batch=half)
    ref = reference_steps(cell, weights, teacher_weights, pool, device, Precision("reference"))
    return ref_train.compare_steps(*got, *ref, fusion_prefixes=cell.fusion_reference().PREFIXES)
