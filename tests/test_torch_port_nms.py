"""The port's NMS entry points against the JAX package's.

CPU, float32, the plain IoU (the CPU path of the kernel wrapper). The JAX
functions run as on the TPU, with the IoU matrix of the Pallas kernel (in
interpret mode; the jnp IoU of JAX's CPU path parts from it by ~1e-4 on
corner-touching pairs, enough to flip a keep at the 0.01 threshold), one
frame at a time under ``vmap`` with ``exact_top_k=True``; the port's take
the frame axis as a batch dimension. ``foreground_scores``
(2 and 4 classes), ``rotated_nms`` on caller boxes, the packed spatial,
spatial and flat layouts of ``rotated_nms_decode`` and
``rotated_nms_decode_packed``: boxes within 1e-5, scores within 1e-6, keep
masks equal. The packed path equals the score path except where float32
sigmoid saturates, on both sides: there the two packages' packed paths agree
with each other, and the selected sets differ from the score path's only
among anchors scoring exactly 1.0. ``make_predict_step`` with
``packed_nms`` gives the default step's detections.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disconet_tpu.ops import nms as jax_nms_module
from disconet_tpu.ops.pallas.rotated_iou_pallas import rotated_iou_matrix_pallas
from disconet_tpu_torch import build_model, tiny_config
from disconet_tpu_torch.config import Config
from disconet_tpu_torch.ops import foreground_scores, rotated_nms, rotated_nms_decode
from disconet_tpu_torch.ops.nms import packed_scores_and_deltas, rotated_nms_decode_packed
from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix_plain
from disconet_tpu_torch.pipeline import example_train_batch
from disconet_tpu_torch.training import batch_to_device, make_predict_step

CODE = 6


def _boxes(rng, shape, spread=12.0):
    return np.stack([rng.uniform(-spread, spread, shape), rng.uniform(-spread, spread, shape),
                     rng.uniform(0.5, 3, shape), rng.uniform(0.5, 4, shape),
                     rng.uniform(-np.pi, np.pi, shape)], -1).astype(np.float32)


def _close(got, want):
    (gb, gs, gk), (wb, ws, wk) = (tuple(np.asarray(x) for x in t) for t in (got, want))
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_allclose(gs, ws, atol=1e-6)
    np.testing.assert_allclose(gb, wb, atol=1e-5)


@pytest.fixture
def jnms(monkeypatch):
    """The JAX NMS entry points with the Pallas IoU (interpret mode), un-jitted
    so that each call traces them afresh with it."""
    def pallas_iou(top_boxes):
        b = top_boxes.at[:, 2:4].set(jnp.abs(top_boxes[:, 2:4]))
        return rotated_iou_matrix_pallas(b[None], b[None], interpret=True)[0]

    monkeypatch.setattr(jax_nms_module, "_iou_matrix", pallas_iou)
    names = ("rotated_nms", "rotated_nms_decode", "rotated_nms_decode_packed")
    return types.SimpleNamespace(packed_scores_and_deltas=jax_nms_module.packed_scores_and_deltas,
                                 **{n: getattr(jax_nms_module, n).__wrapped__ for n in names})


def _jax_frames(fn, *arrays, **kw):
    """A single-frame JAX NMS vmapped over the leading frame axis."""
    return jax.vmap(functools.partial(fn, **kw, exact_top_k=True))(*(jnp.asarray(a) for a in arrays))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("classes", [2, 4])
def test_foreground_scores_matches_jax(classes):
    logits = np.random.default_rng(classes).normal(0, 3, (3, 5, 7, classes)).astype(np.float32)
    np.testing.assert_allclose(foreground_scores(torch.from_numpy(logits)).numpy(),
                               np.asarray(jax_nms_module.foreground_scores(jnp.asarray(logits))), atol=1e-6)


@pytest.mark.parametrize("n,top_k,thr,score_thr", [(300, 64, 0.1, 0.0), (300, 64, 0.01, 0.5),
                                                   (40, 64, 0.3, 0.2), (500, 128, 0.5, 0.3)])
def test_rotated_nms_matches_jax(jnms, n, top_k, thr, score_thr):
    rng = np.random.default_rng(n + top_k)
    boxes = _boxes(rng, (3, n))
    boxes[0, 1] = boxes[0, 0] * [1, 1, -1, -1, 1]  # negative sizes: the same point set
    scores = rng.uniform(0, 1, (3, n)).astype(np.float32)
    scores[1, :10] = scores[1, 10]  # equal scores: the lower index first
    kw = dict(iou_threshold=thr, score_threshold=score_thr, top_k=top_k)
    got = rotated_nms(*_t(boxes, scores), **kw, iou=rotated_iou_matrix_plain)
    _close(got, _jax_frames(jnms.rotated_nms, boxes, scores, **kw))
    assert got[2].any() and not got[2].all()


def _head(rng, F, H, W, NA, scale=1.5):
    """Packed class-major head tensors (F, H, W, NA*2 + NA*code) and anchors."""
    raw = rng.normal(0, scale, (F, H, W, NA * (2 + CODE))).astype(np.float32)
    raw[..., 2 * NA:] *= 0.2
    anchors = _boxes(rng, (H, W, NA), spread=30.0)
    return raw, anchors


@pytest.mark.parametrize("layout", ["packed", "spatial", "flat"])
@pytest.mark.parametrize("H,W,NA,top_k", [(8, 8, 6, 64), (2, 2, 2, 64)])  # 2nd: fewer anchors than top_k
def test_rotated_nms_decode_layouts_match_jax(jnms, layout, H, W, NA, top_k):
    rng = np.random.default_rng(H * 10 + NA)
    raw, anchors = _head(rng, 3, H, W, NA)
    scores = np.asarray(jnms.packed_scores_and_deltas(jnp.asarray(raw), NA)[0])
    deltas = raw[..., 2 * NA:]
    if layout == "spatial":
        deltas = deltas.reshape(3, H, W, NA, CODE)
    elif layout == "flat":
        deltas, scores, anchors = deltas.reshape(3, -1, CODE), scores.reshape(3, -1), anchors.reshape(-1, 5)
    kw = dict(iou_threshold=0.3, score_threshold=0.9, top_k=top_k)  # ~15% of the anchors pass
    got = rotated_nms_decode(*_t(deltas, scores, anchors), **kw, iou=rotated_iou_matrix_plain)
    want = jax.vmap(lambda d, s: jnms.rotated_nms_decode(d, s, jnp.asarray(anchors), **kw, exact_top_k=True))(
        jnp.asarray(deltas), jnp.asarray(scores))
    _close(got, want)
    dead = got[1] <= -1
    assert dead.any() and (got[0][dead] == 0).all()


@pytest.mark.parametrize("scale", [1.5, 12.0])  # 12: many logit differences past sigmoid's saturation
def test_rotated_nms_decode_packed_matches_jax(jnms, scale):
    NA = 6
    raw, anchors = _head(np.random.default_rng(5), 3, 8, 8, NA, scale)
    kw = dict(iou_threshold=0.3, score_threshold=0.2, top_k=64)
    got = rotated_nms_decode_packed(*_t(raw, anchors), NA, **kw, iou=rotated_iou_matrix_plain)
    want = jax.vmap(lambda r: jnms.rotated_nms_decode_packed(r, jnp.asarray(anchors), num_anchors=NA, **kw,
                                                              exact_top_k=True))(jnp.asarray(raw))
    _close(got, want)


def _score_path(raw, anchors, NA, kw):
    s, d = packed_scores_and_deltas(torch.from_numpy(raw), NA, CODE)
    return rotated_nms_decode(d, s, torch.from_numpy(anchors), **kw, iou=rotated_iou_matrix_plain)


def test_packed_equals_score_path():
    """Below saturation the logit-domain selection is the score path's,
    array for array, dead slots included."""
    NA = 6
    raw, anchors = _head(np.random.default_rng(17), 4, 8, 8, NA)
    kw = dict(iou_threshold=0.3, score_threshold=0.2, top_k=64)
    got = rotated_nms_decode_packed(*_t(raw, anchors), NA, **kw, iou=rotated_iou_matrix_plain)
    for g, w in zip(got, _score_path(raw, anchors, NA, kw)):
        assert torch.equal(g, w)


def test_packed_tie_caveat_on_both_sides(jnms):
    """Where fp32 sigmoid saturates (logit differences > ~17 score exactly
    1.0), the score path breaks the ties by index and the packed path still
    ranks by logit: the selections differ, in both packages alike, and only
    among the anchors scoring 1.0."""
    NA, top_k = 6, 16
    rng = np.random.default_rng(23)
    raw, anchors = _head(rng, 2, 8, 8, NA)
    raw[..., NA:2 * NA] += np.where(rng.random((2, 8, 8, NA)) < 0.3, 40.0, 0.0) + rng.uniform(0, 5, (2, 8, 8, NA))
    kw = dict(iou_threshold=0.3, score_threshold=0.2, top_k=top_k)
    packed = rotated_nms_decode_packed(*_t(raw, anchors), NA, **kw, iou=rotated_iou_matrix_plain)
    scored = _score_path(raw, anchors, NA, kw)
    j_packed = jax.vmap(lambda r: jnms.rotated_nms_decode_packed(
        r, jnp.asarray(anchors), num_anchors=NA, **kw, exact_top_k=True))(jnp.asarray(raw))
    j_scores, j_deltas = jnms.packed_scores_and_deltas(jnp.asarray(raw), NA)
    j_scored = jax.vmap(lambda d, s: jnms.rotated_nms_decode(d, s, jnp.asarray(anchors), **kw, exact_top_k=True))(
        j_deltas, j_scores)
    _close(packed, j_packed)
    _close(scored, j_scored)
    # both select top_k anchors of score 1.0, but not the same ones
    assert (packed[1] == 1.0).all() and (scored[1] == 1.0).all()
    assert not torch.equal(packed[0], scored[0])
    assert not np.array_equal(np.asarray(j_packed[0]), np.asarray(j_scored[0]))


@pytest.mark.parametrize("bf16", [False, True])
def test_predict_step_packed_nms_matches_default(bf16):
    over = {} if bf16 else dict(compute_dtype="float32", head_raw_dtype="float32")
    cfg = tiny_config(32, **over)
    batch = batch_to_device(example_train_batch(cfg, 2, 3, seed=4, occupancy=(0.05, 0.1)), "cpu")
    model = build_model("disco", cfg, layer=1, device="cpu", seed=2)
    want = make_predict_step(model, cfg)(batch)
    got = make_predict_step(model, dataclasses.replace(cfg, packed_nms=True))(batch)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert want[2].any()


def test_config_defaults_match_jax():
    from disconet_tpu.config import Config as JaxConfig

    assert Config().packed_nms == JaxConfig().packed_nms is False
    assert Config().warp_dtype == JaxConfig().warp_dtype == "bfloat16"
