"""The port's ops against the JAX package's (disconet_tpu_torch.ops vs disconet_tpu.ops).

The same seeded numpy inputs go through the JAX function and its port; the
Pallas kernels run in interpret mode, as the JAX package's own tests run them
on the CPU. Here the port's wrappers take their plain PyTorch path, because
the tensors lie on the CPU.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from disconet_tpu.config import tiny_config as jax_tiny_config
from disconet_tpu.ops import boxes as jboxes
from disconet_tpu.ops import nms as jnms
from disconet_tpu.ops import warp as jwarp
from disconet_tpu.ops.pallas.rotated_iou_pallas import rotated_iou_matrix_pallas
from disconet_tpu.ops.pallas.voxelize_pallas import voxelize_occupy_pallas
from disconet_tpu.ops.rotated_iou import rotated_iou_np
from disconet_tpu.ops.voxelize import voxelize_occupy_jax, voxelize_occupy_np
from disconet_tpu_torch import tiny_config
from disconet_tpu_torch.ops import boxes as tboxes
from disconet_tpu_torch.ops import nms as tnms
from disconet_tpu_torch.ops import warp as twarp
from disconet_tpu_torch.ops.rotated_iou import rotated_iou_matrix, rotated_iou_matrix_plain
from disconet_tpu_torch.ops.voxelize import grid_dims, voxelize_occupy, voxelize_occupy_plain

VS = (0.25, 0.25, 0.4)
EXT = ((-8.0, 8.0), (-8.0, 8.0), (-3.0, 2.0))


# ---------------------------------------------------------------------------
# voxelize: bit-exact against the numpy oracle, the XLA scatter and Pallas
# ---------------------------------------------------------------------------

def _edge_points(shape, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-9, 9, shape + (3,)).astype(np.float32)  # some out of extent
    flat = pts.reshape(-1, 3)
    flat[5] = np.nan
    flat[6] = [np.inf, 0.0, 0.0]
    flat[7] = [0.0, -np.inf, 1.0]
    flat[8] = [8.0, 0.0, 0.0]  # on hi: dropped
    flat[9] = [-8.0, -8.0, -3.0]  # on lo: kept
    flat[10] = [7.99999, 7.99999, 1.99999]  # just inside hi
    return pts


@pytest.mark.parametrize("shape,masked", [((3000,), False), ((2, 3, 512), True), ((2, 3, 512), False)])
def test_voxelize_bit_exact(shape, masked):
    pts = _edge_points(shape, seed=len(shape))
    mask = None
    if masked:
        mask = np.random.default_rng(7).random(shape) < 0.7
        mask.reshape(-1)[9] = True
    got = voxelize_occupy_plain(
        torch.from_numpy(pts), VS, EXT, mask=None if mask is None else torch.from_numpy(mask)
    ).numpy()
    assert got.shape == shape[:-1] + grid_dims(VS, EXT)
    assert got[(0,) * (len(shape) - 1)][0, 0, 0] == 1.0  # the point on lo landed
    jm = None if mask is None else jnp.asarray(mask)
    np.testing.assert_array_equal(got, np.asarray(voxelize_occupy_jax(jnp.asarray(pts), VS, EXT, mask=jm)))
    np.testing.assert_array_equal(
        got, np.asarray(voxelize_occupy_pallas(jnp.asarray(pts), VS, EXT, mask=jm, interpret=True))
    )
    flat_pts = pts.reshape((-1,) + shape[-1:] + (3,))
    flat_mask = None if mask is None else mask.reshape((-1,) + shape[-1:])
    flat_got = got.reshape((-1,) + got.shape[-3:])
    for f in range(flat_pts.shape[0]):
        want = voxelize_occupy_np(flat_pts[f], VS, EXT, mask=None if flat_mask is None else flat_mask[f])
        np.testing.assert_array_equal(flat_got[f], want)


def test_voxelize_wrapper_cpu_path_and_checks():
    pts = torch.from_numpy(_edge_points((2, 256), seed=3))
    before = voxelize_occupy.launches
    np.testing.assert_array_equal(
        voxelize_occupy(pts, VS, EXT).numpy(), voxelize_occupy_plain(pts, VS, EXT).numpy()
    )
    assert voxelize_occupy.launches == before  # CPU tensors never count as launches
    with pytest.raises(TypeError):
        voxelize_occupy(pts.double(), VS, EXT)
    with pytest.raises(ValueError):
        voxelize_occupy(pts[..., :2], VS, EXT)
    with pytest.raises(ValueError):
        voxelize_occupy(pts, VS, EXT, mask=torch.ones(2, 255, dtype=torch.bool))


# ---------------------------------------------------------------------------
# rotated IoU: the plain version is the Pallas kernel's arithmetic
# ---------------------------------------------------------------------------

def _boxes(rng, shape):
    return np.stack(
        [rng.uniform(-10, 10, shape), rng.uniform(-10, 10, shape),
         rng.uniform(0.5, 4, shape), rng.uniform(0.5, 5, shape),
         rng.uniform(-np.pi, np.pi, shape)], -1,
    ).astype(np.float32)


@pytest.mark.parametrize("batch,n,m", [(1, 50, 50), (3, 7, 11), (2, 33, 17)])
def test_rotated_iou_matches_pallas_and_oracle(batch, n, m):
    rng = np.random.default_rng(batch * 100 + n)
    a = _boxes(rng, (batch, n))
    b = a[:, :m] if m <= n else _boxes(rng, (batch, m))
    if m > n:
        b[:, :n] = a  # identical boxes in the cross matrix too
    got = rotated_iou_matrix_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (batch, n, m)
    pallas = np.asarray(rotated_iou_matrix_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    for f in range(batch):
        np.testing.assert_allclose(got[f], rotated_iou_np(a[f], b[f]), atol=2e-3)
        k = min(n, m)
        np.testing.assert_allclose(np.diag(got[f][:k, :k]), 1.0, atol=1e-4)


def test_rotated_iou_padding_rows_are_zero():
    """Zero-size boxes give exactly 0 (the Pallas kernel gives ~1e6 there,
    which the NMS never reads because padding slots are invalid)."""
    rng = np.random.default_rng(11)
    a = _boxes(rng, (2, 20))
    a[:, 3] = 0.0
    a[:, 7, 2:4] = 0.0
    got = rotated_iou_matrix_plain(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    assert (got[:, [3, 7]] == 0).all() and (got[:, :, [3, 7]] == 0).all()
    live = np.setdiff1d(np.arange(20), [3, 7])
    pallas = np.asarray(rotated_iou_matrix_pallas(jnp.asarray(a), jnp.asarray(a), interpret=True))
    np.testing.assert_allclose(got[:, live][:, :, live], pallas[:, live][:, :, live], atol=1e-5)


def test_rotated_iou_wrapper_cpu_path_and_checks():
    rng = np.random.default_rng(12)
    a = torch.from_numpy(_boxes(rng, (2, 9)))
    before = rotated_iou_matrix.launches
    torch.testing.assert_close(rotated_iou_matrix(a, a), rotated_iou_matrix_plain(a, a), rtol=0, atol=0)
    assert rotated_iou_matrix.launches == before
    with pytest.raises(TypeError):
        rotated_iou_matrix(a.double(), a.double())
    with pytest.raises(ValueError):
        rotated_iou_matrix(a[0], a[0])
    with pytest.raises(ValueError):
        rotated_iou_matrix(a, a[:1])


# ---------------------------------------------------------------------------
# box codec and pose warp, against JAX float32
# ---------------------------------------------------------------------------

def test_box_codec_matches_jax():
    jcfg, tcfg = jax_tiny_config(32), tiny_config(32)
    np.testing.assert_array_equal(tboxes.make_anchors(tcfg), jboxes.make_anchors(jcfg))
    rng = np.random.default_rng(0)
    anchors = np.broadcast_to(tboxes.make_anchors(tcfg), (2, 32, 32, 6, 5)).copy()
    deltas = rng.normal(0, 1, (2, 32, 32, 6, 6)).astype(np.float32)
    deltas[0, 0, 0, 0, 2:4] = [30.0, -30.0]  # clipped
    got = tboxes.decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(got, np.asarray(jboxes.decode_boxes(deltas, anchors)), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(
        tboxes.box_corners(torch.from_numpy(got)).numpy(),
        np.asarray(jboxes.box_corners(jnp.asarray(got))), atol=1e-5, rtol=1e-6,
    )


def _poses(rng, batch, agents, max_t):
    trans = np.tile(np.eye(4, dtype=np.float32), (batch, agents, agents, 1, 1))
    for b in range(batch):
        for i in range(agents):
            for j in range(agents):
                if i != j:
                    th = rng.uniform(-np.pi, np.pi)
                    c, s = np.cos(th), np.sin(th)
                    trans[b, i, j][:2, :2] = [[c, -s], [s, c]]
                    trans[b, i, j][:2, 3] = rng.uniform(-max_t, max_t, 2)
    return trans


def test_warp_features_matches_jax():
    rng = np.random.default_rng(1)
    B, A, H, W, C = 2, 3, 8, 12, 5
    ext = ((-8.0, 8.0), (-6.0, 6.0))
    feats = rng.normal(0, 1, (B, A, H, W, C)).astype(np.float32)
    trans = _poses(rng, B, A, max_t=5.0)  # part of each field of view lies off the map
    got = twarp.warp_features(torch.from_numpy(feats), torch.from_numpy(trans), ext).numpy()
    assert got.shape == (B, A, A, H, W, C)
    assert (got == 0).any()  # zero padding was exercised
    for b in range(B):
        want = np.asarray(jwarp.warp_features(jnp.asarray(feats[b]), jnp.asarray(trans[b]), ext))
        np.testing.assert_allclose(got[b], want, atol=1e-5)
        want_mm = np.asarray(jwarp.warp_features_matmul(jnp.asarray(feats[b]), jnp.asarray(trans[b]), ext))
        np.testing.assert_allclose(got[b], want_mm, atol=1e-5)
    np.testing.assert_allclose(
        twarp.pose_to_affine(torch.from_numpy(trans)).numpy(),
        np.asarray(jwarp.pose_to_affine(jnp.asarray(trans))), atol=1e-6,
    )


# ---------------------------------------------------------------------------
# NMS: packed layout, exact top-k, against rotated_nms_decode(exact_top_k=True)
# ---------------------------------------------------------------------------

def _jax_nms(deltas, scores, anchors, cfg):
    fn = lambda d, s: jnms.rotated_nms_decode(  # noqa: E731
        d, s, jnp.asarray(anchors), cfg.nms_iou_threshold,
        score_threshold=cfg.score_threshold, top_k=cfg.nms_top_k, exact_top_k=True,
    )
    return [np.asarray(x) for x in jax.vmap(fn)(jnp.asarray(deltas), jnp.asarray(scores))]


def _nms_inputs(kind, cfg, frames=3, seed=0):
    rng = np.random.default_rng(seed)
    H, W, _ = cfg.bev_shape
    NA = cfg.num_anchors
    deltas = (rng.normal(0, 0.2, (frames, H, W, NA * 6))).astype(np.float32)
    if kind == "clusters":
        scores = rng.uniform(0.0, 0.2, (frames, H, W, NA))
        for f in range(frames):
            for _ in range(4):  # a few objects, each a cluster of confident anchors
                h, w = rng.integers(2, H - 4), rng.integers(2, W - 4)
                scores[f, h:h + 3, w:w + 3] = rng.uniform(0.3, 1.0, (3, 3, NA))
    else:  # many exact ties: flat background, a few stronger equal-valued cells
        scores = np.full((frames, H, W, NA), 0.5)
        scores[:, ::7, ::5, 2] = 0.75
        scores[:, 3, :, :] = 0.1
    return deltas, scores.astype(np.float32)


@pytest.mark.parametrize("kind", ["clusters", "ties"])
def test_rotated_nms_decode_matches_jax(kind):
    jcfg, tcfg = jax_tiny_config(32), tiny_config(32)
    anchors = tboxes.make_anchors(tcfg)
    deltas, scores = _nms_inputs(kind, tcfg)
    jb, js, jk = _jax_nms(deltas, scores, anchors, jcfg)
    tb, ts, tk = tnms.rotated_nms_decode(
        torch.from_numpy(deltas), torch.from_numpy(scores), torch.from_numpy(anchors),
        tcfg.nms_iou_threshold, tcfg.score_threshold, tcfg.nms_top_k,
    )
    valid = js > -1.0
    assert valid.sum() >= 3 * 10 and jk.sum() >= 3  # candidates pass the threshold
    assert (valid & ~jk).any()  # and some are suppressed
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_allclose(ts.numpy(), js, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), jb, atol=1e-5)


def test_packed_scores_and_deltas_matches_jax():
    rng = np.random.default_rng(5)
    raw = rng.normal(0, 2, (2, 4, 5, 48)).astype(np.float32)
    ts, td = tnms.packed_scores_and_deltas(torch.from_numpy(raw), 6)
    js, jd = jnms.packed_scores_and_deltas(jnp.asarray(raw), 6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    with pytest.raises(ValueError):
        tnms.packed_scores_and_deltas(torch.from_numpy(raw[..., :40]), 6)
