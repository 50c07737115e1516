"""The port's DiscoNet and pipeline against the JAX package's.

One JAX DiscoNet on a 64-grid float32 config, with seeded random running
BatchNorm statistics (so that eval-mode BN is not the identity), is carried
into the port with ``state_dict_from_flax``. The port's forward must match at
atol/rtol 1e-4 (as tests/test_torch_parity.py holds the reference twin), a
``save_pth`` export must load strictly with ``load_pth``, and the whole
points -> voxelize -> model -> NMS slice must keep the same boxes as the JAX
pipeline that bench.py times (with exact top-k).
"""

import functools
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from disconet_tpu.config import tiny_config as jax_tiny_config
from disconet_tpu.models import build_model as jax_build_model
from disconet_tpu.ops.boxes import make_anchors as jax_make_anchors
from disconet_tpu.ops.nms import packed_scores_and_deltas as jax_packed, rotated_nms_decode
from disconet_tpu.ops.voxelize import voxelize_occupy_jax
from disconet_tpu.training.checkpoint import save_pth
from disconet_tpu_torch import build_model, make_anchors, predict, tiny_config
from disconet_tpu_torch.checkpoint import load_pth, load_state_dict_strict, state_dict_from_flax

B, A, N = 2, 3, 4096
OVERRIDES = dict(compute_dtype="float32", head_raw_dtype="float32")
JCFG = jax_tiny_config(64, **OVERRIDES)
TCFG = tiny_config(64, **OVERRIDES)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    (x_lo, x_hi), (y_lo, y_hi), (z_lo, z_hi) = TCFG.area_extents
    pts = rng.uniform([x_lo, y_lo, z_lo], [x_hi, y_hi, z_hi], (B, A, N, 3)).astype(np.float32)
    pts[:, :, : N // 8] *= 1.3  # some out of extent
    trans = np.tile(np.eye(4, dtype=np.float32), (B, A, A, 1, 1))
    for b in range(B):
        for i in range(A):
            for j in range(A):
                if i != j:
                    th = rng.uniform(-1.0, 1.0)
                    c, s = np.cos(th), np.sin(th)
                    trans[b, i, j][:2, :2] = [[c, -s], [s, c]]
                    trans[b, i, j][:2, 3] = rng.uniform(-4.0, 4.0, 2)
    mask = np.ones((B, A), bool)
    mask[1, A - 1] = False  # one absent agent
    pts[1, A - 1] = np.nan  # that sends only padding
    return pts, trans, mask


@pytest.fixture(scope="module")
def jax_side():
    """JAX DiscoNet variables with random running statistics, its forward on
    the voxelized inputs, and the JAX pipeline's detections."""
    pts, trans, mask = _inputs()
    model = jax_build_model("disco", JCFG)
    bev = voxelize_occupy_jax(jnp.asarray(pts), JCFG.voxel_size, JCFG.area_extents)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), bev, jnp.asarray(trans), jnp.asarray(mask))
    rng = np.random.default_rng(42)

    def _stat(path, x):
        if jax.tree_util.keystr(path).endswith("['mean']"):
            return jnp.asarray(rng.normal(0.0, 0.3, x.shape).astype(np.float32))
        return jnp.asarray(rng.uniform(0.5, 2.0, x.shape).astype(np.float32))

    variables = {
        "params": variables["params"],
        "batch_stats": jax.tree_util.tree_map_with_path(_stat, variables["batch_stats"]),
    }
    anchors = jnp.asarray(jax_make_anchors(JCFG))
    nms = functools.partial(
        rotated_nms_decode, anchors=anchors, iou_threshold=JCFG.nms_iou_threshold,
        score_threshold=JCFG.score_threshold, top_k=JCFG.nms_top_k, exact_top_k=True,
    )

    @jax.jit
    def pipeline(variables, pts, trans, mask):  # bench.py's pipeline, f32, exact top-k
        bev = voxelize_occupy_jax(pts, JCFG.voxel_size, JCFG.area_extents)
        out = model.apply(variables, bev, trans, mask, train=False)
        raw = out["head_raw"].reshape((B * A,) + out["head_raw"].shape[2:])
        scores, deltas = jax_packed(raw, JCFG.num_anchors)
        return out, jax.vmap(nms)(deltas, scores)

    out, dets = pipeline(variables, jnp.asarray(pts), jnp.asarray(trans), jnp.asarray(mask))
    return types.SimpleNamespace(
        variables=variables,
        out={k: np.asarray(out[k]) for k in ("cls", "reg", "head_raw")},
        dets=[np.asarray(x) for x in dets],
        bev=np.asarray(bev),
        inputs=(pts, trans, mask),
    )


@pytest.fixture(scope="module")
def port_model(jax_side):
    model = build_model("disco", TCFG, device="cpu")
    sd = state_dict_from_flax(jax_side.variables["params"], jax_side.variables["batch_stats"])
    return load_state_dict_strict(model, sd)


def test_disconet_forward_matches_jax(jax_side, port_model):
    _, trans, mask = jax_side.inputs
    with torch.no_grad():
        out = port_model(torch.from_numpy(jax_side.bev.copy()), torch.from_numpy(trans), torch.from_numpy(mask))
    for key in ("cls", "reg", "head_raw"):
        assert out[key].shape == jax_side.out[key].shape, key
        np.testing.assert_allclose(out[key].numpy(), jax_side.out[key], atol=1e-4, rtol=1e-4, err_msg=key)


def test_save_pth_export_loads_strictly(jax_side, port_model, tmp_path):
    path = str(tmp_path / "disco.pth")
    v = jax_side.variables
    save_pth(path, types.SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"]), epoch=3)
    loaded, epoch, _ = load_pth(build_model("disco", TCFG, device="cpu", seed=5), path)
    assert epoch == 3
    for (k, a), (k2, b) in zip(sorted(port_model.state_dict().items()), sorted(loaded.state_dict().items())):
        assert k == k2
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)

    ckpt = torch.load(path, weights_only=True)
    sd = ckpt["model_state_dict"]
    sd["stpn.stages_0.ConvBNRelu_0.weights"] = sd.pop("stpn.stages_0.ConvBNRelu_0.weight")
    torch.save(ckpt, path)
    with pytest.raises(KeyError):
        load_pth(build_model("disco", TCFG, device="cpu"), path)


def test_predict_matches_jax_pipeline(jax_side, port_model):
    pts, trans, mask = jax_side.inputs
    boxes, scores, keep = predict(port_model, pts, trans, mask, make_anchors(TCFG), TCFG)
    K = TCFG.nms_top_k
    jb, js, jk = (x.reshape((B, A, K) + x.shape[2:]) for x in jax_side.dets)
    assert boxes.shape == (B, A, K, 5) and keep.dtype == torch.bool
    assert jk.sum() >= B * A and ((js > -1) & ~jk).any()  # detections kept and suppressed
    boxes, scores, keep = boxes.numpy(), scores.numpy(), keep.numpy()
    for b in range(B):
        for a in range(A):
            s = np.sort(js[b, a][js[b, a] > -1])
            near_tie = s.size > 1 and np.diff(s).min() < 1e-5
            if not near_tie:
                np.testing.assert_array_equal(keep[b, a], jk[b, a], err_msg=f"frame {b},{a}")
                np.testing.assert_allclose(boxes[b, a], jb[b, a], atol=1e-4)
                np.testing.assert_allclose(scores[b, a], js[b, a], atol=1e-4)
            else:  # the candidate order may swap between close scores: compare kept sets
                got = boxes[b, a][keep[b, a]]
                want = jb[b, a][jk[b, a]]
                assert got.shape == want.shape, f"frame {b},{a}"
                got, want = got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])]
                np.testing.assert_allclose(got, want, atol=1e-4)


def test_bf16_forward_tracks_jax():
    """The bf16 compute mode (the card's default) against JAX's bf16 mode:
    the two round at different places (JAX's default decoder stage 0 runs a
    block rewrite whose summed taps round to bf16 once), so the bound is on
    the head logits' error, not their bits."""
    pts, trans, mask = _inputs(1)
    jcfg = jax_tiny_config(64, head_raw_dtype="float32")
    tcfg = tiny_config(64, head_raw_dtype="float32")
    model = jax_build_model("disco", jcfg)
    bev = voxelize_occupy_jax(jnp.asarray(pts), jcfg.voxel_size, jcfg.area_extents)
    variables = jax.jit(model.init)(jax.random.PRNGKey(1), bev, jnp.asarray(trans), jnp.asarray(mask))
    want = np.asarray(jax.jit(model.apply)(variables, bev, jnp.asarray(trans), jnp.asarray(mask))["head_raw"])
    port = load_state_dict_strict(
        build_model("disco", tcfg, device="cpu"),
        state_dict_from_flax(variables["params"], variables["batch_stats"]),
    )
    with torch.no_grad():
        got = port(torch.from_numpy(np.asarray(bev)), torch.from_numpy(trans), torch.from_numpy(mask))["head_raw"]
    err = np.abs(got.numpy() - want)
    scale = np.abs(want).max()
    assert err.max() < 2e-2 * scale, (err.max(), scale)  # bf16 keeps 8 bits: 0.4% a rounding
    assert err.mean() < 3e-3 * scale, (err.mean(), scale)
