"""The port's tap-matrix warp (``ops/warp.py::warp_features_matmul``) against
the JAX package's ``warp_features_matmul`` on the CPU, and the dispatch of
``models/base.py::warp_all_pairs``.

* float32 features: the forward within ``F32_LIMIT`` of JAX's (the same
  fp32 products; readings below), a strip of receiver rows against those
  rows of JAX's whole output, and the gradient of the features (the VJP of
  a random cotangent) within ``F32_LIMIT`` of JAX's.
* bf16 features: the tap matrix and the output rounded to bf16, fp32
  accumulation, as JAX computes them; within one bf16 step.
* The dispatch: the product while the fusion grid has at most 1024 cells,
  the gather above (the JAX package's threshold), through every path a
  model warps by.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disconet_tpu.ops import warp as jwarp
from disconet_tpu_torch.models import base
from disconet_tpu_torch.ops import warp as twarp
from test_torch_port_ops import _poses

# CPU readings (seed 1): the forward, the VJP and the bf16 forward all equal
# JAX's (max difference 0: the same products summed in the same order)
F32_LIMIT = 1e-5
EXT = ((-8.0, 8.0), (-6.0, 6.0))


def _case(seed=1, shape=(2, 3, 8, 12, 5)):
    rng = np.random.default_rng(seed)
    B, A, H, W, C = shape
    feats = rng.normal(0, 1, shape).astype(np.float32)
    trans = _poses(rng, B, A, max_t=5.0)  # part of each field of view lies off the map
    return feats, trans


def _jax_matmul(feats, trans, dtype=jnp.float32):
    """JAX's warp of each scene, stacked."""
    return np.stack([np.asarray(jwarp.warp_features_matmul(jnp.asarray(f).astype(dtype), jnp.asarray(t), EXT)
                                .astype(jnp.float32)) for f, t in zip(feats, trans)])


def test_float32_matmul_warp_matches_jax():
    feats, trans = _case()
    got = twarp.warp_features_matmul(torch.from_numpy(feats), torch.from_numpy(trans), EXT)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 3, 8, 12, 5)
    want = _jax_matmul(feats, trans)
    assert (want == 0).any()  # zero padding was exercised
    np.testing.assert_allclose(got.numpy(), want, atol=F32_LIMIT, rtol=0)
    gather = twarp.warp_features(torch.from_numpy(feats), torch.from_numpy(trans), EXT).numpy()
    np.testing.assert_allclose(got.numpy(), gather, atol=F32_LIMIT, rtol=0)


@pytest.mark.parametrize("rows", [(0, 4), (2, 6), (4, 8)])
def test_a_strip_of_rows_is_those_rows_of_the_whole_warp(rows):
    feats, trans = _case()
    got = twarp.warp_features_matmul(torch.from_numpy(feats), torch.from_numpy(trans), EXT, rows=rows)
    want = _jax_matmul(feats, trans)[:, :, :, rows[0]:rows[1]]
    np.testing.assert_allclose(got.numpy(), want, atol=F32_LIMIT, rtol=0)


def test_a_rank_of_receivers_warps_every_sender():
    """Fewer receivers than senders (an agent-sharded rank): trans (B, Ar, As)."""
    feats, trans = _case()
    got = twarp.warp_features_matmul(torch.from_numpy(feats), torch.from_numpy(trans[:, 1:]), EXT)
    np.testing.assert_allclose(got.numpy(), _jax_matmul(feats, trans)[:, 1:], atol=F32_LIMIT, rtol=0)


def test_bf16_matmul_warp_matches_jax():
    feats, trans = _case()
    got = twarp.warp_features_matmul(torch.from_numpy(feats).to(torch.bfloat16), torch.from_numpy(trans), EXT)
    assert got.dtype == torch.bfloat16
    want = _jax_matmul(feats, trans, jnp.bfloat16)
    # the same fp32 sums of the same bf16 products, rounded once: a step of
    # bf16 at most where two summation orders would round apart
    np.testing.assert_allclose(got.float().numpy(), want, atol=0, rtol=2 ** -8)


def test_matmul_warp_vjp_matches_jax():
    feats, trans = _case()
    r = np.random.default_rng(7).normal(size=(2, 3, 3, 8, 12, 5)).astype(np.float32)
    ft = torch.from_numpy(feats).requires_grad_(True)
    (twarp.warp_features_matmul(ft, torch.from_numpy(trans), EXT) * torch.from_numpy(r)).sum().backward()
    for b in range(2):
        _, vjp = jax.vjp(lambda f: jwarp.warp_features_matmul(f, jnp.asarray(trans[b]), EXT), jnp.asarray(feats[b]))
        np.testing.assert_allclose(ft.grad[b].numpy(), np.asarray(vjp(jnp.asarray(r[b]))[0]), atol=F32_LIMIT, rtol=0)


@pytest.mark.parametrize("hw,form", [((32, 32), "matmul"), ((16, 64), "matmul"), ((8, 8), "matmul"),
                                     ((32, 33), "gather"), ((64, 64), "gather")])
def test_warp_all_pairs_dispatches_as_jax(hw, form):
    """The product up to ``MATMUL_WARP_CELLS`` (1024) cells, the gather
    above, for the one-process warp and a strip of rows alike."""
    assert base.MATMUL_WARP_CELLS == 1024
    feats, trans = _case(shape=(1, 2) + hw + (3,))
    with mock.patch.object(base, "warp_features_matmul", wraps=twarp.warp_features_matmul) as mm, \
            mock.patch.object(base, "warp_features", wraps=twarp.warp_features) as ga:
        whole = base.warp_all_pairs(torch.from_numpy(feats), torch.from_numpy(trans), EXT)
        strip = base.warp_all_pairs(torch.from_numpy(feats), torch.from_numpy(trans), EXT, rows=(4, 8))
    assert (mm.call_count, ga.call_count) == ((2, 0) if form == "matmul" else (0, 2))
    assert torch.equal(strip, whole[:, :, :, 4:8])
