"""The port's seeded initialization (``models/build.py::init_parameters``)
against flax's ``lecun_normal``, which the JAX package draws every conv and
dense kernel from.

For each model, flax's initializer draws every kernel of the JAX model at
its shape (``jax.eval_shape`` of the JAX model's ``init`` gives the shapes,
with nothing compiled), and the port builds the same model from a seed.
Per kernel, by the ``.pth`` key rules: the same shape; the port's standard
deviation within 3% of flax's draw; no |w| beyond flax's truncation, 2
sigma / 0.87962566 with sigma = 1/sqrt(fan_in). A kernel of fewer than
16384 weights is too small for a 3% comparison of two draws (the standard
deviation of one draw's std is ~1/sqrt(2n)); those are compared pooled,
each weight scaled by sqrt(fan_in). Biases are zero and BatchNorm is the
identity, as flax's.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from disconet_tpu.config import tiny_config as jax_tiny_config
from disconet_tpu.models import build_model as jax_build_model
from disconet_tpu_torch import build_model, tiny_config
from disconet_tpu_torch.checkpoint import state_dict_from_flax
from disconet_tpu_torch.models.build import TRUNC_NORMAL_STD

MIN_ALONE = 16384
STD_RTOL = 0.03


def _flax_draws(com, task, layer, seed=0):
    """{port key: flax lecun_normal draw} for every kernel of the JAX model,
    and the port's state_dict keys of the biases and BatchNorm scales."""
    jcfg = jax_tiny_config(32)
    model = jax_build_model(com, jcfg, layer=layer, task=task)
    B, A = 1, jcfg.max_agents
    bev = jnp.zeros((B, A) + jcfg.bev_shape, jnp.float32)
    trans = jnp.tile(jnp.eye(4), (B, A, A, 1, 1))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), bev, trans, jnp.ones((B, A), bool))
    init = nn.initializers.lecun_normal()
    key = jax.random.PRNGKey(seed)
    draws = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        name = path[-1].key
        if name.endswith("kernel"):
            key, sub = jax.random.split(key)
            draws[path] = np.asarray(init(sub, leaf.shape, jnp.float32))
        else:  # biases and BatchNorm parameters: zeros and ones, as drawn
            draws[path] = np.zeros(leaf.shape, np.float32) if name != "scale" else np.ones(leaf.shape, np.float32)
    nested = {}
    for path, v in draws.items():
        d = nested
        for p in path[:-1]:
            d = d.setdefault(p.key, {})
        d[path[-1].key] = v
    return {k: v.numpy() for k, v in state_dict_from_flax(nested).items()}


@pytest.mark.parametrize("com,task,layer", [
    ("disco", "det", 3), ("v2v", "det", 3), ("when2com", "det", 3), ("agent", "det", 3), ("disco", "seg", 1),
])
def test_init_matches_flax_lecun_normal(com, task, layer):
    want = _flax_draws(com, task, layer)
    port = build_model(com, tiny_config(32), layer=layer, device="cpu", seed=0, task=task).state_dict()
    kernels = [k for k in want if k.endswith("weight") and want[k].ndim >= 2]
    assert kernels and set(want) <= set(port)
    small_p, small_j = [], []
    for k in kernels:
        w, j = port[k].numpy(), want[k]
        assert w.shape == j.shape, k
        fan_in = w[0].size
        bound = 2.0 / math.sqrt(fan_in) / TRUNC_NORMAL_STD
        assert np.abs(w).max() <= bound * (1 + 1e-6), (k, np.abs(w).max(), bound)
        assert np.abs(j).max() <= bound * (1 + 1e-6), k  # flax truncates where the port does
        if w.size >= MIN_ALONE:
            assert abs(w.std() / j.std() - 1) < STD_RTOL, (k, w.std(), j.std())
        else:
            small_p.append(w.ravel() * math.sqrt(fan_in))
            small_j.append(j.ravel() * math.sqrt(fan_in))
    if small_p:
        sp, sj = np.concatenate(small_p), np.concatenate(small_j)
        assert abs(sp.std() / sj.std() - 1) < STD_RTOL, (sp.size, sp.std(), sj.std())
    for k in want:
        if k not in kernels:  # biases zero, BatchNorm scales one
            np.testing.assert_array_equal(port[k].numpy(), want[k], err_msg=k)
    for k, v in port.items():
        if k.endswith("running_mean"):
            assert not v.any()
        elif k.endswith("running_var"):
            assert (v == 1).all()


def test_init_is_a_truncated_unit_variance_draw():
    """Over DiscoNet's kernels, scaled by sqrt(fan_in): variance 1 within 1%,
    and a truncated normal's shape (about 4.6% of a normal's mass lies beyond
    2 sigma; here none lies beyond 2 / 0.8796 of the scaled std)."""
    sd = build_model("disco", tiny_config(32), device="cpu", seed=3).state_dict()
    z = np.concatenate([v.numpy().ravel() * math.sqrt(v[0].numel()) for k, v in sd.items()
                        if k.endswith("weight") and v.dim() >= 2])
    assert abs(z.var() - 1) < 0.01, z.var()
    assert np.abs(z).max() <= 2 / TRUNC_NORMAL_STD * (1 + 1e-6)
    assert (np.abs(z) > 2).mean() > 0.03  # not clipped at 1 std: the tails to 2 / 0.8796 are there
    again = build_model("disco", tiny_config(32), device="cpu", seed=3).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in sd.items())  # seeded
