"""The seeded weights' norm scales, found by module type: a LayerNorm,
GroupNorm or RMSNorm starts at 1 as a BatchNorm does, and the models the
cells run get the same state as under the rule by key names that came
before."""

import json
import os

import pytest
import torch

from port_bench.core.registry import BENCH_DIR
from port_bench.core.weights import seeded_state, unit_keys


class Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(8, 16)
        self.ln = torch.nn.LayerNorm(16)
        self.gn = torch.nn.GroupNorm(4, 16)
        self.rms = torch.nn.RMSNorm(16)
        self.bn = torch.nn.BatchNorm1d(16)
        self.attn = torch.nn.Sequential(torch.nn.LayerNorm(16), torch.nn.Linear(16, 16))


def test_norms_of_any_type_start_at_one():
    toy = Toy()
    ones = unit_keys(toy)
    assert ones == {"ln.weight", "gn.weight", "rms.weight", "bn.weight", "bn.running_var", "attn.0.weight"}
    s = seeded_state(toy.state_dict(), 2**31 + 5, 1, "cpu", ones)
    for k in ones:
        assert torch.equal(s[k], torch.ones(16)), k
    for k in ("ln.bias", "gn.bias", "bn.bias", "bn.running_mean", "proj.bias", "attn.0.bias", "attn.1.bias"):
        assert torch.equal(s[k], torch.zeros(16)), k
    assert s["proj.weight"].std() > 0.1 and s["bn.num_batches_tracked"].dtype == torch.long


def _before(template, seed, stream):
    """The rule by key names that the benchmark used before (the running
    variances and every ``.weight`` keyed ``BatchNorm``)."""
    ones = frozenset(k for k, v in template.items() if v.dim() < 2 and v.is_floating_point() and (
        k.endswith("running_var") or (k.endswith(".weight") and "BatchNorm" in k)))
    return seeded_state(template, seed, stream, "cpu", ones)


@pytest.mark.parametrize("com,kd", [("disco", False), ("disco", True), ("v2v", False), ("when2com", False),
                                    ("teacher", False)])
def test_the_cells_models_seed_as_before(com, kd):
    from disconet_tpu_torch.models.build import build_model

    from port_bench.core.model import port_config

    with open(os.path.join(BENCH_DIR, "configs", "disconet.json")) as f:
        cfg = port_config(json.load(f)["config"])
    model = build_model(com, cfg, device="cpu") if com == "teacher" else \
        build_model(com, cfg, layer=3, device="cpu", kd_flag=kd)
    template = model.state_dict()
    for seed in (0, 1, 2):
        for stream in (1, 2):
            old, new = _before(template, seed, stream), seeded_state(template, seed, stream, "cpu", unit_keys(model))
            assert old.keys() == new.keys()
            assert all(torch.equal(old[k], new[k]) and old[k].dtype == new[k].dtype for k in old), com
