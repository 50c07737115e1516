"""Seeded weights, made by the benchmark on the device.

Every floating leaf of a model's ``state_dict`` gets a value from the seed:
kernels (two or more axes) a normal truncated to +-2 standard units,
scaled to variance gain^2 / fan_in (fan_in = the kernel's row); biases
zero; every norm's scale 1 and shift 0, running mean 0, running variance
1. The norms are found by module type (:func:`unit_keys`), so that a
LayerNorm, GroupNorm or RMSNorm of a later model starts at 1 as a
BatchNorm does, whatever its key. The
gain is sqrt(2) for kernels that a ReLU follows (``ConvBNRelu`` and
V2VNet's message conv), so that eval-mode activations keep their scale
through the depth of the network and the heads' scores spread, and 1
elsewhere, but 0.1 for the box regression head, whose cos bias is 1. All
kernels come from one draw of a ``torch.Generator`` on the device, in one
call, then one scaling; the benchmark loads the result into the program
with ``load_state_dict`` and hands the same tensors to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, FrozenSet

import torch

TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]
# the box regression head's gain: deltas of about 0.1, the size of a trained
# detector's offsets from its anchors (unit-size deltas would make boxes of
# e^3 times an anchor)
REG_GAIN = 0.1
# the regression head's code (dx, dy, dw, dl, sin, cos); its cos bias is 1,
# so that headings are atan2 of a vector of about unit length, as a trained
# head's are, and not of two small numbers
BOX_CODE = 6


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed of its own for each ``stream`` of one ``--seed``."""
    return (int(seed) * 1_000_003 + 7919 * stream) % (2**63 - 1)


def _gain(key: str) -> float:
    if key.startswith("heads.reg."):
        return REG_GAIN
    return math.sqrt(2.0) if ("ConvBNRelu" in key or "head_conv" in key or "msg_conv" in key) else 1.0


# the norms whose ``weight`` is a scale that starts at 1
NORMS = (torch.nn.modules.batchnorm._NormBase, torch.nn.LayerNorm, torch.nn.GroupNorm) + (
    (torch.nn.RMSNorm,) if hasattr(torch.nn, "RMSNorm") else ())


def unit_keys(model: torch.nn.Module) -> FrozenSet[str]:
    """The ``state_dict`` keys of ``model`` that start at 1: the ``weight``
    of every norm module (:data:`NORMS`) and every running variance."""
    keys = set()
    for prefix, mod in model.named_modules():
        if isinstance(mod, NORMS):
            dot = prefix + "." if prefix else ""
            keys.update(dot + name for name in ("weight", "running_var")
                        if getattr(mod, name, None) is not None)
    return frozenset(keys)


def seeded_state(template: Dict[str, torch.Tensor], seed: int, stream: int, device,
                 ones: FrozenSet[str]) -> Dict[str, torch.Tensor]:
    """Values for every floating leaf of ``template`` (a ``state_dict``),
    fp32 on ``device``; the 1-D leaves ``ones`` (of :func:`unit_keys`) 1;
    integer leaves (BatchNorm's step counts) keep theirs."""
    kernels = [(k, v) for k, v in template.items() if v.is_floating_point() and v.dim() >= 2]
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
    sizes = [v.numel() for _, v in kernels]
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    stds = torch.tensor([_gain(k) / math.sqrt(v[0].numel()) / TRUNC_STD for k, v in kernels], device=device)
    flat *= torch.repeat_interleave(stds, torch.tensor(sizes, device=device))
    out = {}
    for (k, v), part in zip(kernels, flat.split(sizes)):
        out[k] = part.view(v.shape)
    for k, v in template.items():
        if k in out:
            continue
        if not v.is_floating_point():
            out[k] = v.to(device)
        elif k in ones:
            out[k] = torch.ones(v.shape, device=device)
        elif k == "heads.reg.bias":  # (dx, dy, dw, dl, sin, cos) per anchor: headings near 0
            out[k] = torch.zeros(v.shape, device=device)
            out[k].view(-1, BOX_CODE)[:, BOX_CODE - 1] = 1.0
        else:
            out[k] = torch.zeros(v.shape, device=device)
    return out
