"""Carrying weights into the port (from flax variables and ``.pth`` exports)
and out of it (``save_pth``, which the JAX package's ``load_pth`` reads).

The JAX package exports the reference checkpoint format (``save_pth``): a flat
torch ``state_dict`` whose names come from the flax parameter paths by the
rules below (the port keeps its own copy of them). Conv kernels go HWIO ->
OIHW, dense kernels (in, out) -> (out, in), BatchNorm {scale, bias, mean, var}
-> {weight, bias, running_mean, running_var}. The port's module names are
chosen so that these keys load strictly.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

# (regex on the flax leaf path, torch suffix, layout transform tag)
_KEY_RULES = (
    (re.compile(r"(.*)/cls_kernel$"), "cls.weight", "kernel"),
    (re.compile(r"(.*)/cls_bias$"), "cls.bias", None),
    (re.compile(r"(.*)/reg_kernel$"), "reg.weight", "kernel"),
    (re.compile(r"(.*)/reg_bias$"), "reg.bias", None),
    (re.compile(r"(.*)/kernel$"), "weight", "kernel"),
    (re.compile(r"(.*)/bias$"), "bias", None),
    (re.compile(r"(.*)/scale$"), "weight", None),  # BatchNorm scale
    (re.compile(r"(.*)/mean$"), "running_mean", None),
    (re.compile(r"(.*)/var$"), "running_var", None),
)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if hasattr(tree, "items"):  # dict or flax FrozenDict
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    else:
        out[prefix] = np.asarray(tree)
    return out


def _to_torch_name_and_value(path: str, value: np.ndarray):
    for rx, suffix, tag in _KEY_RULES:
        m = rx.match(path)
        if m:
            base = m.group(1).replace("/", ".")
            if tag == "kernel":
                if value.ndim == 4:  # HWIO -> OIHW
                    value = np.transpose(value, (3, 2, 0, 1))
                elif value.ndim == 2:  # (in, out) -> (out, in)
                    value = value.T
            return f"{base}.{suffix}", value
    return path.replace("/", "."), value


def state_dict_from_flax(params, batch_stats=None) -> Dict[str, torch.Tensor]:
    """Flax variables as nested dicts of arrays -> the port's ``state_dict``
    (float32 CPU tensors)."""
    flat = {**_flatten(params or {}), **_flatten(batch_stats or {})}
    out = {}
    for path, val in flat.items():
        name, v = _to_torch_name_and_value(path, val)
        out[name] = torch.from_numpy(np.array(v, dtype=np.float32))
    return out


def load_state_dict_strict(model: nn.Module, sd: Dict[str, torch.Tensor]) -> nn.Module:
    """Load ``sd`` into ``model``; every key must match, except the BatchNorm
    ``num_batches_tracked`` counters, which flax exports do not have."""
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [m for m in missing if not m.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing={missing} unexpected={unexpected}")
    return model


def save_pth(path: str, model: nn.Module, optimizer: torch.optim.Optimizer, epoch: int, loss: float = 0.0) -> None:
    """Write the reference checkpoint dict ``{'epoch', 'model_state_dict',
    'optimizer_state_dict', 'loss'}``, tensors on the CPU. The model's keys
    are the ones the JAX package's ``load_pth`` looks up; its
    ``num_batches_tracked`` counters ride along unread."""
    def cpu(t):
        return t.detach().cpu() if isinstance(t, torch.Tensor) else t

    opt = optimizer.state_dict()
    torch.save(
        {
            "epoch": int(epoch),
            "model_state_dict": {k: cpu(v) for k, v in model.state_dict().items()},
            "optimizer_state_dict": {
                "state": {i: {k: cpu(v) for k, v in s.items()} for i, s in opt["state"].items()},
                "param_groups": opt["param_groups"],
            },
            "loss": float(loss),
        },
        path,
    )


def load_pth(model: nn.Module, path: str) -> nn.Module:
    """Load a ``save_pth`` export (``{'model_state_dict': ...}`` or a bare
    state_dict) into ``model``, strictly. Returns the model in eval mode."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    return load_state_dict_strict(model, sd).eval()
