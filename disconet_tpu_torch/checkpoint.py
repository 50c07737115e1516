"""Carrying weights into the port (from flax variables and ``.pth`` exports)
and out of it (``save_pth``, which the JAX package's ``load_pth`` reads), and
the training CLI's per-epoch checkpoints (:class:`CheckpointIO`,
:func:`restore_or_die`).

The JAX package exports the reference checkpoint format (``save_pth``): a flat
torch ``state_dict`` whose names come from the flax parameter paths by the
rules below (the port keeps its own copy of them). Conv kernels go HWIO ->
OIHW, dense kernels (in, out) -> (out, in), BatchNorm {scale, bias, mean, var}
-> {weight, bias, running_mean, running_var}. The port's module names are
chosen so that these keys load strictly.

The JAX package keeps its per-epoch checkpoints with orbax, which the port
does not read (orbax is a JAX library): the port keeps its own under
``{logdir}/ckpt/`` as ``{N}.pth`` files of the same dict, Adam's state
included, and reads those and any ``.pth`` export.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple, Union

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


def save_pth(
    path: str,
    model: Union[nn.Module, Dict[str, torch.Tensor]],
    optimizer: Optional[torch.optim.Optimizer] = None,
    epoch: int = 0,
    loss: float = 0.0,
) -> None:
    """Write the reference checkpoint dict ``{'epoch', 'model_state_dict',
    'optimizer_state_dict', 'loss'}``, tensors on the CPU, through a
    temporary file and a rename, so a reader never sees half a file.
    ``model`` is a module or its ``state_dict``; without an ``optimizer`` the
    optimizer entry is ``{}``, as the JAX package writes it. The model's keys
    are the ones the JAX package's ``load_pth`` looks up; its
    ``num_batches_tracked`` counters ride along unread."""
    def cpu(t):
        return t.detach().cpu() if isinstance(t, torch.Tensor) else t

    sd = model.state_dict() if isinstance(model, nn.Module) else model
    opt = {}
    if optimizer is not None:
        o = optimizer.state_dict()
        opt = {
            "state": {i: {k: cpu(v) for k, v in st.items()} for i, st in o["state"].items()},
            "param_groups": o["param_groups"],
        }
    torch.save(
        {
            "epoch": int(epoch),
            "model_state_dict": {k: cpu(v) for k, v in sd.items()},
            "optimizer_state_dict": opt,
            "loss": float(loss),
        },
        path + ".tmp",
    )
    os.replace(path + ".tmp", path)


def load_pth(model: nn.Module, path: str, optimizer: Optional[torch.optim.Optimizer] = None):
    """Load a ``save_pth`` export (``{'model_state_dict': ...}`` or a bare
    state_dict) into ``model``, strictly, and with an ``optimizer`` its
    state too where the file has one. Returns (model in eval mode, epoch,
    loss); a bare state_dict gives epoch 0 and loss 0."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    load_state_dict_strict(model, sd)
    if optimizer is not None and ckpt.get("optimizer_state_dict"):
        load_optimizer_state(optimizer, ckpt["optimizer_state_dict"])
    return model.eval(), int(ckpt.get("epoch", 0)), float(ckpt.get("loss", 0.0))


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: Dict) -> None:
    """Load a saved optimizer state, keeping the optimizer's own
    ``capturable`` flag: a run saved on the card (capturable Adam, its step
    count on the device) resumes on the CPU, and the other way round."""
    groups = [{**saved, "capturable": cur["capturable"]} if "capturable" in saved and "capturable" in cur else saved
              for saved, cur in zip(state["param_groups"], optimizer.param_groups)]
    optimizer.load_state_dict({**state, "param_groups": groups})


class CheckpointIO:
    """Per-epoch checkpoints of a training run in ``directory``: the model
    (weights and BatchNorm statistics), the optimizer and the epoch, one
    ``{N}.pth`` each (named apart from the log directory's ``epoch_{N}.pth``
    exports), the newest ``max_to_keep`` kept (None keeps all).
    The directory is made by the first save, never by a probe."""

    _NAME = re.compile(r"^(\d+)\.pth$")

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def epochs(self):
        """The saved epochs, ascending."""
        if not os.path.isdir(self.directory):
            return []
        found = (self._NAME.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{epoch}.pth")

    def save(self, epoch: int, model: nn.Module, optimizer: torch.optim.Optimizer, loss: float = 0.0) -> None:
        os.makedirs(self.directory, exist_ok=True)
        save_pth(self.path(epoch), model, optimizer, epoch, loss)
        if self.max_to_keep:
            for old in self.epochs()[: -self.max_to_keep]:
                os.remove(self.path(old))

    def restore(self, model: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None) -> Optional[int]:
        """Load the latest epoch into ``model`` (and ``optimizer``); returns
        the epoch, or None when there is none."""
        epochs = self.epochs()
        if not epochs:
            return None
        load_pth(model, self.path(epochs[-1]), optimizer)
        return epochs[-1]


def restore_or_die(path: str, model: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None
                   ) -> Tuple[int, str]:
    """Restore ``model`` (and ``optimizer``) from ``path``: a ``.pth`` file, a
    ``ckpt/`` directory of :class:`CheckpointIO`, or the training log
    directory holding one. Returns (epoch, the path read). Exits when
    nothing restores: a mistyped path must never go on with random weights."""
    if os.path.isfile(path):
        if not path.endswith(".pth"):
            raise SystemExit(f"--resume {path}: is a file but not a .pth checkpoint")
        _, epoch, _ = load_pth(model, path, optimizer)
        return epoch, path
    for d in (path, os.path.join(path, "ckpt")):
        epoch = CheckpointIO(d).restore(model, optimizer)
        if epoch is not None:
            return epoch, CheckpointIO(d).path(epoch)
    raise SystemExit(
        f"--resume {path}: no checkpoint found (pass a .pth file, the ckpt/ "
        "directory of the port's training CLI, or the log directory holding it; "
        "the port does not read the JAX package's orbax checkpoints: export a "
        ".pth with its --save_pth 1)"
    )
