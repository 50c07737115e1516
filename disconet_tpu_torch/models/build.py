"""Model factory for the ``--com`` surface: ``disco``, ``v2v``, ``when2com``,
``who2com``, ``sum``, ``mean``, ``max``, ``cat``, ``agent``, FaFNet (``""``,
``"lowerbound"``, ``"upperbound"``, ``"faf"``) and TeacherNet (``"teacher"``),
each for ``task`` "det" or "seg"."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn as nn

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.device import resolve_device
from disconet_tpu_torch.models.backbone import ConvBNRelu
from disconet_tpu_torch.models.base import TASKS
from disconet_tpu_torch.models.disco_net import DiscoNet
from disconet_tpu_torch.models.faf_net import FaFNet, TeacherNet
from disconet_tpu_torch.models.naive_fusion import (
    AgentWiseWeightedFusion,
    CatFusion,
    MaxFusion,
    MeanFusion,
    SumFusion,
)
from disconet_tpu_torch.models.v2v_net import V2VNet
from disconet_tpu_torch.models.when2com import When2com

_FUSION = {
    "disco": DiscoNet,
    "sum": SumFusion,
    "mean": MeanFusion,
    "max": MaxFusion,
    "cat": CatFusion,
    "agent": AgentWiseWeightedFusion,
}
_SINGLE_AGENT = ("", "lowerbound", "upperbound", "faf")


# std of a standard normal truncated to [-2, 2]: dividing by it gives the
# truncated draw unit variance (flax's variance_scaling "truncated_normal")
TRUNC_NORMAL_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """flax's ``lecun_normal``, ``variance_scaling(1.0, "fan_in",
    "truncated_normal")``: a normal truncated to +-2 standard units, scaled to
    variance 1/fan_in, with fan_in = Cin * kh * kw (the kernel's row)."""
    std = math.sqrt(1.0 / weight[0].numel()) / TRUNC_NORMAL_STD
    draw = torch.empty(weight.shape)
    nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=gen)
    weight.copy_(draw * std)


def init_parameters(model: nn.Module, seed: int = 0) -> None:
    """Seeded random weights as the JAX package draws them: flax's truncated
    ``lecun_normal`` for every conv (ConvBNRelu included) and dense kernel,
    zero biases, identity BatchNorm."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ConvBNRelu):
                lecun_normal_(mod.weight, gen)
                mod.BatchNorm_0.reset_parameters()
            elif isinstance(mod, (nn.Conv2d, nn.Linear)):
                lecun_normal_(mod.weight, gen)
                if mod.bias is not None:
                    mod.bias.zero_()


def build_model(
    com: str,
    config: Config,
    layer: int = 3,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
    kd_flag: bool = False,
    warp_flag: bool = True,
    task: str = "det",
    gru_rounds: int = 0,
) -> nn.Module:
    """The eval-mode model for ``com`` on ``device`` (CUDA unless the caller
    names another), with weights drawn from ``seed``. ``kd_flag`` adds the KD
    taps to the outputs (TeacherNet always has them); ``warp_flag`` (when2com,
    who2com) fuses warped values; ``task`` "seg" gives the segmentation
    variant; ``gru_rounds`` (v2v only) overrides V2VNet's 3 rounds (0 keeps
    them; a checkpoint must be evaluated with the rounds it trained with).

    Sets the process's TF32 switches off, for both cuDNN convolutions and
    matrix products: the float32 mode is then exact float32, and the bf16
    mode's fp32 products of bf16-rounded operands stay exact. Sets cuDNN to
    deterministic algorithms: with its own choice for float32 convs a
    training step does not repeat bit for bit on the card.
    """
    com = (com or "").lower()
    if gru_rounds and com != "v2v":
        raise ValueError(f"--gru_rounds applies to --com v2v only (got '{com}')")
    if com not in _FUSION and com not in _SINGLE_AGENT and com not in ("teacher", "v2v", "when2com", "who2com"):
        raise ValueError(f"unknown --com '{com}'")
    if task not in TASKS:
        raise ValueError(f"task must be one of {TASKS}, got {task!r}")
    if config.compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"compute_dtype must be 'bfloat16' or 'float32', got {config.compute_dtype!r}")
    dev = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    if com == "teacher":
        model = TeacherNet(config, task=task)
    elif com in _SINGLE_AGENT:
        model = FaFNet(config, kd_flag=kd_flag, task=task)
    elif com == "v2v":
        model = V2VNet(config, layer=layer, kd_flag=kd_flag, task=task, rounds=gru_rounds or 3)
    elif com in ("when2com", "who2com"):
        model = When2com(config, layer=layer, kd_flag=kd_flag, task=task, warp_flag=warp_flag,
                         hard_select=com == "who2com")
    else:
        model = _FUSION[com](config, layer=layer, kd_flag=kd_flag, task=task)
    init_parameters(model, seed)
    return model.to(dev).eval()
