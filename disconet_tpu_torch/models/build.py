"""Model factory for the ``--com`` surface: DiscoNet, FaFNet (``""``,
``"lowerbound"``, ``"upperbound"``, ``"faf"``) and TeacherNet (``"teacher"``)."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn as nn

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.device import resolve_device
from disconet_tpu_torch.models.backbone import ConvBNRelu
from disconet_tpu_torch.models.disco_net import DiscoNet
from disconet_tpu_torch.models.faf_net import FaFNet, TeacherNet

_FUSION = {"disco": DiscoNet}
_SINGLE_AGENT = ("", "lowerbound", "upperbound", "faf")


def init_parameters(model: nn.Module, seed: int = 0) -> None:
    """Seeded random weights: He-normal for ConvBNRelu kernels (ReLU follows),
    LeCun-normal for the linear 1x1 convs, zero biases, identity BatchNorm."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ConvBNRelu):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * math.sqrt(2.0 / fan_in))
                mod.BatchNorm_0.reset_parameters()
            elif isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * math.sqrt(1.0 / fan_in))
                mod.bias.zero_()


def build_model(
    com: str,
    config: Config,
    layer: int = 3,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
    kd_flag: bool = False,
) -> nn.Module:
    """The eval-mode model for ``com`` on ``device`` (CUDA unless the caller
    names another), with weights drawn from ``seed``. ``kd_flag`` adds the KD
    taps to the outputs (TeacherNet always has them).

    Sets the process's TF32 switches off, for both cuDNN convolutions and
    matrix products: the float32 mode is then exact float32, and the bf16
    mode's fp32 products of bf16-rounded operands stay exact.
    """
    com = (com or "").lower()
    if com not in _FUSION and com not in _SINGLE_AGENT and com != "teacher":
        ported = sorted(_FUSION) + list(_SINGLE_AGENT) + ["teacher"]
        raise ValueError(f"unknown or not yet ported --com '{com}' (ported: {ported})")
    if config.compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"compute_dtype must be 'bfloat16' or 'float32', got {config.compute_dtype!r}")
    dev = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if com == "teacher":
        model = TeacherNet(config)
    elif com in _SINGLE_AGENT:
        model = FaFNet(config, kd_flag=kd_flag)
    else:
        model = _FUSION[com](config, layer=layer, kd_flag=kd_flag)
    init_parameters(model, seed)
    return model.to(dev).eval()
