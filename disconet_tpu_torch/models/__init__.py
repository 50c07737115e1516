"""Backbone, fusion core and DiscoNet of the port."""

from disconet_tpu_torch.models.build import build_model
from disconet_tpu_torch.models.disco_net import DiscoNet

__all__ = ["build_model", "DiscoNet"]
