"""Backbone, fusion core, DiscoNet, FaFNet and TeacherNet of the port."""

from disconet_tpu_torch.models.build import build_model
from disconet_tpu_torch.models.disco_net import DiscoNet
from disconet_tpu_torch.models.faf_net import FaFNet, TeacherNet

__all__ = ["build_model", "DiscoNet", "FaFNet", "TeacherNet"]
