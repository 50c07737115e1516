"""Backbones (STPN, UNet), the fusion core and every ``--com`` model of the
port: DiscoNet, V2VNet, When2com/Who2com, the naive fusions, FaFNet and
TeacherNet."""

from disconet_tpu_torch.models.build import build_model
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

__all__ = [
    "build_model", "DiscoNet", "FaFNet", "TeacherNet", "AgentWiseWeightedFusion", "CatFusion", "MaxFusion",
    "MeanFusion", "SumFusion", "V2VNet", "When2com",
]
