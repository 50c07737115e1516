"""Backbones (STPN, UNet), the fusion core and every ``--com`` model of the
port: DiscoNet, V2VNet, When2com/Who2com, the naive fusions, FaFNet and
TeacherNet."""

from disconet_tpu_torch.models.backbone import STPN, ConvBNRelu, DetectionHeads
from disconet_tpu_torch.models.base import (
    IntermediateFusionModel,
    agents_to_batch,
    batch_to_agents,
    warp_all_pairs,
)
from disconet_tpu_torch.models.build import build_model
from disconet_tpu_torch.models.disco_net import DiscoNet, PixelWeightedFusion
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
    "STPN", "ConvBNRelu", "DetectionHeads", "IntermediateFusionModel", "agents_to_batch", "batch_to_agents",
    "warp_all_pairs", "build_model", "DiscoNet", "PixelWeightedFusion", "FaFNet", "TeacherNet",
    "AgentWiseWeightedFusion", "CatFusion", "MaxFusion", "MeanFusion", "SumFusion", "V2VNet", "When2com",
]
