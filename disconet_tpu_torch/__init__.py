"""PyTorch/CUDA port of disconet_tpu: DiscoNet inference and training on NVIDIA
Hopper, with the data tools and detection CLIs (``tools/det/``).

Plain tensor code is PyTorch; the two kernels the JAX package wrote in Pallas
(the occupancy voxelizer and the rotated-IoU matrix) are hand-written CUDA in
``csrc/``, built at first use. Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""

from disconet_tpu_torch.config import Config, tiny_config
from disconet_tpu_torch.models.build import build_model
from disconet_tpu_torch.ops.boxes import make_anchors
from disconet_tpu_torch.pipeline import example_batch, example_train_batch, predict

__all__ = [
    "Config", "tiny_config", "build_model", "make_anchors", "example_batch", "example_train_batch", "predict",
]
