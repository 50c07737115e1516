"""PyTorch/CUDA port of disconet_tpu: DiscoNet and every other ``--com``
model, detection and segmentation, inference and training (KD, K-step CUDA
graphs, remat, data/agent/spatial parallelism over ``torch.distributed``) on
NVIDIA Hopper, with the data tools and the CLIs (``tools/det/``, ``tools/seg/``,
``tools/track/``) and the quality protocols (``tools/bench_quality.py``,
``tools/bench_seg_matrix.py``).

Plain tensor code is PyTorch; the two kernels the JAX package wrote in Pallas
(the occupancy voxelizer and the rotated-IoU matrix) are hand-written CUDA in
``csrc/``, built at first use. Entry points run on CUDA unless the caller
passes ``device="cpu"``."""

from disconet_tpu_torch.config import Config, ConfigGlobal, tiny_config
from disconet_tpu_torch.models.build import build_model
from disconet_tpu_torch.ops.boxes import make_anchors
from disconet_tpu_torch.pipeline import example_batch, example_train_batch, predict

__all__ = [
    "Config", "ConfigGlobal", "tiny_config", "build_model", "make_anchors", "example_batch", "example_train_batch",
    "predict",
]
