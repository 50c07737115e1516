"""Box codec, voxelizer, rotated IoU, NMS, late fusion, pose warp and block-out conv rewrites of the port."""

from disconet_tpu_torch.ops.nms import (  # noqa: F401
    foreground_scores,
    rotated_nms,
    rotated_nms_decode,
)
