"""Box codec, voxelizer, V2VNet's float32 3x3 conv, rotated IoU, NMS, losses, late fusion, pose warp and
block-space conv rewrites of the port; the names of the JAX package's
``disconet_tpu.ops`` where the port has them."""

from disconet_tpu_torch.ops.conv3x3 import conv3x3_f32x3, conv3x3_plain  # noqa: F401
from disconet_tpu_torch.ops.boxes import (  # noqa: F401
    box_corners,
    box_corners_np,
    decode_boxes,
    encode_boxes,
    make_anchors,
)
# ``ops.late_fusion`` stays the module (the JAX package binds the name to
# its function): ``ops.late_fusion.late_fusion`` is the function
from disconet_tpu_torch.ops.late_fusion import nms_np, transform_boxes  # noqa: F401
from disconet_tpu_torch.ops.losses import kd_feature_loss, softmax_focal_loss, weighted_smooth_l1  # noqa: F401
from disconet_tpu_torch.ops.nms import (  # noqa: F401
    foreground_scores,
    rotated_nms,
    rotated_nms_decode,
)
from disconet_tpu_torch.ops.rotated_iou import (  # noqa: F401
    rotated_iou_matrix,
    rotated_iou_matrix_np,
    rotated_iou_pairs,
    rotated_iou_pairs_np,
)
from disconet_tpu_torch.ops.voxelize import voxelize_occupy, voxelize_occupy_plain  # noqa: F401
from disconet_tpu_torch.ops.warp import affine_grid, grid_sample, pose_to_affine, warp_features  # noqa: F401
