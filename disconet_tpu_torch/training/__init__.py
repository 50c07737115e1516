"""Training of the port: the detection and segmentation train, eval and
predict steps, the KD feature cache, device prefetch, metrics logging, and
the checkpoints (``disconet_tpu_torch.checkpoint``)."""

from disconet_tpu_torch.checkpoint import CheckpointIO, load_pth, restore_or_die, save_pth

from disconet_tpu_torch.training.det_module import (
    batch_to_device,
    create_train_state,
    get_bev,
    make_eval_step,
    make_predict_step,
    make_train_step,
    make_train_step_multi,
    pipeline_one_deep,
    precompute_teacher_feats,
    prefetch_to_device,
    stack_host_batches,
    teacher_feat_bytes,
)
from disconet_tpu_torch.training.metrics import AverageMeter, MetricLogger
from disconet_tpu_torch.training.seg_module import (
    create_seg_train_state,
    iou_per_class,
    make_seg_predict_step,
    make_seg_train_step,
    make_seg_train_step_multi,
)

__all__ = [
    "AverageMeter",
    "CheckpointIO",
    "MetricLogger",
    "batch_to_device",
    "create_seg_train_state",
    "create_train_state",
    "get_bev",
    "iou_per_class",
    "load_pth",
    "make_eval_step",
    "make_predict_step",
    "make_seg_predict_step",
    "make_seg_train_step",
    "make_seg_train_step_multi",
    "make_train_step",
    "make_train_step_multi",
    "pipeline_one_deep",
    "precompute_teacher_feats",
    "prefetch_to_device",
    "restore_or_die",
    "save_pth",
    "stack_host_batches",
    "teacher_feat_bytes",
]
