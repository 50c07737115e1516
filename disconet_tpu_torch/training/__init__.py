"""Detection training of the port: train, eval and predict steps, the KD
feature cache, device prefetch, metrics logging."""

from disconet_tpu_torch.training.det_module import (
    batch_to_device,
    create_train_state,
    get_bev,
    make_eval_step,
    make_predict_step,
    make_train_step,
    pipeline_one_deep,
    precompute_teacher_feats,
    prefetch_to_device,
    teacher_feat_bytes,
)
from disconet_tpu_torch.training.metrics import AverageMeter, MetricLogger

__all__ = [
    "AverageMeter",
    "MetricLogger",
    "batch_to_device",
    "create_train_state",
    "get_bev",
    "make_eval_step",
    "make_predict_step",
    "make_train_step",
    "pipeline_one_deep",
    "precompute_teacher_feats",
    "prefetch_to_device",
    "teacher_feat_bytes",
]
