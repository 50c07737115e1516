"""Detection training of the port: train, eval and predict steps."""

from disconet_tpu_torch.training.det_module import (
    batch_to_device,
    create_train_state,
    get_bev,
    make_eval_step,
    make_predict_step,
    make_train_step,
)

__all__ = [
    "batch_to_device",
    "create_train_state",
    "get_bev",
    "make_eval_step",
    "make_predict_step",
    "make_train_step",
]
