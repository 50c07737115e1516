"""Host evaluation of the port: mAP."""

from disconet_tpu_torch.evaluation.mean_ap import (  # noqa: F401
    average_precision,
    eval_map,
    eval_map_multiclass,
    tpfp_default,
)
