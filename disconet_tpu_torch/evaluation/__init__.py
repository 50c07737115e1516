"""Host evaluation of the port: mAP and CLEAR-MOT."""

from disconet_tpu_torch.evaluation.mean_ap import (  # noqa: F401
    average_precision,
    eval_map,
    eval_map_multiclass,
    tpfp_default,
)
from disconet_tpu_torch.evaluation.mot import clear_mot  # noqa: F401
