"""Tracking tools of the port: ``sort`` (SORT over ``test_codet --tracking``
dumps) and ``eval_mot`` (CLEAR-MOT against the dataset's ground truth).

Run each as ``python -m disconet_tpu_torch.tools.track.<name> ...``; ``main(argv)``
runs it in-process."""
