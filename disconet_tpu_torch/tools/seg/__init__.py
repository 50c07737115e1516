"""Segmentation CLIs of the port: ``create_data_seg``, ``train_codet``, ``test_codet``.

Run each as ``python -m disconet_tpu_torch.tools.seg.<name> ...``; ``main(argv)``
runs it in-process."""
