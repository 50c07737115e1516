"""Detection CLIs of the port: ``create_data_det``, ``train_codet``, ``test_codet``.

Run each as ``python -m disconet_tpu_torch.tools.det.<name> ...``; ``main(argv)``
runs it in-process."""
