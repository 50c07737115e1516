"""Host-side data of the port: the on-disk schema, synthetic scenes, the
detection and segmentation datasets and batching, and training targets."""
