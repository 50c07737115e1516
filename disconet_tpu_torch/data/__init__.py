"""Host-side data of the port: the on-disk schema, synthetic scenes, the
detection dataset and batching, and training targets."""
