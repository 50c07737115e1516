"""Host-side data preparation of the port: training targets."""
