"""Command-line entry points of the port (``python -m rnntransducer_tpu_torch.cli.<name>``)."""
