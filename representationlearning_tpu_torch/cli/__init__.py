"""Command-line entry points of the port (``python -m representationlearning_tpu_torch.cli.<name>``)."""
