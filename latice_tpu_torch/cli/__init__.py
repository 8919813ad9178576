"""Command-line entry points of the port (``python -m latice_tpu_torch.cli.serve``)."""
