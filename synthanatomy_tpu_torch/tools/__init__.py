"""Command-line tools of the port (``python -m synthanatomy_tpu_torch.tools.<name>``)."""
