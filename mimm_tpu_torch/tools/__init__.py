"""Command-line tools of the port (each runs as ``python -m
mimm_tpu_torch.tools.<name>``)."""
