"""Command-line tools of the port (`python -m llmlb_tpu_torch.tools.<name>`)."""
