"""Tensor ops of the port: counterparts of `llmlb_tpu/ops`."""
