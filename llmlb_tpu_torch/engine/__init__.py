"""Serving engine of the port: counterparts of `llmlb_tpu/engine`."""
