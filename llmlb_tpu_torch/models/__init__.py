"""Model families of the port: counterparts of `llmlb_tpu/models`."""
