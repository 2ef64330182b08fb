"""PyTorch/CUDA port of the llmlb_tpu serving engine.

The JAX package `llmlb_tpu` is the reference this package is held against;
nothing here imports it (or JAX). Module names mirror the reference so each
counterpart is easy to find: `ops/` (norms, rope, attention, sampling, and the
hand-written Hopper kernels behind `ops/cuda_attention.py`), `models/llama.py`,
and `engine/` (paging, tokenizer, presets, scheduler, service, HTTP server).

Entry points run on the CUDA card unless the caller asks for the CPU
(`device="cpu"`), which the tests do; see `device.resolve_device`.
"""

__version__ = "0.1.0"
