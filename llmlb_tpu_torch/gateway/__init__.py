"""The port's gateway: the reference gateway (llmlb_tpu/gateway/) on the
Python standard library, at one worker or several (`--workers N`: forked
workers on one SO_REUSEPORT port, their routing state gossiped).

Module names follow the reference, so each module's counterpart is found by
name. `http` is new: the part of aiohttp the reference is written against,
on asyncio streams, so the gateway needs no package beyond the standard
library. The router core, the SSE scanner and the audit hash chain run on
the port's native library (llmlb_tpu_torch/native/) when it is built, on
their Python twins otherwise. Entry point:
`python -m llmlb_tpu_torch.gateway.server serve`.
"""
