"""Int8 quantization for weights and KV pages: `--quantize
off|weights|kv|all` (`LLMLB_QUANTIZE`, default off).

- weights: per-output-channel int8 for the projection matrices, stored as
  `{int8 values, float32 <name>_scale}` pairs; each product takes the int8
  operand widened to the activation dtype and scales its fp32 output.
- kv: int8 KV pages. Each pool becomes `{"q": int8 [L, P, PS, K, D],
  "s": float32 [L, P, PS, K]}`, one scale per written (token, head) vector,
  quantized on write by every entry point and dequantized on read by the
  attention kernels through the same block tables.
"""

from llmlb_tpu_torch.quant.core import (
    KV_SCALE_DTYPE,
    SCALE_SUFFIX,
    WEIGHT_QUANT_NAMES,
    QuantConfig,
    dequantize_channelwise,
    dequantize_kv,
    kv_cell_bytes,
    parse_quant_mode,
    quantize_channelwise,
    quantize_kv,
    quantize_params,
)

__all__ = [
    "KV_SCALE_DTYPE",
    "SCALE_SUFFIX",
    "WEIGHT_QUANT_NAMES",
    "QuantConfig",
    "dequantize_channelwise",
    "dequantize_kv",
    "kv_cell_bytes",
    "parse_quant_mode",
    "quantize_channelwise",
    "quantize_kv",
    "quantize_params",
]
