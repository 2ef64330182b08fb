"""Batched grouped LoRA matmul (bgmv): counterpart of `llmlb_tpu/ops/lora.py`.

Multi-LoRA serving keeps every resident adapter's factors stacked in pools
`a [N, IN, R]` / `b [N, R, OUT]` per projection, and each batch row carries
an adapter index. The delta of row i is

    delta_i = (x_i @ a[idx_i]) @ b[idx_i]        # rank-R bottleneck

added to the base projection's output, so a batch that mixes adapters (and
adapter-free rows, which point at the all-zero identity row 0) runs in one
dispatch.

`lora_delta` takes the device of its tensors as the route: CUDA tensors
launch the hand-written kernel `csrc/lora_bgmv.cu` (one count of
`LAUNCHES["lora_delta"]`), CPU tensors take `lora_delta_reference`, and
anything else raises. There is no switch.

Numerics, as the Pallas kernel's: both products accumulate in fp32, the
rank-R middle stays fp32 (it is not rounded to the model dtype), and the
delta is returned in fp32 [B, T, OUT]; the caller rounds it and adds it to
the base output. Row 0 gives exactly +0.0, so adapter-free rows are
bit-identical to a LoRA-free forward.
"""

from __future__ import annotations

import ctypes

import torch

from llmlb_tpu_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_RANK = 64  # kMaxRank in csrc/lora_bgmv.cu
_CHUNK = 128  # kChunk: IN elements a shrink block stages per step
_SHRINK_T = 32  # kShrinkT: positions per shrink block
_TARGET_BLOCKS = 128  # shrink blocks per batch row worth splitting IN for


def lora_delta_reference(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """Plain version: gather each row's factors, then the two products in
    fp32 (the middle not rounded). Returns [B, T, OUT] fp32."""
    sel = idx.to(device=x.device, dtype=torch.long)
    u = torch.einsum("bti,bir->btr", x.float(), a[sel].float())
    return torch.einsum("btr,bro->bto", u, b[sel].float())


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def lora_splits(in_dim: int, t: int) -> int:
    """How many blocks share one row's IN in the shrink: enough to give a
    decode row (T = 1) about _TARGET_BLOCKS blocks, none for a long T. A
    function of IN and T alone, so a row's sums are the same whatever
    shares its batch."""
    tiles = -(-t // _SHRINK_T)
    return max(1, min(-(-in_dim // _CHUNK), _TARGET_BLOCKS // tiles))


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """Per-row LoRA delta. x [B, T, IN]; a [N, IN, R], b [N, R, OUT] in x's
    dtype; idx [B] int32 pool rows (each in [0, N): the kernel does not
    check them, as the paged kernels do not check block tables) ->
    [B, T, OUT] float32."""
    if x.device.type == "cpu":
        return lora_delta_reference(x, a, b, idx)
    if x.device.type != "cuda":
        raise ValueError(f"lora_delta: unsupported device {x.device}")
    bsz, t, in_dim = x.shape
    n, r = a.shape[0], a.shape[2]
    out_dim = b.shape[2]
    if a.shape != (n, in_dim, r) or b.shape != (n, r, out_dim) \
            or idx.shape != (bsz,):
        raise ValueError(f"lora_delta: shapes x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, idx "
                         f"{tuple(idx.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"lora_delta: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if not 1 <= r <= _MAX_RANK:
        raise ValueError(f"lora_delta: rank {r} not supported (1..{_MAX_RANK})")
    if in_dim % 8:
        raise ValueError(f"lora_delta: IN {in_dim} must be a multiple of 8 "
                         "(16-byte loads of x and A)")
    for arg, tensor in (("x", x), ("a", a), ("b", b), ("idx", idx)):
        if tensor.device != x.device:
            raise ValueError(f"lora_delta: {arg} is on {tensor.device}, x on "
                             f"{x.device}")
        if not tensor.is_contiguous():
            raise ValueError(f"lora_delta: {arg} must be contiguous")
    for arg, tensor in (("a", a), ("b", b)):
        if tensor.dtype != x.dtype:
            raise TypeError(f"lora_delta: {arg} is {tensor.dtype}, x is "
                            f"{x.dtype}")
    for arg, tensor in (("x", x), ("a", a)):
        if tensor.data_ptr() % 16:
            raise ValueError(f"lora_delta: {arg} must be 16-byte aligned")
    if idx.dtype != torch.int32:
        raise TypeError(f"lora_delta: idx must be int32, got {idx.dtype}")
    out = torch.empty((bsz, t, out_dim), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    splits = lora_splits(in_dim, t)
    u = torch.empty(bsz * t * splits * r, dtype=torch.float32, device=x.device)
    build.launch("lora_delta", "llmlb_lora_bgmv", x.device, _ptr(x), _ptr(a),
                 _ptr(b), _ptr(idx), _ptr(u), _ptr(out), bsz, t, in_dim, r,
                 out_dim, splits, _DTYPE_CODES[x.dtype])
    return out
