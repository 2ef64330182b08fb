"""Batched grouped LoRA matmul (bgmv): counterpart of `llmlb_tpu/ops/lora.py`.

Multi-LoRA serving keeps every resident adapter's factors stacked in pools
`a [N, IN, R]` / `b [N, R, OUT]` per projection, and each batch row carries
an adapter index. The delta of row i is

    delta_i = (x_i @ a[idx_i]) @ b[idx_i]        # rank-R bottleneck

added to the base projection's output, so a batch that mixes adapters (and
adapter-free rows, which point at the all-zero identity row 0) runs in one
dispatch.

Two entry points over one hand-written kernel (`csrc/lora_bgmv.cu`, a
thread block cluster per (row, tile of positions); one count of
`LAUNCHES["lora_delta"]` per call):

- `lora_delta` returns the fp32 delta [B, T, OUT], the Pallas kernel's
  contract;
- `lora_delta_add` adds it into the projection's output y in place,
  y + delta.to(y.dtype) bit for bit, with no separate cast or add.

Each takes the device of its tensors as the route: CUDA tensors launch the
kernel, CPU tensors take the plain version (`lora_delta_reference`, and
`y + lora_delta_reference(...).to(y.dtype)`), and anything else raises.
There is no switch.

Numerics, as the Pallas kernel's: both products accumulate in fp32, the
rank-R middle stays fp32 (it is not rounded to the model dtype). Row 0
gives exactly +0.0 for finite x, so adapter-free rows are bit-identical to
a LoRA-free forward.

How the kernel cuts the work (`lora_plan`) depends on T, IN, R, OUT and the
dtype alone, never on B: a row gives the same bits alone or in a batch.
"""

from __future__ import annotations

import ctypes

import torch

from llmlb_tpu_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_RANK = 64  # kMaxRank in csrc/lora_bgmv.cu
_TILE_T = 16  # kTileT: positions of the longest tile
_CLUSTER_MAX, _CLUSTER_MIN = 16, 4  # kClusterMax, kClusterMin
_ROW_BLOCKS = 128  # kRowBlocks: blocks one row's call should spread over


def lora_delta_reference(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """Plain version: gather each row's factors, then the two products in
    fp32 (the middle not rounded). Returns [B, T, OUT] fp32."""
    sel = idx.to(device=x.device, dtype=torch.long)
    u = torch.einsum("bti,bir->btr", x.float(), a[sel].float())
    return torch.einsum("btr,bro->bto", u, b[sel].float())


def _tile(t: int) -> int:
    """Positions of a tile: T rounded up to a power of two, at most
    _TILE_T (tile_positions)."""
    return next(p for p in (1, 2, 4, 8, _TILE_T) if t <= p or p == _TILE_T)


def lora_cluster(t: int) -> int:
    """Blocks of one cluster for T positions (cluster_blocks): the power of
    two in [_CLUSTER_MIN, _CLUSTER_MAX] that spreads a lone row's tiles
    over about _ROW_BLOCKS blocks. A function of T alone."""
    tiles = -(-t // _tile(t))
    c = _CLUSTER_MIN
    while c < _CLUSTER_MAX and c * tiles < _ROW_BLOCKS:
        c *= 2
    return c


def lora_plan(t: int, in_dim: int, out_dim: int,
              dtype: torch.dtype = torch.bfloat16) -> dict:
    """How the kernel cuts one row's work (make_plan in csrc/lora_bgmv.cu):
    positions of a tile, blocks of a cluster, and the [lo, hi) bounds of
    each block's IN slice (whole 16-byte copies) and OUT slice (whole
    groups of four columns). A function of the shapes and the dtype; no
    batch size enters it."""
    def ceil(n, m):
        return -(-n // m)

    v = 16 // torch.empty((), dtype=dtype).element_size()
    tt = _tile(t)
    c = lora_cluster(t)
    in_slice = ceil(ceil(in_dim, c), v) * v
    out_slice = ceil(ceil(out_dim, c), 4) * 4

    def bounds(n, size):
        return [(min(n, i * size), min(n, (i + 1) * size)) for i in range(c)]

    return {"tile": tt, "cluster": c, "in": bounds(in_dim, in_slice),
            "out": bounds(out_dim, out_slice)}


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check(name: str, x, a, b, idx, y=None) -> tuple[int, int, int, int, int]:
    """Validate what the kernel takes; returns (B, T, IN, R, OUT). Every
    projection of a LoRA step calls this, so the common case is a few
    comparisons; the message is built only for a refusal."""
    bsz, t, in_dim = x.shape
    n, r = a.shape[0], a.shape[2]
    out_dim = b.shape[2]
    if a.shape != (n, in_dim, r) or b.shape != (n, r, out_dim) \
            or idx.shape != (bsz,) \
            or (y is not None and y.shape != (bsz, t, out_dim)):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, idx "
                         f"{tuple(idx.shape)}"
                         + ("" if y is None else f", y {tuple(y.shape)}"))
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if not 1 <= r <= _MAX_RANK:
        raise ValueError(f"{name}: rank {r} not supported (1..{_MAX_RANK})")
    if in_dim % 8:
        raise ValueError(f"{name}: IN {in_dim} must be a multiple of 8 "
                         "(16-byte copies of x and A)")
    if out_dim % 4:
        raise ValueError(f"{name}: OUT {out_dim} must be a multiple of 4 "
                         "(four columns a thread)")
    dev, dtype = x.device, x.dtype
    for arg, tensor in (("x", x), ("a", a), ("b", b), ("y", y)):
        if tensor is not None and (
                tensor.device != dev or tensor.dtype != dtype
                or not tensor.is_contiguous() or tensor.data_ptr() % 16):
            _refuse(name, arg, tensor, x)
    if idx.device != dev or idx.dtype != torch.int32 \
            or not idx.is_contiguous():
        _refuse(name, "idx", idx, x)
    return bsz, t, in_dim, r, out_dim


def _refuse(name: str, arg: str, tensor: torch.Tensor, x: torch.Tensor):
    """Raise the refusal that names why `arg` cannot reach the kernel."""
    if tensor.device != x.device:
        raise ValueError(f"{name}: {arg} is on {tensor.device}, x on "
                         f"{x.device}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")
    if arg == "idx":
        raise TypeError(f"{name}: idx must be int32, got {tensor.dtype}")
    if tensor.dtype != x.dtype:
        raise TypeError(f"{name}: {arg} is {tensor.dtype}, x is {x.dtype}")
    raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def _route(name: str, x: torch.Tensor) -> bool:
    """True for the CUDA launch, False for the plain version on the CPU."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def _launch(x, a, b, idx, out, y, shape) -> None:
    bsz, t, in_dim, r, out_dim = shape
    build.launch("lora_delta", "llmlb_lora_bgmv", x.device, _ptr(x), _ptr(a),
                 _ptr(b), _ptr(idx), _ptr(out), _ptr(y), bsz, t, in_dim, r,
                 out_dim, lora_cluster(t), _DTYPE_CODES[x.dtype])


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """Per-row LoRA delta. x [B, T, IN]; a [N, IN, R], b [N, R, OUT] in x's
    dtype; idx [B] int32 pool rows (each in [0, N): the kernel does not
    check them, as the paged kernels do not check block tables) ->
    [B, T, OUT] float32."""
    if not _route("lora_delta", x):
        return lora_delta_reference(x, a, b, idx)
    shape = _check("lora_delta", x, a, b, idx)
    out = torch.empty(shape[:2] + shape[4:], dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    _launch(x, a, b, idx, out, None, shape)
    return out


def lora_delta_add(y: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y + lora_delta(x, a, b, idx).to(y.dtype): the delta rounded to y's
    dtype and added in fp32, then rounded once more. y [B, T, OUT] is the
    projection's output in x's dtype. On the card the kernel adds in place
    into y and returns it (one launch, no fp32 delta in device memory); on
    the CPU the plain version returns a new tensor."""
    if not _route("lora_delta_add", x):
        return y + lora_delta_reference(x, a, b, idx).to(y.dtype)
    shape = _check("lora_delta_add", x, a, b, idx, y)
    if y.numel() == 0:
        return y
    _launch(x, a, b, idx, None, y, shape)
    return y
