"""The bf16 tensor-core prefill and extend kernels' contract, on the CPU.

`flash_prefill` and `flash_extend` run in bf16 on the tensor-core block body
(llmlb_tpu_torch/csrc/attention_tc.cuh: 64 query rows, 64-key tiles, head_dim
64 or 128). The kernel itself is held against its plain version on the card
by chip_smoke.py; here the plain versions are held against the Pallas kernels
run in interpret mode IN BF16 on the edges of those tiles: prompt lengths one
below, at and one above a tile, a GQA group that does not divide the 64 rows
(G = 7, as Qwen2.5-0.5B's 14 heads over 2 KV heads), an extend chunk whose
start is not tile-aligned and whose second query tile is all padding. Also
pinned: the bf16 head-dim validator, and that every kernel source file is
part of the build's source hash.

Tolerance: both sides round the probabilities to bf16 before the PV product,
but the Pallas kernel rounds them against its running max of each 64-key
block and the plain version against the row's final max, and both round the
output to bf16: 2^-6 (|pallas| + RMS of its (query, head) row), the limit
chip_smoke.py holds the kernels to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmlb_tpu.ops import pallas_attention as pallas
from llmlb_tpu_torch.kernels import build
from llmlb_tpu_torch.ops import cuda_attention

BF16_REL = 2.0**-6


def _bf16(rng, shape):
    """Normal values rounded to bf16, as numpy float32 (exactly
    representable in both frameworks)."""
    x = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def _assert_within(got: torch.Tensor, want, rows):
    """Every defined element within BF16_REL (|want| + row RMS)."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    for b, n in enumerate(rows):
        w, g = want[b, :n], got[b, :n]
        rms = np.sqrt((w * w).mean(axis=-1, keepdims=True))
        bad = np.abs(g - w) > BF16_REL * (np.abs(w) + rms)
        assert not bad.any(), (
            f"row {b}: {int(bad.sum())} elements outside the limit, max |err| "
            f"{np.abs(g - w).max():.3e}")


@pytest.mark.parametrize("h,kv", [(8, 2), (14, 2)])  # G = 4; G = 7
def test_flash_prefill_reference_matches_pallas_bf16_on_tile_edges(h, kv):
    rng = np.random.default_rng(h)
    lens = np.array([1, 63, 64, 65, 127, 129], np.int32)
    b, t, d = len(lens), 192, 64
    q, k, v = (_bf16(rng, (b, t, n, d)) for n in (h, kv, kv))
    want = pallas.flash_prefill(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                lens, block_q=64, block_k=64, interpret=True)
    got = cuda_attention.flash_prefill_reference(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    _assert_within(got, want, lens)


def test_flash_extend_reference_matches_pallas_bf16_unaligned_start():
    """Row 0: start 37, 50 queries, so its second 64-query tile is all
    padding; row 1: start 100, a full chunk. Neither start is a multiple of
    the 64-key tile."""
    rng = np.random.default_rng(17)
    b, t, h, kv, d, s = 2, 128, 8, 2, 64, 320
    q = _bf16(rng, (b, t, h, d))
    kc, vc = _bf16(rng, (b, s, kv, d)), _bf16(rng, (b, s, kv, d))
    start = np.array([37, 100], np.int32)
    chunk = np.array([50, 128], np.int32)
    want = pallas.flash_extend(*(jnp.asarray(x, jnp.bfloat16) for x in (q, kc, vc)),
                               start, chunk, block_q=64, block_k=64,
                               interpret=True)
    got = cuda_attention.flash_extend_reference(
        *(torch.from_numpy(x).bfloat16() for x in (q, kc, vc)),
        torch.from_numpy(start), torch.from_numpy(chunk))
    _assert_within(got, want, chunk)


@pytest.mark.parametrize("d,ok", [(64, True), (128, True), (16, False),
                                  (32, False), (80, False)])
def test_bf16_head_dim_validator(d, ok):
    """The tensor-core kernels are built for head_dim 64 and 128; any other
    bf16 head_dim raises before a launch, and is sent to no other kernel."""
    if ok:
        cuda_attention.check_tc_head_dim("flash_prefill", d)
    else:
        with pytest.raises(ValueError, match=f"head_dim {d} not supported"):
            cuda_attention.check_tc_head_dim("flash_prefill", d)


def test_every_kernel_source_is_in_the_source_hash(tmp_path, monkeypatch):
    """Every file under csrc/ is a listed source or header, so editing any of
    them (attention_tc.cuh included) changes the hash that names the built
    library and forces a rebuild."""
    on_disk = {p.name for p in build.CSRC_DIR.iterdir() if p.is_file()}
    assert on_disk == set(build.SOURCES) | set(build.HEADERS)
    for name in on_disk:
        (tmp_path / name).write_bytes((build.CSRC_DIR / name).read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build._source_hash()
    for name in build.HEADERS:
        path = tmp_path / name
        text = path.read_bytes()
        path.write_bytes(text + b"\n")
        assert build._source_hash() != before, name
        path.write_bytes(text)
    assert build._source_hash() == before
