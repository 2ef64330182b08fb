"""The port's int8 path against the JAX package's, on the CPU.

- Quant core: codes bit for bit and scales equal to `llmlb_tpu.quant`'s,
  exact .5 ties and all-zero groups included; the knob grid of
  tests/quant/test_quant_core.py.
- Plain versions of the two int8 kernels against the Pallas quant kernels in
  interpret mode, over tests/test_torch_attention.py's shape grids: fp32
  inputs, ATOL 1e-5 (both dequantize exactly in fp32; online vs two-pass
  softmax in another order); a bf16 case within one bf16 step of O(1)
  outputs (1e-2), since both round the dequantized cells and the
  probabilities to bf16.
- The paged Llama entry points with int8 pools and int8 weights carried
  across from JAX: logits within 1e-4 (as tests/test_torch_llama.py), pool
  codes equal, scales within 1e-6.
- params_from_numpy carries a quantized pytree across exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmlb_tpu import quant as jquant
from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.models import llama as jllama
from llmlb_tpu.ops import attention as jattention
from llmlb_tpu.ops import pallas_attention as pallas
from llmlb_tpu_torch import quant
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.models import llama
from llmlb_tpu_torch.ops import attention, cuda_attention

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------------ quant core


def _kv_with_ties(rng):
    """Vectors whose x / scale lands exactly on .5 (absmax 127 makes the
    scale exactly 1), all-zero vectors, and ordinary normals."""
    kv = (rng.normal(size=(3, 5, 4, 16)) * 2).astype(np.float32)
    kv[0, 0, 0] = 0.0
    kv[1, 2, 3] = 0.0
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 63.5, -63.5,
                     126.5, -126.5, 3.5, 4.5, 0.0, -127.0, 5.5], np.float32)
    kv[2, 1, 0] = ties
    kv[2, 1, 1] = ties[::-1]
    return kv


@pytest.mark.parametrize("src", ["numpy", "torch"])
def test_quantize_kv_codes_and_scales_equal_jax(src):
    kv = _kv_with_ties(np.random.default_rng(0))
    jq, js = jquant.quantize_kv(jnp.asarray(kv))
    q, s = quant.quantize_kv(kv if src == "numpy" else torch.from_numpy(kv))
    q, s = np.asarray(q), np.asarray(s)
    np.testing.assert_array_equal(q, np.asarray(jq))
    np.testing.assert_array_equal(s, np.asarray(js))
    assert q.dtype == np.int8 and s.dtype == np.float32
    # the ties round half to even, as jnp.round does
    assert q[2, 1, 0].tolist()[:7] == [127, 0, 2, 2, 0, -2, -2]
    assert not q[0, 0, 0].any()


def test_quantize_channelwise_and_params_equal_jax():
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(2, 24, 40)) * 0.1).astype(np.float32)
    w[0, :, 3] = 0.0  # an all-zero output channel
    w[1, :, 5] = np.linspace(-127, 127, 24) / 127 * 0.5  # exact grid values
    jq, js = jquant.quantize_channelwise(jnp.asarray(w))
    q, s = quant.quantize_channelwise(torch.from_numpy(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = quant.dequantize_channelwise(q, s)
    np.testing.assert_allclose(back.numpy(), np.asarray(
        jquant.dequantize_channelwise(jq, js)), atol=0)

    jparams = {k: np.asarray(v) for k, v in jllama.init_params(
        jax_preset("debug-tiny"), jax.random.PRNGKey(0)).items()}
    want = jquant.quantize_params(jparams)
    got = quant.quantize_params(jparams)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]), err_msg=name)
    # idempotent: an already-quantized pytree passes through
    again = quant.quantize_params(got)
    assert all(again[k] is got[k] for k in got)


@pytest.mark.parametrize("mode,weights,kv", [
    (None, False, False), ("off", False, False), ("0", False, False),
    ("weights", True, False), ("kv", False, True), ("all", True, True),
    ("ALL", True, True),
])
def test_parse_quant_mode(mode, weights, kv, monkeypatch):
    monkeypatch.delenv("LLMLB_QUANTIZE", raising=False)
    qc = quant.parse_quant_mode(mode)
    want = jquant.parse_quant_mode(mode)
    assert (qc.weights, qc.kv) == (weights, kv) == (want.weights, want.kv)
    assert qc.mode == want.mode


def test_parse_quant_mode_env_and_typos(monkeypatch):
    monkeypatch.setenv("LLMLB_QUANTIZE", "kv")
    assert quant.parse_quant_mode(None).mode == "kv"
    monkeypatch.delenv("LLMLB_QUANTIZE")
    assert quant.parse_quant_mode(None).mode == "off"
    with pytest.raises(ValueError):
        quant.parse_quant_mode("int8")
    for d in (16, 64, 128):
        for q in (False, True):
            assert quant.kv_cell_bytes(d, q, 2) == jquant.kv_cell_bytes(d, q, 2)


# ----------------------------------------------------- kernels' plain versions


def _qpool(rng, b, kv, d, ps, ppn):
    """Random int8 pools (quantized normals) plus per-row tables of
    DISTINCT scattered pages (page 0 reserved as the trash page)."""
    num_pages = b * ppn * 2 + 1
    kq, ks = jquant.quantize_kv(
        rng.normal(size=(num_pages, ps, kv, d)).astype(np.float32))
    vq, vs = jquant.quantize_kv(
        rng.normal(size=(num_pages, ps, kv, d)).astype(np.float32))
    perm = rng.permutation(np.arange(1, num_pages))[: b * ppn]
    return (kq, ks, vq, vs), perm.reshape(b, ppn).astype(np.int32)


def _tt(pools):
    return [_t(x) for x in pools]


@pytest.mark.parametrize(
    "b,h,kv,d,ps,ppn,pages",
    [
        (2, 8, 8, 32, 16, 4, None),  # G=1
        (3, 8, 4, 16, 32, 3, None),  # G=2
        (2, 8, 2, 16, 16, 4, 2),     # G=4, pages bound
        (3, 4, 1, 32, 8, 5, 3),      # MQA, pages bound, small pages
    ],
)
def test_paged_flash_decode_quant_reference_matches_pallas(b, h, kv, d, ps,
                                                           ppn, pages):
    rng = np.random.default_rng(ps * 100 + ppn + 1)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    pools, tables = _qpool(rng, b, kv, d, ps, ppn)
    sweep = ppn if pages is None else pages
    lens = rng.integers(1, sweep * ps + 1, size=(b,)).astype(np.int32)
    lens[0] = ps
    lens[-1] = sweep * ps
    want = pallas.paged_flash_decode_quant(q, *pools, tables, lens,
                                           pages=pages, interpret=True)
    got = cuda_attention.paged_flash_decode_quant(
        _t(q), *_tt(pools), _t(tables), _t(lens), pages=pages)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_paged_flash_decode_quant_reference_rows_past_the_bound():
    """Rows longer than the swept pages: the same garbage on both sides
    (attention over the swept pages only)."""
    rng = np.random.default_rng(7)
    b, h, kv, d, ps, ppn = 2, 4, 2, 16, 8, 4
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    pools, tables = _qpool(rng, b, kv, d, ps, ppn)
    lens = np.array([3 * ps + 2, ppn * ps], np.int32)
    want = pallas.paged_flash_decode_quant(q, *pools, tables, lens, pages=2,
                                           interpret=True)
    got = cuda_attention.paged_flash_decode_quant_reference(
        _t(q), *_tt(pools), _t(tables), _t(lens), pages=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize(
    "b,t,h,kv,d,ps,ppn,block_q",
    [
        (2, 16, 8, 8, 32, 16, 4, 16),  # G=1
        (2, 12, 8, 4, 16, 8, 5, 4),    # G=2, chunk crosses pages
        (2, 8, 8, 2, 16, 32, 2, 4),    # G=4
        (1, 12, 4, 1, 32, 16, 3, 8),   # MQA, ragged T
    ],
)
def test_paged_flash_extend_quant_reference_matches_pallas(b, t, h, kv, d, ps,
                                                           ppn, block_q):
    rng = np.random.default_rng(t * 100 + ps + 1)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    pools, tables = _qpool(rng, b, kv, d, ps, ppn)
    start = rng.integers(0, ps * ppn - t, size=(b,)).astype(np.int32)
    chunk_lens = rng.integers(1, t + 1, size=(b,)).astype(np.int32)
    want = pallas.paged_flash_extend_quant(q, *pools, tables, start,
                                           chunk_lens, block_q=block_q,
                                           interpret=True)
    got = cuda_attention.paged_flash_extend_quant(
        _t(q), *_tt(pools), _t(tables), _t(start), _t(chunk_lens))
    for bi in range(b):
        n = chunk_lens[bi]
        np.testing.assert_allclose(got[bi, :n].numpy(),
                                   np.asarray(want)[bi, :n], atol=ATOL)


def test_bf16_quant_reference_rounds_like_pallas():
    """bf16 q: both sides round the dequantized cells and the
    probabilities to bf16; tolerance one bf16 step of O(1) outputs."""
    rng = np.random.default_rng(3)
    b, h, kv, d, ps, ppn = 2, 8, 2, 32, 16, 3
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    pools, tables = _qpool(rng, b, kv, d, ps, ppn)
    lens = np.array([20, 48], np.int32)
    want = pallas.paged_flash_decode_quant(
        jnp.asarray(q, jnp.bfloat16), *pools, tables, lens, interpret=True)
    got = cuda_attention.paged_flash_decode_quant_reference(
        _t(q).bfloat16(), *_tt(pools), _t(tables), _t(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=1e-2)
    # the cells are rounded to bf16 before the dot: the same gather, exactly
    kq, ks = pools[0], pools[1]
    deq = cuda_attention.gather_kv_pages({"q": _t(kq), "s": _t(ks)},
                                         _t(tables), torch.bfloat16)
    jdeq = jattention.gather_kv_pages({"q": kq, "s": ks}, tables,
                                      dtype=jnp.bfloat16)
    np.testing.assert_array_equal(deq.float().numpy(),
                                  np.asarray(jdeq.astype(jnp.float32)))


def test_public_functions_route_int8_pools_on_cpu():
    """ops/attention.py sends {"q","s"} pools to the quant wrappers, which
    on CPU tensors match the reference's ops/attention.py on defined rows
    and launch no kernel."""
    cuda_attention.reset_launch_counts()
    rng = np.random.default_rng(5)
    b, t, h, kv, d, ps, ppn = 2, 12, 8, 2, 16, 8, 4
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    (kq, ks, vq, vs), tables = _qpool(rng, b, kv, d, ps, ppn)
    tk, tv = {"q": _t(kq), "s": _t(ks)}, {"q": _t(vq), "s": _t(vs)}
    jk, jv = {"q": kq, "s": ks}, {"q": vq, "s": vs}
    kv_lens = np.array([9, 30], np.int32)
    got = attention.paged_attention_decode(_t(q[:, :1]), tk, tv, _t(tables),
                                           _t(kv_lens))
    want = jattention.paged_attention_decode(q[:, :1], jk, jv, tables,
                                             kv_lens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    start = np.array([3, 17], np.int32)
    chunk = np.array([12, 5], np.int32)
    pos = start[:, None] + np.arange(t, dtype=np.int32)[None, :]
    got = attention.paged_attention_extend(_t(q), tk, tv, _t(tables), _t(pos),
                                           _t(chunk))
    want = jattention.paged_attention_extend(q, jk, jv, tables, pos, chunk)
    for bi in range(b):
        np.testing.assert_allclose(got[bi, :chunk[bi]].numpy(),
                                   np.asarray(want)[bi, :chunk[bi]], atol=ATOL)
    assert all(n == 0 for n in cuda_attention.LAUNCHES.values())


def test_quant_wrappers_refuse_other_devices():
    q = torch.empty((1, 4, 16), device="meta")
    pool = torch.empty((2, 8, 2, 16), dtype=torch.int8, device="meta")
    scales = torch.empty((2, 8, 2), device="meta")
    ints = torch.empty((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_attention.paged_flash_decode_quant(q, pool, scales, pool, scales,
                                                ints, ints[:, 0])


# ------------------------------------------------------------- Llama entry points


PS, PPN, NUM_PAGES = 8, 4, 12
TABLES = np.array([[3, 7, 1, 10], [5, 2, 9, 0]], np.int32)


@pytest.fixture(scope="module")
def qmodels():
    """The reference's debug-tiny weights quantized by the JAX package, on
    both sides."""
    jcfg = jax_preset("debug-tiny")
    np_params = jquant.quantize_params(
        {k: np.asarray(v) for k, v in
         jllama.init_params(jcfg, jax.random.PRNGKey(0)).items()})
    cfg = get_preset("debug-tiny")
    return jcfg, np_params, cfg, params_from_numpy(np_params, cfg, "cpu")


def _assert_qcells(pools, jpools, lens):
    """Codes equal and scales within 1e-6 at every valid cell."""
    for pool, jpool in zip(pools, jpools):
        for b, n in enumerate(lens):
            for p in range(n):
                page, off = TABLES[b, p // PS], p % PS
                np.testing.assert_array_equal(
                    pool["q"][:, page, off].numpy(),
                    np.asarray(jpool["q"])[:, page, off])
                np.testing.assert_allclose(
                    pool["s"][:, page, off].numpy(),
                    np.asarray(jpool["s"])[:, page, off], atol=1e-6)


def test_int8_entry_points_match_jax(qmodels):
    """prefill, a chunk across a page boundary, then decode steps (some
    under a window bound), on int8 pools with int8 weights."""
    jcfg, np_params, cfg, params = qmodels
    assert params["wq"].dtype == torch.int8
    assert params["wq_scale"].dtype == torch.float32
    rng = np.random.default_rng(0)
    lens = np.array([5, 13], np.int32)
    ids = rng.integers(0, 512, size=(2, 16)).astype(np.int32)
    ck, cv = llama.init_kv_pages(cfg, NUM_PAGES, PS, "cpu", quantized=True)
    jck, jcv = jllama.init_kv_pages(jcfg, NUM_PAGES, PS, quantized=True)
    assert ck["q"].dtype == torch.int8 and ck["s"].shape == (2, NUM_PAGES, PS, 4)
    logits, ck, cv = llama.prefill_into_pages(
        params, cfg, _t(ids), _t(lens), _t(TABLES), ck, cv)
    jlogits, jck, jcv = jllama.prefill_into_pages(
        np_params, jcfg, ids, lens, TABLES, jck, jcv)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4)
    _assert_qcells((ck, cv), (jck, jcv), lens)

    chunk = rng.integers(0, 512, size=(2, 16)).astype(np.int32)
    chunk_lens = np.array([10, 3], np.int32)
    logits, ck, cv = llama.prefill_extend_pages(
        params, cfg, _t(chunk), _t(chunk_lens), _t(lens), _t(TABLES), ck, cv)
    jlogits, jck, jcv = jllama.prefill_extend_pages(
        np_params, jcfg, chunk, chunk_lens, lens, TABLES, jck, jcv)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4)
    seq = lens + chunk_lens
    _assert_qcells((ck, cv), (jck, jcv), seq)

    for step in range(3):
        toks = rng.integers(0, 512, size=(2,)).astype(np.int32)
        window = 24 if step < 2 else None
        logits, ck, cv = llama.decode_step_paged(
            params, cfg, _t(toks), _t(seq), ck, cv, _t(TABLES), window=window)
        jlogits, jck, jcv = jllama.decode_step_paged(
            np_params, jcfg, toks, seq, jck, jcv, TABLES, window=window)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4)
        seq = seq + 1
        _assert_qcells((ck, cv), (jck, jcv), seq)


def test_int8_weight_without_scale_raises(qmodels):
    _, _, cfg, params = qmodels
    lp = llama._layer(params, cfg, 0)
    assert "wq_scale" in lp
    del lp["wq_scale"]
    with pytest.raises(TypeError, match="wq_scale"):
        llama._proj(lp, "wq", torch.zeros((1, 1, cfg.hidden_size)))


def test_params_from_numpy_carries_a_quantized_pytree_exactly(qmodels):
    _, np_params, cfg, params = qmodels
    assert sorted(params) == sorted(np_params)
    for name, arr in np_params.items():
        t = params[name]
        if name in quant.WEIGHT_QUANT_NAMES or name.endswith("_scale"):
            assert t.dtype == (torch.float32 if name.endswith("_scale")
                               else torch.int8), name
            np.testing.assert_array_equal(t.numpy(), arr, err_msg=name)
    assert sorted(llama.param_shapes(cfg, ("wq", "wd"))) == sorted(
        list(llama.param_shapes(cfg)) + ["wq_scale", "wd_scale"])
    assert llama.param_shapes(cfg, ("wd",))["wd_scale"][0] == (
        cfg.num_layers, cfg.hidden_size)
    bad = dict(np_params)
    del bad["wq_scale"]
    with pytest.raises(ValueError, match="without its wq_scale"):
        params_from_numpy(bad, cfg, "cpu")
    bad = dict(np_params)
    bad["wq"] = bad["wq"].astype(np.float32)
    with pytest.raises(ValueError, match="not int8"):
        params_from_numpy(bad, cfg, "cpu")


def test_profile_step_rehearses_int8_on_cpu(capsys):
    """The card profiler's int8 dispatches run end to end on the CPU at
    debug-tiny size and report no timing there (seven, the two decode
    bursts among them, which run eagerly on the CPU)."""
    from llmlb_tpu_torch import profile_step

    assert profile_step.main(["--device", "cpu", "--quantize", "all"]) == 0
    out = capsys.readouterr().out
    assert out.count("rehearsal on cpu:") == 7
    assert "wall_ms" not in out
