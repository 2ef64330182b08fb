"""The port's Mixtral entry points against `llmlb_tpu/models/mixtral.py`.

debug-moe-tiny (4 experts, top-2), the reference's init_params carried
across with params_from_numpy, the same numpy inputs from a seed on both
sides, fp32 on the CPU. Both regimes of the reference's rule: exact MoE when
the padded B * T <= 4 * num_experts = 16, capacity dispatch above (with the
capacity of the padded group and padding kept out by token_valid); decode
and verify always exact. Tolerances as tests/test_torch_llama.py: logits
within 1e-4, KV cells at valid positions within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from llmlb_tpu import quant as jquant
from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.models import mixtral as jmixtral
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.models import family_for, llama, mixtral
from llmlb_tpu_torch.quant import quantize_params

PS, PPN, NUM_PAGES = 8, 4, 12
TABLES = np.array([[3, 7, 1, 10], [5, 2, 9, 11]], np.int32)
LOGIT_ATOL, KV_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def models():
    jcfg = jax_preset("debug-moe-tiny")
    jparams = jmixtral.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    cfg = get_preset("debug-moe-tiny")
    return jcfg, np_params, cfg


def _lora_pools(cfg, seed):
    """Attention adapter pools of 3 rows (row 0 the identity), rank 4."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (i, o) in {"wq": (64, 64), "wk": (64, 32), "wv": (64, 32),
                         "wo": (64, 64)}.items():
        a = rng.standard_normal((cfg.num_layers, 3, i, 4)) * 0.1
        b = rng.standard_normal((cfg.num_layers, 3, 4, o)) * 0.1
        a[:, 0] = 0
        b[:, 0] = 0
        out[name + "_lora_a"] = a.astype(np.float32)
        out[name + "_lora_b"] = b.astype(np.float32)
    return out


def _variant(models, variant):
    """(JAX params, port params, int8 pools?, lora_idx) of a variant."""
    jcfg, np_params, cfg = models
    p = dict(np_params)
    lidx = None
    if variant in ("int8", "int8_kv"):
        p = {k: np.asarray(v) for k, v in jquant.quantize_params(p).items()}
    if variant == "lora":
        p.update(_lora_pools(cfg, 3))
        lidx = np.array([2, 1], np.int32)
    return p, params_from_numpy(p, cfg, "cpu"), variant == "int8_kv", lidx


def _cells(ck, jck, rows, lens, atol=KV_ATOL):
    for pool, jpool in ((ck, jck),):
        if isinstance(pool, dict):
            # int8 pools: codes may differ by one step where a value sits on
            # a rounding edge; the dequantized cells agree within a step
            pool = pool["q"].float() * pool["s"][..., None]
            jpool = (np.asarray(jpool["q"]).astype(np.float32)
                     * np.asarray(jpool["s"])[..., None])
            atol = float(np.abs(jpool).max()) / 127 + KV_ATOL
        for b, n in zip(rows, lens):
            for p in range(n):
                page, off = TABLES[b, p // PS], p % PS
                np.testing.assert_allclose(pool[:, page, off].numpy(),
                                           np.asarray(jpool)[:, page, off],
                                           atol=atol)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("variant", ["fp32", "int8", "int8_kv", "lora"])
@pytest.mark.parametrize("rows,t", [(2, 16), (1, 16)])  # 32: dispatch; 16: exact
def test_paged_entry_points_match_jax(models, variant, rows, t):
    jcfg, _, cfg = models
    jp, tp, kv8, lidx = _variant(models, variant)
    rng = np.random.default_rng(rows * 10 + t)
    tables = TABLES[:rows]
    lens = np.array([5, 13], np.int32)[:rows]
    ids = rng.integers(0, 512, size=(rows, t)).astype(np.int32)
    li = None if lidx is None else lidx[:rows]
    tli = None if li is None else torch.from_numpy(li)
    ck, cv = mixtral.init_kv_pages(cfg, NUM_PAGES, PS, "cpu", quantized=kv8)
    jck, jcv = jmixtral.init_kv_pages(jcfg, NUM_PAGES, PS, quantized=kv8)
    logits, ck, cv = mixtral.prefill_into_pages(
        tp, cfg, torch.from_numpy(ids), torch.from_numpy(lens),
        torch.from_numpy(tables), ck, cv, lora_idx=tli)
    jl, jck, jcv = jmixtral.prefill_into_pages(jp, jcfg, ids, lens, tables,
                                               jck, jcv, lora_idx=li)
    _close(logits, jl)
    _cells(ck, jck, range(rows), lens)

    # an extend chunk across a page edge: B * T = 16 (exact) or 32
    chunk = rng.integers(0, 512, size=(rows, t)).astype(np.int32)
    chunk_lens = np.array([10, 3], np.int32)[:rows]
    logits, ck, cv = mixtral.prefill_extend_pages(
        tp, cfg, torch.from_numpy(chunk), torch.from_numpy(chunk_lens),
        torch.from_numpy(lens), torch.from_numpy(tables), ck, cv,
        lora_idx=tli)
    jl, jck, jcv = jmixtral.prefill_extend_pages(
        jp, jcfg, chunk, chunk_lens, lens, tables, jck, jcv, lora_idx=li)
    _close(logits, jl)
    seq = lens + chunk_lens
    _cells(ck, jck, range(rows), seq)

    # a verify of K + 1 = 3 positions (always exact), then decode steps
    ver = rng.integers(0, 512, size=(rows, 3)).astype(np.int32)
    vlens = np.array([3, 2], np.int32)[:rows]
    logits, ck, cv = mixtral.verify_step_paged(
        tp, cfg, torch.from_numpy(ver), torch.from_numpy(vlens),
        torch.from_numpy(seq), torch.from_numpy(tables), ck, cv, window=32,
        lora_idx=tli)
    jl, jck, jcv = jmixtral.verify_step_paged(
        jp, jcfg, ver, vlens, seq, tables, jck, jcv, window=32, lora_idx=li)
    assert logits.shape == (rows, 3, cfg.vocab_size)
    _close(logits, jl)
    seq = seq + vlens
    for step in range(2):
        toks = rng.integers(0, 512, size=(rows,)).astype(np.int32)
        logits, ck, cv = mixtral.decode_step_paged(
            tp, cfg, torch.from_numpy(toks), torch.from_numpy(seq), ck, cv,
            torch.from_numpy(tables), window=32 if step else None,
            lora_idx=tli)
        jl, jck, jcv = jmixtral.decode_step_paged(
            jp, jcfg, toks, seq, jck, jcv, tables,
            window=32 if step else None, lora_idx=li)
        _close(logits, jl)
        seq = seq + 1
        _cells(ck, jck, range(rows), seq)


@pytest.mark.parametrize("variant", ["fp32", "int8", "lora"])
@pytest.mark.parametrize("rows,t", [(2, 16), (1, 16)])
def test_dense_slot_entry_points_match_jax(models, variant, rows, t):
    jcfg, _, cfg = models
    jp, tp, _, lidx = _variant(models, variant)
    rng = np.random.default_rng(100 + rows * 10 + t)
    slots = np.array([2, 0], np.int32)[:rows]
    lens = np.array([5, 13], np.int32)[:rows]
    ids = rng.integers(0, 512, size=(rows, t)).astype(np.int32)
    li = None if lidx is None else lidx[:rows]
    tli = None if li is None else torch.from_numpy(li)
    ck, cv = mixtral.init_kv_cache(cfg, 3, 48, "cpu")
    jck, jcv = jmixtral.init_kv_cache(jcfg, 3, 48)
    logits, ck, cv = mixtral.prefill_into_slots(
        tp, cfg, torch.from_numpy(ids), torch.from_numpy(lens),
        torch.from_numpy(slots).long(), ck, cv, lora_idx=tli)
    jl, jck, jcv = jmixtral.prefill_into_slots(jp, jcfg, ids, lens, slots,
                                               jck, jcv, lora_idx=li)
    _close(logits, jl)
    chunk = rng.integers(0, 512, size=(rows, t)).astype(np.int32)
    chunk_lens = np.array([10, 3], np.int32)[:rows]
    logits, ck, cv = mixtral.prefill_extend_slots(
        tp, cfg, torch.from_numpy(chunk), torch.from_numpy(chunk_lens),
        torch.from_numpy(lens), torch.from_numpy(slots).long(), ck, cv,
        lora_idx=tli)
    jl, jck, jcv = jmixtral.prefill_extend_slots(
        jp, jcfg, chunk, chunk_lens, lens, slots, jck, jcv, lora_idx=li)
    _close(logits, jl)
    for b, n in zip(slots, lens + chunk_lens):
        np.testing.assert_allclose(ck[:, b, :n].numpy(),
                                   np.asarray(jck)[:, b, :n], atol=KV_ATOL)
        np.testing.assert_allclose(cv[:, b, :n].numpy(),
                                   np.asarray(jcv)[:, b, :n], atol=KV_ATOL)
    # every slot in order (the engine's call): verify, then a decode step
    seq = np.zeros(3, np.int32)
    seq[slots] = lens + chunk_lens
    rows_li = None
    if li is not None:
        rows_li = np.zeros(3, np.int32)
        rows_li[slots] = li
    tr = None if rows_li is None else torch.from_numpy(rows_li)
    ver = rng.integers(0, 512, size=(3, 3)).astype(np.int32)
    vlens = np.array([3, 1, 2], np.int32)
    logits, ck, cv = mixtral.verify_step(
        tp, cfg, torch.from_numpy(ver), torch.from_numpy(vlens),
        torch.from_numpy(seq), None, ck, cv, window=48, lora_idx=tr)
    jl, jck, jcv = jmixtral.verify_step(
        jp, jcfg, ver, vlens, seq, np.arange(3, dtype=np.int32), jck, jcv,
        window=48, lora_idx=rows_li)
    _close(logits[slots], np.asarray(jl)[slots])
    seq = seq + vlens
    toks = rng.integers(0, 512, size=(3,)).astype(np.int32)
    logits, ck, cv = mixtral.decode_step(
        tp, cfg, torch.from_numpy(toks), torch.from_numpy(seq), ck, cv,
        window=48, lora_idx=tr)
    jl, jck, jcv = jmixtral.decode_step(jp, jcfg, toks, seq, jck, jcv,
                                        window=48, lora_idx=rows_li)
    _close(logits[slots], np.asarray(jl)[slots])


def test_quantized_experts_equal_jax_codes(models):
    """quantize_params on the expert leaves: codes equal to the reference's
    and scales [L, X, out] within 1e-7 relative, per (layer, expert)."""
    _, np_params, cfg = models
    want = jquant.quantize_params(np_params)
    got = quantize_params(params_from_numpy(np_params, cfg, "cpu"))
    for name in ("we_gate", "we_up", "we_down", "wq", "wo"):
        assert got[name].dtype == torch.int8
        assert np.array_equal(got[name].numpy(), np.asarray(want[name]))
        scale = got[name + "_scale"]
        assert tuple(scale.shape) == np.asarray(want[name + "_scale"]).shape
        np.testing.assert_allclose(scale.numpy(),
                                   np.asarray(want[name + "_scale"]),
                                   rtol=1e-7)
    assert got["router"].dtype == torch.float32  # the router stays


def test_init_params_layout_and_int8_fill():
    """The port's init has the reference's leaves and shapes; filled as
    int8 it gives quantize_params of the model-dtype init, code for code,
    with no model-dtype expert leaf made."""
    import dataclasses

    cfg = dataclasses.replace(get_preset("debug-moe-tiny"),
                              dtype=torch.bfloat16)
    jshapes = {k: v.shape for k, v in jmixtral.init_params(
        jax_preset("debug-moe-tiny"), jax.random.PRNGKey(0)).items()}
    p = mixtral.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == jshapes
    q = mixtral.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            quantize_weights=True)
    want = quantize_params(p)
    assert set(q) == set(want)
    for k in want:
        assert torch.equal(q[k], want[k]), k
    assert q["we_up"].dtype == torch.int8
    assert tuple(q["we_down_scale"].shape) == (2, 4, 64)


def test_family_for():
    assert family_for(get_preset("debug-moe-tiny")) is mixtral
    assert family_for(get_preset("debug-tiny")) is llama
    assert not hasattr(mixtral, "encode")
    with pytest.raises(TypeError):
        family_for(object())
