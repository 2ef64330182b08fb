"""Speculative decoding's pieces in the port against the JAX package.

- `PromptLookupDrafter` (the port's copy) proposes what the reference's
  proposes over seeded token histories, at every n-gram range and draft
  budget, and `SpecConfig` refuses what the reference refuses.
- `verify_step_paged` and `verify_step` give the JAX functions' logits at
  every chunk position (fp32 [B, K+1, V], atol 1e-4: fp32 through two
  layers and a 512-way vocab projection summed in another order) and the
  same pool cells (1e-5; int8 codes equal and scales 1e-6), on the same
  debug-tiny weights and inputs made from a seed with numpy: ragged chunks
  of 1..K+1 tokens, one crossing a page edge, on fp32 pools, int8 pools
  under int8 weights, and with mixed adapter rows (cells within 1e-4: the
  rank-8 deltas add a sum to each projection); and the debug-tiny model
  cast to bf16 on both sides (bf16 weights and pools): logits within 0.1
  and cells within 5e-2, a few bf16 ulps (two implementations' bf16
  roundings: the prefill before it already differs by 3.4e-2 on these
  inputs, with logits up to 3.5).
- `sample_chunk` draws JAX's `_sample_chunk` ids for seeded and greedy rows
  (the seed folded by global position start + j).
- `verify_body` (the verify graph key's body) on the CPU: its samples,
  accepted counts and advances are those of the unfused pieces, its grammar
  columns those of walking the table through the drafts, and inactive rows
  keep their lengths and last tokens.

The engines' contracts are in tests/test_torch_spec_engine.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import _sample_chunk as jax_sample_chunk
from llmlb_tpu.lora import store as jstore
from llmlb_tpu.lora.manager import LoraManager as JaxLoraManager
from llmlb_tpu.models import llama as jllama
from llmlb_tpu import quant as jquant
from llmlb_tpu.spec import PromptLookupDrafter as JaxDrafter
from llmlb_tpu.spec import SpecConfig as JaxSpecConfig
from llmlb_tpu_torch.engine.decode_graph import BurstState, verify_body
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.models import llama
from llmlb_tpu_torch.ops.grammar import grammar_advance, grammar_bias
from llmlb_tpu_torch.ops.sampling import sample_chunk
from llmlb_tpu_torch.spec import PromptLookupDrafter, SpecConfig

PS, PPN, NUM_PAGES = 8, 4, 12
TABLES = np.array([[3, 7, 1, 10], [5, 2, 9, 0], [4, 6, 8, 11]], np.int32)
K1 = 5  # K + 1, the engine's default verify width
PREFILL = np.array([5, 13, 7], np.int32)
# 1..K+1 tokens a row; row 0 runs positions 5..9 and row 1 13..15 and 16
# (across the page edge at 16)
CHUNKS = np.array([5, 4, 1], np.int32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs, restored after it: its
    engines run many small CPU ops, which intra-op threads only slow down
    (the more so when the suite's workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ drafter


@pytest.mark.parametrize("ngram", [(1, 1), (1, 3), (2, 4)])
def test_drafter_proposals_equal_the_reference(ngram):
    rng = np.random.default_rng(sum(ngram))
    lo, hi = ngram
    for _ in range(12):
        vocab = int(rng.integers(2, 12))  # small vocabularies repeat n-grams
        prompt = rng.integers(0, vocab, size=int(rng.integers(0, 30))).tolist()
        ours = PromptLookupDrafter(prompt, max_ngram=hi, min_ngram=lo)
        ref = JaxDrafter(prompt, max_ngram=hi, min_ngram=lo)
        for t in rng.integers(0, vocab, size=40).tolist():
            for k in (0, 1, 4, 7):
                assert ours.propose(k) == ref.propose(k)
            ours.append(t)
            ref.append(t)
            assert len(ours) == len(ref)


@pytest.mark.parametrize("kw", [dict(max_draft_tokens=0),
                                dict(min_ngram=0), dict(min_ngram=3,
                                                        max_ngram=2)])
def test_spec_config_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError):
        JaxSpecConfig(**kw)
    with pytest.raises(ValueError):
        SpecConfig(**kw)
    assert dataclasses.asdict(SpecConfig()) == dataclasses.asdict(
        JaxSpecConfig())


# ------------------------------------------------------------- verify steps


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_preset("debug-tiny")
    np_params = {k: np.asarray(v) for k, v in
                 jllama.init_params(jcfg, jax.random.PRNGKey(0)).items()}
    return jcfg, np_params, get_preset("debug-tiny")


def _adapter_leaves(tmp_path_factory):
    """Pool leaves (identity, acme, beta) filled from the JAX store."""
    d = str(tmp_path_factory.mktemp("spec_adapters"))
    jcfg = jax_preset("debug-tiny")
    targets = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
    jstore.save_adapter(d, "acme", jcfg, rank=4)
    jstore.save_adapter(d, "beta", jcfg, rank=8, alpha=16.0, targets=targets)
    mgr = JaxLoraManager(jcfg, lora_dir=d, max_adapters=2, rank_cap=8)
    leaves = mgr.init_pool_leaves(np.float32)
    infos = jstore.discover_adapters(d, rank_cap=8, allowed_targets=targets)
    for row, name in ((1, "acme"), (2, "beta")):
        host = jstore.load_adapter_tensors(infos[name], jcfg, pool_rank=8,
                                           dtype=np.float32)
        for tgt, (a, b) in host.items():
            leaves[tgt + "_lora_a"][:, row] = a
            leaves[tgt + "_lora_b"][:, row] = b
    return leaves


def _assert_cells(pools, jpools, lens, atol=1e-5):
    for pool, jpool in zip(pools, jpools):
        for b, n in enumerate(lens):
            for p in range(n):
                page, off = TABLES[b, p // PS], p % PS
                if isinstance(pool, dict):
                    np.testing.assert_array_equal(
                        pool["q"][:, page, off].numpy(),
                        np.asarray(jpool["q"])[:, page, off])
                    np.testing.assert_allclose(
                        pool["s"][:, page, off].numpy(),
                        np.asarray(jpool["s"])[:, page, off], atol=1e-6)
                else:
                    np.testing.assert_allclose(
                        pool[:, page, off].float().numpy(),
                        np.asarray(jpool[:, page, off], np.float32),
                        atol=atol)


def _assert_chunk_logits(logits, jlogits, lens, atol=1e-4):
    assert tuple(logits.shape) == (len(lens), K1, 512)
    assert logits.dtype == torch.float32
    for b, n in enumerate(lens):
        np.testing.assert_allclose(logits[b, :n].numpy(),
                                   np.asarray(jlogits)[b, :n], atol=atol)


@pytest.mark.parametrize("kind", ["model", "bf16", "int8", "lora"])
def test_verify_step_paged_matches_jax(weights, kind, tmp_path_factory):
    """A ragged prefill, then one verify chunk a row (1..K+1 tokens, one
    across a page edge), then a second verify over the first's rows."""
    jcfg, np_params, cfg = weights
    jparams = np_params
    atol = (1e-4, 1e-5)
    if kind == "bf16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
        jparams = {k: jnp.asarray(v, jnp.bfloat16)
                   for k, v in np_params.items()}
        atol = (1e-1, 5e-2)
    if kind == "int8":
        np_params = jparams = jquant.quantize_params(dict(np_params))
    lidx = None
    if kind == "lora":
        np_params = jparams = {**np_params,
                               **_adapter_leaves(tmp_path_factory)}
        lidx = np.array([2, 0, 1], np.int32)
        atol = (1e-4, 1e-4)
    params = params_from_numpy(np_params, cfg, "cpu")
    quantized = kind == "int8"
    ck, cv = llama.init_kv_pages(cfg, NUM_PAGES, PS, "cpu",
                                 quantized=quantized)
    jck, jcv = jllama.init_kv_pages(jcfg, NUM_PAGES, PS, quantized=quantized)
    lkw = {} if lidx is None else {"lora_idx": _t(lidx)}
    jlkw = {} if lidx is None else {"lora_idx": lidx}
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 512, size=(3, 16)).astype(np.int32)
    _, ck, cv = llama.prefill_into_pages(params, cfg, _t(ids), _t(PREFILL),
                                         _t(TABLES), ck, cv, **lkw)
    _, jck, jcv = jllama.prefill_into_pages(jparams, jcfg, ids, PREFILL,
                                            TABLES, jck, jcv, **jlkw)
    start = PREFILL.copy()
    for chunks in (CHUNKS, np.array([2, 5, 3], np.int32)):
        chunk = rng.integers(0, 512, size=(3, K1)).astype(np.int32)
        logits, ck, cv = llama.verify_step_paged(
            params, cfg, _t(chunk), _t(chunks), _t(start), _t(TABLES), ck, cv,
            window=32, **lkw)
        jlogits, jck, jcv = jllama.verify_step_paged(
            jparams, jcfg, chunk, chunks, start, TABLES, jck, jcv,
            window=32, **jlkw)
        _assert_chunk_logits(logits, jlogits, chunks, atol[0])
        start = start + chunks
        _assert_cells((ck, cv), (jck, jcv), start, atol[1])


@pytest.mark.parametrize("lora", [False, True])
def test_verify_step_dense_matches_jax(weights, lora, tmp_path_factory):
    """The dense slot cache: every slot in order (slot_ids=None, the
    engine's form) and the reference's explicit arange give JAX's logits
    and cells."""
    jcfg, np_params, cfg = weights
    lidx = None
    if lora:
        np_params = {**np_params, **_adapter_leaves(tmp_path_factory)}
        lidx = np.array([1, 2, 0], np.int32)
    params = params_from_numpy(np_params, cfg, "cpu")
    lkw = {} if lidx is None else {"lora_idx": _t(lidx)}
    jlkw = {} if lidx is None else {"lora_idx": lidx}
    cap = 32
    catol = 1e-4 if lora else 1e-5
    slots = np.arange(3, dtype=np.int32)
    ck, cv = llama.init_kv_cache(cfg, 3, cap, "cpu")
    jck, jcv = jllama.init_kv_cache(jcfg, 3, cap)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 512, size=(3, 16)).astype(np.int32)
    _, ck, cv = llama.prefill_into_slots(params, cfg, _t(ids), _t(PREFILL),
                                         _t(slots), ck, cv, **lkw)
    _, jck, jcv = jllama.prefill_into_slots(np_params, jcfg, ids, PREFILL,
                                            slots, jck, jcv, **jlkw)
    start = PREFILL.copy()
    for explicit in (False, True):
        chunk = rng.integers(0, 512, size=(3, K1)).astype(np.int32)
        logits, ck, cv = llama.verify_step(
            params, cfg, _t(chunk), _t(CHUNKS), _t(start),
            _t(slots) if explicit else None, ck, cv, window=32, **lkw)
        jlogits, jck, jcv = jllama.verify_step(
            np_params, jcfg, chunk, CHUNKS, start, slots, jck, jcv,
            window=32, **jlkw)
        _assert_chunk_logits(logits, jlogits, CHUNKS)
        start = start + CHUNKS
        for b, n in enumerate(start):
            np.testing.assert_allclose(ck[:, b, :n].numpy(),
                                       np.asarray(jck)[:, b, :n], atol=catol)
            np.testing.assert_allclose(cv[:, b, :n].numpy(),
                                       np.asarray(jcv)[:, b, :n], atol=catol)


# ------------------------------------------------------------------ sampling


def test_sample_chunk_matches_jax_seeded_and_greedy():
    """Every position of a [B, K+1, V] chunk: seeded rows (temperature,
    top-k, top-p, a grammar-like mask) and greedy rows draw JAX's ids."""
    rng = np.random.default_rng(5)
    b, v = 6, 512
    logits = (rng.normal(size=(b, K1, v)) * 3).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.0, 1.3, 0.0, 0.9], np.float32)
    top_ps = np.array([1.0, 0.9, 1.0, 0.8, 1.0, 0.95], np.float32)
    top_ks = np.array([0, 0, 20, 5, 0, 40], np.int32)
    seeds = np.array([-1, 3, 77, 2**31 - 1, 5, 12345], np.int32)
    start = np.array([0, 7, 100, 511, 3, 2**20], np.int32)
    mask = np.where(rng.random((b * K1, v)) < 0.3, -1e9, 0.0).astype(
        np.float32)
    for m in (None, mask):
        want = np.asarray(jax_sample_chunk(
            jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(temps),
            jnp.asarray(top_ps), jnp.asarray(top_ks), jnp.asarray(seeds),
            None if m is None else jnp.asarray(m), jnp.asarray(start)))
        got = sample_chunk(_t(logits), torch.Generator().manual_seed(0),
                           _t(temps), _t(top_ps), _t(top_ks),
                           None if m is None else _t(m),
                           _t(seeds.astype(np.int64)), _t(start))
        assert got.dtype == torch.int32 and tuple(got.shape) == (b, K1)
        # row 0 is greedy and unseeded; every other row is seeded or greedy
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- verify body


def _body_state(weights, b=3, gram=None):
    jcfg, np_params, cfg = weights
    params = params_from_numpy(np_params, cfg, "cpu")
    ck, cv = llama.init_kv_pages(cfg, NUM_PAGES, PS, "cpu")
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 512, size=(b, 16)).astype(np.int32)
    llama.prefill_into_pages(params, cfg, _t(ids), _t(PREFILL), _t(TABLES),
                             ck, cv)
    i32 = dict(dtype=torch.int32)
    vin = torch.zeros(b * (K1 + 3), **i32)
    nk = b * K1
    state = BurstState(
        params=params, cfg=cfg, cache_k=ck, cache_v=cv,
        block_tables=_t(TABLES), last_tokens=_t(ids[:, 0].copy()),
        seq_lens=torch.tensor([40, 41, 42], **i32),
        tokens=torch.zeros((2, b), **i32),
        temps=torch.tensor([0.0, 0.8, 0.0]), top_ps=torch.ones(b),
        top_ks=torch.zeros(b, **i32),
        seeds=torch.tensor([-1, 9, -1], dtype=torch.int64),
        lora_idx=None, nan_rows=torch.zeros((), dtype=torch.int64),
        generator=torch.Generator().manual_seed(0),
        gram_table=gram, gram_state=torch.zeros(b, **i32),
        verify_ids=vin[:nk].view(b, K1), verify_lens=vin[nk:nk + b],
        verify_start=vin[nk + b:nk + 2 * b], verify_active=vin[nk + 2 * b:],
        verify_out=torch.zeros((b, K1 + 2), **i32))
    return state, params, ck, cv


def test_verify_body_equals_its_unfused_pieces(weights):
    """The fused step against the pieces it fuses, on a copy of the pools:
    the splice, the extend's logits, the seeded and greedy samples, the
    accepted count, and an advance of active rows only (row 2 inactive, at
    the capacity's last cell)."""
    state, params, ck, cv = _body_state(weights)
    cfg = weights[2]
    # drafts chosen to match row 0's greedy samples for two positions: run
    # the unfused extend once to learn them
    start = torch.tensor([5, 13, PS * PPN - 1], dtype=torch.int32)
    lens = torch.tensor([5, 3, 1], dtype=torch.int32)
    probe = torch.zeros((3, K1), dtype=torch.int32)
    probe[:, 0] = state.last_tokens
    pools = (ck.clone(), cv.clone())
    logits, _, _ = llama.verify_step_paged(params, cfg, probe, lens, start,
                                           state.block_tables, *pools)
    g0 = int(torch.argmax(logits[0, 0]))
    state.verify_ids.copy_(probe)
    state.verify_ids[0, 1] = g0  # accepted
    state.verify_ids[0, 2:] = 3  # not the model's choice, most likely
    state.verify_lens.copy_(lens)
    state.verify_start.copy_(start)
    state.verify_active.copy_(torch.tensor([1, 1, 0], dtype=torch.int32))
    ids_in = state.verify_ids.clone()
    pools = (ck.clone(), cv.clone())
    want_logits, _, _ = llama.verify_step_paged(
        params, cfg, ids_in, lens, start, state.block_tables, *pools)
    want = sample_chunk(want_logits, torch.Generator().manual_seed(0),
                        state.temps, state.top_ps, state.top_ks, None,
                        state.seeds, start)
    lens_before = state.seq_lens.clone()
    last_before = state.last_tokens.clone()
    verify_body(state, 32, True, "free")
    out = state.verify_out
    assert torch.equal(out[:, 0], last_before)
    assert torch.equal(out[:, 1:K1 + 1], want)
    matches = (want[:, :-1] == ids_in[:, 1:]) & (
        torch.arange(1, K1)[None, :] < lens[:, None])
    accepted = torch.cumprod(matches.int(), 1).sum(1)
    assert torch.equal(out[:, K1 + 1], accepted.int())
    assert int(accepted[0]) >= 1
    assert state.seq_lens.tolist()[:2] == (start + accepted + 1).tolist()[:2]
    assert int(state.seq_lens[2]) == int(lens_before[2])
    assert int(state.last_tokens[2]) == int(last_before[2])
    for b in (0, 1):
        assert int(state.last_tokens[b]) == int(want[b, accepted[b]])


def test_verify_body_grammar_columns_walk_the_table(weights):
    """The grammar key: column j's bias is the table row after drafts 1..j
    (a refused draft keeps the state), so a sample never leaves the
    grammar and a refused draft is never accepted."""
    rng = np.random.default_rng(7)
    v = 512
    table = torch.from_numpy(np.where(rng.random((6, v)) < 0.5,
                                      rng.integers(1, 6, (6, v)), -1)
                             .astype(np.int32))
    table[0] = 0  # the free row
    state, params, ck, cv = _body_state(weights, gram=table)
    start = torch.tensor([5, 13, 7], dtype=torch.int32)
    lens = torch.tensor([5, 5, 1], dtype=torch.int32)
    drafts = torch.from_numpy(rng.integers(0, v, (3, K1)).astype(np.int32))
    state.verify_ids.copy_(drafts)
    state.verify_lens.copy_(lens)
    state.verify_start.copy_(start)
    state.verify_active.fill_(1)
    state.gram_state.copy_(torch.tensor([1, 3, 0], dtype=torch.int32))
    verify_body(state, 32, False, "grammar")
    toks = state.verify_out[:, 1:K1 + 1]
    gs = state.gram_state.clone()
    for j in range(K1):
        allowed = grammar_bias(table, gs) == 0
        picked = allowed[torch.arange(3), toks[:, j].long()]
        assert bool(picked.all()), f"column {j} sampled outside the grammar"
        if j + 1 < K1:
            gs = grammar_advance(table, gs, drafts[:, j + 1])
    # a draft the grammar refuses at its column is never accepted
    acc = state.verify_out[:, K1 + 1]
    gs = state.gram_state.clone()
    for b in range(2):
        s = gs[b:b + 1]
        for j in range(int(acc[b])):
            tok = drafts[b, j + 1]
            assert int(table[int(s), int(tok)]) >= 0
            s = grammar_advance(table, s, drafts[b:b + 1, j + 1])
