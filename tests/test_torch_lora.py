"""The port's multi-LoRA serving against the JAX package.

- the bgmv plain version against the Pallas kernel in interpret mode and the
  XLA gather path, over the reference's grid (tests/ops/test_lora_kernel.py);
- the adapter store: files written by either side load to the same pool
  rows, bit for bit; the port's safetensors reader and writer; discovery and
  request parsing on a table of good and bad cases;
- the device pool manager: LRU eviction, pinned adapters, the exhausted
  error;
- the paged entry points with adapter pools and mixed `lora_idx`;
- the paged engine: greedy and seeded streams of a batch mixing two
  adapters and the base model identical to the JAX engine's, at decode
  burst 1 and 4 (one JAX engine, module-scoped); LoRA enabled but unused
  identical to the LoRA-free port engine;
- the HTTP surface: 400s naming `lora`, `/v1/models` adapter entries, and
  the unchanged gateway health parser reading the resident adapters.

All at debug-tiny size in fp32 on the CPU. Tolerances: deltas within 1e-5
(fp32 sums in another order), logits within 1e-4 (as tests/test_torch_llama.py).
"""

import dataclasses
import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.gateway.health import _parse_telemetry
from llmlb_tpu.lora import api as japi
from llmlb_tpu.lora import store as jstore
from llmlb_tpu.lora.manager import LoraManager as JaxLoraManager
from llmlb_tpu.models import llama as jllama
from llmlb_tpu.ops.lora import lora_delta_pallas, lora_delta_xla
from llmlb_tpu_torch.engine import safetensors_io
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import EngineCore, Request, SamplingParams
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.lora import api, store
from llmlb_tpu_torch.lora.manager import LoraManager
from llmlb_tpu_torch.models import llama
from llmlb_tpu_torch.ops import cuda_attention
from llmlb_tpu_torch.ops.lora import lora_delta

ALL = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
CORE_KW = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
               kv_page_size=16, eos_id=-1, seed=0)
PROMPT_LENS = (5, 12, 15, 64, 9)  # 64 > the largest bucket: two chunks
ADAPTER_OF = (None, "acme", "beta", "acme", None)
MAX_TOKENS = 10
SEEDED = [dict(temperature=0.8, top_p=0.9, top_k=0, seed=11),
          dict(temperature=1.0, top_p=1.0, top_k=20, seed=5)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------------ kernel


def _pools(rng, n=4, in_dim=64, r=8, out_dim=96):
    a = (rng.normal(size=(n, in_dim, r)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(n, r, out_dim)) * 0.1).astype(np.float32)
    a[0] = 0.0  # row 0 is the identity adapter
    b[0] = 0.0
    return a, b


@pytest.mark.parametrize("t", [1, 7, 16])  # decode, ragged chunk, prefill
def test_lora_delta_matches_pallas_and_xla(t):
    rng = np.random.default_rng(t)
    a, b = _pools(rng)
    x = rng.normal(size=(5, t, 64)).astype(np.float32)
    idx = np.asarray([0, 1, 3, 1, 2], np.int32)
    got = lora_delta(_t(x), _t(a), _t(b), _t(idx))
    assert got.dtype == torch.float32 and got.shape == (5, t, 96)
    pallas = np.asarray(lora_delta_pallas(x, a, b, idx, interpret=True))
    xla = np.asarray(lora_delta_xla(x, a, b, idx))
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), xla, atol=1e-5, rtol=0)
    assert np.all(got[0].numpy() == 0.0)  # the identity row


def test_identity_row_is_exact_positive_zero():
    rng = np.random.default_rng(2)
    a, b = _pools(rng)
    for dtype in (torch.float32, torch.bfloat16):
        x = _t(rng.normal(size=(3, 4, 64)).astype(np.float32)).to(dtype)
        out = lora_delta(x, _t(a).to(dtype), _t(b).to(dtype),
                         torch.zeros(3, dtype=torch.int32))
        assert torch.equal(out, torch.zeros_like(out))
        assert not torch.signbit(out).any()


def test_lora_delta_refuses_other_devices():
    x = torch.empty((1, 1, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lora_delta(x, torch.empty((2, 8, 4), device="meta"),
                   torch.empty((2, 4, 8), device="meta"),
                   torch.empty(1, device="meta"))


# ------------------------------------------------------------ store and API


@pytest.fixture(scope="module")
def lora_dir(tmp_path_factory):
    """Adapters written by the JAX store: acme (rank 4, attention) and beta
    (rank 8, all seven targets, alpha 16: the scale 2 folds into B)."""
    d = str(tmp_path_factory.mktemp("adapters"))
    cfg = jax_preset("debug-tiny")
    jstore.save_adapter(d, "acme", cfg, rank=4)
    jstore.save_adapter(d, "beta", cfg, rank=8, alpha=16.0, targets=ALL)
    return d


def _jax_info(d, name):
    return jstore.discover_adapters(d, rank_cap=8, allowed_targets=ALL)[name]


def _port_info(d, name):
    return store.discover_adapters(d, rank_cap=8, allowed_targets=ALL)[name]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_written_adapters_load_bit_identical(lora_dir, dtype):
    jdtype = np.dtype(jnp.float32 if dtype == "float32" else jnp.bfloat16)
    for name in ("acme", "beta"):
        want = jstore.load_adapter_tensors(
            _jax_info(lora_dir, name), jax_preset("debug-tiny"), pool_rank=8,
            dtype=jdtype)
        got = store.load_adapter_tensors(
            _port_info(lora_dir, name), get_preset("debug-tiny"), pool_rank=8,
            dtype=getattr(torch, dtype))
        assert sorted(got) == sorted(want)
        for tgt, (a, b) in want.items():
            for g, w in zip(got[tgt], (a, b)):
                assert g.dtype == getattr(torch, dtype)
                # bit for bit: float32 of values that are exact in the dtype
                assert np.array_equal(g.float().numpy(), w.astype(np.float32))


def test_port_written_adapters_load_in_jax(tmp_path, lora_dir):
    """The port's save_adapter draws the reference's values for the same
    (name, seed) and writes a file the JAX store reads to the same rows."""
    d = str(tmp_path)
    store.save_adapter(d, "beta", get_preset("debug-tiny"), rank=8,
                       alpha=16.0, targets=ALL)
    with open(os.path.join(d, "beta", store.CONFIG_FILE)) as f, \
            open(os.path.join(lora_dir, "beta", store.CONFIG_FILE)) as g:
        assert json.load(f) == json.load(g)
    cfg = jax_preset("debug-tiny")
    ours = jstore.load_adapter_tensors(_jax_info(d, "beta"), cfg, pool_rank=8,
                                       dtype=np.float32)
    theirs = jstore.load_adapter_tensors(_jax_info(lora_dir, "beta"), cfg,
                                         pool_rank=8, dtype=np.float32)
    for tgt in ALL:
        for x, y in zip(ours[tgt], theirs[tgt]):
            assert np.array_equal(x, y)


def test_safetensors_bf16_round_trip(tmp_path):
    from safetensors.torch import load_file, save_file

    w = torch.randn((3, 5), generator=torch.Generator().manual_seed(0))
    tensors = {"w_bf16": w.bfloat16(), "w_f32": w, "w_f16": w.half()}
    ours = str(tmp_path / "ours.safetensors")
    safetensors_io.save_file(tensors, ours)
    loaded = load_file(ours)  # the safetensors package reads our file
    for k, v in tensors.items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v)
    theirs = str(tmp_path / "theirs.safetensors")
    save_file(tensors, theirs, metadata={"format": "pt"})
    f = safetensors_io.SafetensorsFile(theirs)  # and we read theirs
    assert sorted(f.keys()) == sorted(tensors)
    for k, v in tensors.items():
        got = f.get_tensor(k)
        assert got.dtype == np.float32 and got.shape == (3, 5)
        assert np.array_equal(got, v.float().numpy())


def test_discover_adapters_agrees_with_jax(tmp_path, lora_dir):
    d = str(tmp_path)
    cfg = get_preset("debug-tiny")
    store.save_adapter(d, "good", cfg, rank=4)
    store.save_adapter(d, "mlp", cfg, rank=4, targets=("wq", "wd"))
    store.save_adapter(d, "big", cfg, rank=32)
    bad = {"badtarget": {"r": 4, "target_modules": ["foo_proj"]},
           "zero": {"r": 0, "target_modules": ["q_proj"]},
           "broken": "{not json"}
    for name, conf in bad.items():
        store.save_adapter(d, name, cfg, rank=4)
        with open(os.path.join(d, name, store.CONFIG_FILE), "w") as f:
            f.write(conf if isinstance(conf, str) else json.dumps(conf))
    store.save_adapter(d, "noconfig", cfg, rank=4)
    os.remove(os.path.join(d, "noconfig", store.CONFIG_FILE))
    os.makedirs(os.path.join(d, "empty"))  # no weights: not an adapter
    for allowed in (ALL, ("wq", "wk", "wv", "wo")):
        want = jstore.discover_adapters(d, rank_cap=16, allowed_targets=allowed)
        got = store.discover_adapters(d, rank_cap=16, allowed_targets=allowed)
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
            {k: dataclasses.asdict(v) for k, v in want.items()}
        assert got["good"].error is None and got["big"].error is not None
    assert "empty" not in got and got["mlp"].error  # attention targets only


BODIES = [
    {"model": "debug-tiny"},
    {"model": "debug-tiny:acme"},
    {"model": "debug-tiny", "lora": "acme"},
    {"model": "debug-tiny:acme", "lora": "acme"},
    {"model": "debug-tiny:acme", "lora": "beta"},
    {"model": "org/model:v1:acme"},
    {"model": "debug-tiny:bad name"},
    {"model": ":acme"},
    {"lora": ""},
    {"lora": 7},
    {"lora": "bad name!"},
    {"lora": "x" * 65},
    {},
]


@pytest.mark.parametrize("body", BODIES)
def test_adapter_from_body_agrees_with_jax(body):
    def outcome(fn):
        try:
            return "ok", fn(dict(body))
        except ValueError as e:
            return "error", str(e)

    assert outcome(api.adapter_from_body) == outcome(japi.adapter_from_body)
    assert api.split_model_adapter(body.get("model")) == \
        japi.split_model_adapter(body.get("model"))


# ------------------------------------------------------------------ manager


def test_manager_lru_eviction_pins_and_exhaustion(tmp_path):
    d = str(tmp_path)
    cfg = get_preset("debug-tiny")
    for name in ("a1", "a2", "a3", "a4"):
        store.save_adapter(d, name, cfg, rank=4)
    mgr = LoraManager(cfg, lora_dir=d, max_adapters=2, rank_cap=4)
    pool = mgr.init_pool_leaves(cfg.dtype, "cpu")
    mgr.attach(pool)
    assert mgr.slot_of(None) == 0
    r1 = mgr.acquire("a1", "t1")
    r2 = mgr.acquire("a2", "t2")
    assert {r1, r2} == {1, 2}
    assert mgr.acquire("a1", "t1") == r1  # idempotent per token
    mgr.release("t1")
    mgr.release("t1")  # idempotent
    # a1 is idle and least recently used: a3 takes its row
    assert mgr.acquire("a3", "t3") == r1
    assert mgr.resident_names() == ["a2", "a3"] and mgr.evictions_total == 1
    # a2 and a3 are pinned: no row for a4, and nothing is evicted
    with pytest.raises(ValueError, match="'lora' adapter pool exhausted"):
        mgr.acquire("a4", "t4")
    assert mgr.resident_names() == ["a2", "a3"]
    with pytest.raises(ValueError, match="'lora' names unknown adapter"):
        mgr.acquire("zz", "t5")
    # the rows hold the adapter's factors; the identity row stays zero
    host = store.load_adapter_tensors(mgr.available["a3"], cfg, pool_rank=4,
                                      dtype=cfg.dtype)
    assert torch.equal(pool["wq_lora_a"][:, r1], host["wq"][0])
    assert torch.equal(pool["wq_lora_b"][:, r1], host["wq"][1])
    assert not pool["wq_lora_a"][:, 0].any() and not pool["wg_lora_a"].any()
    mgr.release("t2")
    mgr.release("t3")
    info = mgr.info()
    assert info["active"] == {} and info["loads_total"] == 3
    assert set(info) == {"enabled", "dir", "max_adapters", "rank_cap",
                         "targets", "available", "resident", "active",
                         "loads_total", "evictions_total"}


# ------------------------------------------------------------ entry points


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jax_preset("debug-tiny"), jax.random.PRNGKey(0))
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


def _pool_leaves(lora_dir):
    """Adapter pool leaves (rank cap 8, rows: identity, acme, beta) filled
    from the JAX store, as numpy."""
    cfg = jax_preset("debug-tiny")
    mgr = JaxLoraManager(cfg, lora_dir=lora_dir, max_adapters=2, rank_cap=8)
    leaves = mgr.init_pool_leaves(np.float32)
    for row, name in ((1, "acme"), (2, "beta")):
        host = jstore.load_adapter_tensors(_jax_info(lora_dir, name), cfg,
                                           pool_rank=8, dtype=np.float32)
        for tgt, (a, b) in host.items():
            leaves[tgt + "_lora_a"][:, row] = a
            leaves[tgt + "_lora_b"][:, row] = b
    return leaves


def test_paged_entry_points_with_adapters_match_jax(weights, lora_dir):
    np_params = {**weights[1], **_pool_leaves(lora_dir)}
    jcfg, cfg = jax_preset("debug-tiny"), get_preset("debug-tiny")
    params = params_from_numpy(np_params, cfg, "cpu")
    tables = np.array([[3, 7, 1, 10], [5, 2, 9, 0]], np.int32)
    lidx = np.array([2, 1], np.int32)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 512, size=(2, 16)).astype(np.int32)
    lens = np.array([5, 13], np.int32)
    ck, cv = llama.init_kv_pages(cfg, 12, 8, "cpu")
    jck, jcv = jllama.init_kv_pages(jcfg, 12, 8)
    logits, ck, cv = llama.prefill_into_pages(
        params, cfg, _t(ids), _t(lens), _t(tables), ck, cv, lora_idx=_t(lidx))
    jlogits, jck, jcv = jllama.prefill_into_pages(
        np_params, jcfg, ids, lens, tables, jck, jcv, lora_idx=lidx)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4)
    chunk = rng.integers(0, 512, size=(2, 16)).astype(np.int32)
    chunk_lens = np.array([10, 3], np.int32)
    logits, ck, cv = llama.prefill_extend_pages(
        params, cfg, _t(chunk), _t(chunk_lens), _t(lens), _t(tables), ck, cv,
        lora_idx=_t(lidx))
    jlogits, jck, jcv = jllama.prefill_extend_pages(
        np_params, jcfg, chunk, chunk_lens, lens, tables, jck, jcv,
        lora_idx=lidx)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4)
    seq = lens + chunk_lens
    for lid in (lidx, np.array([0, 2], np.int32)):
        toks = rng.integers(0, 512, size=(2,)).astype(np.int32)
        logits, ck, cv = llama.decode_step_paged(
            params, cfg, _t(toks), _t(seq), ck, cv, _t(tables), window=24,
            lora_idx=_t(lid))
        jlogits, jck, jcv = jllama.decode_step_paged(
            np_params, jcfg, toks, seq, jck, jcv, tables, window=24,
            lora_idx=lid)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4)
        seq = seq + 1
    # an all-identity batch is the LoRA-free forward, bit for bit
    base = params_from_numpy(weights[1], cfg, "cpu")
    ck0, cv0 = llama.init_kv_pages(cfg, 12, 8, "cpu")
    ck1, cv1 = llama.init_kv_pages(cfg, 12, 8, "cpu")
    plain, _, _ = llama.prefill_into_pages(base, cfg, _t(ids), _t(lens),
                                           _t(tables), ck0, cv0)
    ident, _, _ = llama.prefill_into_pages(
        params, cfg, _t(ids), _t(lens), _t(tables), ck1, cv1,
        lora_idx=torch.zeros(2, dtype=torch.int32))
    assert torch.equal(plain, ident) and torch.equal(ck0, ck1)


# ----------------------------------------------------------------- engines


@pytest.fixture(scope="module")
def requests():
    """(prompt, sampling kwargs, adapter): greedy requests over the
    PROMPT_LENS with ADAPTER_OF, then two seeded ones (acme, base)."""
    rng = np.random.default_rng(21)
    greedy = [(rng.integers(0, 256, size=(n,)).tolist(), {}, name)
              for n, name in zip(PROMPT_LENS, ADAPTER_OF)]
    seeded = [(rng.integers(0, 256, size=(n,)).tolist(), s, name)
              for n, s, name in zip((8, 14), SEEDED, ("acme", None))]
    return greedy + seeded


def _drain(events, timeout=120):
    toks = []
    while True:
        kind, value = events.get(timeout=timeout)
        if kind == "token":
            toks.append(int(value))
        elif kind == "error":
            raise AssertionError(f"engine error: {value}")
        else:
            return toks, value


@pytest.fixture(scope="module")
def jax_streams(weights, lora_dir, requests):
    core = JaxEngineCore(jax_preset("debug-tiny"), weights[0],
                         kv_layout="paged", prefix_cache=False, decode_burst=1,
                         lora_dir=lora_dir, lora_rank_cap=8, **CORE_KW)
    reqs = [core.submit(JaxRequest(prompt_ids=list(p), sampling=JaxSampling(
        max_tokens=MAX_TOKENS, lora=name, **{"temperature": 0.0, **s})))
        for p, s, name in requests]
    core.start()  # everything queued before the loop starts: same groups
    try:
        out = [_drain(r.events) for r in reqs]
        assert core.lora_info()["active"] == {}
        return out
    finally:
        core.stop()


def _run_port(np_params, requests, burst, lora_dir, adapters=True):
    cfg = get_preset("debug-tiny")
    core = EngineCore(cfg, params_from_numpy(np_params, cfg, "cpu"),
                      device="cpu", decode_burst=burst, lora_dir=lora_dir,
                      lora_rank_cap=8, prefix_cache=False, **CORE_KW)
    reqs = [core.submit(Request(prompt_ids=list(p), sampling=SamplingParams(
        max_tokens=MAX_TOKENS, lora=name if adapters else None,
        **{"temperature": 0.0, **s}))) for p, s, name in requests]
    core.start()
    try:
        out = [_drain(r.events) for r in reqs]
        assert core.nan_logit_rows() == 0
        assert core.page_pool.available() == core.page_pool.total
        if core.lora is not None:
            assert core.lora_info()["active"] == {}  # every pin released
        return out
    finally:
        core.stop()


@pytest.mark.parametrize("burst", [1, 4])
def test_mixed_adapter_streams_identical_to_jax_engine(weights, lora_dir,
                                                       requests, jax_streams,
                                                       burst):
    port = _run_port(weights[1], requests, burst, lora_dir)
    assert [r for _t, r in jax_streams] == ["length"] * len(requests)
    assert port == jax_streams
    # the adapters matter: acme's prompt 1 differs from the base model's
    base = _run_port(weights[1], requests[1:2], burst, None, adapters=False)
    assert base[0] != port[1]


def test_lora_enabled_but_unused_is_the_lora_free_engine(weights, lora_dir,
                                                         requests):
    on = _run_port(weights[1], requests, 4, lora_dir, adapters=False)
    off = _run_port(weights[1], requests, 4, None, adapters=False)
    assert on == off


def test_prefix_cache_never_shared_across_adapters(weights, lora_dir):
    """Twin of the reference's test of the same name: the base model and
    two adapters sharing one prompt never share cached KV. Each first use
    of the prompt under a new adapter is a miss, a second use under the
    same adapter a hit with the first use's tokens, and the adapters'
    continuations differ."""
    cfg = get_preset("debug-tiny")
    core = EngineCore(cfg, params_from_numpy(weights[1], cfg, "cpu"),
                      device="cpu", lora_dir=lora_dir, lora_rank_cap=8,
                      min_prefix_len=8, **CORE_KW)
    prompt = list(range(2, 50))  # long enough to cache (align 16)

    def run(name):
        r = core.submit(Request(prompt_ids=prompt, sampling=SamplingParams(
            temperature=0.0, max_tokens=MAX_TOKENS, lora=name)))
        return _drain(r.events)

    core.start()
    try:
        base_1 = run(None)
        assert core.stats().prefix.prefix_hits_total == 0
        assert run(None) == base_1
        assert core.stats().prefix.prefix_hits_total == 1  # warm: base hit
        a_1 = run("acme")
        assert core.stats().prefix.prefix_hits_total == 1, (
            "an adapter request hit the base model's cached prompt KV")
        assert run("acme") == a_1  # same-adapter reuse
        assert core.stats().prefix.prefix_hits_total == 2
        b_1 = run("beta")
        assert core.stats().prefix.prefix_hits_total == 2, (
            "adapter beta hit acme's (or the base model's) cached KV")
        assert b_1 != a_1 and a_1 != base_1
        st = core.stats()
        assert (st.prefix.prefix_misses_total, st.prefix.prefix_insertions_total) == (3, 3)
        # a budget of 2 donors: beta's donation evicted the base model's
        assert st.prefix.prefix_evictions_total == 1
        assert sorted(e.ns for e in core.prefix_cache.entries()) == [
            "acme", "beta"]
        assert core.lora_info()["active"] == {}
    finally:
        core.stop()


def test_engine_lora_info_and_accounting(weights, lora_dir, monkeypatch):
    cfg = get_preset("debug-tiny")
    monkeypatch.setenv("LLMLB_LORA_DIR", lora_dir)
    monkeypatch.setenv("LLMLB_LORA_RANK_CAP", "8")
    monkeypatch.setenv("LLMLB_LORA_MAX_ADAPTERS", "3")
    core = EngineCore(cfg, params_from_numpy(weights[1], cfg, "cpu"),
                      device="cpu", **CORE_KW)
    plain = EngineCore(cfg, params_from_numpy(weights[1], cfg, "cpu"),
                       device="cpu", lora_dir="", **CORE_KW)
    info = core.lora_info()
    assert info["enabled"] and info["max_adapters"] == 3
    assert info["rank_cap"] == 8 and info["available"] == ["acme", "beta"]
    assert info["cp_fallback_total"] == 0 and info["targets"] == list(ALL)
    assert plain.lora_info() == {"enabled": False}
    assert core.n_params == plain.n_params  # pool leaves are not parameters
    assert core.param_bytes > plain.param_bytes
    with pytest.raises(ValueError, match="not enabled"):
        plain.submit(Request(prompt_ids=[1, 2], sampling=SamplingParams(
            lora="acme")))
    # a refused submit releases the pin the service took before it
    req = Request(prompt_ids=[], sampling=SamplingParams(lora="acme"))
    core.prepare_lora(req)
    assert core.lora_info()["active"] == {"acme": 1}
    with pytest.raises(ValueError, match="at least one token"):
        core.submit(req)
    assert core.lora_info()["active"] == {}


# -------------------------------------------------------------- HTTP server


@pytest.fixture(scope="module")
def server(lora_dir):
    engine = Engine.from_preset("debug-tiny", device="cpu", num_slots=2,
                                slot_capacity=128, prefill_buckets=(32, 64),
                                kv_page_size=16, eos_id=-1, lora_dir=lora_dir,
                                lora_rank_cap=8)
    srv, thread = start_server(engine)
    try:
        yield "http://%s:%d" % srv.server_address[:2], engine
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        engine.shutdown()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


CHAT = {"model": "debug-tiny", "temperature": 0, "max_tokens": 4,
        "messages": [{"role": "user", "content": "hi"}]}


@pytest.mark.parametrize("extra", [
    {"lora": "nope"},
    {"model": "debug-tiny:nope"},
    {"model": "debug-tiny:acme", "lora": "beta"},
    {"lora": "bad name!"},
])
def test_bad_adapters_are_400_naming_lora(server, extra):
    base, engine = server
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base + "/v1/chat/completions", {**CHAT, **extra})
    assert err.value.code == 400
    assert "'lora'" in json.loads(err.value.read())["error"]["message"]
    assert engine.core.lora_info()["active"] == {}


def test_adapter_requests_models_and_health(server):
    base, engine = server
    with _post(base + "/v1/chat/completions",
               {**CHAT, "model": "debug-tiny:acme"}) as resp:
        out = json.loads(resp.read())
    assert out["model"] == "debug-tiny" and out["usage"]["completion_tokens"] == 4
    with _post(base + "/v1/chat/completions",
               {**CHAT, "lora": "beta", "stream": True}) as resp:
        lines = [ln.decode().strip() for ln in resp if ln.strip()]
    assert lines[-1] == "data: [DONE]"
    models = _get(base + "/v1/models")["data"]
    assert models[0]["id"] == "debug-tiny"
    assert "lora" in models[0]["capabilities"]
    entries = {m["id"]: m.get("lora") for m in models[1:]}
    assert entries == {"debug-tiny:acme": "acme", "debug-tiny:beta": "beta"}
    health = _get(base + "/api/health")
    assert health["lora"]["resident"] == ["acme", "beta"]
    assert health["lora"]["active"] == {}
    # the gateway's unchanged health parser reads the resident adapters
    parsed = _parse_telemetry(health)
    assert parsed.lora_loaded == ("acme", "beta")
    assert parsed.lora_available == ("acme", "beta")
    assert _get(base + "/api/system")["lora"]["enabled"] is True
    assert all(n == 0 for n in cuda_attention.LAUNCHES.values())
