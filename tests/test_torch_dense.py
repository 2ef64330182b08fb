"""The port's dense slot layout (`kv_layout="dense"`) against the JAX package.

- the plain versions of flash_decode and flash_extend against the Pallas
  kernels in interpret mode (tests/ops/test_pallas_attention.py's way), on
  defined rows only, with a window below S;
- the public dense attention functions against the reference's;
- the slot entry points (prefill_into_slots, prefill_extend_slots,
  decode_step) against the reference's, with and without adapter pools;
- the dense engine with LoRA: greedy and seeded streams of a batch mixing
  two adapters and the base model identical to the JAX dense engine's at
  decode burst 1 and 4 (one JAX engine, module-scoped), and its KV
  accounting; int8 KV downgrades on this layout as in the reference;
- `--kv-layout dense` on the server.

fp32 on the CPU at debug-tiny size. Tolerances: attention within 1e-5
(online vs two-pass softmax), logits within 1e-4 (as
tests/test_torch_llama.py) and so are cache cells.
"""

import json
import logging
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.lora import store as jstore
from llmlb_tpu.lora.manager import LoraManager as JaxLoraManager
from llmlb_tpu.models import llama as jllama
from llmlb_tpu.ops import attention as jattention
from llmlb_tpu.ops import pallas_attention as pallas
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import (
    EngineCore,
    Request,
    SamplingParams,
    kv_cache_bytes,
)
from llmlb_tpu_torch.engine.server import build_parser, start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.models import llama
from llmlb_tpu_torch.ops import attention, cuda_attention

ATOL = 1e-5
ALL = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
CORE_KW = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
               eos_id=-1, seed=0)
PROMPT_LENS = (5, 12, 15, 64, 9)  # 64 > the largest bucket: two chunks
ADAPTER_OF = ("beta", None, "acme", "beta", "acme")
MAX_TOKENS = 10
SEEDED = [dict(temperature=0.8, top_p=0.9, top_k=0, seed=11),
          dict(temperature=1.0, top_p=1.0, top_k=20, seed=5)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------------ kernels


@pytest.mark.parametrize(
    "b,s,h,kv,d,block_k,window",
    [
        (2, 64, 8, 8, 32, 16, None),   # G=1, several key blocks
        (3, 48, 8, 2, 16, 16, None),   # G=4
        (3, 256, 8, 4, 16, 32, 128),   # G=2, a window below S
    ],
)
def test_flash_decode_reference_matches_pallas(b, s, h, kv, d, block_k,
                                               window):
    rng = np.random.default_rng(s + h)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kc = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    vc = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    sweep = s if window is None else window
    lens = rng.integers(1, sweep + 1, size=(b,)).astype(np.int32)
    lens[0], lens[-1] = 1, sweep  # one key; every swept cell
    want = pallas.flash_decode(q, kc, vc, lens, block_k=block_k,
                               interpret=True, window=window)
    got = cuda_attention.flash_decode_reference(_t(q), _t(kc), _t(vc),
                                                _t(lens), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert cuda_attention.dense_decode_sweep(s, window) == sweep


@pytest.mark.parametrize(
    "b,t,h,kv,d,s",
    [
        (2, 16, 8, 8, 32, 64),  # G=1
        (2, 8, 8, 2, 16, 48),   # G=4
        (1, 16, 4, 1, 32, 64),  # MQA
    ],
)
def test_flash_extend_reference_matches_pallas(b, t, h, kv, d, s):
    rng = np.random.default_rng(t * 100 + s)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    kc = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    vc = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    start = rng.integers(0, s - t, size=(b,)).astype(np.int32)
    chunk_lens = rng.integers(1, t + 1, size=(b,)).astype(np.int32)
    want = pallas.flash_extend(q, kc, vc, start, chunk_lens, block_q=8,
                               block_k=16, interpret=True)
    got = cuda_attention.flash_extend_reference(_t(q), _t(kc), _t(vc),
                                                _t(start), _t(chunk_lens))
    for bi in range(b):
        n = chunk_lens[bi]
        np.testing.assert_allclose(got[bi, :n].numpy(),
                                   np.asarray(want)[bi, :n], atol=ATOL)


def test_dense_attention_functions_match_jax():
    """gqa_attention_decode / gqa_attention_extend on CPU tensors against the
    reference's einsum paths (defined rows), launching no kernel; the
    extend without chunk_lens is CPU-only."""
    cuda_attention.reset_launch_counts()
    rng = np.random.default_rng(11)
    b, t, s, h, kv, d = 3, 8, 160, 8, 2, 16
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    kc = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    vc = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    kv_lens = np.array([1, 9, 130], np.int32)
    for window in (None, 128):  # 128 leaves row 2 past the window: garbage
        got = attention.gqa_attention_decode(_t(q[:, :1]), _t(kc), _t(vc),
                                             _t(kv_lens), window=window)
        want = jattention.gqa_attention_decode(q[:, :1], kc, vc, kv_lens,
                                               window=window)
        rows = 2 if window else b
        np.testing.assert_allclose(got[:rows].numpy(),
                                   np.asarray(want)[:rows], atol=ATOL)
    start = np.array([0, 17, 140], np.int32)
    chunk = np.array([8, 5, 3], np.int32)
    pos = start[:, None] + np.arange(t, dtype=np.int32)[None, :]
    want = jattention.gqa_attention_extend(q, kc, vc, pos, None)
    for lens in (chunk, None):
        got = attention.gqa_attention_extend(
            _t(q), _t(kc), _t(vc), _t(pos), None if lens is None else _t(lens))
        for bi in range(b):
            np.testing.assert_allclose(got[bi, :chunk[bi]].numpy(),
                                       np.asarray(want)[bi, :chunk[bi]],
                                       atol=ATOL)
    assert all(n == 0 for n in cuda_attention.LAUNCHES.values())
    meta = torch.empty((b, t, h, d), device="meta")
    cache = torch.empty((b, s, kv, d), device="meta")
    with pytest.raises(ValueError, match="chunk_lens is required"):
        attention.gqa_attention_extend(meta, cache, cache,
                                       torch.empty((b, t), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        attention.gqa_attention_decode(meta[:, :1], cache, cache,
                                       torch.empty(b, device="meta"))


# ------------------------------------------------------------ entry points


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jax_preset("debug-tiny"), jax.random.PRNGKey(0))
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


@pytest.fixture(scope="module")
def lora_dir(tmp_path_factory):
    """Adapters written by the JAX store: acme (rank 4, attention) and beta
    (rank 8, all seven targets)."""
    d = str(tmp_path_factory.mktemp("adapters"))
    cfg = jax_preset("debug-tiny")
    jstore.save_adapter(d, "acme", cfg, rank=4)
    jstore.save_adapter(d, "beta", cfg, rank=8, targets=ALL)
    return d


def _pool_leaves(lora_dir):
    """Adapter pool leaves (rank cap 8; rows identity, acme, beta) from the
    JAX store, as numpy."""
    cfg = jax_preset("debug-tiny")
    mgr = JaxLoraManager(cfg, lora_dir=lora_dir, max_adapters=2, rank_cap=8)
    leaves = mgr.init_pool_leaves(np.float32)
    infos = jstore.discover_adapters(lora_dir, rank_cap=8, allowed_targets=ALL)
    for row, name in ((1, "acme"), (2, "beta")):
        host = jstore.load_adapter_tensors(infos[name], cfg, pool_rank=8,
                                           dtype=np.float32)
        for tgt, (a, b) in host.items():
            leaves[tgt + "_lora_a"][:, row] = a
            leaves[tgt + "_lora_b"][:, row] = b
    return leaves


def _assert_rows(ck, cv, jck, jcv, slots, lens):
    """Cache cells at valid positions, within the logits' 1e-4: the second
    layer's K/V come out of a first layer whose adapter deltas (debug-tiny's
    default scale) are larger than its base projections."""
    for slot, n in zip(slots, lens):
        for got, want in ((ck, jck), (cv, jcv)):
            np.testing.assert_allclose(got[:, slot, :n].numpy(),
                                       np.asarray(want)[:, slot, :n],
                                       atol=1e-4)


@pytest.mark.parametrize("adapters", [False, True])
def test_slot_entry_points_match_jax(weights, lora_dir, adapters):
    """Two prompts prefilled into slots 2 and 0 of 3, a chunk on top, then
    decode steps over all three rows with a window below capacity, the
    adapter rows mixed ([2, 1] then [0, 2] ...)."""
    np_params = dict(weights[1])
    if adapters:
        np_params.update(_pool_leaves(lora_dir))
    jcfg, cfg = jax_preset("debug-tiny"), get_preset("debug-tiny")
    params = params_from_numpy(np_params, cfg, "cpu")
    slots = np.array([2, 0], np.int32)
    lidx = np.array([2, 1], np.int32) if adapters else None

    def li(x):
        return None if x is None else _t(x)

    rng = np.random.default_rng(5)
    ids = rng.integers(0, 512, size=(2, 16)).astype(np.int32)
    lens = np.array([5, 13], np.int32)
    ck, cv = llama.init_kv_cache(cfg, 3, 160, "cpu")
    jck, jcv = jllama.init_kv_cache(jcfg, 3, 160)
    logits, ck, cv = llama.prefill_into_slots(
        params, cfg, _t(ids), _t(lens), _t(slots), ck, cv, lora_idx=li(lidx))
    jlogits, jck, jcv = jllama.prefill_into_slots(
        np_params, jcfg, ids, lens, slots, jck, jcv, lora_idx=lidx)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4)
    _assert_rows(ck, cv, jck, jcv, slots, lens)

    chunk = rng.integers(0, 512, size=(2, 16)).astype(np.int32)
    chunk_lens = np.array([10, 3], np.int32)
    logits, ck, cv = llama.prefill_extend_slots(
        params, cfg, _t(chunk), _t(chunk_lens), _t(lens), _t(slots), ck, cv,
        lora_idx=li(lidx))
    jlogits, jck, jcv = jllama.prefill_extend_slots(
        np_params, jcfg, chunk, chunk_lens, lens, slots, jck, jcv,
        lora_idx=lidx)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4)
    seq = np.zeros(3, np.int32)
    seq[slots] = lens + chunk_lens
    _assert_rows(ck, cv, jck, jcv, slots, seq[slots])

    for step in range(3):
        toks = rng.integers(0, 512, size=(3,)).astype(np.int32)
        rows = (np.array([0, 2, 1], np.int32) if adapters else None)
        window = 128 if step < 2 else None
        logits, ck, cv = llama.decode_step(params, cfg, _t(toks), _t(seq), ck,
                                           cv, window=window, lora_idx=li(rows))
        jlogits, jck, jcv = jllama.decode_step(np_params, jcfg, toks, seq, jck,
                                               jcv, window=window,
                                               lora_idx=rows)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4)
        seq = seq + 1
        _assert_rows(ck, cv, jck, jcv, range(3), seq)


# ----------------------------------------------------------------- engines


@pytest.fixture(scope="module")
def requests():
    rng = np.random.default_rng(33)
    greedy = [(rng.integers(0, 256, size=(n,)).tolist(), {}, name)
              for n, name in zip(PROMPT_LENS, ADAPTER_OF)]
    seeded = [(rng.integers(0, 256, size=(n,)).tolist(), s, name)
              for n, s, name in zip((14, 6), SEEDED, ("beta", None))]
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
def jax_run(weights, lora_dir, requests):
    """(streams, kv_cache_info, lora_info) of the JAX dense engine with
    adapters."""
    core = JaxEngineCore(jax_preset("debug-tiny"), weights[0],
                         kv_layout="dense", prefix_cache=False, decode_burst=1,
                         lora_dir=lora_dir, lora_rank_cap=8, **CORE_KW)
    reqs = [core.submit(JaxRequest(prompt_ids=list(p), sampling=JaxSampling(
        max_tokens=MAX_TOKENS, lora=name, **{"temperature": 0.0, **s})))
        for p, s, name in requests]
    core.start()  # everything queued before the loop starts: same groups
    try:
        streams = [_drain(r.events) for r in reqs]
        return streams, core.kv_cache_info(), core.lora_info()
    finally:
        core.stop()


@pytest.mark.parametrize("burst", [1, 4])
def test_dense_mixed_adapter_streams_identical_to_jax_engine(
        weights, lora_dir, requests, jax_run, burst):
    jax_streams, jax_kv, jax_lora = jax_run
    cfg = get_preset("debug-tiny")
    core = EngineCore(cfg, params_from_numpy(weights[1], cfg, "cpu"),
                      device="cpu", decode_burst=burst, kv_layout="dense",
                      lora_dir=lora_dir, lora_rank_cap=8, **CORE_KW)
    assert core.page_pool is None and core.kv_cache_info() == jax_kv
    reqs = [core.submit(Request(prompt_ids=list(p), sampling=SamplingParams(
        max_tokens=MAX_TOKENS, lora=name, **{"temperature": 0.0, **s})))
        for p, s, name in requests]
    core.start()
    try:
        port = [_drain(r.events) for r in reqs]
        assert core.nan_logit_rows() == 0
        info = core.lora_info()
    finally:
        core.stop()
    assert [r for _t, r in jax_streams] == ["length"] * len(requests)
    n = len(PROMPT_LENS)
    assert port[:n] == jax_streams[:n]  # greedy
    assert port[n:] == jax_streams[n:]  # seeded stochastic
    assert info["active"] == {} and info["resident"] == jax_lora["resident"]


def test_dense_kv_accounting_and_int8_downgrade(weights, caplog,
                                                monkeypatch):
    cfg = get_preset("debug-tiny")
    monkeypatch.setenv("LLMLB_KV_LAYOUT", "dense")
    with caplog.at_level(logging.WARNING):
        core = EngineCore(cfg, params_from_numpy(weights[1], cfg, "cpu"),
                          device="cpu", quantize="all", **CORE_KW)
    assert "int8 KV quantization requires the paged layout" in caplog.text
    assert core.kv_layout == "dense" and core.page_pool is None
    # weights still quantize; the slot cache stays in the model dtype
    assert core.params["wq"].dtype == torch.int8
    assert core.cache_k.dtype == torch.float32
    assert core.cache_k.shape == (2, 4, 128, 4, 16)
    info = core.kv_cache_info()
    assert info["effective_kv_dtype"] == "float32"
    assert info["hbm_bytes"] == kv_cache_bytes(cfg, 4, 128) == 2 * 4 * 128 * 4 * 16 * 2 * 4
    quant = core.quant_info()
    assert quant["weights_int8"] and not quant["kv_int8"]
    with pytest.raises(ValueError, match="kv_layout must be"):
        EngineCore(cfg, device="cpu", kv_layout="ragged", **CORE_KW)


def test_server_serves_dense():
    """--kv-layout dense through Engine.from_preset: the kv_cache block of
    /api/system, a chat completion over the slot cache, and a `lora` field
    refused on an engine without adapters."""
    assert build_parser().parse_args(["--kv-layout", "dense"]).kv_layout == \
        "dense"
    engine = Engine.from_preset("debug-tiny", device="cpu", num_slots=2,
                                slot_capacity=64, prefill_buckets=(32, 64),
                                eos_id=-1, kv_layout="dense")
    srv, thread = start_server(engine)
    base = "http://%s:%d" % srv.server_address[:2]
    body = {"model": "debug-tiny", "temperature": 0, "max_tokens": 4,
            "messages": [{"role": "user", "content": "hi"}]}

    def post(b):
        return urllib.request.urlopen(urllib.request.Request(
            base + "/v1/chat/completions", data=json.dumps(b).encode(),
            headers={"Content-Type": "application/json"}), timeout=60)

    try:
        with urllib.request.urlopen(base + "/api/system", timeout=60) as resp:
            system = json.loads(resp.read())
        assert system["kv_cache"]["layout"] == "dense"
        assert system["kv_cache"]["slot_capacity"] == 64
        assert system["lora"] == {"enabled": False}
        with post(body) as resp:
            assert json.loads(resp.read())["usage"]["completion_tokens"] == 4
        # a colon in the model name stays inert without adapters
        with post({**body, "model": "debug-tiny:acme"}) as resp:
            assert resp.status == 200
        with pytest.raises(urllib.error.HTTPError) as err:
            post({**body, "lora": "acme"})
        assert err.value.code == 400
        assert "not enabled" in json.loads(err.value.read())["error"]["message"]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        engine.shutdown()


@pytest.mark.parametrize("args", [["--kv-layout", "dense"],
                                  ["--kv-layout", "dense", "--lora", "2"],
                                  ["--lora", "3", "--quantize", "weights"]])
def test_profile_step_rehearses_dense_and_lora_on_cpu(capsys, args):
    """The card profiler's dense and LoRA dispatches run end to end on the
    CPU at debug-tiny size and report no timing there (seven: two decode
    steps, two decode bursts as the engine runs them, eager on the CPU, two
    prefills and an extend); int8 KV on the dense layout is refused as the
    engine downgrades it."""
    from llmlb_tpu_torch import profile_step

    assert profile_step.main(["--device", "cpu", *args]) == 0
    out = capsys.readouterr().out
    assert out.count("rehearsal on cpu:") == 7
    assert out.count("rehearsal on cpu: decode graph burst=8") == 2
    assert "wall_ms" not in out
    with pytest.raises(SystemExit):
        profile_step.main(["--device", "cpu", "--kv-layout", "dense",
                           "--quantize", "kv"])
