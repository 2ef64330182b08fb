"""The port's int8 engine, seeded sampling and server against the JAX
paged engine.

Both cores get the reference's debug-tiny weights (unquantized, carried
across with params_from_numpy; each engine quantizes them itself) and the
same requests, submitted together: greedy ones with the prompts of
tests/test_torch_engine.py (short ones prefilled in one bucketed dispatch,
one longer than the largest bucket, chunked) and seeded stochastic ones.
With the prefix cache off, for quantize in {off, kv, weights, all} and at
the port's decode burst 1 and 4, greedy streams must be identical and
seeded streams too (the port draws JAX's threefry stream), and the KV byte
accounting must be the JAX engine's. One JAX engine per mode serves both
kinds of request.
"""

import json
import urllib.request

import jax
import numpy as np
import pytest

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.models import llama as jllama
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import EngineCore, Request, SamplingParams
from llmlb_tpu_torch.engine.server import build_parser, start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.weights import params_from_numpy

# 8 slots, the engine's default: the 10 requests still queue for a slot,
# and the JAX engine of each quant mode compiles about a quarter less than
# at 4 slots (fewer prefill group shapes)
CORE_KW = dict(num_slots=8, slot_capacity=128, prefill_buckets=(16, 32),
               kv_page_size=16, eos_id=-1, seed=0)
PROMPT_LENS = (5, 12, 20, 70, 9)  # 70 > the largest bucket: chunked prefill
MAX_TOKENS = 12
GREEDY = dict(temperature=0.0)
SEEDED = [dict(temperature=0.8, top_p=0.9, top_k=0, seed=11),
          dict(temperature=1.0, top_p=1.0, top_k=20, seed=2**31 - 1),
          dict(temperature=0.5, top_p=0.95, top_k=0, seed=0),
          dict(temperature=1.3, top_p=0.8, top_k=40, seed=424242),
          dict(temperature=0.9, top_p=1.0, top_k=0, seed=7)]


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jax_preset("debug-tiny"), jax.random.PRNGKey(0))
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


@pytest.fixture(scope="module")
def requests():
    """(prompt, sampling kwargs): greedy requests, then seeded ones."""
    rng = np.random.default_rng(21)
    greedy = [rng.integers(0, 256, size=(n,)).tolist() for n in PROMPT_LENS]
    rng = np.random.default_rng(33)
    seeded = [rng.integers(0, 256, size=(n,)).tolist() for n in PROMPT_LENS]
    return ([(p, GREEDY) for p in greedy]
            + [(p, s) for p, s in zip(seeded, SEEDED)])


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


@pytest.fixture(scope="module", params=[None, "kv", "weights", "all"])
def jax_run(request, weights, requests):
    """(mode, streams, kv_cache_info, quant_info) of the JAX paged engine."""
    mode = request.param
    core = JaxEngineCore(jax_preset("debug-tiny"), weights[0],
                         kv_layout="paged", prefix_cache=False, decode_burst=1,
                         quantize=mode, **CORE_KW)
    reqs = [core.submit(JaxRequest(prompt_ids=list(p), sampling=JaxSampling(
        max_tokens=MAX_TOKENS, **s))) for p, s in requests]
    core.start()  # everything queued before the loop starts: same groups
    try:
        streams = [_drain(r.events) for r in reqs]
        return mode, streams, core.kv_cache_info(), core.quant_info()
    finally:
        core.stop()


def _port_core(np_params, burst, quantize):
    cfg = get_preset("debug-tiny")
    return EngineCore(cfg, params_from_numpy(np_params, cfg, "cpu"),
                      device="cpu", decode_burst=burst, quantize=quantize,
                      **CORE_KW)


def _run_port(core, requests):
    reqs = [core.submit(Request(prompt_ids=list(p), sampling=SamplingParams(
        max_tokens=MAX_TOKENS, **s))) for p, s in requests]
    core.start()
    try:
        out = [_drain(r.events) for r in reqs]
        assert core.nan_logit_rows() == 0
        assert core.page_pool.available() == core.page_pool.total  # drained
        return out
    finally:
        core.stop()


@pytest.mark.parametrize("burst", [1, 4])
def test_streams_and_accounting_match_jax(weights, requests, jax_run, burst):
    mode, jax_streams, jax_kv, jax_quant = jax_run
    core = _port_core(weights[1], burst, mode)
    assert core.quant_info() == jax_quant
    info = core.kv_cache_info()
    assert info["bytes_per_page"] == jax_kv["bytes_per_page"]
    assert info["hbm_bytes"] == jax_kv["hbm_bytes"]
    assert info["kv_dtype"] == jax_kv["kv_dtype"]
    assert (info["kv_dtype"] == "int8") == (mode in ("kv", "all"))
    port = _run_port(core, requests)
    assert [r for _t, r in jax_streams] == ["length"] * len(requests)
    n = len(PROMPT_LENS)
    # the seeded rows really sample: no two of their streams coincide
    assert len({tuple(t) for t, _r in jax_streams[n:]}) == n
    assert port[:n] == jax_streams[:n]  # greedy
    assert port[n:] == jax_streams[n:]  # seeded stochastic


def test_int8_pages_are_smaller(weights):
    plain = _port_core(weights[1], 1, None).kv_cache_info()["bytes_per_page"]
    int8 = _port_core(weights[1], 1, "kv").kv_cache_info()["bytes_per_page"]
    assert int8 < 0.6 * plain


def test_quantize_off_is_no_knob(weights, requests, monkeypatch):
    monkeypatch.delenv("LLMLB_QUANTIZE", raising=False)
    off = _run_port(_port_core(weights[1], 4, "off"), requests)
    assert off == _run_port(_port_core(weights[1], 4, None), requests)
    monkeypatch.setenv("LLMLB_QUANTIZE", "kv")
    assert _port_core(weights[1], 1, None).quant_info()["mode"] == "kv"


def test_server_serves_int8():
    """--quantize all through Engine.from_preset: the quant block in
    /api/health and /api/system, and a chat completion over int8 pages."""
    assert build_parser().parse_args(["--quantize", "all"]).quantize == "all"
    engine = Engine.from_preset("debug-tiny", device="cpu", num_slots=2,
                                slot_capacity=64, prefill_buckets=(32, 64),
                                kv_page_size=16, eos_id=-1, quantize="all")
    srv, thread = start_server(engine)
    base = "http://%s:%d" % srv.server_address[:2]
    try:
        assert engine.health()["quant"]["mode"] == "all"
        with urllib.request.urlopen(base + "/api/system", timeout=60) as resp:
            system = json.loads(resp.read())
        assert system["quant"]["mode"] == "all"
        assert system["quant"]["weights_int8"] and system["quant"]["kv_int8"]
        assert system["kv_cache"]["kv_dtype"] == "int8"
        body = {"model": "debug-tiny", "temperature": 0, "max_tokens": 4,
                "messages": [{"role": "user", "content": "hi"}]}
        req = urllib.request.Request(
            base + "/v1/chat/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        assert out["usage"]["completion_tokens"] == 4
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        engine.shutdown()
