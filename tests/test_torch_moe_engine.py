"""The port's EngineCore serving debug-moe-tiny against the JAX EngineCore.

Both cores get the reference's Mixtral weights (carried across with
params_from_numpy), one attention adapter directory and the same traffic, in
the same order: a group of five greedy requests queued before the loop
starts (so both prefill the same groups: one of 4 padded rows at bucket 16
and one of 32 positions, both in the capacity regime, and a 70-token prompt
in chunks of 32), then single requests one at a time (16 positions: the
exact regime), an adapter request, and a prefix-cache hit whose suffix runs
as an extend. Greedy streams must be identical, in the paged and the dense
layout. Embeddings are refused as the reference refuses them, and the served
model's capabilities lack `embeddings`.
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.models import mixtral as jmixtral
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import EngineCore, Request, SamplingParams
from llmlb_tpu_torch.engine.server import _models, start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.lora import save_adapter
from llmlb_tpu_torch.models import mixtral

CORE_KW = dict(num_slots=8, slot_capacity=128, prefill_buckets=(16, 32),
               kv_page_size=16, eos_id=-1, seed=0, decode_burst=1)
GROUP_LENS = (5, 12, 20, 70, 9)  # 70 > the largest bucket: chunked
SINGLE_LENS = (7, 16)
MAX_TOKENS = 10


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(numpy weights, JAX weights, adapter dir, traffic)."""
    jparams = jmixtral.init_params(jax_preset("debug-moe-tiny"),
                                   jax.random.PRNGKey(0))
    lora_dir = str(tmp_path_factory.mktemp("moe_lora"))
    save_adapter(lora_dir, "acme", get_preset("debug-moe-tiny"), rank=4,
                 alpha=16.0)
    rng = np.random.default_rng(5)
    group = [rng.integers(0, 256, size=(n,)).tolist() for n in GROUP_LENS]
    singles = [rng.integers(0, 256, size=(n,)).tolist() for n in SINGLE_LENS]
    donor = rng.integers(0, 256, size=(40,)).tolist()
    hit = donor[:36] + rng.integers(0, 256, size=(6,)).tolist()
    traffic = dict(group=group, singles=singles, adapter=singles[0],
                   donor=donor, hit=hit)
    return ({k: np.asarray(v) for k, v in jparams.items()}, jparams,
            lora_dir, traffic)


def _drain(events, timeout=120):
    toks = []
    while True:
        kind, value = events.get(timeout=timeout)
        if kind == "token":
            toks.append(int(value))
        elif kind == "error":
            raise AssertionError(f"engine error: {value}")
        else:
            return toks


def _serve(core, req_cls, sampling_cls, traffic, full: bool):
    """The traffic through a core, in order: the group queued before the
    loop starts, then (full) one request at a time."""
    def make(prompt, lora=None):
        return req_cls(prompt_ids=list(prompt), sampling=sampling_cls(
            max_tokens=MAX_TOKENS, temperature=0.0, lora=lora))

    group = [core.submit(make(p)) for p in traffic["group"]]
    core.start()
    try:
        out = {"group": [_drain(r.events) for r in group]}
        if full:
            out["singles"] = [_drain(core.submit(make(p)).events)
                              for p in traffic["singles"]]
            out["adapter"] = _drain(core.submit(
                make(traffic["adapter"], "acme")).events)
            out["donor"] = _drain(core.submit(make(traffic["donor"])).events)
            out["hit"] = _drain(core.submit(make(traffic["hit"])).events)
        return out
    finally:
        core.stop()


@pytest.fixture(scope="module")
def jax_paged(setup):
    _, jparams, lora_dir, traffic = setup
    core = JaxEngineCore(jax_preset("debug-moe-tiny"), jparams,
                         kv_layout="paged", prefix_cache=True,
                         lora_dir=lora_dir, **CORE_KW)
    out = _serve(core, JaxRequest, JaxSampling, traffic, full=True)
    return out, core.metrics.prefix_hits_total


def test_paged_streams_match_jax(setup, jax_paged):
    np_params, _, lora_dir, traffic = setup
    want, jax_hits = jax_paged
    cfg = get_preset("debug-moe-tiny")
    core = EngineCore(cfg, params_from_numpy(np_params, cfg, "cpu"),
                      device="cpu", kv_layout="paged", prefix_cache=True,
                      lora_dir=lora_dir, **CORE_KW)
    assert core.family is mixtral
    assert core.lora.targets == ("wq", "wk", "wv", "wo")
    got = _serve(core, Request, SamplingParams, traffic, full=True)
    assert got == want
    # the adapter moves the stream; the hit is a hit on both sides
    assert got["adapter"] != got["singles"][0]
    assert core.prefix_counters.prefix_hits_total == jax_hits == 1
    assert core.nan_logit_rows() == 0


def test_dense_streams_match_jax(setup):
    np_params, jparams, _, traffic = setup
    jcore = JaxEngineCore(jax_preset("debug-moe-tiny"), jparams,
                          kv_layout="dense", prefix_cache=False, **CORE_KW)
    want = _serve(jcore, JaxRequest, JaxSampling, traffic, full=False)
    cfg = get_preset("debug-moe-tiny")
    core = EngineCore(cfg, params_from_numpy(np_params, cfg, "cpu"),
                      device="cpu", kv_layout="dense", prefix_cache=False,
                      **CORE_KW)
    assert _serve(core, Request, SamplingParams, traffic, full=False) == want


def test_embeddings_refused_and_not_advertised():
    engine = Engine.from_preset("debug-moe-tiny", device="cpu",
                                slot_capacity=128, prefill_buckets=(16, 32))
    server, _ = start_server(engine)
    try:
        assert not engine.supports_embeddings()
        with pytest.raises(ValueError, match="not supported"):
            engine.embed([[1, 2, 3]])
        caps = _models(engine)[0]["capabilities"]
        assert "embeddings" not in caps and "chat_completion" in caps
        base = f"http://127.0.0.1:{server.server_address[1]}"
        req = urllib.request.Request(
            base + "/v1/embeddings", method="POST",
            data=json.dumps({"input": "hello"}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400
        assert "not supported" in err.value.read().decode()
        # a chat completes on the MoE engine
        req = urllib.request.Request(
            base + "/v1/chat/completions", method="POST",
            data=json.dumps({"messages": [{"role": "user", "content": "hi"}],
                             "max_tokens": 4, "temperature": 0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        assert body["usage"]["completion_tokens"] >= 1
    finally:
        server.shutdown()
        engine.shutdown()
