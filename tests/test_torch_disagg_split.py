"""The port's in-process split (`role="split"`) against the JAX engine.

The twin of tests/engine/test_disagg_split.py, at its configuration (`KW`):
the port's split engine (one prefill slot, three decode slots, on the CPU)
serves the JAX engine's streams token for token, from the JAX engine's
debug-tiny weights carried across with params_from_numpy:

- identity: greedy, seeded and a prompt past the largest bucket (chunked
  in the prefill pool), each handed off once; and a constrained row,
  staged and adopted, whose grammar cursor attaches in its decode slot;
- isolation: background decoders while long prompts arrive run no prefill
  dispatch on the decode loop (the `prefill_dispatch_by_loop` ledger),
  and the decode loop runs every decode step;
- surfaces: `disagg_info`, `queued_by_role` and the role series of
  /metrics; `normalize_role` against the reference's; the refusals of the
  dense layout and of fewer than two slots; the `staged` / `adopted` pair
  of the flight record;
- a debug-moe-tiny split engine, one request at a time, against the port's
  own `both` engine over the same weights.

One JAX EngineCore, module-scoped, runs every reference stream.
"""

import threading

import jax
import numpy as np
import pytest

from llmlb_tpu.disagg import normalize_role as jax_normalize_role
from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmlb_tpu.models import llama as jllama
from llmlb_tpu.structured import ConstraintCompiler as JaxCompiler
from llmlb_tpu_torch.disagg import normalize_role
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import (
    EngineCore,
    EngineStats,
    Request,
    SamplingParams,
)
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer
from llmlb_tpu_torch.engine.weights import params_from_numpy

CFG = get_preset("debug-tiny")
EOS = 256
# the reference test's configuration
KW = dict(num_slots=4, slot_capacity=256, prefill_buckets=(16, 32, 64),
          seed=0, kv_layout="paged", kv_page_size=16, prefix_cache=False)
SCHEMA = {"type": "json_schema", "schema": {
    "type": "object",
    "properties": {"name": {"type": "string", "maxLength": 8},
                   "n": {"enum": [0, 1, 2, 3]}},
    "required": ["name", "n"]}}
GREEDY = dict(temperature=0.0)
SHORT = list(b"the quick brown fox jumps over")
LONG = list(b"z" * 150)  # past the 64 bucket: chunked
# name: (prompt, sampling, constraint spec, max_tokens)
CASES = {
    "greedy": (SHORT, GREEDY, None, 32),
    "seeded": (SHORT, dict(temperature=0.9, seed=1234), None, 32),
    "long": (LONG, GREEDY, None, 16),
    "constrained": (list(b"the quick brown fox"), GREEDY, SCHEMA, 60),
    "background": (list(b"background decoder"), GREEDY, None, 160),
}


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
def weights():
    jparams = jllama.init_params(jax_preset("debug-tiny"),
                                 jax.random.PRNGKey(0))
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


@pytest.fixture(scope="module")
def jax_streams(weights):
    """Each case alone on one idle JAX engine."""
    core = JaxEngineCore(jax_preset("debug-tiny"), weights[0], eos_id=EOS,
                         decode_burst=1, **KW)
    core.constraint_compiler = JaxCompiler(JaxByteTokenizer(CFG.vocab_size),
                                           CFG.vocab_size)
    core.start()
    try:
        return {name: _drain(core.submit(JaxRequest(
            prompt_ids=list(p), sampling=JaxSampling(
                max_tokens=n, constraint=spec, **s))).events)
            for name, (p, s, spec, n) in CASES.items()}
    finally:
        core.stop()


@pytest.fixture(scope="module")
def split(weights):
    core = EngineCore(CFG, params_from_numpy(weights[1], CFG, "cpu"),
                      device="cpu", eos_id=EOS, role="split",
                      disagg_prefill_slots=1, **KW)
    engine = Engine("debug-tiny", core, ByteTokenizer(CFG.vocab_size))
    core.start()
    yield engine
    engine.shutdown()


def _submit(engine, name, max_tokens=None, request_id=None):
    prompt, sampling, spec, n = CASES[name]
    sp = SamplingParams(max_tokens=max_tokens or n, constraint=spec,
                        **sampling)
    kw = {} if request_id is None else {"request_id": request_id}
    return engine.core.submit(Request(
        prompt_ids=list(prompt), sampling=sp,
        compiled_constraint=(engine.constraint_compiler.compile_spec(spec)
                             if spec is not None else None), **kw))


# ------------------------------------------------------------------ identity


@pytest.mark.parametrize("name", ["greedy", "seeded", "long", "constrained"])
def test_split_stream_is_the_jax_stream(split, jax_streams, monkeypatch,
                                        name):
    """Each request prefills in the prefill pool, is staged, and is adopted
    into a decode slot: its stream is the JAX engine's. A constrained row's
    cursor attaches at its activation, in the decode slot."""
    core = split.core
    attached: list[int] = []
    attach = core._attach_constraint

    def spy(slot_id, request):
        if request.compiled_constraint is not None:
            attached.append(slot_id)
        attach(slot_id, request)

    monkeypatch.setattr(core, "_attach_constraint", spy)
    before = core.metrics.handoff_total["in_process"]
    violations = core.stats().structured.constraint_violations_total
    got = _drain(_submit(split, name).events)
    assert got == tuple(jax_streams[name])
    assert core.metrics.handoff_total["in_process"] == before + 1
    if name == "constrained":
        assert got[1] == "stop"
        assert attached and set(attached) <= set(core.split.decode_pool)
        assert (core.stats().structured.constraint_violations_total
                == violations)


# ----------------------------------------------------------------- isolation


def test_zero_prefill_dispatches_on_the_decode_loop(split, jax_streams):
    """Background decoders stream while three long prompts arrive: every
    prefill runs on the prefill loop, every decode step on the decode loop,
    handoffs flow, and each stream is the JAX engine's."""
    core = split.core
    handoffs = core.metrics.handoff_total["in_process"]
    bg = _submit(split, "background")
    first = bg.events.get(timeout=60)
    assert first[0] == "token", first
    longs = [_submit(split, "long", max_tokens=8) for _ in range(3)]
    got = [_drain(r.events) for r in longs]
    bg_toks, bg_reason = _drain(bg.events)
    assert ([first[1]] + bg_toks, bg_reason) == tuple(
        jax_streams["background"])
    want = jax_streams["long"][0][:8]
    assert got == [(want, "length")] * 3
    ledger = core.prefill_dispatch_by_loop
    assert ledger["decode"] == 0 and ledger["main"] == 0, ledger
    assert ledger["prefill"] > 0
    decodes = core.decode_dispatch_by_loop
    assert decodes["decode"] > 0
    assert decodes["prefill"] == decodes["main"] == 0, decodes
    assert core.metrics.handoff_total["in_process"] - handoffs >= 4


def test_split_surfaces_role_and_queue_depths(split):
    core = split.core
    info = core.disagg_info()
    assert info["role"] == "split" and info["split"] is True
    assert (info["prefill_slots"], info["decode_slots"]) == (1, 3)
    assert set(info["handoff_total"]) == {"in_process", "emitted", "adopted"}
    sched = core.sched_info()
    assert set(sched["queued_by_role"]) == {"prefill", "decode"}
    text = core.metrics.render(
        EngineStats(num_slots=4, active_slots=0, queued=0, total_requests=0,
                    total_tokens=0, uptime_s=0.0), sched=sched)
    assert 'llmlb_engine_queue_depth_role{role="decode"}' in text
    assert 'llmlb_engine_handoff_total{kind="in_process"}' in text
    assert "llmlb_engine_handoff_backlog" in text
    assert "llmlb_engine_handoff_latency_seconds_count" in text
    health = split.health()
    assert health["disagg"] == core.disagg_info()
    assert health["metrics"]["handoff_total"]["in_process"] >= 1


def test_split_flight_record_pairs_stage_with_adopt(split):
    """A split request's flight record shows the handoff as a `staged` /
    `adopted` pair, in causal order, inside one timeline keyed by the
    gateway's request id."""
    rid = "trace-split-fr-1"
    toks, reason = _drain(_submit(split, "greedy", max_tokens=8,
                                  request_id=f"{rid}.0badcafe").events)
    assert reason == "length" and len(toks) == 8
    tl = split.core.flightrec.timeline(rid)
    assert tl is not None, "the split request left no flight record"
    names = [e["event"] for e in tl["events"]]
    assert names.count("staged") == names.count("adopted") == 1
    assert (names.index("prefill_chunk") < names.index("staged")
            < names.index("adopted"))
    assert names[-1] == "finished"
    adopted = next(e for e in tl["events"] if e["event"] == "adopted")
    assert adopted["attrs"]["in_process"] is True
    assert adopted["attrs"]["staged_s"] >= 0
    staged = next(e for e in tl["events"] if e["event"] == "staged")
    assert staged["attrs"] == {"tokens": len(SHORT), "slot": 0}
    tss = [e["ts"] for e in tl["events"]]
    assert tss == sorted(tss)


# -------------------------------------------------------------- construction


@pytest.mark.parametrize("role", [None, "", " Split ", "both", "PREFILL",
                                  "decode", "shard"])
def test_role_normalization_is_the_reference(role):
    try:
        want = jax_normalize_role(role)
    except ValueError:
        with pytest.raises(ValueError, match="role must be one of"):
            normalize_role(role)
        return
    assert normalize_role(role) == want


def test_split_requires_paged_layout_and_two_slots(monkeypatch):
    """No quiet fall back to `both`: the dense layout and a single slot are
    refused with the reference's errors, whether the role comes from the
    keyword or from LLMLB_ROLE."""
    small = dict(device="cpu", slot_capacity=64, prefill_buckets=(16,))
    with pytest.raises(ValueError, match="paged"):
        EngineCore(CFG, role="split", num_slots=2, kv_layout="dense", **small)
    with pytest.raises(ValueError, match="2 slots"):
        EngineCore(CFG, role="split", num_slots=1, **small)
    monkeypatch.setenv("LLMLB_ROLE", "split")
    with pytest.raises(ValueError, match="2 slots"):
        EngineCore(CFG, num_slots=1, **small)
    monkeypatch.setenv("LLMLB_ROLE", "decode")
    core = EngineCore(CFG, num_slots=2, **small)
    assert core.role == "decode" and core.split is None


def test_split_turns_off_shipping_and_the_offload_tier():
    core = EngineCore(CFG, device="cpu", role="split", num_slots=4,
                      slot_capacity=64, prefill_buckets=(16,), kv_ship=True,
                      kv_offload_bytes=1 << 20)
    assert core.kv_ship is False and core.kv_offload is None
    assert (core.split.prefill_pool, core.split.decode_pool) == ((0,),
                                                                 (1, 2, 3))


# ------------------------------------------------------------------------ MoE


def test_moe_split_requests_are_the_both_engine_streams():
    """A debug-moe-tiny split engine, one request at a time, gives the
    port's own combined engine's streams over the same weights (each
    request prefills in a group of one on both)."""
    cfg = get_preset("debug-moe-tiny")
    kw = dict(device="cpu", num_slots=4, slot_capacity=128,
              prefill_buckets=(16, 32), kv_page_size=16, eos_id=-1,
              prefix_cache=False)
    both = EngineCore(cfg, seed=0, **kw)
    split = EngineCore(cfg, both.params, role="split", **kw)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=(n,)).tolist() for n in (9, 40)]
    samplings = [GREEDY, dict(temperature=0.9, seed=77)]
    out = {}
    for core in (both, split):
        core.start()
        try:
            out[core.role] = [
                _drain(core.submit(Request(prompt_ids=p, sampling=SamplingParams(
                    max_tokens=12, **s))).events)
                for p in prompts for s in samplings]
        finally:
            core.stop()
    assert out["split"] == out["both"]
    assert split.metrics.handoff_total["in_process"] == 4
    assert split.prefill_dispatch_by_loop["decode"] == 0


def test_split_serves_call_in_loop_work(split):
    """Work other threads hand the engine (embeddings, the profiler) runs
    on the prefill loop, under the split's lock."""
    seen = []
    assert split.core.call_in_loop(
        lambda: seen.append(threading.current_thread().name) or 7) == 7
    assert seen == ["engine-prefill-pool"]
    vecs = split.embed([[1, 2, 3], [4, 5]])
    assert len(vecs) == 2 and len(vecs[0]) == CFG.hidden_size
