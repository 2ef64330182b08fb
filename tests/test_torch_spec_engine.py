"""Speculative decoding and the prefill chunk budget on the port's engine,
against the JAX engine and against the port with speculation off.

The same debug-tiny weights (JAX's `init_params(PRNGKey(0))`), prompts and
byte vocabulary (EOS 256) on both engines, each driven so that one group is
admitted together:

- twins of tests/engine/test_spec_decode.py: a mixed batch (rows opting in,
  out, with a smaller draft budget, and a seeded row) gives the JAX
  engine's streams AND its verify steps, drafts, accepted and emitted
  counts; eagerly, and with the verify steps replayed from stub graphs
  (each replay runs the eager body); constrained rows speculate under the
  grammar key (with the JAX engine's counts) and under the mask key (fused
  decode off: drafts cut on the host at the grammar) and give the JAX
  engine's fused streams, valid JSON, no violation; the dense layout, int8
  pages (quantize="all", page size 4) and adapter rows (the twins of
  tests/engine/test_quantized_serving.py::
  test_spec_decode_on_int8_pages_rolls_back_cleanly and
  tests/engine/test_lora_serving.py::
  test_spec_decode_with_adapter_token_identical) give their spec-off
  streams; rollback releases pages exactly once, the page-edge case
  included, and the pool is clean after traffic; the `spec` block of
  /api/health, and the HTTP knob with its 400s (an engine defaulting off:
  the parsed knob now acts);
- the spec column of tests/engine/test_fused_decode.py:109: greedy and
  seeded, constrained and free, in one batch, spec on gives spec off's
  streams on the grammar key;
- a speculating row parked by a priority-0 arrival resumes with its
  drafter (the same index) and the uninterrupted spec-on stream, through
  the replay and landed from the offload tier; `Engine.adopt_stream`
  gives an adopted stream a drafter over prompt and committed tokens;
- the budget (the twin of tests/engine/test_preemption.py::
  test_prefill_chunk_budget_interleaves_and_is_token_identical): a prompt
  arriving while a row decodes runs in budget-sized chunks, token for token
  the unbudgeted engine's; its chunks are the same with and without a
  decoding row, and a prefix hit's suffix follows them (C3).

One JAX EngineCore, module-scoped, runs every reference stream.
"""

import json
import urllib.error
import urllib.request

import jax
import jsonschema
import numpy as np
import pytest
import torch

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmlb_tpu.lora import store as jstore
from llmlb_tpu.models import llama as jllama
from llmlb_tpu.structured import ConstraintCompiler as JaxCompiler
from llmlb_tpu_torch.engine.decode_graph import BurstGraphs
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import (
    EngineCore,
    Request,
    SamplingParams,
)
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.models import llama
from llmlb_tpu_torch.spec import PromptLookupDrafter
from llmlb_tpu_torch.structured import ConstraintCompiler

CFG = get_preset("debug-tiny")
EOS = 256
CORE_KW = dict(slot_capacity=128, prefill_buckets=(16, 32), kv_page_size=16,
               eos_id=EOS, seed=0, num_slots=4, prefix_cache=False)
ON = {"enabled": True}
PROMPT = list(b"count: 1 2 3 4 5 6 7 8 9 then repeat: 1 2 3 4 5")
# (prompt, sampling, speculative knob), admitted together on an engine
# whose default is off
MIXED = [(PROMPT, dict(temperature=0.0), ON),
         (list(b"alpha beta alpha beta alpha"), dict(temperature=0.0),
          {"enabled": False}),
         (list(b"aa bb aa bb aa bb"), dict(temperature=0.0),
          {"enabled": True, "max_draft_tokens": 2}),
         (PROMPT[:30], dict(temperature=0.9, top_p=0.95, seed=1234), ON)]
MAX_TOKENS = 48
ARRAY = {"type": "array", "items": {"enum": ["aa"]}, "minItems": 6,
         "maxItems": 6}
OBJECT = {"type": "object",
          "properties": {"ok": {"type": "boolean"},
                         "tag": {"enum": ["alpha", "beta"]}},
          "required": ["ok", "tag"]}
CONSTRAINED = [(list(b"emit array 0"), dict(temperature=0.0),
                {"type": "json_schema", "schema": ARRAY}),
               (list(b"produce json"), dict(temperature=0.7, seed=99),
                {"type": "json_schema", "schema": OBJECT}),
               (list(b"free text here"), dict(temperature=0.0), None)]
COUNTERS = ("verify_steps_total", "draft_tokens_total",
            "accepted_tokens_total", "emitted_tokens_total")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs, restored after it: its
    engines run many small CPU ops, which intra-op threads only slow down
    (the more so when the suite's workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jax_preset("debug-tiny"),
                                 jax.random.PRNGKey(0))
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


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
def jax_runs(weights):
    """The mixed batch, then the constrained batch, each admitted together
    on one idle JAX engine (speculation off by default, on per request),
    with the spec counters each batch added."""
    core = JaxEngineCore(jax_preset("debug-tiny"), weights[0],
                         kv_layout="paged", decode_burst=1, **CORE_KW)
    core.constraint_compiler = JaxCompiler(JaxByteTokenizer(CFG.vocab_size),
                                           CFG.vocab_size)
    out = {}

    def batch(name, rows):
        reqs = [core.submit(JaxRequest(prompt_ids=list(p), sampling=JaxSampling(
            max_tokens=MAX_TOKENS, constraint=spec, speculative=knob, **s)))
            for p, s, knob, spec in rows]
        before = core.spec_info()
        core.start()  # everything queued before the loop starts: one group
        try:
            out[name] = [_drain(r.events) for r in reqs]
        finally:
            core.stop()
        after = core.spec_info()
        out[name + "/spec"] = {k: after[k] - before[k] for k in COUNTERS}

    batch("mixed", [(p, s, knob, None) for p, s, knob in MIXED])
    batch("constrained", [(p, s, ON, spec) for p, s, spec in CONSTRAINED])
    assert core.metrics.constraint_violations_total == 0
    return out


class _StubGraph:
    """Stands in for torch.cuda.CUDAGraph: replay() runs the eager body."""

    def __init__(self, fn):
        self.replay = fn


def _core(weights, stub_graphs=False, **kw) -> EngineCore:
    core = EngineCore(CFG, params_from_numpy(weights[1], CFG, "cpu"),
                      device="cpu", **{**CORE_KW, **kw})
    core.constraint_compiler = ConstraintCompiler(ByteTokenizer(CFG.vocab_size),
                                                  CFG.vocab_size)
    if stub_graphs:
        def capture(fn):
            return _StubGraph(fn), 0, None
        core._bursts = BurstGraphs(core._burst_body, capture)
        core._verifies = BurstGraphs(core._verify_body, capture,
                                     kind="verify/")
    return core


def _step(core) -> None:
    """One iteration of the step loop's body, on this thread."""
    core._try_insert()
    core._advance_prefill()
    core._decode_active()


def _req(prompt, sampling, knob, spec=None, max_tokens=MAX_TOKENS):
    return Request(prompt_ids=list(prompt), sampling=SamplingParams(
        max_tokens=max_tokens, constraint=spec, speculative=knob, **sampling))


def _serve(core, requests, limit=3000):
    """Submit together, step until all ended; (tokens, reason) each."""
    for r in requests:
        core.submit(r)
    for _ in range(limit):
        if all(r.finished_at for r in requests):
            break
        _step(core)
    return [_drain(r.events, timeout=1) for r in requests]


def _spec(core) -> dict:
    info = core.spec_info()
    return {k: info[k] for k in COUNTERS}


def _mixed(core, knobs=True):
    return _serve(core, [_req(p, s, k if knobs else None)
                         for p, s, k in MIXED])


def _text(ids) -> str:
    return ByteTokenizer(CFG.vocab_size).decode(ids)


# ------------------------------------------------------------ the JAX twins


@pytest.mark.parametrize("stubs", [False, True], ids=["eager", "replayed"])
def test_mixed_batch_streams_and_counts_are_the_jax_engines(weights, jax_runs,
                                                            stubs):
    core = _core(weights, stub_graphs=stubs)
    assert _mixed(core) == jax_runs["mixed"]
    assert _spec(core) == jax_runs["mixed/spec"]
    assert jax_runs["mixed/spec"]["verify_steps_total"] > 0
    assert jax_runs["mixed/spec"]["accepted_tokens_total"] > 0
    stats = core.stats()
    assert stats.spec.verify_steps_total == _spec(core)["verify_steps_total"]
    if stubs:
        info = core.decode_graph_info()["verify"]
        assert set(info["keys"]) == {"verify/128/seeded"}
        assert stats.verify_eager_steps == 1
        assert stats.verify_graph_replays == (
            stats.spec.verify_steps_total - 1)
    # spec off everywhere: the same streams, no verify step
    off = _core(weights)
    assert _mixed(off, knobs=False) == jax_runs["mixed"]
    assert _spec(off)["verify_steps_total"] == 0


@pytest.mark.parametrize("kw,mode", [
    (dict(), "grammar"), (dict(fused_decode=False), "mask"),
], ids=["grammar", "mask"])
def test_constrained_rows_speculate_on_both_keys(weights, jax_runs, kw, mode):
    core = _core(weights, stub_graphs=True, **kw)
    got = _serve(core, [_req(p, s, ON, spec) for p, s, spec in CONSTRAINED])
    assert got == jax_runs["constrained"]
    for (ids, reason), schema in zip(got[:2], (ARRAY, OBJECT)):
        assert reason == "stop"
        jsonschema.validate(json.loads(_text(ids)), schema)
    st = core.stats()
    assert st.structured.constraint_violations_total == 0
    assert st.structured.masked_decode_steps_total > 0
    if mode == "grammar":
        # the JAX engine's fused verify: drafts are not cut on the host
        assert _spec(core) == jax_runs["constrained/spec"]
    else:
        # the host cuts drafts at the grammar: fewer drafted, as many
        # accepted
        spec = _spec(core)
        assert (spec["draft_tokens_total"]
                < jax_runs["constrained/spec"]["draft_tokens_total"])
    assert st.spec.accepted_tokens_total > 0
    keys = set(core.decode_graph_info()["verify"]["keys"])
    assert any(k.endswith("/" + mode) for k in keys), keys


def test_fused_grid_spec_column(weights):
    """Greedy and seeded, constrained and free, in one batch on the grammar
    key: speculation on gives speculation off's streams."""
    rows = [(p, s, spec) for p, s, spec in CONSTRAINED] + [MIXED[3][:2] + (
        None,)]
    on = _serve(_core(weights), [_req(p, s, ON, spec) for p, s, spec in rows])
    off = _serve(_core(weights), [_req(p, s, None, spec)
                                  for p, s, spec in rows])
    assert on == off


# ------------------------------------------------- the other serve paths


@pytest.fixture(scope="module")
def lora_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("spec_adapters"))
    jstore.save_adapter(d, "acme", jax_preset("debug-tiny"), rank=4)
    return d


@pytest.mark.parametrize("path", ["dense", "int8", "lora"])
def test_spec_on_equals_spec_off(weights, lora_dir, path):
    kw = {"dense": dict(kv_layout="dense"),
          "int8": dict(quantize="all", kv_page_size=4),
          "lora": dict(lora_dir=lora_dir)}[path]
    rows = [(PROMPT, dict(temperature=0.0)), ([5, 6, 7] * 4,
                                              dict(temperature=0.0)),
            (PROMPT[:24], dict(temperature=0.8, seed=7))]
    lora = "acme" if path == "lora" else None

    def run(knob):
        core = _core(weights, **kw)
        reqs = [_req(p, {**s, "lora": lora}, knob) for p, s in rows]
        return _serve(core, reqs), core

    on, core = run(ON)
    off, _ = run(None)
    assert on == off
    assert core.spec_info()["verify_steps_total"] > 0
    if path != "dense":
        assert core.page_pool.available() == core.page_pool.total


# ------------------------------------------------------------ page rollback


def _paged(weights, **kw):
    return _core(weights, **{**dict(num_slots=2, slot_capacity=64,
                                    prefill_buckets=(16,), kv_page_size=4),
                             **kw})


def test_trim_releases_over_allocated_pages_exactly_once(weights):
    core = _paged(weights)
    pool = core.page_pool
    free0 = pool.available()
    core._assign_slot_pages(0, (), core._try_reserve_pages(4))
    core._seq_lens[0] = 9
    core._trim_slot_pages(0, 10)  # 3 pages cover 10 tokens: one released
    assert pool.available() == free0 - 3 and len(core._slot_pages[0]) == 3
    assert core._block_tables[0, 3] == 0
    core._trim_slot_pages(0, 10)  # again: no double free
    assert pool.available() == free0 - 3
    core._free_slot_kv(0)
    assert pool.available() == free0


def test_trim_page_edge_rollback_empties_the_last_page(weights):
    core = _paged(weights)
    pool = core.page_pool
    free0 = pool.available()
    core._assign_slot_pages(0, (), core._try_reserve_pages(3))
    core._seq_lens[0] = 7
    core._trim_slot_pages(0, 8)  # exactly two pages: the third goes
    assert len(core._slot_pages[0]) == 2
    assert pool.available() == free0 - 2
    core._free_slot_kv(0)
    assert pool.available() == free0


def test_spec_traffic_leaves_the_pool_clean(weights):
    core = _core(weights, num_slots=4, kv_page_size=4, spec_decode=True)
    got = _serve(core, [_req(PROMPT + [i], dict(temperature=0.0), None,
                             max_tokens=40) for i in range(6)])
    assert all(r in ("stop", "length") for _, r in got)
    assert core.spec_info()["verify_steps_total"] > 0
    assert core.page_pool.used() == 0


# ------------------------------------------------------- park and resume


def _park_when(core, request, n_tokens):
    """Step until the request's row has emitted n_tokens, then park it."""
    for _ in range(500):
        slot = next((i for i, s in enumerate(core.slots)
                     if s.request is request), None)
        if (slot is not None and core._parkable(core.slots[slot])
                and len(core.slots[slot].out_tokens) >= n_tokens):
            drafter = core.slots[slot].drafter
            core._park_slot(slot)
            return drafter
        _step(core)
    raise AssertionError("the row never reached the park point")


@pytest.mark.parametrize("tier", [False, True], ids=["replayed", "landed"])
def test_speculating_row_parks_with_its_drafter(weights, tier):
    kw = dict(num_slots=1, kv_offload_bytes=1 << 26 if tier else 0)
    want = _serve(_core(weights, **kw), [_req(PROMPT, dict(temperature=0.0),
                                              ON)])
    core = _core(weights, **kw)
    r = _req(PROMPT, dict(temperature=0.0), ON)
    core.submit(r)
    drafter = _park_when(core, r, 12)
    assert drafter is not None and r.parked.drafter is drafter
    assert r.parked.spec_k == core.spec.max_draft_tokens
    resumed = False
    for _ in range(500):
        if r.finished_at:
            break
        _step(core)
        if (not resumed and core.slots[0].request is r
                and not core.slots[0].prefilling):
            resumed = True
            assert core.slots[0].drafter is drafter
    assert [_drain(r.events, timeout=1)] == want
    stats = core.stats()
    assert stats.preempt_resumes_total == 1
    assert stats.kv.kv_restored_total == (1 if tier else 0)
    assert stats.spec.verify_steps_total > 0


def test_adopted_stream_gets_a_drafter_over_prompt_and_committed(weights):
    engine = Engine("tiny", _core(weights, spec_decode=True),
                    ByteTokenizer(CFG.vocab_size))
    sampling = SamplingParams(temperature=0.0, max_tokens=24)
    full = _serve(engine.core, [_req(PROMPT, dict(temperature=0.0), None,
                                     max_tokens=24)])[0][0]
    committed = full[:6]
    state = engine.core.adopted_state(PROMPT, committed, sampling)
    drafter, k = state.drafter, state.spec_k
    ref = PromptLookupDrafter(PROMPT + committed)
    assert k == 4 and drafter.tokens == ref.tokens
    assert drafter.propose(4) == ref.propose(4)
    off = engine.core.adopted_state(PROMPT, committed, SamplingParams(
        speculative={"enabled": False}))
    assert (off.drafter, off.spec_k) == (None, 0)
    engine.core.start()
    try:
        deltas = list(engine.adopt_stream(PROMPT, committed, sampling))
    finally:
        engine.shutdown()
    ids = [t for d in deltas for t in (d.token_ids or [])]
    assert ids == full
    assert engine.core.spec_info()["verify_steps_total"] > 0


# -------------------------------------------------------------- HTTP knob


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_knob_acts_and_health_carries_the_spec_block(weights):
    engine = Engine("tiny", _core(weights), ByteTokenizer(CFG.vocab_size))
    engine.core.start()
    server, thread = start_server(engine)
    base = "http://%s:%d" % server.server_address[:2]
    try:
        with urllib.request.urlopen(base + "/api/health", timeout=60) as resp:
            spec = json.loads(resp.read())["spec"]
        assert spec["enabled"] is False and spec["available"] is True
        assert spec["max_draft_tokens"] == 4 and spec["ngram"] == [1, 3]
        body = {"model": "tiny", "max_tokens": 40, "temperature": 0.0,
                "messages": [{"role": "user", "content": _text(PROMPT)}]}
        status, _ = _post(base + "/v1/chat/completions", body)
        assert status == 200
        assert engine.core.spec_info()["verify_steps_total"] == 0
        status, _ = _post(base + "/v1/chat/completions", {
            **body, "speculative": {"enabled": True, "max_draft_tokens": 4}})
        assert status == 200
        assert engine.core.spec_info()["verify_steps_total"] > 0
        for bad in ("yes", {"enabled": "yes"}, {"max_draft_tokens": 0},
                    {"max_draft_tokens": True}):
            status, err = _post(base + "/v1/chat/completions",
                                {**body, "speculative": bad})
            assert status == 400, bad
            assert "speculative" in err["error"]["message"]
        with urllib.request.urlopen(base + "/api/system", timeout=60) as resp:
            system = json.loads(resp.read())
        assert system["spec"]["verify_steps_total"] > 0
        assert system["sched"]["prefill_chunk_budget"] == 0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        engine.shutdown()


# ---------------------------------------------------- prefill chunk budget


def _chunks_of(core, monkeypatch) -> list:
    """Record (start, chunk length, bucket) of every chunk the core runs."""
    seen = []
    extend = llama.prefill_extend_pages

    def spy(params, cfg, ids, lens, start, *args, **kw):
        seen.append((int(start[0]), int(lens[0]), ids.shape[1]))
        return extend(params, cfg, ids, lens, start, *args, **kw)

    monkeypatch.setattr(llama, "prefill_extend_pages", spy)
    return seen


def _budget_core(weights, budget, **kw):
    return _core(weights, **{**dict(num_slots=2, slot_capacity=256,
                                    prefill_buckets=(16, 32, 64, 128),
                                    kv_page_size=16,
                                    prefill_chunk_budget=budget), **kw})


def test_budget_interleaves_and_is_token_identical(weights, monkeypatch,
                                                   caplog):
    long_prompt = list(b"x" * 100)  # > 64, within the 128 bucket

    def run(budget):
        core = _budget_core(weights, budget)
        chunks = _chunks_of(core, monkeypatch)
        bg = _req(list(b"background decoder"), dict(temperature=0.0), None,
                  max_tokens=120)
        core.submit(bg)
        while len(core.slots[0].out_tokens) < 2:
            _step(core)
        before = core.prefill_dispatches
        got = _serve(core, [_req(long_prompt, dict(temperature=0.0), None,
                                 max_tokens=8)])
        assert not bg.finished_at  # the decoder outlived the long prompt
        return got, core.prefill_dispatches - before, chunks, core

    got_b, steps_b, chunks_b, core = run(32)
    got_f, steps_f, _, _ = run(0)
    assert got_b == got_f
    assert steps_f == 1
    assert steps_b == 4  # 100 tokens in chunks of 32
    assert chunks_b == [(0, 32, 32), (32, 32, 32), (64, 32, 32),
                        (96, 4, 16)]
    assert core.sched_info()["prefill_chunk_budget"] == 32
    with caplog.at_level("WARNING"):
        small = _budget_core(weights, 8)
    assert small._chunk_bucket == 16
    assert "below the smallest prefill bucket" in caplog.text


def test_budget_chunks_do_not_depend_on_decoders_and_hits_follow_them(
        weights, monkeypatch):
    """C3 under the budget: a 90-token prompt runs the same chunks on an
    idle engine as beside a decoding row, and its prefix hit (80 tokens
    cached, at prefix_align 16) runs its suffix as the rest of the cold
    run's last chunk, at that chunk's bucket; the hit's stream is the cold
    run's."""
    prompt = list(b"y" * 90)
    idle = _budget_core(weights, 32, prefix_cache=True)
    chunks = _chunks_of(idle, monkeypatch)
    cold = _serve(idle, [_req(prompt, dict(temperature=0.0), None,
                              max_tokens=8)])
    cold_chunks = list(chunks)
    assert cold_chunks == [(0, 32, 32), (32, 32, 32), (64, 26, 32)]
    chunks.clear()
    hit = _serve(idle, [_req(prompt, dict(temperature=0.0), None,
                             max_tokens=8)])
    assert idle.stats().prefix.prefix_hits_total == 1
    assert chunks == [(80, 10, 32)]  # the rest of the last chunk, its bucket
    assert hit == cold
    busy = _budget_core(weights, 32)
    chunks = _chunks_of(busy, monkeypatch)
    busy.submit(_req(list(b"background"), dict(temperature=0.0), None,
                     max_tokens=100))
    while not busy.slots[0].out_tokens:
        _step(busy)
    assert _serve(busy, [_req(prompt, dict(temperature=0.0), None,
                              max_tokens=8)]) == cold
    assert chunks == cold_chunks
