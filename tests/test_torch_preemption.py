"""The port's overload protection against the JAX package: priority classes,
deadline shedding, park/resume and page-exhaustion parking.

Held to the docstring of tests/engine/test_preemption.py (a parked request
resumes token-identical to an uninterrupted run), here against the JAX
engine's uninterrupted streams for the same weights and prompts:

- the class queues, the held request, deadline shedding and `sched_info`
  on a core whose step loop never starts;
- a priority-2 victim on a one-slot engine parked by a priority-0 arrival,
  greedy and seeded, paged and dense, with an adapter, and with a prompt
  longer than the largest bucket (chunked on resume as when cold): its
  stream is the JAX engine's; and on a split engine (`role="split"`, one
  prefill and one decode slot, with and without speculation), where the
  arrival's adoption parks the victim mid-generation, which resumes
  through the prefill pool and hands off a second time, as the reference's
  `split` and `split-spec` cases do;
- a page pool too small for two growing rows: the loser parks instead of
  finishing with "length" (the reference itself fails this today);
- the resumed row's forced tail writes the KV rows the uninterrupted run
  wrote, exactly (both layouts);
- drain at the core: nothing admitted, rows parked, queue flushed.

The engines are driven by hand (one step-loop iteration at a time), so
each park lands at a known token. debug-tiny is fp32 on the CPU, so the
KV comparison is bit for bit and the streams token for token. One JAX
EngineCore, module-scoped.
"""

import queue
import time

import jax
import numpy as np
import pytest
import torch

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.lora import store as jstore
from llmlb_tpu.models import llama as jllama
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import (
    EngineCore,
    ParkedState,
    Request,
    SamplingParams,
)
from llmlb_tpu_torch.engine.weights import params_from_numpy

CORE_KW = dict(slot_capacity=128, prefill_buckets=(16, 32), kv_page_size=16,
               eos_id=-1, seed=0)
MAX_TOKENS = 24
PROMPT = list(range(40, 60))  # 20 tokens: one bucket-32 prefill
LONG = list(range(100, 140))  # 40 tokens: chunked past the 32 bucket
GREEDY = dict(temperature=0.0)
SEEDED = dict(temperature=0.9, seed=1234)
# page exhaustion: two 12-token prompts growing to 36 on 8-token pages
# want 5 pages each; the pool has 8 (and the trash page)
EXHAUST = ([7] * 12, [9] * 12)
# (name, prompt, sampling, adapter) of every uninterrupted JAX stream
CASES = {
    "greedy": (PROMPT, GREEDY, None),
    "seeded": (PROMPT, SEEDED, None),
    "greedy-lora": (PROMPT, GREEDY, "acme"),
    "seeded-lora": (PROMPT, SEEDED, "acme"),
    "greedy-long": (LONG, GREEDY, None),
    "exhaust-a": (EXHAUST[0], GREEDY, None),
    "exhaust-b": (EXHAUST[1], GREEDY, None),
}


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jax_preset("debug-tiny"),
                                 jax.random.PRNGKey(0))
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


@pytest.fixture(scope="module")
def lora_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("adapters"))
    jstore.save_adapter(d, "acme", jax_preset("debug-tiny"), rank=4)
    return d


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
def jax_streams(weights, lora_dir):
    """Each case alone on the idle JAX engine, uninterrupted."""
    core = JaxEngineCore(jax_preset("debug-tiny"), weights[0],
                         kv_layout="paged", prefix_cache=False,
                         decode_burst=1, num_slots=2, lora_dir=lora_dir,
                         lora_rank_cap=8, **CORE_KW)
    core.start()
    try:
        return {name: _drain(core.submit(JaxRequest(
            prompt_ids=list(p), sampling=JaxSampling(
                max_tokens=MAX_TOKENS, lora=adapter, **s))).events)
            for name, (p, s, adapter) in CASES.items()}
    finally:
        core.stop()


def _core(weights, num_slots=1, **kw):
    cfg = get_preset("debug-tiny")
    return EngineCore(cfg, params_from_numpy(weights[1], cfg, "cpu"),
                      device="cpu", num_slots=num_slots, prefix_cache=False,
                      **{**CORE_KW, **kw})


def _step(core) -> None:
    """One iteration of the step loop's body, on this thread (of both split
    loops' bodies, each under its thread's tag, for a split engine)."""
    if core.split is not None:
        core._tls.tag = "prefill"
        core.split.pump_handoffs()
        core._try_insert()
        core._advance_prefill()
        core._tls.tag = "decode"
        core._decode_active()
        core.split.pump_handoffs()
        core._tls.tag = "main"
        return
    if core._drain_park_requested:
        core._drain_park_requested = False
        core._drain_park_all()
    if core._drain_flush_requested:
        core._drain_flush_requested = False
        core._drain_flush_all()
    core._try_insert()
    core._advance_prefill()
    core._decode_active()


def _take(events: queue.SimpleQueue, out: list) -> str | None:
    """Move the queued token events into `out`; the terminal event's value
    (or None while the request runs)."""
    while True:
        try:
            kind, value = events.get_nowait()
        except queue.Empty:
            return None
        if kind == "token":
            out.append(int(value))
        elif kind == "error":
            raise AssertionError(f"engine error: {value}")
        else:
            return value


def _run(core, requests, until=None, limit=2000) -> list:
    """Step until every request ended, or until `until(got)` holds; returns
    `got`, the (tokens, finish reason or None) of each request so far."""
    got = [[[], None] for _ in requests]
    for _ in range(limit):
        for g, r in zip(got, requests):
            if g[1] is None:
                g[1] = _take(r.events, g[0])
        if (all(g[1] is not None for g in got)
                or (until is not None and until(got))):
            return [tuple(g) for g in got]
        _step(core)
    raise AssertionError("the engine did not finish the requests")


def _req(prompt, priority=1, max_tokens=MAX_TOKENS, lora=None,
         deadline_ms=None, **sampling):
    return Request(prompt_ids=list(prompt), sampling=SamplingParams(
        max_tokens=max_tokens, priority=priority, lora=lora,
        deadline_ms=deadline_ms, **{**GREEDY, **sampling}))


# ------------------------------------------------------------ class queues


@pytest.fixture
def cold_core(weights):
    """A core whose step loop never starts: the queues are driven by hand."""
    core = _core(weights, num_slots=2, slot_capacity=64)
    yield core
    core._fail_all("test over")


def test_class_queues_pop_strictly_by_priority(cold_core):
    reqs = [_req((1, 2, 3), 2), _req((1, 2, 3), 0), _req((1, 2, 3), 1),
            _req((1, 2, 3), 0)]
    for r in reqs:
        cold_core.pending.put(r)
    cold_core._drain_pending()
    assert cold_core.queue_class_depths() == {"high": 2, "normal": 1,
                                              "low": 1}
    assert [cold_core._pop_request() for _ in range(4)] == [
        reqs[1], reqs[3], reqs[2], reqs[0]]
    assert cold_core._pop_request() is None


def test_pop_prefers_more_important_class_over_held(cold_core):
    low, hi = _req((1, 2, 3), 2), _req((1, 2, 3), 0)
    cold_core._held_request = low
    cold_core._class_queues[0].append(hi)
    assert cold_core._head_priority() == 0
    assert cold_core._pop_request() is hi
    # the held request still holds the front of its own class
    assert cold_core._pop_request() is low
    assert cold_core._held_request is None
    assert cold_core._pop_request() is None


def test_hold_on_pool_never_overwrites_held(cold_core):
    a, b = _req((1, 2, 3), 2), _req((1, 2, 3), 0)
    cold_core._hold_on_pool(a)
    cold_core._hold_on_pool(b)  # the second hold requeues, never drops a
    assert cold_core._held_request is a
    assert cold_core._pop_request() is b
    assert cold_core._pop_request() is a
    assert cold_core._pop_request() is None


def test_expired_deadline_is_shed_before_prefill(cold_core):
    req = _req((1, 2, 3), deadline_ms=1.0)
    time.sleep(0.01)
    cold_core.pending.put(req)
    assert cold_core._try_insert() is True  # handled work: the shed
    assert req.events.get_nowait() == ("error",
                                       "deadline exceeded before prefill")
    assert cold_core.stats().deadline_shed_total == 1
    assert cold_core.prefill_dispatches == 0
    assert all(s.request is None for s in cold_core.slots)


def test_resumed_request_is_never_shed(cold_core):
    req = _req((1, 2, 3), deadline_ms=1.0)
    req.parked = ParkedState(generated=2, tokens=[5, 6])
    time.sleep(0.01)
    cold_core.pending.put(req)
    cold_core._try_insert()
    assert cold_core.stats().deadline_shed_total == 0
    assert cold_core.prefill_dispatches == 1
    assert cold_core.stats().preempt_resumes_total == 1
    assert req.parked is None
    assert req.events.empty()  # the committed tokens are not emitted again


def test_sched_info(cold_core):
    cold_core.pending.put(_req((1, 2, 3), 0))
    cold_core._drain_pending()
    assert cold_core.sched_info() == {
        "prefill_chunk_budget": 0,
        "queued_by_class": {"high": 1, "normal": 0, "low": 0},
        "preemptions_total": 0, "preempt_resumes_total": 0,
        "deadline_shed_total": 0}
    assert cold_core.stats().queued == 1


# ------------------------------------------------------------ park / resume


PARK_CASES = [("paged", "greedy"), ("paged", "seeded"), ("dense", "greedy"),
              ("dense", "seeded"), ("paged", "greedy-lora"),
              ("paged", "seeded-lora"), ("dense", "greedy-long"),
              ("split", "greedy"), ("split", "seeded"),
              ("split-spec", "greedy"), ("split-spec", "seeded")]
# the engines of the layouts beside the two KV layouts: one prefill and one
# decode slot, so the arrival's adoption is the preemption point
SPLIT_KW = {"split": dict(role="split", disagg_prefill_slots=1, num_slots=2),
            "split-spec": dict(role="split", disagg_prefill_slots=1,
                               num_slots=2, spec_decode=True)}


@pytest.mark.parametrize("layout,case", PARK_CASES,
                         ids=[f"{a}-{b}" for a, b in PARK_CASES])
def test_priority_park_resume_is_the_jax_stream(weights, lora_dir,
                                                jax_streams, layout, case):
    """One decoding slot: the priority-2 victim decodes 5 tokens, a
    priority-0 request arrives and parks it, and its resumed stream is the
    JAX engine's uninterrupted one. On a split engine the victim hands off
    twice: once cold, once after its resume through the prefill pool."""
    prompt, sampling, adapter = CASES[case]
    kw = SPLIT_KW.get(layout, {"kv_layout": layout})
    core = _core(weights, **kw,
                 **({"lora_dir": lora_dir, "lora_rank_cap": 8}
                    if adapter else {}))
    victim = core.submit(_req(prompt, 2, lora=adapter, **sampling))
    [(emitted, _)] = _run(core, [victim], until=lambda g: len(g[0][0]) >= 5)
    hi = core.submit(_req([3, 1, 4, 1, 5], 0, max_tokens=6))
    (hi_toks, hi_reason), (rest, reason) = _run(core, [hi, victim])
    assert hi_reason == "length" and len(hi_toks) == 6
    st = core.stats()
    assert (st.preemptions_total, st.preempt_resumes_total) == (1, 1)
    assert (emitted + rest, reason) == tuple(jax_streams[case])
    if adapter:
        assert core.lora_info()["active"] == {}
        assert jax_streams[case] != jax_streams[case.replace("-lora", "")]
    if core.split is not None:
        # the victim twice, the arrival once; no prefill on the decode loop
        assert core.metrics.handoff_total["in_process"] == 3
        assert core.prefill_dispatch_by_loop["decode"] == 0
        assert core.page_pool.available() == core.page_pool.total


def test_same_class_waits_instead_of_parking(weights):
    core = _core(weights)
    first = core.submit(_req(PROMPT, 1, max_tokens=8))
    _run(core, [first], until=lambda g: len(g[0][0]) >= 2)
    second = core.submit(_req(PROMPT, 1, max_tokens=8))
    _run(core, [first, second])
    assert core.stats().preemptions_total == 0


def test_midstream_page_exhaustion_parks_instead_of_finishing(weights,
                                                              jax_streams):
    """Two decoders that cannot both fit the pool: the loser parks and
    resumes, and both streams are the JAX engine's uncontended ones; none
    ends early with "length"."""
    core = _core(weights, num_slots=2, slot_capacity=64, kv_page_size=8,
                 kv_pages=9)
    reqs = [core.submit(_req(p)) for p in EXHAUST]
    got = _run(core, reqs)
    assert got == [tuple(jax_streams["exhaust-a"]),
                   tuple(jax_streams["exhaust-b"])]
    assert core.stats().preemptions_total >= 1
    assert core.page_pool.available() == core.page_pool.total


def _kv_rows(core, slot_id, n):
    """K and V of a row's positions [0, n), every layer, in order."""
    if core.page_pool is None:
        return core.cache_k[:, slot_id, :n].clone(), \
            core.cache_v[:, slot_id, :n].clone()
    pos = torch.arange(n)
    pages = torch.as_tensor(core._block_tables[slot_id])[
        pos // core.kv_page_size].long()
    off = pos % core.kv_page_size
    return core.cache_k[:, pages, off].clone(), core.cache_v[:, pages, off].clone()


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_forced_tail_writes_the_uninterrupted_kv(weights, layout):
    """A row parked after m committed tokens resumes: its prompt prefills,
    then decode steps fed committed[1:] write those tokens' KV. Once the
    tail is fed, the row's KV rows equal the ones the uninterrupted run
    wrote before the park, bit for bit, and its next tokens are the
    uninterrupted run's."""
    core = _core(weights, num_slots=2, kv_layout=layout)
    ref = _run(core, [core.submit(_req(PROMPT, **SEEDED))])[0]
    victim = core.submit(_req(PROMPT, **SEEDED))
    [(emitted, _)] = _run(core, [victim], until=lambda g: len(g[0][0]) >= 7)
    slot_id = next(i for i, s in enumerate(core.slots)
                   if s.request is victim)
    m = len(emitted)
    n_kv = len(PROMPT) + m - 1  # prompt, then committed[0 .. m-2]
    assert core._seq_lens[slot_id] == n_kv
    before = _kv_rows(core, slot_id, n_kv)
    core._park_slot(slot_id)
    assert victim.parked.tokens == emitted

    def tail_fed(_got):
        s = next((s for s in core.slots if s.request is victim), None)
        return (s is not None and not s.forced and not s.prefilling
                and core._seq_lens[core.slots.index(s)] == n_kv)

    _run(core, [victim], until=tail_fed)
    slot_id = next(i for i, s in enumerate(core.slots)
                   if s.request is victim)
    after = _kv_rows(core, slot_id, n_kv)
    assert torch.equal(before[0], after[0]) and torch.equal(before[1],
                                                            after[1])
    rest, reason = _run(core, [victim])[0]
    assert (emitted + rest, reason) == ref


# ------------------------------------------------------------------ drain


def test_drain_parks_rows_and_flushes_the_queue(weights):
    core = _core(weights)
    running = core.submit(_req(PROMPT, max_tokens=MAX_TOKENS))
    [(emitted, _)] = _run(core, [running], until=lambda g: len(g[0][0]) >= 3)
    waiting = core.submit(_req(LONG))
    core.begin_drain()
    _step(core)
    assert core.stats().queued == 1  # admitted nothing
    core.request_drain_park()
    _step(core)
    st = core.stats()
    assert (st.drain_parked_total, st.preemptions_total) == (1, 1)
    assert st.active_slots == 0 and st.queued == 2
    assert _take(running.events, emitted) is None  # parked, not finished
    assert running.parked.tokens == emitted
    core.request_drain_flush()
    _step(core)
    for r in (running, waiting):
        assert r.events.get_nowait() == ("error", "engine draining")
    assert core.stats().queued == 0
    assert core.page_pool.available() == core.page_pool.total


def test_resume_at_the_capacity_edge(weights):
    """A request resumed near the slot's end reserves no page past the
    row's table and ends where the uninterrupted run ends; one parked at
    the edge itself ends with "length" at once, emitting nothing."""
    core = _core(weights, num_slots=2, decode_burst=4)
    [(solo, reason)] = _run(core, [core.submit(_req(PROMPT,
                                                    max_tokens=200))])
    assert reason == "length"
    assert len(PROMPT) + len(solo) == core.slot_capacity
    near = _req(PROMPT, max_tokens=200)
    near.parked = ParkedState(generated=105, tokens=solo[:105])
    edge = _req(PROMPT, max_tokens=200)
    edge.parked = ParkedState(generated=len(solo), tokens=solo)
    got = _run(core, [core.submit(near), core.submit(edge)])
    assert got == [(solo[105:], "length"), ([], "length")]
    assert core.page_pool.available() == core.page_pool.total


def test_resumed_row_goes_in_with_its_first_committed_token(weights):
    """In a padded prefill group (3 rows padded to 4 by repeating the last)
    a resumed unseeded row goes into decode with its first committed token,
    never with the activation's fresh draw, and emits nothing for it."""
    core = _core(weights, num_slots=4)
    reqs = [_req(PROMPT[:12 + i], temperature=1.0) for i in range(3)]
    reqs[2].parked = ParkedState(generated=3, tokens=[7, 8, 9])
    for r in reqs:
        core.submit(r)
    core._try_insert()
    assert core.prefill_dispatches == 1  # one group of three, padded to 4
    slot = next(i for i, s in enumerate(core.slots) if s.request is reqs[2])
    assert int(core._d_last_tokens[slot]) == 7
    assert core.slots[slot].forced == [8, 9]
    assert not core.slots[slot].first_pending and reqs[2].events.empty()
