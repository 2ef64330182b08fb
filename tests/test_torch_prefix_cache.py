"""The port's prefix KV cache against the JAX package's.

Three layers, as in the reference's own tests
(tests/engine/test_prefix_cache.py):

- The radix tree: the reference's unit cases, run over both
  implementations, and random sequences of insert, match, acquire,
  release, evict and evict_subsumed that must give both the same results.
- The port's EngineCore over both KV layouts (dense: pinned donor slots and
  a device row copy per hit; paged: zero-copy page sharing): a hit gives the
  cold run's greedy stream, dispatches only its suffix (and no copy when
  paged), and leaves the donor evictable on cancel; donors are reclaimed
  under slot pressure and subsumed by longer turns. Two invariants of the
  shared KV: a paged hit row's parked garbage writes never land in a shared
  page, and a dense donor's rows survive any number of bursts.
- A JAX EngineCore with the cache on in each layout, over the same
  weights and traffic as the port (requests one at a time, then a group
  admitted together): identical greedy streams, counters, cache info and
  entries.
"""

import dataclasses
import json
import queue
import urllib.request

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from llmlb_tpu.engine.prefix_cache import PrefixCache as JaxPrefixCache
from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.models import llama as jllama
from llmlb_tpu_torch.engine.prefix_cache import PrefixCache
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import EngineCore, Request, SamplingParams
from llmlb_tpu_torch.engine.server import build_parser, start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.models import llama

CFG = get_preset("debug-tiny")

# ----------------------------------------------------------------- radix tree

IMPLS = {"jax": JaxPrefixCache, "port": PrefixCache}


@pytest.fixture(params=sorted(IMPLS))
def make_cache(request):
    impl = IMPLS[request.param]

    def make(**kw):
        kw.setdefault("max_entries", 4)
        kw.setdefault("min_len", 4)
        kw.setdefault("align", 4)
        return impl(**kw)

    return make


def _slot(entry):
    return None if entry is None else entry.slot


def test_insert_and_exact_match(make_cache):
    c = make_cache()
    assert c.insert((1, 2, 3, 4, 5, 6, 7, 8), slot=0) is not None
    entry, use_len = c.match([1, 2, 3, 4, 5, 6, 7, 8, 9], max_len=8)
    assert (entry.slot, use_len) == (0, 8)
    assert c.pinned_slots() == {0}
    assert c.cached_tokens() == 8


def test_match_uses_partial_head_of_longer_entry(make_cache):
    c = make_cache()
    c.insert(tuple(range(100, 112)), slot=1)
    entry, use_len = c.match(list(range(100, 106)) + [999, 998], max_len=7)
    assert (entry.slot, use_len) == (1, 4)  # 6 matched, aligned down


def test_match_respects_max_len_and_min_len(make_cache):
    c = make_cache()
    c.insert((1, 2, 3, 4, 5, 6, 7, 8), slot=0)
    _entry, use_len = c.match([1, 2, 3, 4, 5, 6, 7, 8], max_len=7)
    assert use_len == 4
    assert c.match([1, 2, 3, 9], max_len=3) is None


def test_edge_split_on_divergent_insert(make_cache):
    c = make_cache()
    c.insert((1, 2, 3, 4, 5, 6, 7, 8), slot=0)
    c.insert((1, 2, 3, 4, 9, 9, 9, 9), slot=1)
    e0, u0 = c.match([1, 2, 3, 4, 5, 6, 7, 8, 0], max_len=8)
    e1, u1 = c.match([1, 2, 3, 4, 9, 9, 9, 9, 0], max_len=8)
    assert (e0.slot, u0, e1.slot, u1) == (0, 8, 1, 8)
    assert len(c) == 2


def test_covers_blocks_duplicate_coverage_but_allows_extension(make_cache):
    c = make_cache()
    c.insert((1, 2, 3, 4), slot=0)
    assert c.covers((1, 2, 3, 4))
    assert c.insert((1, 2, 3, 4), slot=1) is None
    assert c.insert((1, 2, 3, 4, 5, 6, 7, 8), slot=1) is not None
    assert c.covers((1, 2, 3, 4))


def test_refcount_blocks_eviction(make_cache):
    c = make_cache()
    e = c.insert((1, 2, 3, 4), slot=0)
    c.acquire(e)
    assert c.evict_lru_entry() is None
    c.release(e)
    assert c.evict_lru_entry() is e
    assert len(c) == 0
    assert c.match([1, 2, 3, 4, 5], max_len=4) is None


def test_lru_eviction_order_and_match_refreshes(make_cache):
    c = make_cache()
    for slot, tok in enumerate((1, 2, 3)):
        c.insert((tok,) * 8, slot=slot)
    c.match([1] * 9, max_len=8)
    assert [_slot(c.evict_lru_entry()) for _ in range(4)] == [1, 2, 0, None]


def test_evict_subsumed_reclaims_ancestor_donors(make_cache):
    c = make_cache()
    e1 = c.insert((1, 2, 3, 4), slot=0)
    turn2 = (1, 2, 3, 4, 5, 6, 7, 8)
    assert [e.slot for e in c.evict_subsumed_entries(turn2)] == [0]
    c.insert(turn2, slot=1)
    assert c.pinned_slots() == {1}
    entry, use_len = c.match([1, 2, 3, 4, 9], max_len=4)
    assert (entry.slot, use_len) == (1, 4)
    e2 = c.insert((9, 9, 9, 9), slot=2)
    c.acquire(e2)
    assert c.evict_subsumed_entries((9, 9, 9, 9, 1, 1, 1, 1)) == []
    c.release(e2)
    assert e1.node is None


def test_budget_rejects_insert_when_full(make_cache):
    c = make_cache(max_entries=1)
    assert c.insert((1, 2, 3, 4), slot=0) is not None
    assert c.insert((5, 6, 7, 8), slot=1) is None
    assert _slot(c.evict_lru_entry()) == 0
    assert c.insert((5, 6, 7, 8), slot=1) is not None


def test_clear_drops_everything(make_cache):
    c = make_cache()
    c.insert((1, 2, 3, 4), slot=0)
    c.insert((1, 2, 3, 4, 5, 6, 7, 8), slot=1)
    c.clear()
    assert len(c) == 0
    assert c.match([1, 2, 3, 4, 5], max_len=4) is None


def test_namespaces_and_paged_entries_are_apart(make_cache):
    """An adapter's tree never serves another's prompt, and paged entries
    (slot -1, their page ids) pin no slot and take unique keys."""
    c = make_cache()
    e = c.insert((1, 2, 3, 4), slot=-1, pages=(7,), ns="acme")
    assert c.match([1, 2, 3, 4, 5], max_len=4) is None
    assert c.match([1, 2, 3, 4, 5], max_len=4, ns="acme") == (e, 4)
    e2 = c.insert((5, 6, 7, 8), slot=-1, pages=(9,))
    assert e.key != e2.key and c.pinned_slots() == frozenset()
    assert c.evict_lru_entry() is e and c.evict_subsumed_entries(
        (5, 6, 7, 8, 1, 1, 1, 1)) == [e2]


# (op, a, b): tokens come from a 3-letter alphabet, so prefixes collide
_TOKENS = st.lists(st.integers(0, 2), min_size=1, max_size=12)
_OPS = st.lists(st.tuples(
    st.sampled_from(["insert", "insert_paged", "match", "acquire", "release",
                     "evict", "evict_subsumed", "touch", "covers"]),
    _TOKENS, st.integers(0, 12), st.sampled_from([None, "acme"])),
    max_size=40)


def _script(cache, ops) -> list:
    """Replay `ops` on one cache; every result as plain data."""
    out = []
    held = []  # entries acquired, in order
    slot = 0
    for op, tokens, k, ns in ops:
        if op in ("insert", "insert_paged"):
            slot += 1
            e = (cache.insert(tokens, slot, ns=ns) if op == "insert" else
                 cache.insert(tokens, -1, pages=(slot,), ns=ns))
            out.append(None if e is None else (e.tokens, e.slot, e.pages))
        elif op == "match":
            hit = cache.match(tokens, max_len=k, ns=ns)
            out.append(None if hit is None else (hit[0].tokens, hit[1]))
        elif op == "acquire":
            hit = cache.match(tokens, max_len=len(tokens), ns=ns)
            if hit is not None:
                cache.acquire(hit[0])
                held.append(hit[0])
            out.append(hit is not None)
        elif op == "release":
            if held:
                cache.release(held.pop(k % len(held)))
        elif op == "evict":
            e = cache.evict_lru_entry()
            out.append(None if e is None else (e.tokens, e.slot, e.pages))
        elif op == "evict_subsumed":
            out.append(sorted(e.tokens for e in
                              cache.evict_subsumed_entries(tokens, ns)))
        elif op == "touch":
            cache.touch(tokens, ns)
        else:
            out.append(cache.covers(tokens, ns))
        out.append((len(cache), cache.cached_tokens(),
                    sorted(cache.pinned_slots()),
                    sorted((e.tokens, e.refcount, e.last_used)
                           for e in cache.entries())))
    return out


@settings(max_examples=150, deadline=None, database=None)
@given(ops=_OPS, max_entries=st.integers(0, 4), align=st.integers(1, 3))
def test_random_operation_sequences_agree_with_the_reference(ops, max_entries,
                                                             align):
    kw = dict(max_entries=max_entries, min_len=align, align=align)
    assert _script(PrefixCache(**kw), ops) == _script(JaxPrefixCache(**kw),
                                                      ops)


# ---------------------------------------------------------------- engine core


def _run(core, prompt_ids, *, max_tokens=4, lora=None):
    r = core.submit(Request(prompt_ids=list(prompt_ids), sampling=SamplingParams(
        temperature=0.0, max_tokens=max_tokens, lora=lora)))
    toks = []
    while True:
        kind, value = r.events.get(timeout=120)
        if kind == "token":
            toks.append(int(value))
        elif kind == "error":
            raise AssertionError(f"engine error: {value}")
        else:
            return toks, value


@pytest.fixture(scope="module")
def prompt():
    rng = np.random.default_rng(7)
    return [int(t) for t in rng.integers(1, CFG.vocab_size, size=(48,))]


@pytest.fixture(params=["dense", "paged"])
def kv_layout(request):
    return request.param


def make_core(kv_layout, **kw):
    # 16-token pages equal the bucket: aligned lengths and every counter
    # below are the same in both layouts
    kw.setdefault("kv_page_size", 16)
    kw.setdefault("num_slots", 4)
    kw.setdefault("slot_capacity", 64)
    kw.setdefault("prefill_buckets", (16,))
    return EngineCore(CFG, device="cpu", kv_layout=kv_layout, seed=0, **kw)


def test_cache_hit_reuses_prefix_and_matches_cold_output(prompt, kv_layout):
    core = make_core(kv_layout)
    core.start()
    try:
        cold = _run(core, prompt)
        st = core.stats()
        assert (st.prefix.prefix_misses_total, st.prefix.prefix_insertions_total) == (1, 1)
        info = core.prefix_cache_info()
        assert info["enabled"] and info["entries"] == 1
        assert info["cached_tokens"] == 48
        warm = _run(core, prompt)
        st = core.stats()
        assert st.prefix.prefix_hits_total == 1
        assert st.prefix.prefix_cached_tokens_total == 32  # 47 aligned to 16
        assert warm == cold
    finally:
        core.stop()


def test_divergent_tail_still_hits_shared_head(prompt, kv_layout):
    core = make_core(kv_layout)
    core.start()
    try:
        _run(core, prompt)
        _run(core, prompt[:40] + [p - 1 for p in prompt[40:]])
        st = core.stats()
        assert (st.prefix.prefix_hits_total, st.prefix.prefix_cached_tokens_total) == (1, 32)
    finally:
        core.stop()


def test_slot_pressure_evicts_donors_for_live_traffic(kv_layout):
    rng = np.random.default_rng(3)
    core = make_core(kv_layout, num_slots=2, prefix_cache_slots=1)
    core.start()
    try:
        for _ in range(4):
            _run(core, rng.integers(1, CFG.vocab_size, size=(20,)).tolist())
        assert core.stats().prefix.prefix_evictions_total >= 1
        assert core.stats().active_slots == 0
        assert len(core.prefix_cache) <= 1
    finally:
        core.stop()


def _drive(core, requests, limit=500, queue_them=True):
    """The step loop inline (the core not started) until every request of
    `requests` (queued here unless `queue_them` is False) ends; their
    (tokens, finish) in order."""
    for r in requests if queue_them else ():
        core.pending.put(r)
    out = {id(r): [] for r in requests}
    done = {}
    for _ in range(limit):
        core._try_insert()
        core._advance_prefill()
        core._decode_active()
        for r in requests:
            try:
                while True:
                    kind, value = r.events.get_nowait()
                    if kind == "token":
                        out[id(r)].append(int(value))
                    elif kind == "error":
                        raise AssertionError(f"engine error: {value}")
                    else:
                        done[id(r)] = value
            except queue.Empty:
                pass
        if len(done) == len(requests):
            return [(out[id(r)], done[id(r)]) for r in requests]
    raise AssertionError("requests did not finish")


def _greedy(prompt_ids, max_tokens):
    return Request(prompt_ids=list(prompt_ids), sampling=SamplingParams(
        temperature=0.0, max_tokens=max_tokens))


def test_dense_slot_pressure_admits_a_queued_request(prompt):
    """Dense donors pin slots: with the serving slot busy and a request
    queued, the LRU donor is evicted at once to take it, not when the busy
    row finishes."""
    core = make_core("dense", num_slots=2, prefix_cache_slots=1)
    _drive(core, [_greedy(prompt, 2)])  # pins one slot
    assert len(core._free_slots()) == 1
    reqs = [_greedy([5 + i] * 20, 6) for i in range(2)]
    for r in reqs:
        core.pending.put(r)
    core._try_insert()  # the first takes the free slot
    assert core.stats().active_slots == 1
    core._try_insert()  # the second evicts the donor
    assert core.stats().active_slots == 2
    assert core.stats().prefix.prefix_evictions_total == 1
    assert len(core.prefix_cache) == 0


def test_cancel_mid_suffix_prefill_releases_entry(prompt, kv_layout):
    core = make_core(kv_layout)
    assert _drive(core, [_greedy(prompt, 2)])[0][1] == "length"
    (entry,) = core.prefix_cache.entries()
    r = _greedy(prompt, 8)
    core.pending.put(r)
    core._try_insert()
    assert core.stats().prefix.prefix_hits_total == 1
    assert entry.refcount == 1
    assert core.prefix_cache.evict_lru_entry() is None
    r.cancel()
    core._advance_prefill()
    assert r.events.get_nowait() == ("done", "cancelled")
    assert entry.refcount == 0
    if core.page_pool is not None:  # the cache alone holds the head
        assert {core.page_pool.refcount(p) for p in entry.pages} == {1}
    assert core.prefix_cache.evict_lru_entry() is not None


def test_multi_turn_conversation_reuses_one_donor_slot(prompt, kv_layout):
    core = make_core(kv_layout, prefix_cache_slots=3)
    core.start()
    try:
        turn = list(prompt[:16])
        for growth in (16, 16):  # 16 -> 32 -> 48 tokens
            _run(core, turn)
            turn = turn + [p - 1 for p in prompt[:growth]]
        _run(core, turn)
        assert len(core.prefix_cache) == 1
        (entry,) = core.prefix_cache.entries()
        assert entry.length == 48
        if core.page_pool is not None:
            assert core.prefix_cache_info()["pinned_pages"] == 3
    finally:
        core.stop()


@pytest.mark.parametrize("value", ["0", "false", "off", "no", "1"])
def test_env_var_turns_the_cache_off(monkeypatch, value):
    monkeypatch.setenv("LLMLB_PREFIX_CACHE", value)
    core = make_core("paged", num_slots=2)
    assert (core.prefix_cache is not None) == (value == "1")


def test_defaults_are_the_reference_defaults(monkeypatch):
    monkeypatch.delenv("LLMLB_PREFIX_CACHE", raising=False)
    paged = EngineCore(CFG, device="cpu", num_slots=8, slot_capacity=512,
                       prefill_buckets=(32, 64, 128), kv_page_size=128)
    dense = EngineCore(CFG, device="cpu", num_slots=8, slot_capacity=512,
                       prefill_buckets=(32, 64, 128), kv_layout="dense")
    assert (paged.prefix_align, paged.min_prefix_len) == (128, 128)
    assert (dense.prefix_align, dense.min_prefix_len) == (32, 32)
    assert paged.prefix_cache.max_entries == dense.prefix_cache.max_entries == 4
    capped = make_core("paged", num_slots=2, prefix_cache_slots=5)
    assert capped.prefix_cache.max_entries == 1  # one slot keeps serving
    assert make_core("paged", num_slots=1).prefix_cache is None
    assert make_core("paged", min_prefix_len=40).min_prefix_len == 40


def test_disabled_flag_restores_plain_scheduler(prompt, kv_layout):
    core = make_core(kv_layout, num_slots=2, prefix_cache=False)
    core.start()
    try:
        assert core.prefix_cache is None
        assert core.prefix_cache_info() == {"enabled": False}
        d0 = core.prefill_dispatches
        _run(core, prompt)
        _run(core, prompt)
        st = core.stats()
        assert (st.prefix.prefix_hits_total, st.prefix.prefix_misses_total,
                st.prefix.prefix_insertions_total) == (0, 0, 0)
        assert core.prefill_dispatches - d0 == 6  # 3 chunks each
    finally:
        core.stop()


def test_cache_hit_skips_prefill_for_cached_region(prompt, kv_layout):
    """48 tokens over 16-token chunks: 3 dispatches cold, 1 warm (the 16
    suffix tokens); the paged hit dispatches no copy, the dense one one."""
    core = make_core(kv_layout)
    core.start()
    try:
        _run(core, prompt)
        cold = core.prefill_dispatches
        assert cold == 3
        _run(core, prompt)
        assert core.stats().prefix.prefix_hits_total == 1
        assert core.prefill_dispatches - cold == 1
        copies = core.stats().prefix.kv_copy_dispatches
        assert copies == (0 if kv_layout == "paged" else 1)
    finally:
        core.stop()


def test_hit_suffix_runs_in_the_cold_runs_chunks(monkeypatch):
    """A cold 40-token prompt over buckets (16, 32) prefills [0, 32) at
    bucket 32, then [32, 40) at 16. A hit of 16 tokens runs the rest of the
    first chunk, [16, 32), padded to that chunk's bucket 32, then [32, 40)
    at 16: every row meets the product shapes of its cold run."""
    calls = []  # (bucket, start, chunk_len) of each extend dispatch
    extend = llama.prefill_extend_pages

    def spy(params, cfg, ids, chunk_lens, start_pos, *args, **kw):
        calls.append((ids.shape[1], int(start_pos[0]), int(chunk_lens[0])))
        return extend(params, cfg, ids, chunk_lens, start_pos, *args, **kw)

    monkeypatch.setattr(llama, "prefill_extend_pages", spy)
    rng = np.random.default_rng(2)
    prompt = rng.integers(1, CFG.vocab_size, size=(40,)).tolist()
    cold_core = make_core("paged", prefill_buckets=(16, 32), prefix_cache=False)
    (cold,) = _drive(cold_core, [_greedy(prompt, 4)])
    assert calls == [(32, 0, 32), (16, 32, 8)]
    core = make_core("paged", prefill_buckets=(16, 32))
    _drive(core, [_greedy(prompt[:16] + [1] * 8, 2)])  # donates 16 tokens
    calls.clear()
    (warm,) = _drive(core, [_greedy(prompt, 4)])
    assert core.stats().prefix.prefix_cached_tokens_total == 16
    assert calls == [(32, 16, 16), (16, 32, 8)]
    assert warm == cold


def test_shared_pages_held_by_cache_and_rows(prompt):
    """A donor page is held by the cache and by every row that shares it,
    and returns to the free list only when the last of them lets go."""
    core = make_core("paged")
    _drive(core, [_greedy(prompt, 2)])
    (entry,) = core.prefix_cache.entries()
    reqs = [_greedy(prompt[:32] + [7 + i] * 10, 4) for i in range(2)]
    for r in reqs:
        core.pending.put(r)
    core._try_insert()
    assert core.stats().prefix.prefix_hits_total == 2
    # two shared head pages: the cache's reference and each row's
    assert [core.page_pool.refcount(p) for p in entry.pages] == [3, 3, 1]
    _drive(core, reqs, queue_them=False)
    assert [core.page_pool.refcount(p) for p in entry.pages] == [1, 1, 1]
    assert core._evict_one_prefix()
    assert core.page_pool.available() == core.page_pool.total


def test_donor_stays_pinned_across_the_suffix_reservation(prompt):
    """A hit short of pages must not evict its own donor to get them: the
    freed head pages could come back as its suffix pages. The pool (7
    pages) holds the donor's 3 and a decoding row's; the hit waits until
    that row finishes and frees pages, then shares the donor's page beside
    3 fresh ones, with no eviction, and its stream is the cold one's."""
    hit = prompt[:16] + [(p + 7) % CFG.vocab_size or 1 for p in prompt[:40]]
    (cold,) = _drive(make_core("paged", prefix_cache=False), [_greedy(hit, 3)])
    core = make_core("paged", num_slots=3, kv_pages=8, prefix_cache_slots=2)
    _drive(core, [_greedy(prompt, 2)])  # the donor: 3 pages
    (entry,) = core.prefix_cache.entries()
    busy, r = _greedy([5] * 20, 40), _greedy(hit, 3)
    for req in (busy, r):
        core.pending.put(req)
        core._try_insert()
    assert core._held_request is r  # 3 fresh pages wanted, 2 free
    for _ in range(200):
        core._advance_prefill()
        core._decode_active()
        core._try_insert()
        if core._held_request is None:
            break
    slot_id = next(i for i, s in enumerate(core.slots) if s.request is r)
    pages = core._slot_pages[slot_id]
    assert pages[0] == entry.pages[0] and len(set(pages)) == 4
    assert core.stats().prefix.prefix_evictions_total == 0
    assert _drive(core, [r], queue_them=False) == [cold]
    assert core.stats().prefix.prefix_hits_total == 1


def test_parked_hit_row_never_writes_a_shared_page():
    """A prefilling hit row parks its device seq_len at capacity-1, and
    every burst writes a garbage cell there through the row's LAST table
    column. Its shared head reaches the page before that column (3 of 4
    pages), and bursts of another row run while it waits: the shared pages
    keep their bytes, and the hit's stream is the cold one's."""
    rng = np.random.default_rng(11)
    head = rng.integers(1, CFG.vocab_size, size=(48,)).tolist()
    donor = head + rng.integers(1, CFG.vocab_size, size=(12,)).tolist()
    hit = head + rng.integers(1, CFG.vocab_size, size=(12,)).tolist()
    assert donor[48] != hit[48]
    (cold,) = _drive(make_core("paged", prefix_cache=False), [_greedy(hit, 3)])

    core = make_core("paged")
    _drive(core, [_greedy(donor, 2)])
    (entry,) = core.prefix_cache.entries()
    pages = list(entry.pages)
    assert len(pages) == 3 == core.pages_per_slot - 1
    before = core.cache_k[:, pages].clone(), core.cache_v[:, pages].clone()
    busy = _greedy([3] * 5, 40)
    core.pending.put(busy)
    core._try_insert()
    core._decode_active()
    r = _greedy(hit, 3)
    core.pending.put(r)
    core._try_insert()
    slot_id = next(i for i, s in enumerate(core.slots) if s.request is r)
    assert core.slots[slot_id].prefilling
    assert core.stats().prefix.prefix_hits_total == 1
    assert core._block_tables[slot_id, -1] not in pages
    for _ in range(6):  # bursts while the hit row stays parked
        core._decode_active()
    assert int(core._d_seq_lens[slot_id]) >= core.slot_capacity - 1
    assert torch.equal(core.cache_k[:, pages], before[0])
    assert torch.equal(core.cache_v[:, pages], before[1])
    (got,) = _drive(core, [r], queue_them=False)
    busy.cancel()
    assert got == cold and cold[1] == "length"


def test_dense_donor_rows_survive_bursts_of_other_rows(prompt):
    """A pinned dense donor keeps counting as an idle row, its writes
    clamped to capacity-1: they land past its prompt. After more bursts
    than the row has room for, rows [0, 48) are unchanged and a hit gives
    the cold stream."""
    core = make_core("dense")
    (cold,) = _drive(core, [_greedy(prompt, 4)])
    (entry,) = core.prefix_cache.entries()
    rows = (core.cache_k[:, entry.slot, :48].clone(),
            core.cache_v[:, entry.slot, :48].clone())
    (other,) = _drive(core, [_greedy([9] * 6, 56)])
    assert len(other[0]) == 56
    assert int(core._d_seq_lens[entry.slot]) >= core.slot_capacity  # clamped
    assert torch.equal(core.cache_k[:, entry.slot, :48], rows[0])
    assert torch.equal(core.cache_v[:, entry.slot, :48], rows[1])
    (warm,) = _drive(core, [_greedy(prompt, 4)])
    assert core.stats().prefix.prefix_hits_total == 1
    assert core.stats().prefix.kv_copy_dispatches == 1
    assert warm == cold


def test_failure_path_drops_the_cache_and_its_pages(prompt):
    core = make_core("paged")
    _drive(core, [_greedy(prompt, 2)])
    assert core.prefix_cache_info()["pinned_pages"] == 3
    core._fail_all("engine step error")
    core._reset_caches()
    assert len(core.prefix_cache) == 0
    assert core.prefix_cache_info()["pinned_pages"] == 0
    assert core.page_pool.available() == core.page_pool.total


def test_health_and_system_carry_prefix_block():
    assert build_parser().parse_args(
        ["--prefix-cache", "off", "--prefix-cache-slots", "3"]).prefix_cache \
        == "off"
    engine = Engine.from_preset("debug-tiny", device="cpu", num_slots=2,
                                slot_capacity=64, prefill_buckets=(16,))
    srv, thread = start_server(engine)
    base = "http://%s:%d" % srv.server_address[:2]
    try:
        with urllib.request.urlopen(base + "/api/health", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["prefix_cache"]["enabled"] is True
        assert health["prefix_cache"]["budget_slots"] == 1
        assert "pinned_pages" in health["prefix_cache"]
        assert health["engine"]["prefix_hits_total"] == 0
        assert health["engine"]["kv_copy_dispatches"] == 0
        with urllib.request.urlopen(base + "/api/system", timeout=60) as resp:
            system = json.loads(resp.read())
        assert system["prefix_cache"] == health["prefix_cache"]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        engine.shutdown()
    off = Engine.from_preset("debug-tiny", device="cpu", num_slots=2,
                             slot_capacity=64, prefill_buckets=(16,),
                             prefix_cache=False)
    try:
        assert off.health()["prefix_cache"] == {"enabled": False}
    finally:
        off.shutdown()


# ------------------------------------------------------------ against JAX

JAX_KW = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
              kv_page_size=16, eos_id=-1, seed=0)


def _traffic():
    """Prompts one at a time that miss, hit a full head, hit a partial head,
    overflow the 2-donor budget (an LRU eviction) and are too short to
    match; then a group queued together (three hits and a miss, more than
    the slots a dense cache leaves free beside its pinned donors); then a
    growing conversation (a subsumed donor).

    Every hit before the conversation's second turn ends its cached head
    on a chunk boundary (a multiple of the largest bucket, 32). The port
    runs a hit's suffix in the cold run's chunks, one dispatch more than
    the reference where the head ends inside a chunk (that turn's, at 16),
    and the prefill rotation among the group's rows counts dispatches: so
    both engines feed the group's rows in the same order."""
    rng = np.random.default_rng(5)

    def ids(n):
        return rng.integers(1, 256, size=(n,)).tolist()

    p, q, r = ids(40), ids(50), ids(70)
    turn = ids(20)
    before = [p, p, p[:35] + ids(10), q, q[:48] + ids(9), r, p, ids(10)]
    together = [p[:33] + ids(12), q[:48] + ids(12), ids(60), r]
    return before, together, [turn, turn + ids(20)]


def _serve(core, request_cls, sampling_cls):
    """The traffic through a core's step loop, driven inline (the core not
    started), so both engines admit the group in the same turns."""
    def make(prompt_ids):
        return core.submit(request_cls(
            prompt_ids=list(prompt_ids),
            sampling=sampling_cls(temperature=0.0, max_tokens=6)))

    before, together, after = _traffic()
    out = [_drive(core, [make(p)], queue_them=False)[0] for p in before]
    out += _drive(core, [make(p) for p in together], queue_them=False)
    return out + [_drive(core, [make(p)], queue_them=False)[0] for p in after]


@pytest.fixture(scope="module")
def jax_weights():
    jparams = jllama.init_params(jax_preset("debug-tiny"), jax.random.PRNGKey(0))
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


@pytest.fixture(scope="module", params=["dense", "paged"])
def jax_run(request, jax_weights):
    core = JaxEngineCore(jax_preset("debug-tiny"), jax_weights[0],
                         kv_layout=request.param, prefix_cache=True,
                         decode_burst=1, **JAX_KW)
    out = _serve(core, JaxRequest, JaxSampling)
    m = core.metrics
    counters = {k: getattr(m, k) for k in (
        "prefix_hits_total", "prefix_misses_total",
        "prefix_cached_tokens_total", "prefix_insertions_total",
        "prefix_inserted_tokens_total", "prefix_evictions_total")}
    counters["kv_copy_dispatches"] = core.kv_copy_dispatches
    entries = sorted((tuple(int(t) for t in e.tokens), e.ns)
                     for e in core.prefix_cache.entries())
    return request.param, out, counters, core.prefix_cache_info(), entries


def test_engine_agrees_with_the_jax_engine(jax_weights, jax_run):
    kv_layout, want, counters, info, entries = jax_run
    core = EngineCore(CFG, params_from_numpy(jax_weights[1], CFG, "cpu"),
                      device="cpu", kv_layout=kv_layout, **JAX_KW)
    got = _serve(core, Request, SamplingParams)
    assert got == want
    assert dataclasses.asdict(core.stats().prefix) == counters
    assert core.prefix_cache_info() == info
    assert sorted((tuple(e.tokens), e.ns)
                  for e in core.prefix_cache.entries()) == entries
    # the traffic reached every branch the comparison should hold
    assert counters["prefix_hits_total"] >= 4
    assert counters["prefix_evictions_total"] >= 1
    assert counters["prefix_misses_total"] >= 4
    assert counters["kv_copy_dispatches"] == (
        counters["prefix_hits_total"] if kv_layout == "dense" else 0)
