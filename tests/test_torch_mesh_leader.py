"""The leader's actions on a lockstep port engine of one host's ranks,
against the JAX engine on its one-process mesh.

Two spawned worlds of two gloo CPU ranks (tests/torch_mesh_workers.py
`mesh_leader`), one at tp=2 and one at dp=2, serve the JAX package's
debug-tiny weights (fp32, carried across with params_from_numpy). The
JAX engine serves the same requests on its 8-device CPU mesh (dp=4 x
tp=2), where one process holds every device, so its leader-only actions
need no plan. On the port every one rides the tick plan, and every rank's
ids must equal the leader's:

- an adoption with committed ids (/v1/resume), plain and under a
  json_schema: the JAX engine's uninterrupted ids (at tp=2 and dp=2). The
  follower rebuilds the parked state itself; before, its shadow sampled
  freely where the leader fed the committed ids (C11);
- a drain: its park and its flush act on the same tick on every rank (tp
  and dp), and the parked rows' ids are the JAX engine's so far;
- a migration park (POST /v1/kv/export {"park": true}): its export is the
  JAX engine's export of the same row, header equal and K/V within 1e-5
  (fp32) or codes and scales equal (int8), gathered over tp to the
  leader; the requeued row comes back from the offload tier and gives the
  JAX engine's ids, whose tier (of the same budget) reports what every
  rank's reports;
- the migration's export and a drained row's, landed by adoptions: the
  JAX engine's ids with no prefill, and every rank's landed rows are its
  own rows at the park;
- /v1/embeddings: the JAX engine's vectors within 1e-5, also where the
  plan's budget holds one forward a tick;
- a split engine (--role split): the JAX engine's ids, and no prefill
  dispatch on any rank's decode loop.
"""

import asyncio

import jax
import numpy as np
import pytest

from llmlb_tpu.engine import kv_transfer as jax_kv
from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.engine.service import Engine as JaxEngine
from llmlb_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmlb_tpu.models import llama as jllama
from llmlb_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from llmlb_tpu.structured import ConstraintCompiler as JaxCompiler
from llmlb_tpu_torch.engine import kv_transfer as port_kv
from tests.torch_mesh_workers import start_world

EOS = 256
MAX_TOKENS = 16
SCHEMA = {"type": "json_schema", "schema": {
    "type": "object",
    "properties": {"name": {"type": "string", "maxLength": 8},
                   "n": {"enum": [0, 1, 2, 3]}},
    "required": ["name", "n"]}}
SCHEMA_TOKENS = 30
PARK_AT = 5
OFFLOAD_BYTES = 1 << 20
CORE_KW = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
               kv_page_size=16, eos_id=EOS, seed=0, prefix_cache=False)


def _prompts() -> dict:
    rng = np.random.default_rng(20)

    def ids(n):  # ids below the byte tokenizer's specials
        return rng.integers(0, 256, size=(n,)).tolist()

    # "long" is over the largest bucket: chunked prefill
    return {"a": ids(20), "b": ids(12), "long": ids(45), "m": ids(24),
            "s": list(b"the quick brown fox")}


EMBED = [[3, 4, 5, 6, 7], list(range(40, 80))]


def _step(core) -> None:
    """One iteration of the JAX engine's loop body, on this thread."""
    if core._drain_park_requested:
        core._drain_park_requested = False
        core._drain_park_all()
    if core._park_rids:
        rids, core._park_rids = core._park_rids, set()
        core._park_requested(rids)
    core._try_insert()
    core._advance_prefill()
    core._decode_active()


def _run(core, reqs, limit=4000):
    for r in reqs:
        core.submit(r)
    for _ in range(limit):
        if all(r.finished_at is not None for r in reqs):
            return [_tokens(r) for r in reqs]
        _step(core)
    raise AssertionError("JAX requests did not finish")


def _tokens(req) -> list[int]:
    out = []
    while not req.events.empty():
        kind, val = req.events.get()
        if kind == "token":
            out.append(int(val))
        elif kind == "error":
            raise AssertionError(f"JAX engine error: {val}")
    return out


def _greedy(max_tokens=MAX_TOKENS, **kw):
    return JaxSampling(temperature=0.0, max_tokens=max_tokens, **kw)


def _jax_migrate(core, prompt) -> dict:
    """The migration on the JAX engine, driven as the port's: park once
    the row holds PARK_AT ids, take the export, and let the requeued row
    come back from the offload tier."""
    req = core.submit(JaxRequest(prompt_ids=list(prompt), sampling=_greedy(),
                                 request_id="mig.0123abcd"))
    payload = None
    for _ in range(4000):
        if req.finished_at is not None:
            break
        slot = next((i for i, s in enumerate(core.slots)
                     if s.request is req), None)
        if payload is None and slot is not None and len(
                core.slots[slot].out_tokens) >= PARK_AT:
            core.request_park("mig")
            _step(core)
            payload = core.take_kv_export("mig")
            continue
        _step(core)
    return {"payload": payload, "ids": _tokens(req),
            "offload": core.kv_offload.info()}


def _jax_core(jparams, **kw):
    core = JaxEngineCore(jax_preset("debug-tiny"), jparams,
                         mesh_config=JaxMeshConfig(dp=4, tp=2), kv_pages=33,
                         decode_burst=1, kv_offload_bytes=OFFLOAD_BYTES,
                         **CORE_KW, **kw)
    core.constraint_compiler = JaxCompiler(JaxByteTokenizer(512), 512)
    return core


@pytest.fixture(scope="module")
def setup():
    jparams = jllama.init_params(jax_preset("debug-tiny"),
                                 jax.random.PRNGKey(0))
    weights = {k: np.asarray(v) for k, v in jparams.items()}
    prompts = _prompts()
    inputs = {"weights": weights, "prompts": prompts,
              "max_tokens": MAX_TOKENS, "eos": EOS, "schema": SCHEMA,
              "schema_tokens": SCHEMA_TOKENS, "park_at": PARK_AT,
              "offload_bytes": OFFLOAD_BYTES, "embed": EMBED}
    tp = start_world("mesh_leader", 2, {**inputs, "axes": "tp"})
    dp = start_world("mesh_leader", 2, {**inputs, "axes": "dp"})
    core = _jax_core(jparams)
    ref = {name: _run(core, [JaxRequest(prompt_ids=list(p),
                                        sampling=_greedy())])[0]
           for name, p in prompts.items() if name != "s"}
    ref["schema"] = _run(core, [JaxRequest(
        prompt_ids=prompts["s"],
        sampling=_greedy(SCHEMA_TOKENS, constraint=SCHEMA))])[0]
    ref["migrate"] = _jax_migrate(core, prompts["m"])
    ref["embed"] = np.asarray(asyncio.run(JaxEngine(
        "debug-tiny", core, JaxByteTokenizer(512)).embed(EMBED)))
    ref["migrate_int8"] = _jax_migrate(_jax_core(jparams, quantize="kv"),
                                       prompts["m"])
    return ref, tp.result(), dp.result()


def _same_on_every_rank(ranks, *path):
    def get(r):
        for key in path:
            r = r[key]
        return r

    leader = get(ranks[0])
    for r in ranks[1:]:
        assert get(r) == leader, (path, get(r), leader)
    return leader


@pytest.mark.parametrize("axes", ["tp", "dp"])
def test_resume_with_committed_ids_gives_the_uninterrupted_ids(setup, axes):
    """C11: an adoption's committed ids are fed on every rank, so the
    stream goes on as the JAX engine's uninterrupted one, plain and under
    a schema, and the follower's ids are the leader's."""
    ref, tp, dp = setup
    ranks = {"tp": tp, "dp": dp}[axes]
    assert ranks[0]["mesh"] == ({"dp": 1, "sp": 1, "ep": 1, "tp": 2}
                                if axes == "tp" else
                                {"dp": 2, "sp": 1, "ep": 1, "tp": 1})
    got, _ = ranks[0]["resume"]
    assert got["plain"] == ref["a"]
    assert got["schema"] == ref["schema"]
    assert got["resumed"] == ref["a"]
    assert got["resumed_schema"] == ref["schema"]
    # a follower's shadows: the streams' ids, and an adoption's new ids
    _, mirrored = ranks[1]["resume"]
    assert mirrored == [got["plain"], got["schema"], got["resumed"][5:],
                        got["resumed_schema"][4:]]


@pytest.mark.parametrize("axes", ["tp", "dp"])
def test_drain_park_and_flush_act_on_one_tick_everywhere(setup, axes):
    ref, tp, dp = setup
    ranks = {"tp": tp, "dp": dp}[axes]
    parks = _same_on_every_rank(ranks, "drain", "parks")
    tick = ranks[0]["drain"]["drain_tick"]
    assert [(t, reason) for t, _, reason, _ in parks] == [
        (tick, "drain"), (tick, "drain")]
    ends = _same_on_every_rank(ranks, "drain", "ends")
    for (ids, end), name, (*_, committed) in zip(ends, ("a", "b"), parks):
        assert end == ("error", "engine draining")
        assert len(ids) == committed >= 4 and ids == ref[name][:committed]
    assert all(r["drain"]["draining"] for r in ranks)
    # the leader serves each parked row's export
    for export, ids, name in zip(ranks[0]["drain"]["exports"],
                                 [ids for ids, _ in ends], ("a", "b")):
        assert export["tokens"] == len(_prompts()[name]) + len(ids) - 1


@pytest.mark.parametrize("case", ["migrate", "migrate_int8"])
def test_migration_export_is_the_jax_engines(setup, case):
    """The export of a migration park on the tp=2 world: the model's KV
    heads, gathered to the leader, as the JAX engine exports the same
    row."""
    ref, tp, _ = setup
    want = jax_kv.parse_kv_payload(ref[case]["payload"])
    got = port_kv.parse_kv_payload(tp[0][case]["payload"])
    assert got.header.__dict__ == want.header.__dict__
    for name, arr in want.sections.items():
        mine = got.sections[name]
        if arr.dtype == np.int8:
            np.testing.assert_array_equal(mine, arr)
        else:
            np.testing.assert_allclose(mine, np.asarray(arr, np.float32),
                                       rtol=0, atol=1e-5)
    assert [p[2] for p in _same_on_every_rank(tp, case, "parks")] == [
        "migrate"]


@pytest.mark.parametrize("case", ["migrate", "migrate_int8"])
def test_offload_tier_spill_and_restore_match_the_jax_engine(setup, case):
    """The parked row spills into the tier (each rank its heads, charged
    at the whole payload's bytes) and comes back from it: the JAX engine's
    ids, and every rank's tier reports what the JAX engine's does."""
    ref, tp, _ = setup
    assert tp[0][case]["ids"] == ref[case]["ids"] == ref["m"]
    assert _same_on_every_rank(tp, case, "offload") == ref[case]["offload"]
    assert ref[case]["offload"]["hits"] == 1
    assert _same_on_every_rank(tp, case, "transfer")["restored_total"] == 1


def test_landed_exports_give_the_jax_engines_ids(setup):
    """The migration's export and a drained row's, each adopted with its
    pages: the JAX engine's uninterrupted ids, no prefill on any rank, and
    every rank's landed rows are its own rows at the park."""
    ref, tp, _ = setup
    got, _ = tp[0]["land"]
    assert got == [ref["m"], ref["a"]]
    for r in tp:
        assert r["land_prefills"] == 0 and r["land_restored"] == 2
        mig = r["migrate"]["rows"]
        assert r["landed_rows"][0] == mig["rows"]
    # a follower's shadows: the ids after each adoption's committed ones
    n_mig = tp[0]["migrate"]["payload"]["tokens"] + 1 - len(_prompts()["m"])
    n_drain = len(tp[0]["drain"]["ends"][0][0])
    assert tp[1]["land"][1] == [got[0][n_mig:], got[1][n_drain:]]


def test_embeddings_match_the_jax_engine(setup):
    ref, tp, _ = setup
    got, _ = tp[0]["embed"]
    np.testing.assert_allclose(np.asarray(got), ref["embed"], rtol=0,
                               atol=1e-5)


def test_embedding_forwards_over_the_plan_budget_wait_for_later_ticks(setup):
    """Forwards queued on one tick share the plan's budget with its
    requests: under a budget that holds one forward, the second rides the
    next plan, each runs at the same tick on every rank, and both answer
    the JAX engine's vector; a forward no plan holds is refused through
    its caller, with nothing broadcast."""
    ref, tp, _ = setup
    answers, ran = tp[0]["embed_spill"]
    for vec in answers[:2]:
        np.testing.assert_allclose(np.asarray(vec), ref["embed"][1], rtol=0,
                                   atol=1e-5)
    assert "too large for a tick plan" in answers[2]
    assert _same_on_every_rank(tp, "embed_spill", 1) == ran
    assert [shape for _, shape in ran] == [(1, 64), (1, 64)]
    assert ran[1][0] == ran[0][0] + 1


def test_split_engine_matches_the_jax_engine(setup):
    ref, tp, _ = setup
    got, _ = tp[0]["split"]
    assert got == [ref["a"], ref["b"], ref["long"]]
    assert tp[1]["split"][1] == got
    for r in tp:
        prefill, decode = r["split_ledger"]
        assert prefill["decode"] == 0 and prefill["prefill"] > 0
        assert decode["decode"] > 0
