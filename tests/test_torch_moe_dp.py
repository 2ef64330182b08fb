"""An MoE engine of the port at dp > 1 against the JAX engine.

Two spawned worlds of gloo CPU ranks (tests/torch_mesh_workers.py
`moe_dp`) serve the JAX package's debug-moe-tiny weights (4 experts, top-2,
carried across with params_from_numpy) with the batch's slots split into
dp groups. A capacity dispatch stays the whole batch's, as the reference's
GSPMD program runs it: when a prefill group's rows span dp groups, each
MoE layer gathers every group's hidden rows over dp in batch order, every
rank runs the whole batch's dispatch at the whole batch's capacity and
keeps its own rows. Both worlds start before the file's one JAX engine
(its 8-device CPU mesh, dp=2 x ep=2 x tp=2) and run beside it. Greedy ids
must be identical to the JAX engine's, and every rank's ids (a follower's
are its mirrored shadows) the leader's.

The traffic, in rounds (a round's requests queued together, so every
engine prefills the same groups): four prompts, three of them one prefill
group at bucket 32 (slots 0, 1 and 3: both dp groups, 4 x 32 tokens, the
capacity regime, which drops pairs on these inputs) and one of 45 tokens
in chunks; then one prompt alone (16 positions: the exact regime); then a
repetitive prompt with speculation on (the verify is exact).

- dp=2 (two ranks), paged and dense; int8 weights at dp=2 against the
  port's one-rank int8 MoE engine;
- dp=2 x ep=2 (four ranks), paged;
- dp=4 (four ranks), paged, three prompts queued together: the group of
  slot 3 holds none of the spanning group's rows and joins its gathers;
- a prefix-cache hit whose head another dp group wrote equals its cold run;
- the inputs have teeth: the capacity dispatch on each dp group's rows
  alone, at the group's own capacity, gives other logits than the whole
  batch's (beyond the 1e-4 fp32 limit of tests/test_torch_mixtral.py).
"""

import jax
import numpy as np
import pytest
import torch

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.models import mixtral as jmixtral
from llmlb_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import EngineCore, Request, SamplingParams
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.models import mixtral
from llmlb_tpu_torch.ops.moe import capacity_drops
from tests.torch_mesh_workers import start_world

# round 0: 45 > the largest bucket (chunked); the others one group at 32
GROUP_LENS = (20, 25, 45, 30)
SINGLE_LEN = 12
TRIO_LENS = (20, 25, 30)
MAX_TOKENS = 6
LOGIT_ATOL = 1e-4
CORE_KW = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
               kv_page_size=16, eos_id=-1, seed=0, prefix_cache=False)
NUM_LAYERS = 2  # debug-moe-tiny's: one gather a layer


def _traffic():
    """The rounds ((prompt, speculative) lists) and the dp=4 trio."""
    rng = np.random.default_rng(1)
    group = [rng.integers(0, 512, size=(n,)).tolist() for n in GROUP_LENS]
    single = rng.integers(0, 512, size=(SINGLE_LEN,)).tolist()
    trio = [rng.integers(0, 512, size=(n,)).tolist() for n in TRIO_LENS]
    rounds = [[(p, False) for p in group], [(single, False)],
              [([7, 8, 9, 10] * 6, True)]]
    return rounds, [[(p, False) for p in trio]]


def _drain(req, timeout=120):
    toks = []
    while True:
        kind, val = req.events.get(timeout=timeout)
        if kind == "token":
            toks.append(int(val))
        elif kind == "done":
            return toks
        else:
            raise AssertionError(f"engine error: {val}")


def _jax_rounds(jcore, rounds):
    """Each round queued before the loop starts, served, then stopped."""
    ids = []
    for r in rounds:
        reqs = [jcore.submit(JaxRequest(prompt_ids=list(p), sampling=JaxSampling(
            temperature=0.0, max_tokens=MAX_TOKENS))) for p, _ in r]
        jcore.start()
        try:
            ids += [_drain(q) for q in reqs]
        finally:
            jcore.stop()
    return ids


@pytest.fixture(scope="module")
def setup():
    jparams = jmixtral.init_params(jax_preset("debug-moe-tiny"),
                                   jax.random.PRNGKey(0))
    weights = {k: np.asarray(v) for k, v in jparams.items()}
    rounds, trio = _traffic()
    rng = np.random.default_rng(23)
    inputs = {"weights": weights, "rounds": rounds, "trio": trio,
              "max_tokens": MAX_TOKENS,
              # a 32-token head (two pages, one bucket) and two tails: the
              # hit's suffix starts on the cold run's chunk boundary
              "hit_head": rng.integers(0, 512, size=(32,)).tolist(),
              "hit_tails": [rng.integers(0, 512, size=(n,)).tolist()
                            for n in (5, 8)]}
    two = start_world("moe_dp", 2, inputs)
    four = start_world("moe_dp", 4, inputs)
    jcore = JaxEngineCore(jax_preset("debug-moe-tiny"), jparams,
                          mesh_config=JaxMeshConfig(dp=2, ep=2, tp=2),
                          kv_pages=33, **CORE_KW)
    jax_ids = _jax_rounds(jcore, rounds + trio)
    n = sum(len(r) for r in rounds)
    return (weights, inputs, jax_ids[:n], jax_ids[n:], two.result(),
            four.result())


def _same_on_every_rank(ranks, case):
    leader = ranks[0][case]
    for r in ranks[1:]:
        assert r[case] == leader, (case, r[case], leader)
    return leader


def _ids(got):
    assert all(end == ("done", "length") for _, end in got)
    return [toks for toks, _ in got]


@pytest.mark.parametrize("case", ["paged", "dense"])
def test_moe_dp2_matches_jax_engine(setup, case):
    _, _, jax_ids, _, ranks, _ = setup
    assert ranks[0][case + "_mesh"] == {"dp": 2, "sp": 1, "ep": 1, "tp": 1}
    assert _ids(_same_on_every_rank(ranks, case)) == jax_ids
    # the spanning group's dispatch gathered over dp, once a layer
    for r in ranks:
        assert r[case + "_counts"] == {"gathers": NUM_LAYERS, "joins": 0}


def test_moe_dp2_ep2_matches_jax_engine(setup):
    _, _, jax_ids, _, _, ranks = setup
    assert ranks[0]["dp2ep2_mesh"] == {"dp": 2, "sp": 1, "ep": 2, "tp": 1}
    assert _ids(_same_on_every_rank(ranks, "dp2ep2")) == jax_ids
    for r in ranks:
        assert r["dp2ep2_counts"] == {"gathers": NUM_LAYERS, "joins": 0}


def test_moe_dp4_group_without_rows_joins_the_gathers(setup):
    _, _, _, jax_trio, _, ranks = setup
    assert ranks[0]["dp4_mesh"] == {"dp": 4, "sp": 1, "ep": 1, "tp": 1}
    assert _ids(_same_on_every_rank(ranks, "dp4")) == jax_trio
    # rows in slots 0, 1, 2 (and the padding row repeating slot 2): groups
    # 0-2 gather, group 3 (slot 3) has no row and joins
    assert [r["dp4_counts"] for r in ranks] == [
        {"gathers": NUM_LAYERS, "joins": 0}] * 3 + [
        {"gathers": 0, "joins": 1}]


def test_moe_dp2_int8_matches_one_rank_port_engine(setup):
    weights, inputs, _, _, ranks, _ = setup
    cfg = get_preset("debug-moe-tiny")
    core = EngineCore(cfg, params_from_numpy(weights, cfg, device="cpu"),
                      device="cpu", quantize="weights", **CORE_KW)
    core._running = True
    one_rank = []
    spec = {"enabled": True, "max_draft_tokens": 4}
    for r in inputs["rounds"]:
        reqs = [core.submit(Request(prompt_ids=list(p), sampling=SamplingParams(
            temperature=0.0, max_tokens=MAX_TOKENS,
            **({"speculative": spec} if s else {})))) for p, s in r]
        while any(q.finished_at is None for q in reqs):
            core._iteration()
        one_rank += [_drain(q) for q in reqs]
    assert _ids(_same_on_every_rank(ranks, "int8")) == one_rank


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_cross_group_prefix_hit_equals_its_cold_run(setup, layout):
    _, _, _, _, ranks, _ = setup
    hit = _same_on_every_rank(ranks, "hit_" + layout)
    groups = hit["groups"]
    first, _, _, again = hit["slots"]
    # the head was written by group 0; the hit landed in group 1
    assert groups[first] == 0 and groups[again] == 1
    assert hit["hits"] >= 1
    cold = _same_on_every_rank(ranks, "cold_" + layout)
    assert hit["ids"][3] == cold[0][0]
    assert len(cold[0][0]) == MAX_TOKENS


def test_split_capacity_drops_other_pairs(setup, monkeypatch):
    """The spanning group's rows as the scheduler pads them (slots 0, 1, 3,
    3: dp groups 0, 0, 1, 1): the whole batch drops pairs, and each dp
    group's rows dispatched alone at their own capacity give other logits,
    so a dp engine that split the dispatch would fail the tests above."""
    weights, inputs, _, _, _, _ = setup
    cfg = get_preset("debug-moe-tiny")
    params = params_from_numpy(weights, cfg, device="cpu")
    group = [p for p, _ in inputs["rounds"][0]]
    rows = [group[0], group[1], group[3], group[3]]
    ids = torch.zeros((4, 32), dtype=torch.int64)
    for i, p in enumerate(rows):
        ids[i, :len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in rows], dtype=torch.int32)
    drops = []
    dispatch = mixtral.moe_dispatch_combine

    def counted(x, logits, *w, num_selected, capacity, token_valid, **kw):
        drops.append(capacity_drops(logits, num_selected, capacity,
                                    token_valid))
        return dispatch(x, logits, *w, num_selected=num_selected,
                        capacity=capacity, token_valid=token_valid, **kw)

    monkeypatch.setattr(mixtral, "moe_dispatch_combine", counted)

    def prefill(sel):
        b = len(sel)
        ck, cv = mixtral.init_kv_cache(cfg, b, 32, "cpu")
        logits, _, _ = mixtral.prefill_into_slots(
            params, cfg, ids[sel], lens[sel], torch.arange(b), ck, cv)
        return logits

    whole = prefill([0, 1, 2, 3])
    assert len(drops) == NUM_LAYERS and sum(drops) > 0
    split = torch.cat([prefill([0, 1]), prefill([2, 3])])
    assert len(drops) == 3 * NUM_LAYERS
    assert (whole - split).abs().max().item() > 100 * LOGIT_ATOL
