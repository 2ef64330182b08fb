"""Lockstep port engines on a tp=2 mesh against the JAX engine.

One spawned world of two gloo CPU ranks (tests/torch_mesh_workers.py
`tp_engine`) serves the JAX package's debug-tiny weights (carried across
with params_from_numpy) on a tp=2 mesh: every rank holds half the heads,
half the ffn width and half the vocab, and the leader's tick plans keep
the ranks in lockstep. The JAX engine serves the same prompts on its own
8-device CPU mesh (dp=4 x tp=2). Greedy ids must be identical, and every
rank's ids (a follower's are its mirrored shadows) equal the leader's:

- paged and dense layouts against the JAX engine;
- int8 weights and KV against the port's one-rank int8 engine (one JAX
  engine per file; the one-rank int8 engine is held against the JAX one
  by tests/test_torch_quant_engine.py);
- a cancel that acts through the plan, on the same token on every rank,
  and the stop of every case, which rides the plan to the followers;
- speculation on: the verify steps run on the mesh and give the greedy ids.
"""

import jax
import numpy as np
import pytest

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.models import llama as jllama
from llmlb_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import EngineCore, Request, SamplingParams
from llmlb_tpu_torch.engine.weights import params_from_numpy
from tests.torch_mesh_workers import start_world

PROMPT_LENS = (5, 12, 20, 45)  # 45 > the largest bucket: chunked prefill
MAX_TOKENS = 8
CORE_KW = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
               kv_page_size=16, eos_id=-1, seed=0, prefix_cache=False)


def _prompts():
    rng = np.random.default_rng(5)
    out = [rng.integers(0, 512, size=(n,)).tolist() for n in PROMPT_LENS]
    # a repetitive prompt, so the prompt-lookup drafter proposes drafts
    out.append([7, 8, 9, 10] * 6)
    return out


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


@pytest.fixture(scope="module")
def setup():
    jparams = jllama.init_params(jax_preset("debug-tiny"), jax.random.PRNGKey(0))
    weights = {k: np.asarray(v) for k, v in jparams.items()}
    prompts = _prompts()
    world = start_world("tp_engine", 2, {"weights": weights,
                                         "prompts": prompts,
                                         "max_tokens": MAX_TOKENS})
    jcore = JaxEngineCore(jax_preset("debug-tiny"), jparams,
                          mesh_config=JaxMeshConfig(dp=4, tp=2), kv_pages=33,
                          **CORE_KW)
    jcore.start()
    try:
        reqs = [JaxRequest(prompt_ids=p, sampling=JaxSampling(
            temperature=0.0, max_tokens=MAX_TOKENS)) for p in prompts]
        for r in reqs:
            jcore.submit(r)
        jax_ids = [_drain(r) for r in reqs]
    finally:
        jcore.stop()
    return weights, prompts, jax_ids, world.result()


def _ids(rank_result):
    return [toks for toks, _ in rank_result]


def _same_on_every_rank(ranks, case):
    leader = ranks[0][case]
    for r in ranks[1:]:
        assert r[case] == leader, (case, r[case], leader)
    return leader


@pytest.mark.parametrize("case", ["paged", "dense"])
def test_tp_engine_matches_jax_engine(setup, case):
    _, _, jax_ids, ranks = setup
    assert ranks[0][case + "_mesh"] == {"dp": 1, "sp": 1, "ep": 1, "tp": 2}
    got = _same_on_every_rank(ranks, case)
    assert _ids(got) == jax_ids
    assert all(end == ("done", "length") for _, end in got)


def test_tp_engine_int8_matches_one_rank_port_engine(setup):
    weights, prompts, _, ranks = setup
    cfg = get_preset("debug-tiny")
    core = EngineCore(cfg, params_from_numpy(weights, cfg, device="cpu"),
                      device="cpu", quantize="all", **CORE_KW)
    core.start()
    try:
        reqs = [Request(prompt_ids=p, sampling=SamplingParams(
            temperature=0.0, max_tokens=MAX_TOKENS)) for p in prompts]
        for r in reqs:
            core.submit(r)
        one_rank = [_drain(r) for r in reqs]
    finally:
        core.stop()
    assert _ids(_same_on_every_rank(ranks, "int8")) == one_rank


def test_cancel_and_stop_act_through_the_plan(setup):
    _, _, jax_ids, ranks = setup
    got = _same_on_every_rank(ranks, "cancel")
    (cancelled, end0), (full, end1) = got
    assert end0 == ("done", "cancelled") and end1 == ("done", "length")
    # cancelled after >= 3 of its 60 tokens, on the same token everywhere;
    # the greedy ids up to the cancel are the uncancelled run's
    assert 3 <= len(cancelled) < 60
    assert full == jax_ids[1]


def test_speculative_requests_on_the_mesh(setup):
    _, _, jax_ids, ranks = setup
    assert _ids(_same_on_every_rank(ranks, "spec")) == jax_ids
    counters = ranks[0]["spec_counters"]
    assert counters["draft_tokens_total"] > 0, counters
