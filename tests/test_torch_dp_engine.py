"""Data parallelism inside one lockstep engine of the port, against the JAX
engine.

Two spawned worlds of gloo CPU ranks (tests/torch_mesh_workers.py
`dp_engine`) serve the JAX package's debug-tiny weights (carried across
with params_from_numpy) with the batch's slots split into dp groups: slot
s belongs to group s // ceil(slots / dp), each group computes its own rows
of every dispatch, and one collective over dp a dispatch gives every rank
the batch's logits and, paged, the KV cells each group wrote. Both worlds
start before the file's one JAX engine (its 8-device CPU mesh, dp=4 x
tp=2) and run beside it. Greedy ids must be identical to the JAX engine's,
and every rank's ids (a follower's are its mirrored shadows) the
leader's:

- dp=2 (two ranks), paged with the reference's default pool (ceil(slots /
  dp) slots' pages plus the trash page) and dense (each rank's cache holds
  its group's two slots);
- dp=2 x tp=2 (four ranks), paged and dense, and dp=2 x sp=2, whose
  40-token prompt prefills through the ring of its group;
- int8 weights and KV at dp=2 against the port's one-rank int8 engine (the
  one-rank int8 engine is held against the JAX one by
  tests/test_torch_quant_engine.py);
- a prefix-cache hit whose head another dp group wrote (paged: its pages,
  copied into every rank's pool by the exchange; dense: the donor's rows
  sent over dp) equals its cold run;
- a cancel acting through the plan, speculation giving the greedy ids, and
  a slot count dp does not divide: paged serves it (the reference does:
  only its dense cache's sharding needs divisibility), dense refuses it.
"""

import math

import jax
import numpy as np
import pytest

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.models import llama as jllama
from llmlb_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from llmlb_tpu.parallel.mesh import default_tp as jax_default_tp
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import EngineCore, Request, SamplingParams
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.parallel.distributed import engine_mesh, ranks_per_host
from llmlb_tpu_torch.parallel.mesh import AXES, MeshConfig, build_mesh, slot_groups
from tests.torch_mesh_workers import start_world

# 45 > the largest bucket: chunks (dp=2 x sp=2: one ring pass)
PROMPT_LENS = (5, 12, 20, 45)
MAX_TOKENS = 8
CORE_KW = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
               kv_page_size=16, eos_id=-1, seed=0, prefix_cache=False)


def _prompts():
    rng = np.random.default_rng(19)
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
    jparams = jllama.init_params(jax_preset("debug-tiny"),
                                 jax.random.PRNGKey(0))
    weights = {k: np.asarray(v) for k, v in jparams.items()}
    prompts = _prompts()
    rng = np.random.default_rng(23)
    inputs = {"weights": weights, "prompts": prompts,
              "max_tokens": MAX_TOKENS,
              # a 32-token head (two pages, one bucket) and two tails: the
              # hit's suffix starts on the cold run's chunk boundary
              "hit_head": rng.integers(0, 512, size=(32,)).tolist(),
              "hit_tails": [rng.integers(0, 512, size=(n,)).tolist()
                            for n in (5, 8)]}
    two = start_world("dp_engine", 2, inputs)
    four = start_world("dp_engine", 4, inputs)
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
    return weights, inputs, jax_ids, two.result(), four.result()


def _ids(rank_result):
    return [toks for toks, _ in rank_result]


def _same_on_every_rank(ranks, case):
    leader = ranks[0][case]
    for r in ranks[1:]:
        assert r[case] == leader, (case, r[case], leader)
    return leader


@pytest.mark.parametrize("case", ["paged", "dense"])
def test_dp2_engine_matches_jax_engine(setup, case):
    _, _, jax_ids, ranks, _ = setup
    assert ranks[0][case + "_mesh"] == {"dp": 2, "sp": 1, "ep": 1, "tp": 1}
    got = _same_on_every_rank(ranks, case)
    assert _ids(got) == jax_ids
    assert all(end == ("done", "length") for _, end in got)


@pytest.mark.parametrize("case,mesh", [
    ("dp2tp2", {"dp": 2, "sp": 1, "ep": 1, "tp": 2}),
    ("dp2tp2_dense", {"dp": 2, "sp": 1, "ep": 1, "tp": 2}),
    ("dp2sp2", {"dp": 2, "sp": 2, "ep": 1, "tp": 1}),
])
def test_dp_with_tp_and_sp_matches_jax_engine(setup, case, mesh):
    _, _, jax_ids, _, ranks = setup
    assert ranks[0][case + "_mesh"] == mesh
    # tp (and sp) innermost: ranks 0-1 are dp group 0, ranks 2-3 group 1
    assert [r[case + "_coord"]["dp"] for r in ranks] == [0, 0, 1, 1]
    assert _ids(_same_on_every_rank(ranks, case)) == jax_ids


def test_pool_default_and_dense_split_follow_the_reference(setup):
    _, _, _, ranks, _ = setup
    pages_per_slot = 128 // 16
    # the reference's formula: ceil(slots / dp) slots' pages + the trash page
    assert ranks[0]["paged_pages"] == -(-4 // 2) * pages_per_slot + 1 == 17
    assert ranks[0]["three_slots_pages"] == -(-3 // 2) * pages_per_slot + 1
    # a rank's dense cache holds its group's 2 of the 4 slots
    assert ranks[0]["dense_cache"] == (2, 2, 128, 4, 16)
    assert ranks[0]["three_slots_groups"] == slot_groups(3, 2) == [0, 0, 1]
    assert "dp=2" in ranks[0]["three_slots_dense"]


def test_three_slots_over_dp2_serves_paged(setup):
    _, _, jax_ids, ranks, _ = setup
    assert _ids(_same_on_every_rank(ranks, "three_slots")) == jax_ids


def test_dp2_int8_matches_one_rank_port_engine(setup):
    weights, inputs, _, ranks, _ = setup
    cfg = get_preset("debug-tiny")
    core = EngineCore(cfg, params_from_numpy(weights, cfg, device="cpu"),
                      device="cpu", quantize="all", **CORE_KW)
    core.start()
    try:
        reqs = [Request(prompt_ids=p, sampling=SamplingParams(
            temperature=0.0, max_tokens=MAX_TOKENS))
            for p in inputs["prompts"]]
        for r in reqs:
            core.submit(r)
        one_rank = [_drain(r) for r in reqs]
    finally:
        core.stop()
    assert _ids(_same_on_every_rank(ranks, "int8")) == one_rank


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_cross_group_prefix_hit_equals_its_cold_run(setup, layout):
    _, _, _, ranks, _ = setup
    hit = _same_on_every_rank(ranks, "hit_" + layout)
    groups = hit["groups"]
    first, long0, long1, again = hit["slots"]
    # the head was written by group 0; the hit landed in group 1
    assert groups[first] == 0 and groups[again] == 1
    assert {long0, long1} <= {0, 1, 2}
    assert hit["hits"] >= 1
    cold = _same_on_every_rank(ranks, "cold_" + layout)
    assert hit["ids"][3] == cold[0][0]
    assert len(cold[0][0]) == MAX_TOKENS


def test_cancel_acts_through_the_plan_at_dp(setup):
    _, _, jax_ids, ranks, _ = setup
    got = _same_on_every_rank(ranks, "cancel")
    (cancelled, end0), (full, end1) = got
    assert end0 == ("done", "cancelled") and end1 == ("done", "length")
    assert 3 <= len(cancelled) < 60
    assert full == jax_ids[1]


def test_speculative_requests_at_dp(setup):
    _, _, jax_ids, ranks, _ = setup
    assert _ids(_same_on_every_rank(ranks, "spec")) == jax_ids
    assert ranks[0]["spec_counters"]["draft_tokens_total"] > 0


# ------------------------------------------------ the default mesh (C10)


def _reference_rule(jcfg, world: int, per_host: int) -> dict:
    """The reference's default mesh (llmlb_tpu/engine/scheduler.py): ep and
    tp sized within one host's devices, dp the rest, times the hosts."""
    ep = 1
    if getattr(jcfg, "num_experts", 0) > 1:
        ep = math.gcd(per_host, jcfg.num_experts)
    tp = jax_default_tp(per_host // ep, jcfg.num_heads, jcfg.num_kv_heads)
    return {"dp": per_host // (ep * tp) * (world // per_host), "sp": 1,
            "ep": ep, "tp": tp}


def _within_hosts(mesh, per_host: int, axes=("sp", "ep", "tp")) -> bool:
    """Every group of ranks along `axes` (all coordinates of the others
    fixed) sits on one host."""
    grid = mesh.grid
    for axis in axes:
        i = AXES.index(axis)
        lines = np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i])
        if any(len(set(r // per_host for r in line)) > 1 for line in lines):
            return False
    return True


@pytest.mark.parametrize("preset,world,per_host", [
    ("debug-tiny", 1, 1),
    ("debug-tiny", 2, 2),
    ("debug-tiny", 4, 4),
    ("debug-tiny", 4, 2),
    ("llama-3-8b", 16, 8),
    ("llama-3-8b", 8, 1),
    ("debug-moe-tiny", 8, 4),
    ("mixtral-8x7b", 4, 2),
])
def test_default_mesh_follows_the_reference_rule(preset, world, per_host):
    cfg = get_preset(preset)
    want = _reference_rule(jax_preset(preset), world, per_host)
    for rank in range(world):
        mesh = engine_mesh(cfg, world=world, rank=rank, per_host=per_host)
        assert mesh.shape == want, (rank, mesh.shape)
        assert _within_hosts(mesh, per_host)
        assert mesh.world == world and mesh.rank == rank


def test_explicit_tp_is_laid_within_a_host():
    cfg = get_preset("debug-tiny")
    # 2 hosts x 2 ranks, tp=2 asked: each host's two ranks are one tp
    # group, the hosts two dp groups
    mesh = engine_mesh(cfg, MeshConfig(tp=2), world=4, rank=3, per_host=2)
    assert mesh.shape == {"dp": 2, "sp": 1, "ep": 1, "tp": 2}
    assert mesh.grid.reshape(2, 2).tolist() == [[0, 1], [2, 3]]
    assert _within_hosts(mesh, 2)
    # a tp of four cannot be laid within a host of two: refused
    with pytest.raises(ValueError, match="does not cover"):
        engine_mesh(cfg, MeshConfig(tp=4), world=4, rank=0, per_host=2)


@pytest.mark.parametrize("conf", [MeshConfig(tp=2), MeshConfig(sp=2, tp=1),
                                  MeshConfig(ep=2, tp=1)])
def test_one_host_meshes_resolve_as_before(conf):
    """The tp, sp and ep worlds of two ranks on one host keep the meshes
    they had before hosts were counted: `build_mesh`'s row-major grid."""
    for rank in range(2):
        mesh = engine_mesh(get_preset("debug-moe-tiny"), conf, world=2,
                           rank=rank, per_host=2)
        want = build_mesh(conf, world=2, rank=rank)
        assert mesh.shape == want.shape
        assert np.array_equal(mesh.grid, want.grid)


def test_ranks_per_host_reads_local_world_size(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert ranks_per_host(4) == 4  # no torchrun: every rank on one host
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert ranks_per_host(4) == 2
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="does not divide"):
        ranks_per_host(4)

