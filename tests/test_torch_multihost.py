"""Multi-rank lockstep of the port: the plan wire, StepCoordinator, the
torch.distributed bring-up from the LLMLB_* variables, the refusals under
a coordinator, and the port's server on a leader and a follower.

The plan-wire contracts are tests/engine/test_plan_wire.py's on the port's
SamplingParams and EngineCore._plan_wire (every field survives the
pickled wire, so a forgotten field fails here instead of silently
diverging the ranks); they and init_from_env's parsing need no processes.
Everything else runs in ONE spawned world of two gloo CPU ranks
(tests/torch_mesh_workers.py `multihost`).
"""

import dataclasses
import pickle

import pytest
import torch.distributed as dist

from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import EngineCore, Request, SamplingParams
from llmlb_tpu_torch.parallel import distributed
from llmlb_tpu_torch.parallel.distributed import fresh_port
from tests.torch_mesh_workers import run_world


# ------------------------------------------------------------ plan wire


def _distinct_value(field: dataclasses.Field):
    ann = str(field.type)
    if "dict" in ann:
        return {"probe": field.name, "n": 3}
    if "bool" in ann:
        default = field.default
        return not default if isinstance(default, bool) else True
    if "float" in ann:
        return 0.125
    if "int" in ann:
        return 7
    if "str" in ann:
        return f"probe-{field.name}"
    raise AssertionError(
        f"SamplingParams.{field.name}: add a wire-probe rule for {ann!r}")


def _probe_params() -> SamplingParams:
    return SamplingParams(**{f.name: _distinct_value(f)
                             for f in dataclasses.fields(SamplingParams)})


def _wire_roundtrip(request: Request) -> Request:
    payload = {"request_id": request.request_id,
               "prompt_ids": list(request.prompt_ids),
               "sampling": dataclasses.asdict(request.sampling)}
    payload = pickle.loads(pickle.dumps(payload))
    return Request(prompt_ids=payload["prompt_ids"],
                   sampling=SamplingParams(**payload["sampling"]),
                   request_id=payload["request_id"])


def test_every_sampling_field_survives_the_wire():
    params = _probe_params()
    shadow = _wire_roundtrip(Request(prompt_ids=[1, 2, 3],
                                     sampling=params)).sampling
    for f in dataclasses.fields(SamplingParams):
        assert getattr(shadow, f.name) == getattr(params, f.name), f.name


def test_probe_values_differ_from_defaults():
    params, defaults = _probe_params(), SamplingParams()
    for f in dataclasses.fields(SamplingParams):
        assert getattr(params, f.name) != getattr(defaults, f.name), f.name


def test_speculative_and_constraint_ride_the_wire_verbatim():
    params = SamplingParams(constraint={"type": "json_object"},
                            speculative={"enabled": True,
                                         "max_draft_tokens": 6})
    shadow = _wire_roundtrip(Request(prompt_ids=[5], sampling=params)).sampling
    assert shadow.constraint == {"type": "json_object"}
    assert shadow.speculative == {"enabled": True, "max_draft_tokens": 6}


def test_plan_wire_matches_engine_implementation():
    req = Request(prompt_ids=[1, 2], sampling=_probe_params())
    plan = {"new": [req], "cancelled": [], "stop": False, "draining": False,
            "flags": (False, set(), False), "calls": [], "section": None}
    wire = EngineCore._plan_wire(None, plan)  # self unused in _plan_wire
    assert wire["new"][0]["sampling"] == dataclasses.asdict(req.sampling)
    assert SamplingParams(**wire["new"][0]["sampling"]) == req.sampling


# ---------------------------------------------------------- init_from_env


@pytest.mark.parametrize("env,expect", [
    ({}, None),
    ({"LLMLB_COORDINATOR": "10.0.0.1:7000", "LLMLB_NUM_HOSTS": "1"}, None),
    ({"LLMLB_COORDINATOR": "10.0.0.1:7000", "LLMLB_NUM_HOSTS": "4",
      "LLMLB_HOST_ID": "2"},
     ("gloo", "tcp://10.0.0.1:7000", {"world_size": 4, "rank": 2})),
    ({"LLMLB_DISTRIBUTED": "1"}, ("gloo", "env://", {})),
])
def test_init_from_env_parsing(monkeypatch, env, expect):
    for k in ("LLMLB_COORDINATOR", "LLMLB_NUM_HOSTS", "LLMLB_HOST_ID",
              "LLMLB_DISTRIBUTED", "LLMLB_MESH_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, init_method, **kw:
                        calls.append((backend, init_method, kw)))
    ran = distributed.init_from_env("cpu")
    assert ran == (expect is not None)
    assert calls == ([] if expect is None else [expect])


def test_backend_choice(monkeypatch):
    monkeypatch.delenv("LLMLB_MESH_BACKEND", raising=False)
    assert distributed._backend_for("cpu") == "gloo"
    assert distributed._backend_for("cuda") == "nccl"
    monkeypatch.setenv("LLMLB_MESH_BACKEND", "gloo")
    assert distributed._backend_for("cuda") == "gloo"
    monkeypatch.setenv("LLMLB_MESH_BACKEND", "nccl")
    with pytest.raises(ValueError):
        distributed._backend_for("cpu")
    monkeypatch.setenv("LLMLB_MESH_BACKEND", "mpi")
    with pytest.raises(ValueError):
        distributed._backend_for("cuda")


# ------------------------------------------------------- the spawned world

PLANS = [
    {"new": [], "cancelled": [], "stop": False},
    {"new": [{"request_id": "a", "prompt_ids": list(range(3000)),
              "sampling": dataclasses.asdict(SamplingParams(max_tokens=3))}],
     "cancelled": ["b"], "stop": False},
    {"new": [], "cancelled": [], "stop": True},
]


DP_PROMPTS = [[5, 9, 14, 200, 31, 7], [11] * 9]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_world("multihost", 2, {
        "plans": PLANS, "port": fresh_port(),
        "lora_dir": str(tmp_path_factory.mktemp("adapters")),
        "dp_prompts": DP_PROMPTS})


def test_step_coordinator_round_trips(ranks):
    for r in ranks:
        assert r["round_trips"] == PLANS
        assert r["after_oversize"] == {"ok": 1}
    # a plan over the bound raises on the leader before any broadcast, so
    # the next exchange still pairs with the followers'
    assert "tick plan too large" in ranks[0]["oversize"]


def test_plan_budget_spills_in_arrival_order(ranks):
    # a 30-token budget: two 12-token prompts fit, the third spills to the
    # next tick's backlog, the 31-token one can never fit and ends
    first, backlog, second = ranks[0]["spill"]
    assert first == [12, 12] and backlog == 2 and second == [12]
    assert ranks[0]["spill_left"] == 0


def test_engine_worker_mode_matches_one_rank_engine(ranks):
    """`--engine-worker`'s lockstep engine (tp=2 over the two ranks) gives
    a one-rank engine's greedy tokens on `selftest_requests`."""
    cfg = get_preset("debug-tiny")
    core = EngineCore(cfg, num_slots=2, slot_capacity=64,
                      prefill_buckets=(16,), seed=0, device="cpu")
    core.start()
    try:
        reqs = distributed.selftest_requests(cfg)
        for r in reqs:
            core.submit(r)
        one_rank = distributed.collect_tokens(reqs)
    finally:
        core.stop()
    assert ranks[0]["engine_selftest"] == one_rank
    assert ranks[1]["engine_selftest"] is None


def test_refusals_under_a_coordinator(ranks):
    """What a coordinator still refuses: graphs on gloo, adapters and a
    split across hosts (the reference's wording; one host's ranks serve
    them, tests/test_torch_lora_mesh.py and tests/test_torch_mesh_leader.py).
    An MoE engine at dp > 1 builds (test_moe_serves_at_dp_and_across_hosts).
    One host's ranks serve --role split, KV shipping and the offload tier,
    which stay off across hosts. dp > 1 inside one Llama engine is served:
    its greedy ids are a one-rank engine's, on both ranks."""
    cfg = get_preset("debug-tiny")
    core = EngineCore(cfg, num_slots=2, slot_capacity=64,
                      prefill_buckets=(16,), eos_id=-1, seed=0, device="cpu")
    core.start()
    try:
        reqs = [core.submit(Request(prompt_ids=p, sampling=SamplingParams(
            temperature=0.0, max_tokens=4))) for p in DP_PROMPTS]
        one_rank = distributed.collect_tokens(reqs)
    finally:
        core.stop()
    for r in ranks:
        ref = r["refusals"]
        assert ref["split"] is None
        assert "--role split is single-host only" in ref["split_hosts"]
        assert ref["lora"] == (
            "--lora-dir is single-host only for now: followers have no "
            "deterministic mirror of the leader's adapter pool slot "
            "assignment")
        assert ref["moe_dp"] is None
        assert "decode_graphs=True" in ref["graphs"] and "gloo" in ref["graphs"]
        assert r["ship_offload"] == (True, 1 << 20)
        assert r["ship_offload_hosts"] == (False, None)
        assert r["n_chips"] == 2
        assert r["dp_mesh"] == {"dp": 2, "sp": 1, "ep": 1, "tp": 1}
        assert [ids for ids, _ in r["dp_served"]] == one_rank


def test_moe_serves_at_dp_and_across_hosts(ranks):
    """A debug-moe-tiny engine at dp=2 (the two prompts one prefill group
    over both dp groups, in the capacity regime) and on Mixtral's default
    mesh across hosts (one rank a host: dp=2, ep=1, the reference's rule,
    KV shipping and the tier off) gives a one-rank engine's greedy ids on
    both ranks."""
    cfg = get_preset("debug-moe-tiny")
    core = EngineCore(cfg, num_slots=2, slot_capacity=64,
                      prefill_buckets=(16,), eos_id=-1, seed=0, device="cpu")
    core.start()
    try:
        reqs = [core.submit(Request(prompt_ids=p, sampling=SamplingParams(
            temperature=0.0, max_tokens=4))) for p in DP_PROMPTS]
        one_rank = distributed.collect_tokens(reqs)
    finally:
        core.stop()
    for r in ranks:
        assert [ids for ids, _ in r["moe_dp_served"]] == one_rank
        assert r["moe_hosts_mesh"] == {"dp": 2, "sp": 1, "ep": 1, "tp": 1}
        assert r["moe_hosts_ship_offload"] == (False, None)
        assert [ids for ids, _ in r["moe_hosts_served"]] == one_rank


def test_follower_server_binds_no_port(ranks):
    # both ranks were given the same --port: had the follower bound it,
    # one of them would have failed; the leader served and stopped both
    assert ranks[0]["server"]["completion"] == 200
    assert ranks[0]["server"]["mesh"] == {"dp": 1, "sp": 1, "ep": 1, "tp": 2}
    assert ranks[1]["server"] == {}
