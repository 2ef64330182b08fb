"""The port gateway's pure units against the reference gateway's.

Each case feeds the same inputs, or the same seeded script of events, to
the reference module (llmlb_tpu/gateway/) and to its port
(llmlb_tpu_torch/gateway/) and requires the same results:

- the LoadManager (both packages' Python cores, `use_native=False`) under
  seeded admit / complete / fail / TPS / clear scripts, in both affinity
  modes: each selection, the active counts, the TPS EMAs and the affinity
  counters; `prefix_affinity_hash` and the HRW owner;
- `to_canonical` / `to_engine_name`, `parse_engine_tag` (on the reference's
  cases and a seeded grid of names), `sanitize_request_body`;
- `maybe_install_uvloop`'s fallback (uvloop is not installed here) and
  `ServerConfig.from_env()`'s fields and values;
- usage extraction from response bodies and SSE streams;
- the breaker's transitions and the retry budget under one scripted clock;
- `ReplayState` accounting and `ChunkSplicer` output over seeded resumes.
"""

import dataclasses
import random
import time

import pytest

from llmlb_tpu.gateway import balancer as ref_balancer
from llmlb_tpu.gateway import model_names as ref_names
from llmlb_tpu.gateway import replay as ref_replay
from llmlb_tpu.gateway import resilience as ref_resilience
from llmlb_tpu.gateway import sanitize as ref_sanitize
from llmlb_tpu.gateway import token_accounting as ref_tokens
from llmlb_tpu.gateway import config as ref_config
from llmlb_tpu.gateway import types as ref_types
from llmlb_tpu_torch.gateway import balancer, config, model_names, replay
from llmlb_tpu_torch.gateway import resilience, sanitize, token_accounting
from llmlb_tpu_torch.gateway import types


@pytest.fixture(autouse=True)
def _no_tiktoken(monkeypatch):
    """The reference estimates tokens by its ~4-characters fallback, as the
    port always does: its tiktoken path would fetch a BPE file over the
    network (ROADMAP C15)."""
    import sys

    monkeypatch.setitem(sys.modules, "tiktoken", None)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _endpoints(mod, rng):
    eps = []
    for i in range(4):
        acc = mod.AcceleratorInfo(
            accelerator="gpu", hbm_used_bytes=rng.choice([0, 70, 95]),
            hbm_total_bytes=100, queue_depth=rng.choice([0, 0, 2]),
            sampled_at=1000.0) if i % 2 else mod.AcceleratorInfo()
        eps.append(mod.Endpoint(name=f"e{i}", base_url=f"http://e{i}",
                                id=f"id{i}", accelerator=acc,
                                status=mod.EndpointStatus.ONLINE))
    return eps


def _tps_view(lm):
    return {k: (v["ema_tps"], v["samples"])
            for k, v in lm.tps_snapshot().items()}


def _outcomes(lm):
    return {eid: {k: v for k, v in o.items() if not k.endswith("_ts")}
            for eid, o in lm.endpoint_outcomes().items()}


@pytest.mark.parametrize("seed,mode", [(s, m) for s in range(4)
                                       for m in ("lru", "ring")])
def test_load_manager_scripts_match(seed, mode, monkeypatch):
    """The Python cores of both packages on one seeded script (the native
    cores are held against each other in tests/test_torch_native.py)."""
    load_manager_script(seed, mode, monkeypatch, native=False)


def load_manager_script(seed, mode, monkeypatch, *, native: bool):
    """A seeded script of admissions, selections (with and without a
    prompt head), lease ends, TPS samples, failures and clears through the
    JAX package's LoadManager and the port's, both on their Python cores or
    both on their native ones: every choice and every counter must agree."""
    clock = _Clock()
    monkeypatch.setattr(time, "time", clock)
    monkeypatch.setattr(time, "monotonic", clock)
    qc = dict(max_queue_size=10, queue_timeout_s=1.0,
              max_active_per_endpoint=3)
    ref = ref_balancer.LoadManager(ref_config.QueueConfig(**qc),
                                   use_native=native, affinity_mode=mode)
    ours = balancer.LoadManager(config.QueueConfig(**qc),
                                use_native=native, affinity_mode=mode)
    assert (ref._rc is not None, ours._rc is not None) == (native, native)
    ref_eps = _endpoints(ref_types, random.Random(seed))
    our_eps = _endpoints(types, random.Random(seed))
    rng = random.Random(1000 + seed)
    heads = ["system: you are helpful " * 8, "system: terse " * 12, "", "x"]
    leases = []
    for step in range(160):
        clock.t += 0.25
        op = rng.choice(["admit"] * 4 + ["complete", "fail", "tps", "select",
                                         "failure", "clear"])
        model = rng.choice(["m1", "m2"])
        kind = rng.choice(list(types.TpsApiKind)[:2])
        rkind = ref_types.TpsApiKind(kind.value)
        if op in ("admit", "select"):
            idx = sorted(rng.sample(range(4), rng.randint(1, 4)))
            text = rng.choice(heads)
            h = balancer.prefix_affinity_hash(model, text) if text else None
            assert h == (ref_balancer.prefix_affinity_hash(model, text)
                         if text else None)
            if op == "admit":
                a = ref.try_admit([ref_eps[i] for i in idx], model, rkind, h)
                b = ours.try_admit([our_eps[i] for i in idx], model, kind, h)
                assert (a and a[0].id) == (b and b[0].id), step
                if a:
                    leases.append((a[1], b[1]))
            else:
                a = ref.select_endpoint([ref_eps[i] for i in idx], model,
                                        rkind, h)
                b = ours.select_endpoint([our_eps[i] for i in idx], model,
                                         kind, h)
                assert (a and a.id) == (b and b.id), step
        elif op in ("complete", "fail") and leases:
            la, lb = leases.pop(rng.randrange(len(leases)))
            if op == "complete":
                pt, ct = rng.randint(1, 50), rng.randint(1, 200)
                la.complete_with_tokens(pt, ct)
                lb.complete_with_tokens(pt, ct)
            else:
                la.fail()
                lb.fail()
        elif op == "tps":
            eid = f"id{rng.randrange(4)}"
            toks, dur = rng.randint(0, 300), rng.uniform(0.0, 3.0)
            ref.update_tps(eid, model, rkind, toks, dur)
            ours.update_tps(eid, model, kind, toks, dur)
        elif op == "failure":
            eid = f"id{rng.randrange(4)}"
            ref.note_endpoint_failure(eid, stream_interruption=True)
            ours.note_endpoint_failure(eid, stream_interruption=True)
        elif op == "clear":
            eid = f"id{rng.randrange(4)}"
            ref.clear_tps_for_endpoint(eid)
            ours.clear_tps_for_endpoint(eid)
        assert [ref.active_count(f"id{i}") for i in range(4)] == [
            ours.active_count(f"id{i}") for i in range(4)]
        assert _tps_view(ref) == _tps_view(ours)
        # the prefix-heat map (LLMLB_AFFINITY_HEAT) is off by default in both
        assert ref.affinity_stats() == ours.affinity_stats()
        assert ours.affinity_stats()["heat_entries"] == 0
        assert _outcomes(ref) == _outcomes(ours)
    for la, lb in leases:
        la.complete()
        lb.complete()
    ids = [f"id{i}" for i in range(7)]
    for text in heads[:2] + ["a" * 600]:
        h = balancer.prefix_affinity_hash("m1", text, lora="ad")
        assert h == ref_balancer.prefix_affinity_hash("m1", text, lora="ad")
        assert balancer.hrw_owner(h, ids) == ref_balancer.hrw_owner(h, ids)


@pytest.mark.parametrize("name", [
    "llama-3-8b", "meta-llama/Meta-Llama-3-8B-Instruct", "llama3:8b",
    "Meta-Llama-3-8B-Instruct-Q4_K_M", "mixtral:8x7b", "debug-tiny",
    "tinyllama-1.1b", "unknown-model-bf16", "llama-3-8b:acme",
])
def test_model_names_match(name):
    assert model_names.to_canonical(name) == ref_names.to_canonical(name)
    for kind in types.EndpointType:
        assert (model_names.to_engine_name(name, kind.value)
                == ref_names.to_engine_name(name, kind.value))


def _engine_tag_grid(seed: int, n: int) -> list[str]:
    """Seeded engine-style names: with and without a tag, a size only,
    variants, quant suffixes, a `.gguf` suffix."""
    rng = random.Random(seed)
    families = ["llama3.1", "Meta-Llama-3", "mistral", "qwen2.5", "gemma-2",
                "phi3", "Mixtral", "tinyllama"]
    sizes = ["8b", "70B", "0.5b", "1.1B", "7b", "8x7b", "350m", "", ""]
    variants = ["instruct", "chat", "it", "", "", "text-v1.5", "Base"]
    quants = ["q4_K_M", "Q5_K_S", "q8_0", "Q4_0", "fp16", "bf16", "int8",
              "awq", "gptq", "F16", "", ""]
    names = []
    for _ in range(n):
        tag = "-".join(p for p in (rng.choice(sizes), rng.choice(variants),
                                   rng.choice(quants)) if p)
        name = rng.choice(families)
        if tag:
            name += rng.choice([":", ":", "-", "."]) + tag
        if rng.random() < 0.3:
            name += rng.choice([".gguf", ".GGUF"])
        names.append(name)
    return names


@pytest.mark.parametrize("name", [
    "llama3.1:8b-instruct-q4_K_M", "Meta-Llama-3-8B-Instruct.Q5_K_S.gguf",
    "mistral:7b", "llama3", "qwen2.5:0.5b", "model:", ":8b", "",
    "MODEL.GGUF", "llama:8b.instruct_q8_0", "a:b:c-7b",
] + _engine_tag_grid(0, 24))
def test_parse_engine_tag_matches(name):
    assert model_names.parse_engine_tag(name) == \
        ref_names.parse_engine_tag(name)


def test_parse_engine_tag_reference_cases():
    """tests/gateway/test_core_units.py's cases, on the port."""
    p = model_names.parse_engine_tag("llama3.1:8b-instruct-q4_K_M")
    assert p == {"family": "llama3.1", "size": "8b", "variant": "instruct",
                 "quant": "q4_k_m"}
    p = model_names.parse_engine_tag("Meta-Llama-3-8B-Instruct.Q5_K_S.gguf")
    assert p["quant"] == "q5_k_s"
    p = model_names.parse_engine_tag("mistral:7b")
    assert p["size"] == "7b" and p["variant"] is None


def test_maybe_install_uvloop_falls_back(monkeypatch, caplog):
    """uvloop is off unless LLMLB_UVLOOP=1; asked for where it is not
    installed, both packages warn and keep the standard event loop."""
    import asyncio
    import logging
    import sys

    from llmlb_tpu.gateway import server as ref_server
    from llmlb_tpu_torch.gateway import server

    policy = asyncio.get_event_loop_policy()
    monkeypatch.delenv("LLMLB_UVLOOP", raising=False)
    with caplog.at_level(logging.WARNING):
        assert server.maybe_install_uvloop() is False
        assert caplog.records == []
        monkeypatch.setenv("LLMLB_UVLOOP", "1")
        monkeypatch.setitem(sys.modules, "uvloop", None)
        assert server.maybe_install_uvloop() is False
        assert ref_server.maybe_install_uvloop() is False
    assert asyncio.get_event_loop_policy() is policy
    warned = [(r.name, r.getMessage()) for r in caplog.records]
    assert warned == [
        ("llmlb_tpu_torch.gateway.server", "LLMLB_UVLOOP=1 but uvloop is not "
         "installed; using the stdlib asyncio event loop"),
        ("llmlb_tpu.gateway.server", "LLMLB_UVLOOP=1 but uvloop is not "
         "installed; using the stdlib asyncio event loop")]


@pytest.mark.parametrize("env", [
    {},
    {"LLMLB_UPDATE_DRAIN_TIMEOUT": "12.5", "LLMLB_AUTO_SYNC_INTERVAL": "42",
     "LLMLB_PORT": "4567", "LLMLB_DATA_DIR": "/srv/llmlb",
     "LLMLB_HEALTH_CHECK_INTERVAL": "0.5", "LLMLB_STREAM_RESUME": "0"},
    {"LLMLB_UPDATE_DRAIN_TIMEOUT": "not-a-number",
     "LLMLB_AUTO_SYNC_INTERVAL": "-1"},
], ids=["defaults", "set", "malformed"])
def test_server_config_from_env_matches(env, monkeypatch):
    """`ServerConfig.from_env()` gives the reference's fields and values
    under the same environment, the update drain timeout among them. The
    one field left out is the reference's `auto_sync_interval_s`, which
    nothing in either package reads (ROADMAP C24)."""
    import os

    for k in list(os.environ):
        if k.startswith("LLMLB_"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = dataclasses.asdict(config.ServerConfig.from_env())
    want = dataclasses.asdict(ref_config.ServerConfig.from_env())
    unread = want.pop("auto_sync_interval_s")
    assert "auto_sync_interval_s" not in got
    assert got == want
    if env.get("LLMLB_PORT"):
        assert (got["update_drain_timeout_s"], unread) == (12.5, 42.0)
    elif not env:
        assert (got["update_drain_timeout_s"], unread) == (300.0, 300.0)


@pytest.mark.parametrize("body", [
    {"model": "m", "messages": [{"role": "user", "content": "hi"}]},
    {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "look"},
        {"type": "image_url", "image_url": {
            "url": "data:image/png;base64," + "A" * 5000}}]}]},
    {"input": "data:audio/wav;base64,UklGR" + "B" * 300, "n": 2},
    ["not", "a", "dict"],
    None,
    {"deep": {"deeper": ["data:text/plain;base64,aGk=", 3, 4.5, None]}},
])
def test_sanitize_request_body_matches(body):
    assert (sanitize.sanitize_request_body(body)
            == ref_sanitize.sanitize_request_body(body))


_CHUNK = ('data: {"choices": [{"index": 0, "delta": {"content": "%s"}}]}'
          '\n\n')
_STREAMS = {
    "reported": (_CHUNK % "Hello" + _CHUNK % " world" + 'data: {"choices":'
                 ' [], "usage": {"prompt_tokens": 9, "completion_tokens": 2}}'
                 '\n\ndata: [DONE]\n\n'),
    "estimated": _CHUNK % "some text here" + "data: [DONE]\n\n",
    "responses": ('data: {"type": "response.output_text.delta", "delta": '
                  '"abc def"}\n\ndata: {"type": "response.completed", '
                  '"usage": {"input_tokens": 4, "output_tokens": 3}}\n\n'),
    "completions": ('data: {"choices": [{"text": "xyz"}]}\n\n'
                    'data: [DONE]\n\n'),
}


@pytest.mark.parametrize("name", sorted(_STREAMS))
@pytest.mark.parametrize("cut", [1, 7, 64])
def test_stream_usage_matches(name, cut):
    raw = _STREAMS[name].encode()
    ours, ref = (token_accounting.StreamingTokenAccumulator(),
                 ref_tokens.StreamingTokenAccumulator())
    for i in range(0, len(raw), cut):
        ours.feed(raw[i:i + cut])
        ref.feed(raw[i:i + cut])
    assert ours.finalize("the prompt") == ref.finalize("the prompt")


@pytest.mark.parametrize("body", [
    {"usage": {"prompt_tokens": 3, "completion_tokens": 4}},
    {"usage": {"input_tokens": 5, "output_tokens": 6}},
    {"usage": {"prompt_tokens": 3}},
    {"usage": "nope"},
    {},
])
def test_response_usage_matches(body):
    assert (token_accounting.extract_usage_from_response(body)
            == ref_tokens.extract_usage_from_response(body))


@pytest.mark.parametrize("seed", range(3))
def test_breaker_and_retry_budget_scripts_match(seed, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    kw = dict(breaker_failure_threshold=3, breaker_open_s=2.0,
              breaker_open_max_s=8.0, retry_budget_ratio=0.25,
              retry_budget_min=2, retry_budget_window_s=30.0)
    ref = ref_resilience.ResilienceManager(ref_config.ResilienceConfig(**kw))
    ours = resilience.ResilienceManager(config.ResilienceConfig(**kw))
    rng = random.Random(seed)
    for step in range(300):
        eid = f"e{rng.randrange(3)}"
        op = rng.choice(["fail", "fail", "ok", "allow", "admit", "probe",
                         "tick", "request", "spend", "reset"])
        if op == "fail":
            reason = rng.choice(["timeout", "http_500", "connect_error"])
            ref.record_failure(eid, reason)
            ours.record_failure(eid, reason)
        elif op == "ok":
            ref.record_success(eid)
            ours.record_success(eid)
        elif op == "allow":
            assert ref.allow(eid) == ours.allow(eid), step
        elif op == "admit":
            if ref.allow(eid) and ours.allow(eid):
                ref.on_admit(eid)
                ours.on_admit(eid)
        elif op == "probe":
            good = rng.random() < 0.5
            ref.note_probe(eid, good)
            ours.note_probe(eid, good)
        elif op == "tick":
            clock.t += rng.choice([0.5, 1.5, 3.0, 12.0])
        elif op == "request":
            ref.budget.note_request()
            ours.budget.note_request()
        elif op == "spend":
            assert ref.budget.try_spend() == ours.budget.try_spend(), step
        else:
            ref.reset(eid)
            ours.reset(eid)
        for e in ("e0", "e1", "e2"):
            assert ref.state_of(e).value == ours.state_of(e).value, step
            assert ref.breaker_info(e) == ours.breaker_info(e), step
        assert ref.budget.snapshot() == ours.budget.snapshot()
        ids = ["e0", "e1", "e2"]
        assert ref.soonest_reopen_s(ids) == ours.soonest_reopen_s(ids)


def _chunk(i, content=None, role=False, finish=None, usage=None):
    delta = {}
    if role:
        delta["role"] = "assistant"
    if content is not None:
        delta["content"] = content
    obj = {"id": f"chatcmpl-{i}", "object": "chat.completion.chunk",
           "created": 1700000000 + i,
           "choices": [{"index": 0, "delta": delta, "finish_reason": finish}]}
    if usage:
        obj["usage"] = usage
        obj["choices"] = []
    return obj


def _tool_chunk(i, name=None, args=""):
    fn = {"arguments": args}
    tc = {"index": 0, "function": fn}
    if name:
        tc["id"] = "call_1"
        tc["type"] = "function"
        fn["name"] = name
    return {"id": f"chatcmpl-{i}", "object": "chat.completion.chunk",
            "created": 1, "choices": [{"index": 0, "delta": {
                "tool_calls": [tc]}, "finish_reason": None}]}


@pytest.mark.parametrize("seed", range(5))
def test_replay_state_and_splicer_match(seed):
    rng = random.Random(seed)
    words = [f"w{i} " for i in range(30)]
    tool = seed % 2 == 1
    # the first engine's stream up to the cut
    first = [_chunk(0, "", role=True)]
    cut = rng.randint(2, 20)
    for i in range(cut):
        first.append({"object": "llmlb.replay", "tokens": [100 + i]})
        first.append(_tool_chunk(0, "f" if i == 0 else None, words[i])
                     if tool else _chunk(0, words[i]))
    payload = {"model": "m", "messages": [], "stream": True,
               "committed_ids": [1]}
    states = [mod.ReplayState(payload, rid="r1", max_attempts=2)
              for mod in (ref_replay, replay)]
    for obj in first:
        assert states[0].note_openai_chunk(dict(obj)) == \
            states[1].note_openai_chunk(dict(obj))
    assert vars(states[0]) == vars(states[1])
    for st in states:
        st.mark_ledger_stale()
    assert (states[0].resume_body("m2", kv_pages={"a": 1})
            == states[1].resume_body("m2", kv_pages={"a": 1}))
    # the adopter re-emits the whole completion from token 0
    second = [_chunk(5, "", role=True)]
    for i in range(30):
        second.append(_tool_chunk(5, "f" if i == 0 else None, words[i])
                      if tool else _chunk(5, words[i]))
    second.append(_chunk(5, finish="stop"))
    second.append(_chunk(5, usage={"prompt_tokens": 3,
                                   "completion_tokens": 30}))
    splicers = [ref_replay.ChunkSplicer(states[0]),
                replay.ChunkSplicer(states[1])]
    for obj in second:
        outs = [sp.splice(dict(obj)) for sp in splicers]
        assert outs[0] == outs[1]
        if outs[1] is not None:
            assert (replay.encode_chunk_frame(outs[1])
                    == ref_replay.encode_chunk_frame(outs[0]))
    assert vars(states[0]) == vars(states[1])
    assert dataclasses.is_dataclass(types.Endpoint)


@pytest.mark.parametrize("password", ["adminpass1", "ünïcode-pass 9"])
async def test_password_hash_is_scrypt_and_an_argon2_row_gets_a_clear_401(
        password, tmp_path, monkeypatch):
    """Known difference from the reference (no argon2 on the card's
    machine): the port hashes with scrypt, and a user row the reference
    wrote (argon2) cannot log in: a 401 that names the cause, no crash."""
    from llmlb_tpu.gateway.auth import UserStore as RefUserStore
    from llmlb_tpu.gateway.db import Database as RefDatabase
    from llmlb_tpu_torch.gateway import auth
    from llmlb_tpu_torch.gateway import http as gh
    from llmlb_tpu_torch.gateway.app import create_app
    from llmlb_tpu_torch.gateway.app_state import build_app_state
    from llmlb_tpu_torch.gateway.db import Database
    from llmlb_tpu_torch.gateway.http import web

    h = auth.hash_password(password)
    assert h.startswith("$scrypt$ln=14,r=8,p=1$")
    assert auth.verify_password(h, password)
    assert not auth.verify_password(h, password + "x")
    assert h != auth.hash_password(password)  # salted

    path = str(tmp_path / "gw.db")
    ref_db = RefDatabase(path)
    RefUserStore(ref_db).create("admin", password,
                                ref_types.Role.ADMIN, enforce_policy=False)
    ref_db.close()
    with pytest.raises(auth.UnsupportedPasswordHash, match="argon2"):
        auth.UserStore(Database(path)).authenticate("admin", password)

    monkeypatch.setenv("LLMLB_ADMIN_PASSWORD", password)
    state = await build_app_state(config.ServerConfig.from_env(),
                                  db=Database(path), start_background=False)
    runner = web.AppRunner(create_app(state), shutdown_timeout=1.0)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", 0).start()
    base = "http://127.0.0.1:%d" % runner.addresses[0][1]
    try:
        async with gh.ClientSession() as s:
            r = await s.post(base + "/api/auth/login", json={
                "username": "admin", "password": password})
            assert r.status == 401
            assert "argon2" in (await r.json())["error"]
            state.users.create("second", password, types.Role.ADMIN,
                               enforce_policy=False)
            r = await s.post(base + "/api/auth/login", json={
                "username": "second", "password": password})
            assert r.status == 200 and (await r.json())["token"]
    finally:
        await runner.cleanup()
