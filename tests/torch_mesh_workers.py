"""The spawned ranks of the port's multi-rank tests (tests/test_torch_*).

Each multi-rank test file spawns ONE world of gloo CPU processes through
`run_world`; every rank runs the file's worker function here, which runs
all of that file's cases and returns a result the test (the parent, which
also runs the JAX side) compares. Workers import only the port and numpy:
`python -m tests.torch_mesh_workers <worker> <rank> <world> <port> <in>
<out>`, inputs and results pickled.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from llmlb_tpu_torch.parallel.distributed import spawn_world, worker_init

WORKER_TIMEOUT_S = 150.0


def run_world(worker: str, world: int, inputs: dict,
              timeout_s: float = WORKER_TIMEOUT_S, env: dict | None = None
              ) -> list:
    """Spawn `world` ranks running `worker` on `inputs`; returns each rank's
    result. Raises with the failing ranks' stderr."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.pkl")
        with open(src, "wb") as f:
            pickle.dump(inputs, f)

        def argv(rank, port):
            return [sys.executable, "-m", "tests.torch_mesh_workers", worker,
                    str(rank), str(world), str(port), src,
                    os.path.join(tmp, f"out{rank}.pkl")]

        full_env = dict(os.environ if env is None else env)
        full_env["PYTHONPATH"] = repo + os.pathsep + full_env.get(
            "PYTHONPATH", "")
        outs = spawn_world(argv, world, timeout_s=timeout_s, env=full_env)
        bad = [(r, rc, err) for r, (rc, _, err) in enumerate(outs) if rc]
        if bad:
            raise AssertionError("\n".join(
                f"rank {r} exited {rc}:\n{err[-4000:]}" for r, rc, err in bad))
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"out{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def start_world(worker: str, world: int, inputs: dict, **kwargs):
    """`run_world` on a thread, so the parent's JAX side runs meanwhile;
    `.result()` gives the ranks' results (or raises their failure)."""
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(run_world, worker, world, inputs, **kwargs)
    pool.shutdown(wait=False)
    return future


# ---------------------------------------------------------------- helpers


def _params(inputs: dict, cfg):
    from llmlb_tpu_torch.engine.weights import params_from_numpy

    return params_from_numpy(inputs["weights"], cfg, device="cpu")


def _mirror(core) -> list:
    """Record the requests every rank queues from the tick plans (on a
    follower: the shadows), so a rank's ids can be read back."""
    seen = []
    apply = core._apply_plan

    def apply_and_keep(plan, local):
        before = core.pending.qsize()
        apply(plan, local)
        with core.pending.mutex:
            seen.extend(list(core.pending.queue)[before:])

    core._apply_plan = apply_and_keep
    return seen


def _wait(cond, timeout=60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError("worker wait timed out")
        time.sleep(0.005)


def _serve(core, rank: int, prompts: list, sampling: list,
           cancel_after: dict | None = None) -> list:
    """Run one lockstep engine over `prompts` and stop it through the plan:
    the leader submits, waits for every request to end and stops (the
    shutdown rides the plan); a follower's loop ends on that plan. Every
    rank returns, in plan order, the (ids, finish) of each request it
    mirrored (a follower's are its shadows). `cancel_after` {index: n}:
    the leader cancels that request once n of its tokens arrived."""
    from llmlb_tpu_torch.engine.scheduler import Request

    seen = _mirror(core)
    core.start()
    if rank == 0:
        reqs = [Request(prompt_ids=list(p), sampling=s)
                for p, s in zip(prompts, sampling)]
        for r in reqs:
            core.submit(r)
        for i, n in (cancel_after or {}).items():
            _wait(lambda: reqs[i].events.qsize() >= n)
            reqs[i].cancel()
        _wait(lambda: all(r.finished_at is not None for r in reqs))
        core.stop()
    else:
        core._thread.join()
        core.stop()
    return [_outcome(r) for r in seen]


def _outcome(request) -> tuple:
    """(ids, end event) of a request whose stream ended."""
    toks, end = [], None
    while not request.events.empty():
        kind, val = request.events.get()
        if kind == "token":
            toks.append(int(val))
        else:
            end = (kind, val)
    return toks, end


def _sampling(max_tokens: int, **kw):
    from llmlb_tpu_torch.engine.scheduler import SamplingParams

    return SamplingParams(temperature=0.0, max_tokens=max_tokens, **kw)


def _mesh(**axes):
    from llmlb_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    return build_mesh(MeshConfig(**{"dp": 1, "sp": 1, "ep": 1, "tp": 1,
                                    **axes}))


# ---------------------------------------------------------------- workers


def tp_engine(rank: int, world: int, inputs: dict) -> dict:
    """test_torch_tp_engine: lockstep engines on a tp=2 mesh over the JAX
    package's debug-tiny weights: paged, dense, int8 weights and KV, a
    cancel through the plan, and speculation on."""
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.engine.scheduler import EngineCore

    cfg = get_preset("debug-tiny")
    params = _params(inputs, cfg)
    prompts, mt = inputs["prompts"], inputs["max_tokens"]
    kw = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
              kv_page_size=16, eos_id=-1, seed=0, device="cpu",
              prefix_cache=False)
    greedy = [_sampling(mt)] * len(prompts)
    out = {}
    for name, extra in (("paged", {}), ("dense", {"kv_layout": "dense"}),
                        ("int8", {"quantize": "all"})):
        core = EngineCore(cfg, params, **kw, **extra)
        out[name] = _serve(core, rank, prompts, greedy)
        out[name + "_mesh"] = dict(core.mesh.shape)
    core = EngineCore(cfg, params, **kw)
    out["cancel"] = _serve(core, rank, prompts[:2],
                           [_sampling(60), _sampling(mt)],
                           cancel_after={0: 3})
    core = EngineCore(cfg, params, **kw)
    spec = _sampling(mt, speculative={"enabled": True,
                                      "max_draft_tokens": 4})
    out["spec"] = _serve(core, rank, prompts, [spec] * len(prompts))
    out["spec_counters"] = dataclasses.asdict(core.stats().spec)
    return out


def ring(rank: int, world: int, inputs: dict) -> dict:
    """test_torch_ring_attention: the ring at sp=4 and at sp=2 x tp=2 on
    this rank's chunk (and heads), the context-parallel prefill on the
    JAX package's weights, and two lockstep engines: sp=2 x tp=2 (the long
    prompt in one ring pass) and tp=4 (KV heads replicated)."""
    import dataclasses as dc

    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.engine.scheduler import EngineCore
    from llmlb_tpu_torch.models import llama
    from llmlb_tpu_torch.ops.ring_attention import ring_prefill_attention
    from llmlb_tpu_torch.parallel.mesh import MeshConfig

    out = {}
    for name, axes in (("sp4", {"sp": 4}), ("sp2tp2", {"sp": 2, "tp": 2})):
        q, k, v, lens = (torch.from_numpy(a) for a in inputs[name])
        mesh = _mesh(**axes)
        t = q.shape[1]
        c = t // mesh.shape["sp"]
        r, j, tp = mesh.coord["sp"], mesh.coord["tp"], mesh.shape["tp"]
        hq, hk = q.shape[2] // tp, k.shape[2] // tp
        sl = slice(r * c, (r + 1) * c)
        got = ring_prefill_attention(
            q[:, sl, j * hq:(j + 1) * hq], k[:, sl, j * hk:(j + 1) * hk],
            v[:, sl, j * hk:(j + 1) * hk], lens, mesh, seq_len=t)
        out[name] = (dict(mesh.coord), got.numpy())

    cfg = dc.replace(get_preset("debug-tiny"), num_kv_heads=2)
    params = _params(inputs, cfg)
    mesh = _mesh(sp=2, tp=2)
    fn = llama.make_context_parallel_prefill(llama.local_config(cfg, mesh),
                                             mesh)
    ids, lens = (torch.from_numpy(a) for a in inputs["cp_ids"])
    logits, k_all, v_all = fn(llama.shard_params(params, cfg, mesh), ids,
                              lens)
    out["cp"] = (dict(mesh.coord), logits.numpy(), k_all.numpy(),
                 v_all.numpy())

    kw = dict(num_slots=2, slot_capacity=128, prefill_buckets=(16, 32),
              kv_page_size=16, eos_id=-1, seed=0, device="cpu",
              prefix_cache=False)
    prompts, mt = inputs["prompts"], inputs["max_tokens"]
    greedy = [_sampling(mt)] * len(prompts)
    core = EngineCore(cfg, params, mesh_config=MeshConfig(sp=2, tp=2), **kw)
    assert core._use_cp_prefill
    out["cp_engine"] = _serve(core, rank, prompts, greedy)
    out["cp_engine_prefills"] = core.prefill_dispatches
    core = EngineCore(cfg, params, mesh_config=MeshConfig(tp=4), **kw)
    out["tp4_local_heads"] = (core.model_cfg.num_heads,
                              core.model_cfg.num_kv_heads,
                              tuple(core.params["wk"].shape))
    out["tp4_engine"] = _serve(core, rank, prompts, greedy)
    return out


def moe_ep(rank: int, world: int, inputs: dict) -> dict:
    """test_torch_moe_ep: Mixtral-tiny on an ep=2 mesh over the JAX
    package's weights: a prefill group in the capacity form, one in the
    exact form, and a decode step (exact); then the `--worker` self-test
    step of parallel/distributed.py in this world."""
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.models import mixtral
    from llmlb_tpu_torch.parallel.distributed import moe_selftest_step

    cfg = get_preset("debug-moe-tiny")
    mesh = _mesh(ep=2)
    params = mixtral.shard_params(_params(inputs, cfg), cfg, mesh)
    out = {"experts": tuple(params["we_gate"].shape)}
    for name in ("capacity", "exact"):
        ids, lens = (torch.from_numpy(a) for a in inputs[name])
        b, t = ids.shape
        ck, cv = mixtral.init_kv_cache(cfg, b, 32, "cpu")
        logits, ck, cv = mixtral.prefill_into_slots(
            params, cfg, ids, lens, torch.arange(b), ck, cv, mesh=mesh)
        tok = torch.from_numpy(inputs[name + "_next"])
        dec, _, _ = mixtral.decode_step(params, cfg, tok, lens, ck, cv,
                                        mesh=mesh)
        out[name] = (logits.numpy(), dec.numpy())
    out["selftest"] = moe_selftest_step(rank, world)
    return out


def multihost(rank: int, world: int, inputs: dict) -> dict:
    """test_torch_multihost: StepCoordinator round trips (and an oversized
    plan), the plan budget's spill, the lockstep self-test engine of
    parallel/distributed.py (`--engine-worker`), the refusals under a
    coordinator, and the port's server on both ranks: the leader serves
    HTTP, the follower binds no port (both are given the same one)."""
    import signal

    from llmlb_tpu_torch.engine import multihost as mh
    from llmlb_tpu_torch.engine import scheduler
    from llmlb_tpu_torch.engine import server as port_server
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.engine.scheduler import EngineCore, Request
    from llmlb_tpu_torch.parallel.distributed import engine_selftest_tokens
    from llmlb_tpu_torch.parallel.mesh import MeshConfig

    out = {}
    coord = mh.StepCoordinator(_mesh(tp=2))
    out["round_trips"] = [coord.exchange(p if rank == 0 else None)
                          for p in inputs["plans"]]
    bound = mh._MAX_PLAN_BYTES
    mh._MAX_PLAN_BYTES = 256
    try:
        if rank == 0:
            try:
                coord.exchange({"blob": "x" * 1000})
                out["oversize"] = None
            except ValueError as e:
                out["oversize"] = str(e)
    finally:
        mh._MAX_PLAN_BYTES = bound
    out["after_oversize"] = coord.exchange({"ok": 1} if rank == 0 else None)

    cfg = get_preset("debug-tiny")
    kw = dict(num_slots=2, slot_capacity=64, prefill_buckets=(16,),
              eos_id=-1, seed=0, device="cpu")
    def ship_offload(core):
        tier = core.kv_offload
        return core.kv_ship, tier.budget_bytes if tier is not None else None

    core = EngineCore(cfg, **kw, kv_offload_bytes=1 << 20)
    out["ship_offload"] = ship_offload(core)
    out["n_chips"] = core.perf_info()["n_chips"]
    if rank == 0:
        plan_bytes = scheduler._MAX_PLAN_BYTES
        scheduler._MAX_PLAN_BYTES = 8 * 30  # a budget of 30 prompt tokens
        try:
            for n in (12, 12, 12, 31):
                core.submit(Request(prompt_ids=[1] * n,
                                    sampling=_sampling(2)))
            first = core._collect_plan()
            backlog = len(core._plan_backlog)
            second = core._collect_plan()
        finally:
            scheduler._MAX_PLAN_BYTES = plan_bytes
        out["spill"] = ([len(r.prompt_ids) for r in first["new"]], backlog,
                        [len(r.prompt_ids) for r in second["new"]])
        big = core._plan_backlog  # the 31-token prompt was refused, not kept
        out["spill_left"] = len(big)

    out["engine_selftest"] = engine_selftest_tokens(rank)

    refusals = {}
    for name, extra in (
            ("split", {"role": "split"}),
            ("graphs", {"decode_graphs": True})):
        try:
            EngineCore(cfg, **kw, **extra)
            refusals[name] = None
        except ValueError as e:
            refusals[name] = str(e)
    # adapters and a split across hosts (one rank a host); an MoE engine at
    # dp builds
    for name, env, conf, extra in (
            ("lora", {"LOCAL_WORLD_SIZE": "1"}, cfg,
             {"lora_dir": inputs["lora_dir"]}),
            ("split_hosts", {"LOCAL_WORLD_SIZE": "1"}, cfg,
             {"role": "split"}),
            ("moe_dp", {}, get_preset("debug-moe-tiny"),
             {"mesh_config": MeshConfig(dp=2, tp=1)})):
        os.environ.update(env)
        try:
            EngineCore(conf, **kw, **extra)
            refusals[name] = None
        except ValueError as e:
            refusals[name] = str(e)
        finally:
            for k in env:
                del os.environ[k]
    # across hosts the pages stay put, as in the reference
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    try:
        out["ship_offload_hosts"] = ship_offload(
            EngineCore(cfg, **kw, kv_offload_bytes=1 << 20))
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    out["refusals"] = refusals
    # dp > 1 inside one engine is served: two dp groups of one slot each
    core = EngineCore(cfg, **kw, mesh_config=MeshConfig(dp=2, tp=1))
    out["dp_mesh"] = dict(core.mesh.shape)
    out["dp_served"] = _serve(core, rank, inputs["dp_prompts"],
                              [_sampling(4)] * len(inputs["dp_prompts"]))
    # an MoE engine at dp=2 serves (its prefill group spans both groups in
    # the capacity regime), and so does Mixtral's default mesh across hosts
    # (one rank a host: dp=2, ep=1), with KV shipping and the tier off
    moe = get_preset("debug-moe-tiny")
    greedy = [_sampling(4)] * len(inputs["dp_prompts"])
    core = EngineCore(moe, **kw, mesh_config=MeshConfig(dp=2, tp=1))
    out["moe_dp_served"] = _serve(core, rank, inputs["dp_prompts"], greedy)
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    try:
        core = EngineCore(moe, **kw, kv_offload_bytes=1 << 20)
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    out["moe_hosts_mesh"] = dict(core.mesh.shape)
    out["moe_hosts_ship_offload"] = ship_offload(core)
    out["moe_hosts_served"] = _serve(core, rank, inputs["dp_prompts"], greedy)

    port = inputs["port"]
    seen = {}
    if rank == 0:
        def drive():
            base = f"http://127.0.0.1:{port}"
            _wait(lambda: _up(base + "/api/health"), timeout=60)
            body = json_bytes({"model": "debug-tiny", "prompt": "hello",
                               "max_tokens": 4, "temperature": 0})
            req = urllib.request.Request(
                base + "/v1/completions", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                seen["completion"] = r.status
            with urllib.request.urlopen(base + "/api/health",
                                        timeout=30) as r:
                import json

                seen["mesh"] = json.loads(r.read())["engine"]["mesh"]
            signal.raise_signal(signal.SIGINT)

        threading.Thread(target=drive, daemon=True).start()
    port_server.main(["--preset", "debug-tiny", "--device", "cpu",
                      "--port", str(port), "--num-slots", "2",
                      "--slot-capacity", "128", "--kv-page-size", "16"])
    out["server"] = seen
    return out


def _up(url: str) -> bool:
    try:
        with urllib.request.urlopen(url, timeout=2) as r:
            return r.status == 200
    except OSError:
        return False


def json_bytes(obj) -> bytes:
    import json

    return json.dumps(obj).encode()


def _tokens(req) -> list[int]:
    out = []
    while not req.events.empty():
        kind, val = req.events.get()
        if kind == "token":
            out.append(int(val))
    return out


def _cross_group_hit(core, rank: int, head: list, tails: list,
                     mt: int) -> dict:
    """test_torch_dp_engine: a prefix-cache hit whose prefix KV another dp
    group wrote. The leader serves head + tails[0] alone (it lands in slot
    0, group 0, and donates its head), then two long requests that hold
    slots 0 and 1 (a dense donor pins slot 0: they take 1 and 2), and then
    head + tails[1], which lands in the first free slot, of group 1, and
    hits. Every rank records each request's slot and ids in plan order."""
    from llmlb_tpu_torch.engine.scheduler import Request

    seen = _mirror(core)
    slots = {}
    activate = core._activate_group

    def spy(group, slot_ids, lens, logits):
        for slot_id, request, _n in group:
            slots[request.request_id] = slot_id
        activate(group, slot_ids, lens, logits)

    core._activate_group = spy
    core.start()
    if rank == 0:
        first = core.submit(Request(prompt_ids=head + tails[0],
                                    sampling=_sampling(mt)))
        _wait(lambda: first.finished_at is not None)
        long = [core.submit(Request(prompt_ids=[3 + i] * 20,
                                    sampling=_sampling(60)))
                for i in range(2)]
        _wait(lambda: all(r.events.qsize() >= 2 for r in long))
        hit = core.submit(Request(prompt_ids=head + tails[1],
                                  sampling=_sampling(mt)))
        _wait(lambda: all(r.finished_at is not None for r in [hit, *long]))
        core.stop()
    else:
        core._thread.join()
        core.stop()
    return {"ids": [_tokens(r) for r in seen],
            "slots": [slots.get(r.request_id) for r in seen],
            "groups": list(core._slot_groups),
            "hits": core.stats().prefix.prefix_hits_total}


def dp_engine(rank: int, world: int, inputs: dict) -> dict:
    """test_torch_dp_engine: lockstep engines with dp groups over the JAX
    package's debug-tiny weights. A world of two ranks: dp=2 paged (the
    default pool) and dense, int8, a cancel through the plan, speculation,
    the cross-group prefix hit against its cold run, and a slot count dp
    does not divide. A world of four: dp=2 x tp=2 paged and dense, and
    dp=2 x sp=2 (the long prompt through the ring of its group)."""
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.engine.scheduler import EngineCore
    from llmlb_tpu_torch.parallel.mesh import MeshConfig

    cfg = get_preset("debug-tiny")
    params = _params(inputs, cfg)
    prompts, mt = inputs["prompts"], inputs["max_tokens"]
    kw = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
              kv_page_size=16, eos_id=-1, seed=0, device="cpu",
              prefix_cache=False)
    greedy = [_sampling(mt)] * len(prompts)
    out = {}
    if world == 4:
        for name, mesh, extra in (
                ("dp2tp2", MeshConfig(dp=2, tp=2), {}),
                ("dp2tp2_dense", MeshConfig(dp=2, tp=2),
                 {"kv_layout": "dense"}),
                ("dp2sp2", MeshConfig(dp=2, sp=2, tp=1), {})):
            core = EngineCore(cfg, params, mesh_config=mesh, **kw, **extra)
            out[name] = _serve(core, rank, prompts, greedy)
            out[name + "_mesh"] = dict(core.mesh.shape)
            out[name + "_coord"] = dict(core.mesh.coord)
        return out
    dp2 = MeshConfig(dp=2, tp=1)
    for name, extra in (("paged", {}), ("dense", {"kv_layout": "dense"}),
                        ("int8", {"quantize": "all"})):
        core = EngineCore(cfg, params, mesh_config=dp2, **kw, **extra)
        out[name] = _serve(core, rank, prompts, greedy)
        out[name + "_mesh"] = dict(core.mesh.shape)
        out[name + "_pages"] = core.kv_num_pages
        out[name + "_cache"] = (tuple(core.cache_k.shape)
                                if name == "dense" else None)
    core = EngineCore(cfg, params, mesh_config=dp2, **kw)
    out["cancel"] = _serve(core, rank, prompts[:2],
                           [_sampling(60), _sampling(mt)],
                           cancel_after={0: 3})
    core = EngineCore(cfg, params, mesh_config=dp2, **kw)
    spec = _sampling(mt, speculative={"enabled": True,
                                      "max_draft_tokens": 4})
    out["spec"] = _serve(core, rank, prompts, [spec] * len(prompts))
    out["spec_counters"] = dataclasses.asdict(core.stats().spec)
    head, tails = inputs["hit_head"], inputs["hit_tails"]
    for layout in ("paged", "dense"):
        core = EngineCore(cfg, params, mesh_config=dp2,
                          **{**kw, "prefix_cache": True, "kv_layout": layout})
        out["hit_" + layout] = _cross_group_hit(core, rank, head, tails, mt)
        core = EngineCore(cfg, params, mesh_config=dp2,
                          **{**kw, "kv_layout": layout})
        out["cold_" + layout] = _serve(core, rank, [head + tails[1]],
                                       [_sampling(mt)])
    core = EngineCore(cfg, params, mesh_config=dp2, **{**kw, "num_slots": 3})
    out["three_slots"] = _serve(core, rank, prompts, greedy)
    out["three_slots_groups"] = list(core._slot_groups)
    out["three_slots_pages"] = core.kv_num_pages
    try:
        EngineCore(cfg, params, mesh_config=dp2,
                   **{**kw, "num_slots": 3, "kv_layout": "dense"})
        out["three_slots_dense"] = None
    except ValueError as e:
        out["three_slots_dense"] = str(e)
    return out


def lora_mesh(rank: int, world: int, inputs: dict) -> dict:
    """test_torch_lora_mesh: a lockstep tp=2 engine with --lora-dir over the
    JAX package's debug-tiny weights and the parent's adapters: a mixed
    batch of adapter and adapter-free rows, then a request whose adapter
    loads cold while another decodes; the pool rows each rank assigned;
    the paged entry points on this rank's shards with the engine's pool
    rows; the same batch on a tp=2 engine without adapters."""
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.engine.scheduler import EngineCore, Request
    from llmlb_tpu_torch.models import llama
    from llmlb_tpu_torch.parallel.mesh import MeshConfig

    cfg = get_preset("debug-tiny")
    params = _params(inputs, cfg)
    prompts, adapters, mt = (inputs["prompts"], inputs["adapters"],
                             inputs["max_tokens"])
    kw = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
              kv_page_size=16, eos_id=-1, seed=0, device="cpu",
              prefix_cache=False, mesh_config=MeshConfig(tp=2))
    out = {}
    core = EngineCore(cfg, params, lora_dir=inputs["lora_dir"],
                      lora_rank_cap=8, lora_max_adapters=2, **kw)
    out["leaf_shapes"] = {k: tuple(v.shape) for k, v in core.params.items()
                          if "_lora_" in k}
    seen = _mirror(core)
    core.start()
    if rank == 0:
        mixed = [core.submit(Request(prompt_ids=list(p),
                                     sampling=_sampling(mt, lora=a)))
                 for p, a in zip(prompts, adapters)]
        _wait(lambda: all(r.finished_at is not None for r in mixed))
    # a cold load mid-run: "gamma" is not resident; it loads (evicting the
    # idle adapter acquired least recently) while another request decodes
    if rank == 0:
        busy = core.submit(Request(prompt_ids=prompts[0],
                                   sampling=_sampling(30)))
        _wait(lambda: busy.events.qsize() >= 2)
        cold = core.submit(Request(prompt_ids=prompts[1],
                                   sampling=_sampling(mt, lora="gamma")))
        _wait(lambda: all(r.finished_at is not None for r in (busy, cold)))
        core.stop()
    else:
        core._thread.join()
        core.stop()
    n = len(prompts)
    out["mixed"] = [(_tokens(r), None) for r in seen[:n]]
    out["cold"] = [_tokens(r) for r in seen[n:]]
    out["rows_after"] = {n: core.lora.slot_of(n)
                         for n in core.lora.resident_names()}
    out["lora_info"] = {k: v for k, v in core.lora_info().items()
                        if k in ("loads_total", "evictions_total", "active")}
    # the paged entry points with this rank's shards: rows of no adapter
    # and of each resident one, at the rows the engine put them in
    ids, lens, tables = (torch.from_numpy(a) for a in inputs["entry"])
    names = [None, *core.lora.resident_names()]
    out["entry_rows"] = {n: core.lora.slot_of(n) for n in names}
    lidx = torch.tensor([core.lora.slot_of(n) for n in names],
                        dtype=torch.int32)
    ck, cv = llama.init_kv_pages(core.model_cfg, 12, 8, "cpu")
    logits, ck, cv = llama.prefill_into_pages(
        core.params, core.model_cfg, ids, lens, tables, ck, cv,
        lora_idx=lidx, mesh=core.mesh)
    out["entry_logits"] = logits.numpy()
    core = EngineCore(cfg, params, **kw)
    out["plain"] = _serve(core, rank, prompts,
                          [_sampling(mt)] * len(prompts))
    # an sp=2 mesh: the long prompt's adapter keeps it off the ring pass
    # (which carries no adapter rows), on the chunked path
    core = EngineCore(cfg, params, lora_dir=inputs["lora_dir"],
                      lora_rank_cap=8, lora_max_adapters=2,
                      **{**kw, "mesh_config": MeshConfig(sp=2, tp=1)})
    out["sp_long"] = _serve(core, rank, [prompts[3]],
                            [_sampling(mt, lora=adapters[3])])
    out["sp_fallbacks"] = core.lora_info()["cp_fallback_total"]
    return out


def _stream_ids(deltas) -> list[int]:
    """Every id a service stream's deltas carry (an adoption's committed
    ids come first)."""
    return [t for d in deltas for t in d.token_ids]


def _drive(core, rank: int, script, limit: int = 4000) -> list:
    """Run a lockstep engine's loop on this thread, one iteration at a
    time: before each, the leader runs `script(tick)`, whose True ends the
    run (the stop rides that tick's plan); a follower iterates until the
    plan stops it. Returns this rank's parks, (tick, slot, reason,
    committed ids), in order."""
    parks, tick = [], [0]
    park = core._park_slot

    def logged(slot_id, reason="preempt"):
        parks.append((tick[0], slot_id, reason,
                      len(core.slots[slot_id].out_tokens)))
        park(slot_id, reason)

    core._park_slot = logged
    core._running = True
    while core._running:
        if rank == 0 and script(tick[0]):
            core._stop_requested = True
        core._iteration()
        tick[0] += 1
        if tick[0] > limit:
            raise TimeoutError("driven engine did not stop")
    return parks


def _slot_of(core, request):
    return next((i for i, s in enumerate(core.slots) if s.request is request),
                None)


def _local_rows(core, pages: list[int], tokens: int) -> dict:
    """This rank's pool rows [0, tokens) over `pages`, by wire section, as
    raw bytes."""
    out = {}
    for name, a in core._gather_kv_sections(pages).items():
        flat = a.reshape(a.shape[0], a.shape[1] * a.shape[2], *a.shape[3:])
        out[name] = flat[:, :tokens].tobytes()
    return out


def _migrate(core, rank: int, prompt: list, mt: int, park_at: int) -> dict:
    """A migration park, driven: the leader parks the stream once it has
    `park_at` ids (POST /v1/kv/export {"park": true}) and takes the export;
    the row, requeued, comes back from the offload tier and finishes. Every
    rank's parks, its own KV rows at the park, its tier's info and
    counters; the leader's export and ids."""
    from llmlb_tpu_torch.engine.scheduler import Request

    seen = _mirror(core)
    req = Request(prompt_ids=list(prompt), sampling=_sampling(mt),
                  request_id="mig.0123abcd")
    state: dict = {}
    rows = {}
    spill = core._spill_parked_slot

    def spy(slot_id, request, reason):
        tokens = int(core._seq_lens[slot_id])
        rows["tokens"] = tokens
        rows["rows"] = _local_rows(core, core._slot_pages[slot_id], tokens)
        spill(slot_id, request, reason)

    core._spill_parked_slot = spy

    def script(tick):
        if tick == 0:
            core.submit(req)
        slot = _slot_of(core, req)
        if ("parked" not in state and slot is not None
                and len(core.slots[slot].out_tokens) >= park_at):
            core.request_park("mig")
            state["parked"] = True
        elif "parked" in state and "payload" not in state:
            state["payload"] = core.take_kv_export("mig")
        return req.finished_at is not None

    parks = _drive(core, rank, script)
    out = {"parks": parks, "rows": rows,
           "ids": _tokens(seen[0]) if seen else None,
           "offload": core.kv_offload.info(),
           "transfer": {k: v for k, v in core.kv_transfer_info().items()
                        if k in ("ship_total", "ship_bytes_total",
                                 "restored_total", "restored_bytes_total")},
           "prefills": core.prefill_dispatches}
    if rank == 0:
        out["payload"] = state.get("payload")
    return out


def _drain_parks(core, rank: int, prompts: list, mt: int,
                 after: int) -> dict:
    """A drain, driven: two rows decode; once both hold `after` ids the
    leader begins the drain and asks for its park, a tick later for its
    flush, and takes the parks' exports. Every rank's parks and each
    request's ids and end; the leader's exports."""
    from llmlb_tpu_torch.engine.scheduler import Request

    seen = _mirror(core)
    reqs = [Request(prompt_ids=list(p), sampling=_sampling(mt),
                    request_id=f"dr{i}.0123abcd")
            for i, p in enumerate(prompts)]
    state: dict = {}

    def script(tick):
        if tick == 0:
            for r in reqs:
                core.submit(r)
        slots = [_slot_of(core, r) for r in reqs]
        if "drain" not in state:
            if all(s is not None and len(core.slots[s].out_tokens) >= after
                   for s in slots):
                core.begin_drain()
                core.request_drain_park()
                state["drain"] = tick
        elif "flush" not in state:
            core.request_drain_flush()
            state["flush"] = tick
        else:
            state["exports"] = [core.take_kv_export(f"dr{i}")
                                for i in range(len(reqs))]
            return True
        return False

    parks = _drive(core, rank, script)
    ends = [_outcome(r) for r in seen]
    out = {"parks": parks, "ends": ends, "drain_tick": state.get("drain"),
           "draining": core.draining}
    if rank == 0:
        out["exports"] = state["exports"]
    return out


def _served(core, rank: int, body) -> list:
    """Run `body(engine)` on the leader of a started lockstep engine (with
    the service over it) and stop; a follower's loop ends on that plan.
    Returns the ids of every request this rank mirrored (the leader's are
    read by its streams: empty)."""
    from llmlb_tpu_torch.engine.service import Engine
    from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer

    engine = Engine("debug-tiny", core, ByteTokenizer(core.cfg.vocab_size))
    seen = _mirror(core)
    core.start()
    result = None
    if rank == 0:
        try:
            result = body(engine)
        finally:
            engine.shutdown()
    else:
        core._thread.join()
        engine.shutdown()
    return result, [_tokens(r) for r in seen]


def _embed_spill(core, rank: int, rows: list) -> tuple:
    """Three embeddings queued before one tick, under a plan budget that
    holds one 64-id forward: two of one row each, and one whose forward
    (a 128-id row) no plan holds. Returns the leader's answers (each
    vector, or the error) and this rank's encode forwards as (tick,
    shape)."""
    from concurrent.futures import ThreadPoolExecutor

    from llmlb_tpu_torch.engine import scheduler

    ticks = [0]
    exchange = core.coordinator.exchange

    def counted(plan):
        ticks[0] += 1
        return exchange(plan)

    core.coordinator.exchange = counted
    ran = []
    encode = core._encode

    def spy(ids, lens):
        ran.append((ticks[0], tuple(ids.shape)))
        return encode(ids, lens)

    core._encode = spy
    gate = threading.Event()
    collect = core._collect_plan

    def gated(section=None):
        gate.wait()
        return collect(section)

    core._collect_plan = gated

    def body(engine):
        budget = scheduler._MAX_PLAN_BYTES
        scheduler._MAX_PLAN_BYTES = 8 * 100  # 100 ids: one 64-id forward
        try:
            with ThreadPoolExecutor(3) as pool:
                futs = [pool.submit(engine.embed, [row]) for row in rows]
                _wait(lambda: len(core._plan_calls) == len(rows))
                gate.set()
                answers = []
                for fut in futs:
                    try:
                        answers.append(fut.result(timeout=60)[0])
                    except ValueError as e:
                        answers.append(str(e))
                return answers
        finally:
            gate.set()
            scheduler._MAX_PLAN_BYTES = budget

    answers, _ = _served(core, rank, body)
    return answers, ran


def mesh_leader(rank: int, world: int, inputs: dict) -> dict:
    """test_torch_mesh_leader: the leader's actions on a lockstep engine of
    one host's ranks over the JAX package's debug-tiny weights, at tp=2
    (`inputs["axes"]` "tp") or dp=2 ("dp": the resume and the drain):
    adoptions with committed ids (plain and under a schema), a migration
    park exported and restored from the offload tier (fp32 and int8
    pools), its export and a drain's landed by adoptions, the drain's park
    and flush, embeddings (and forwards over the plan's budget), and a
    split engine."""
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.engine.scheduler import EngineCore
    from llmlb_tpu_torch.parallel.mesh import MeshConfig

    cfg = get_preset("debug-tiny")
    params = _params(inputs, cfg)
    prompts, mt = inputs["prompts"], inputs["max_tokens"]
    axes = MeshConfig(tp=2) if inputs["axes"] == "tp" else MeshConfig(
        dp=2, tp=1)
    kw = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
              kv_page_size=16, eos_id=inputs["eos"], seed=0, device="cpu",
              prefix_cache=False, mesh_config=axes)
    spec, smt = inputs["schema"], inputs["schema_tokens"]
    out = {}

    def resume(engine):
        got = {"plain": _stream_ids(engine.stream(prompts["a"],
                                                  _sampling(mt)))}
        got["schema"] = _stream_ids(engine.stream(
            prompts["s"], _sampling(smt, constraint=spec)))
        got["resumed"] = _stream_ids(engine.adopt_stream(
            prompts["a"], got["plain"][:5], _sampling(mt)))
        got["resumed_schema"] = _stream_ids(engine.adopt_stream(
            prompts["s"], got["schema"][:4], _sampling(smt, constraint=spec)))
        return got

    core = EngineCore(cfg, params, **kw)
    out["mesh"] = dict(core.mesh.shape)
    out["resume"] = _served(core, rank, resume)
    out["drain"] = _drain_parks(EngineCore(cfg, params, **kw), rank,
                                [prompts["a"], prompts["b"]], mt, 4)
    if inputs["axes"] == "dp":
        return out
    for name, quant in (("migrate", None), ("migrate_int8", "kv")):
        core = EngineCore(cfg, params, quantize=quant,
                          kv_offload_bytes=inputs["offload_bytes"], **kw)
        out[name] = _migrate(core, rank, prompts["m"], mt, inputs["park_at"])

    # the migration's export and the first drained row's, each landed by an
    # adoption; every rank's landed rows
    mig = out["migrate"]
    exports = (mig.get("payload"), (out["drain"].get("exports") or [None])[0])
    core = EngineCore(cfg, params, **kw)
    landed = []
    land = core._land_kv_pages

    def spy(kvp, fresh):
        land(kvp, fresh)
        landed.append(_local_rows(core, fresh, kvp.header.tokens))

    core._land_kv_pages = spy

    def adopt(engine):
        lead = out["drain"]["ends"][0][0]
        n_mig = exports[0]["tokens"] + 1 - len(prompts["m"])
        return [_stream_ids(engine.adopt_stream(
                    prompts["m"], mig["ids"][:n_mig], _sampling(mt),
                    kv_pages=exports[0])),
                _stream_ids(engine.adopt_stream(
                    prompts["a"], lead, _sampling(mt), kv_pages=exports[1]))]

    out["land"] = _served(core, rank, adopt)
    out["landed_rows"] = landed
    out["land_prefills"] = core.prefill_dispatches
    out["land_restored"] = core.kv_transfer_info()["restored_total"]

    out["embed"] = _served(EngineCore(cfg, params, **kw), rank,
                           lambda engine: engine.embed(inputs["embed"]))
    out["embed_spill"] = _embed_spill(
        EngineCore(cfg, params, **kw), rank,
        [inputs["embed"][1], inputs["embed"][1], list(range(120))])
    split = EngineCore(cfg, params, role="split", disagg_prefill_slots=2,
                       **kw)
    out["split"] = _served(split, rank, lambda engine: [
        _stream_ids(d) for d in [engine.stream(prompts[k], _sampling(mt))
                                 for k in ("a", "b", "long")]])
    out["split_ledger"] = (dict(split.prefill_dispatch_by_loop),
                           dict(split.decode_dispatch_by_loop))
    return out


def _rounds(core, rank: int, rounds: list) -> list:
    """Serve `rounds` of (prompt, sampling) on a lockstep engine driven by
    hand (`_drive`): the leader submits a round's requests at one tick, so
    they ride one tick plan and every rank inserts them together (an MoE
    engine's capacity dispatch then sees the batch a one-rank engine fed
    the same rounds sees), and the next round once each of them ended.
    Every rank returns the (ids, end) of each request it mirrored, in plan
    order."""
    from llmlb_tpu_torch.engine.scheduler import Request

    seen = _mirror(core)
    live: list = []
    left = list(rounds)

    def script(tick):
        if any(r.finished_at is None for r in live):
            return False
        if not left:
            return True
        live[:] = [core.submit(Request(prompt_ids=list(p), sampling=s))
                   for p, s in left.pop(0)]
        return False

    _drive(core, rank, script)
    return [_outcome(r) for r in seen]


def moe_dp(rank: int, world: int, inputs: dict) -> dict:
    """test_torch_moe_dp: lockstep debug-moe-tiny engines with dp groups
    over the JAX package's Mixtral weights, serving `inputs["rounds"]`
    (round 0 a group queued together, whose prefill group spans the dp
    groups in the capacity regime). A world of two: dp=2 paged, dense and
    int8 weights, and the cross-group prefix hit beside its cold run
    (paged and dense). A world of four: dp=2 x ep=2 paged, and dp=4 paged
    on `inputs["trio"]` (three prompts queued together: one group holds
    none of the spanning group's rows and joins its gathers). Each case
    records this rank's spanning gathers and joins."""
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.engine.scheduler import EngineCore
    from llmlb_tpu_torch.models import mixtral
    from llmlb_tpu_torch.parallel.mesh import Mesh, MeshConfig

    cfg = get_preset("debug-moe-tiny")
    params = _params(inputs, cfg)
    kw = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
              kv_page_size=16, eos_id=-1, seed=0, device="cpu",
              prefix_cache=False)
    mt = inputs["max_tokens"]
    spec = {"enabled": True, "max_draft_tokens": 4}

    def rounds(name):
        return [[(p, _sampling(mt, **({"speculative": spec} if s else {})))
                 for p, s in r] for r in inputs[name]]

    counts = {"gathers": 0, "joins": 0}
    gather, join = Mesh.gather_batch, mixtral._join_gathers

    def counted_gather(self, parts, rows):
        counts["gathers"] += 1
        return gather(self, parts, rows)

    def counted_join(*args):
        counts["joins"] += 1
        return join(*args)

    Mesh.gather_batch, mixtral._join_gathers = counted_gather, counted_join
    if world == 4:
        cases = (("dp2ep2", MeshConfig(dp=2, ep=2, tp=1), {}, "rounds"),
                 ("dp4", MeshConfig(dp=4, tp=1), {}, "trio"))
    else:
        dp2 = MeshConfig(dp=2, tp=1)
        cases = (("paged", dp2, {}, "rounds"),
                 ("dense", dp2, {"kv_layout": "dense"}, "rounds"),
                 ("int8", dp2, {"quantize": "weights"}, "rounds"))
    out = {}
    for name, mesh, extra, traffic in cases:
        counts.update(gathers=0, joins=0)
        core = EngineCore(cfg, params, mesh_config=mesh, **kw, **extra)
        out[name] = _rounds(core, rank, rounds(traffic))
        out[name + "_mesh"] = dict(core.mesh.shape)
        out[name + "_counts"] = dict(counts)
    if world == 4:
        return out
    head, tails = inputs["hit_head"], inputs["hit_tails"]
    for layout in ("paged", "dense"):
        core = EngineCore(cfg, params, mesh_config=dp2,
                          **{**kw, "prefix_cache": True, "kv_layout": layout})
        out["hit_" + layout] = _cross_group_hit(core, rank, head, tails, mt)
        core = EngineCore(cfg, params, mesh_config=dp2,
                          **{**kw, "kv_layout": layout})
        out["cold_" + layout] = _serve(core, rank, [head + tails[1]],
                                       [_sampling(mt)])
    return out


WORKERS = {"tp_engine": tp_engine, "ring": ring, "moe_ep": moe_ep,
           "multihost": multihost, "dp_engine": dp_engine,
           "lora_mesh": lora_mesh, "mesh_leader": mesh_leader,
           "moe_dp": moe_dp}


if __name__ == "__main__":
    name, rank, world, port, src, dst = sys.argv[1:7]
    rank, world = int(rank), int(world)
    worker_init(rank, world, int(port))
    with open(src, "rb") as f:
        inputs = pickle.load(f)
    result = WORKERS[name](rank, world, inputs)
    with open(dst, "wb") as f:
        pickle.dump(result, f)
    import torch.distributed as dist

    dist.destroy_process_group()
