"""Multi-rank serving: torch.distributed bring-up, the hybrid mesh, and the
spawned self-test worlds. Counterpart of `llmlb_tpu/parallel/distributed.py`.

- In the port a "host" is one process, and there is one process per card.
  `init_from_env()` reads the reference's variables: LLMLB_COORDINATOR
  (host:port), LLMLB_NUM_HOSTS and LLMLB_HOST_ID give the TCP rendezvous;
  LLMLB_DISTRIBUTED=1 takes torchrun's `env://` instead.
- The backend is NCCL when the ranks run on CUDA cards and gloo on the
  CPU. LLMLB_MESH_BACKEND=gloo chooses gloo on the cards explicitly, and
  with it ranks may share a card (NCCL refuses two ranks on one device):
  the mesh then moves CUDA tensors through host memory.
- `build_hybrid_mesh()` lays the axes that may span hosts (dp replicas, ep
  experts) outside the ones that stay within a host (sp, tp).
- `ranks_per_host()` reads how many ranks share a host: torchrun's
  LOCAL_WORLD_SIZE, else the whole world (LLMLB_COORDINATOR ranks all run
  on one host: LOCAL_RANK defaults to the host id, one card each).
  `engine_mesh()` is the engine's mesh over the world, resolved host by
  host as the reference resolves it.

Spawned CPU self-test worlds: `python -m llmlb_tpu_torch.parallel.distributed
--selftest` runs the sharded Mixtral-tiny step on an ep mesh of two
processes (`--worker`); `--engine-worker` runs a lockstep EngineCore.
"""

from __future__ import annotations

import logging
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from llmlb_tpu_torch.device import rank_device
from llmlb_tpu_torch.parallel.mesh import (Mesh, MeshConfig, build_mesh,
                                           default_tp)

log = logging.getLogger("llmlb_tpu_torch.parallel.distributed")


def _backend_for(device: str | None) -> str:
    """gloo on the CPU; on the cards NCCL unless LLMLB_MESH_BACKEND says
    gloo (the ranks-share-a-card arrangement)."""
    chosen = os.environ.get("LLMLB_MESH_BACKEND", "").strip().lower()
    if chosen not in ("", "gloo", "nccl"):
        raise ValueError(f"LLMLB_MESH_BACKEND={chosen!r}: use gloo or nccl")
    on_cpu = (device is not None and torch.device(device).type == "cpu") or (
        device is None and not torch.cuda.is_available())
    if on_cpu:
        if chosen == "nccl":
            raise ValueError("LLMLB_MESH_BACKEND=nccl needs CUDA ranks")
        return "gloo"
    return chosen or "nccl"


def init_from_env(device: str | None = None) -> bool:
    """Initialise torch.distributed from the LLMLB_* variables (True if it
    ran, or a process group exists already). On CUDA ranks this process's
    card is set first (cuda:LOCAL_RANK,
    LOCAL_RANK defaulting to the host id), so `resolve_device(None)` and
    NCCL see it; `device` is the engine's ("cpu" selects gloo)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True  # brought up already (a spawned worker, a test)
    coordinator = os.environ.get("LLMLB_COORDINATOR")
    num_hosts = int(os.environ.get("LLMLB_NUM_HOSTS", "0") or 0)
    if coordinator and num_hosts > 1:
        host_id = int(os.environ.get("LLMLB_HOST_ID", "0"))
        init, world, rank = f"tcp://{coordinator}", num_hosts, host_id
    elif os.environ.get("LLMLB_DISTRIBUTED") == "1":
        init, world, rank = "env://", None, None
        host_id = int(os.environ.get("RANK", "0"))
    else:
        return False
    backend = _backend_for(device)
    on_cuda = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    if on_cuda:
        local = int(os.environ.get("LOCAL_RANK", host_id))
        torch.cuda.set_device(rank_device(local, share=backend == "gloo"))
    log.info("torch.distributed: %s backend %s rank %s/%s", init, backend,
             rank, world)
    kwargs = {} if world is None else {"world_size": world, "rank": rank}
    dist.init_process_group(backend, init_method=init, **kwargs)
    return True


def ranks_per_host(world: int) -> int:
    """The ranks of a host: LOCAL_WORLD_SIZE (torchrun sets it), else all
    `world` ranks (the LLMLB_COORDINATOR arrangement, every rank on one
    host). It must divide the world: hosts hold equal shares."""
    env = os.environ.get("LOCAL_WORLD_SIZE", "").strip()
    n = int(env) if env else world
    if n < 1 or world % n:
        raise ValueError(f"LOCAL_WORLD_SIZE={env!r} does not divide the "
                         f"world of {world} ranks")
    return n


def default_mesh_config(cfg, n_local: int) -> MeshConfig:
    """The reference's default mesh of one host's `n_local` ranks
    (`llmlb_tpu/engine/scheduler.py`, "device" read as "rank"): ep =
    gcd(n_local, experts) for an MoE, tp = default_tp of what is left, dp
    the rest. Across hosts dp multiplies by the host count
    (`engine_mesh`), so ep and tp never leave a host."""
    ep = 1
    if getattr(cfg, "num_experts", 0) > 1:
        ep = math.gcd(n_local, cfg.num_experts)
    tp = default_tp(n_local // ep, cfg.num_heads, cfg.num_kv_heads)
    return MeshConfig(dp=n_local // (ep * tp), ep=ep, tp=tp)


def engine_mesh(cfg, mesh_config: MeshConfig | None = None, *,
                world: int | None = None, rank: int | None = None,
                per_host: int | None = None) -> Mesh:
    """The engine's mesh over the world (default: the initialised one, else
    one rank), as the reference lays it: `mesh_config` (default:
    `default_mesh_config` of one host's ranks) sizes the axes within a
    host; over more than one host the mesh is `build_hybrid_mesh` with dp
    multiplied by the host count, so sp, ep and tp stay within a host,
    default or explicit. One host: `build_mesh`, as before."""
    import torch.distributed as dist

    ready = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if ready else 1
    if per_host is None:
        per_host = ranks_per_host(world)
    hosts = world // per_host
    if mesh_config is None:
        mesh_config = default_mesh_config(cfg, per_host)
    if hosts > 1:
        return build_hybrid_mesh(mesh_config, dcn_dp=hosts, world=world,
                                 rank=rank)
    return build_mesh(mesh_config, world=world, rank=rank)


def build_hybrid_mesh(ici: MeshConfig, *, dcn_dp: int = 1, dcn_ep: int = 1,
                      world: int | None = None,
                      rank: int | None = None) -> Mesh:
    """(dp, sp, ep, tp) mesh whose dp / ep axes may span hosts.

    `ici` sizes the axes within one host (resolved against the ranks per
    host); `dcn_dp` / `dcn_ep` multiply dp / ep across hosts. A host's
    ranks are consecutive, hosts ordered (dp, ep); on each axis the host's
    index is the outer factor, as `create_hybrid_device_mesh` lays the
    reference's devices. sp and tp never cross hosts: their per-layer
    collectives would wait on the slowest link every step."""
    import torch.distributed as dist

    ready = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if ready else 1
    if rank is None:
        rank = dist.get_rank() if ready else 0
    per_host = world // (dcn_dp * dcn_ep)
    ici = ici.resolve(per_host)
    grid = np.arange(world).reshape(dcn_dp, dcn_ep, ici.dp, ici.sp, ici.ep,
                                    ici.tp)
    grid = grid.transpose(0, 2, 3, 1, 4, 5).reshape(
        dcn_dp * ici.dp, ici.sp, dcn_ep * ici.ep, ici.tp)
    config = MeshConfig(dp=grid.shape[0], sp=grid.shape[1], ep=grid.shape[2],
                        tp=grid.shape[3])
    backend = dist.get_backend() if ready and world > 1 else None
    return Mesh(config, rank=rank, grid=grid, backend=backend)


# ---------------------------------------------------------------------------
# Spawned worlds (the self-tests, and the tests' own workers)
# ---------------------------------------------------------------------------


def fresh_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bind_race(err: str) -> bool:
    low = err.lower()
    return ("address already in use" in low or "eaddrinuse" in low
            or "failed to bind" in low)


def spawn_world(argv_for, world: int, *, timeout_s: float = 300.0,
                env: dict | None = None, attempts: int = 3
                ) -> list[tuple[int, str, str]]:
    """Run `world` processes, `argv_for(rank, port)` each (one rendezvous
    port a round), and return their (returncode, stdout, stderr). The
    bind-then-close port probe races (another process can take the port
    before rank 0's store binds it): a round that failed on the bind is
    retried with a fresh port. When one rank fails the others are given a
    few seconds, then killed (they would wait on it in a collective). One
    deadline covers the whole world; on it every process is killed and
    RuntimeError raised."""
    import tempfile

    env = dict(os.environ if env is None else env)
    env.setdefault("OMP_NUM_THREADS", "1")
    env.pop("PYTHONSTARTUP", None)
    deadline = time.monotonic() + timeout_s
    outs: list[tuple[int, str, str]] = []
    for attempt in range(attempts):
        port = fresh_port()
        with tempfile.TemporaryDirectory() as tmp:
            files = [(open(os.path.join(tmp, f"{r}.out"), "w+"),
                      open(os.path.join(tmp, f"{r}.err"), "w+"))
                     for r in range(world)]
            procs = [subprocess.Popen(argv_for(r, port), env=env,
                                      stdout=o, stderr=e, text=True)
                     for r, (o, e) in enumerate(files)]
            grace_until = None
            while any(p.poll() is None for p in procs):
                now = time.monotonic()
                if grace_until is None and any(
                        p.returncode not in (None, 0) for p in procs):
                    grace_until = now + 5.0
                if now > deadline or (grace_until and now > grace_until):
                    for p in procs:
                        if p.poll() is None:
                            p.kill()
                    for p in procs:
                        p.wait()
                    if now > deadline:
                        raise RuntimeError(
                            f"spawned world of {world} timed out after "
                            f"{timeout_s:.0f} s")
                    break
                time.sleep(0.05)
            outs = []
            for p, (o, e) in zip(procs, files):
                o.seek(0)
                e.seek(0)
                outs.append((p.returncode, o.read(), e.read()))
                o.close()
                e.close()
        failed = [err for rc, _, err in outs if rc != 0]
        if failed and any(_bind_race(e) for e in failed) and (
                attempt < attempts - 1):
            log.warning("rendezvous port race; retrying with a fresh port")
            continue
        break
    return outs


def worker_init(rank: int, world: int, port: int) -> None:
    """A spawned CPU worker's process group: gloo over TCP on localhost,
    one torch thread."""
    import torch.distributed as dist

    import datetime

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))


def selftest_requests(cfg):
    """The canonical request set of the lockstep equivalence checks, shared
    by `_engine_worker` and the one-rank baseline in the tests."""
    from llmlb_tpu_torch.engine.scheduler import Request, SamplingParams

    rng = np.random.default_rng(11)
    return [
        Request(prompt_ids=[int(t) for t in rng.integers(1, cfg.vocab_size,
                                                         size=(12,))],
                sampling=SamplingParams(temperature=0.0, max_tokens=6))
        for _ in range(2)
    ]


def collect_tokens(reqs, timeout: float = 240.0) -> list[list[int]]:
    outs = []
    for r in reqs:
        toks = []
        while True:
            kind, val = r.events.get(timeout=timeout)
            if kind == "token":
                toks.append(int(val))
            elif kind == "done":
                break
            else:
                raise AssertionError(f"engine error: {val}")
        outs.append(toks)
    return outs


def _selftest_worker(rank: int, world: int, port: int) -> None:
    import torch.distributed as dist

    worker_init(rank, world, port)
    line = moe_selftest_step(rank, world)
    if rank == 0:
        print(line, flush=True)
    dist.destroy_process_group()


def moe_selftest_step(rank: int, world: int) -> str:
    """One rank of the Mixtral-tiny step on an ep mesh of the initialised
    world: every rank makes the full weights from one seed and keeps its
    experts; prefill and one decode step through the family's entry
    points; the logits must be finite, equal on every rank, and within
    1e-5 of the unsharded model's on this rank. Returns the report line."""
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.models import mixtral

    cfg = get_preset("debug-moe-tiny")
    mesh = build_hybrid_mesh(MeshConfig(dp=1, ep=world, tp=1))
    gen = torch.Generator().manual_seed(0)
    full = mixtral.init_params(cfg, gen, "cpu")
    params = mixtral.shard_params(full, cfg, mesh)
    ids = torch.randint(0, cfg.vocab_size, (2, 8),
                        generator=torch.Generator().manual_seed(1))
    lens = torch.full((2,), 8, dtype=torch.int32)

    def step(p, m):
        ck, cv = mixtral.init_kv_cache(cfg, 2, 16, "cpu")
        logits, ck, cv = mixtral.prefill_into_slots(
            p, cfg, ids, lens, torch.arange(2), ck, cv, mesh=m)
        tok = logits.argmax(-1)
        logits, _, _ = mixtral.decode_step(p, cfg, tok, lens, ck, cv, mesh=m)
        return logits

    logits = step(params, mesh)
    ref = step(full, None)
    assert torch.isfinite(logits).all(), "non-finite logits on the ep mesh"
    err = float((logits - ref).abs().max())
    assert err <= 1e-5, f"ep mesh logits differ from one rank's by {err}"
    gathered = mesh.all_gather(logits[None], "ep", dim=0)
    assert all(torch.equal(g, logits) for g in gathered), "ranks disagree"
    return (f"multihost selftest OK: {world} ranks, mesh ep="
            f"{mesh.shape['ep']} tp={mesh.shape['tp']}, MoE prefill+decode "
            f"finite, max |diff| from one rank {err:.2e}")


def _engine_worker(rank: int, world: int, port: int) -> None:
    import torch.distributed as dist

    worker_init(rank, world, port)
    tokens = engine_selftest_tokens(rank)
    if tokens is not None:
        print(f"ENGINE_TOKENS {tokens!r}", flush=True)
    else:
        print("follower exited cleanly", flush=True)
    dist.destroy_process_group()


def engine_selftest_tokens(rank: int):
    """Lockstep serving across the initialised world: every rank builds the
    same debug-tiny EngineCore over the default mesh (tp over the ranks);
    the leader submits `selftest_requests` and the tick-plan broadcast
    (engine/multihost.py) keeps the followers dispatching the same
    forwards. Returns the leader's greedy tokens (None on a follower)."""
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.engine.scheduler import EngineCore

    cfg = get_preset("debug-tiny")
    core = EngineCore(cfg, num_slots=2, slot_capacity=64,
                      prefill_buckets=(16,), seed=0, device="cpu")
    assert core.coordinator is not None
    assert core.coordinator.is_leader == (rank == 0)
    core.start()
    if rank == 0:
        try:
            reqs = selftest_requests(cfg)
            for r in reqs:
                core.submit(r)
            return collect_tokens(reqs)
        finally:
            core.stop()  # broadcasts the shutdown; followers leave their loops
    # the step thread runs the lockstep loop until the leader's plan says
    # stop (stopping here would strand the leader in its exchange)
    core._thread.join()
    core.stop()
    return None


def run_multihost_selftest(num_hosts: int = 2, timeout_s: float = 300.0,
                           mode: str = "--worker"):
    """Spawn `num_hosts` CPU ranks that form a gloo world: "--worker" runs
    the ep-mesh MoE step, "--engine-worker" the lockstep EngineCore and
    returns the leader's greedy tokens. Raises on any failure."""
    def argv(rank, port):
        return [sys.executable, "-m", "llmlb_tpu_torch.parallel.distributed",
                mode, str(rank), str(num_hosts), str(port)]

    outs = spawn_world(argv, num_hosts, timeout_s=timeout_s)
    for rc, out, err in outs:
        if rc != 0:
            raise RuntimeError(
                f"multihost worker failed (rc={rc}):\n{err[-2000:]}")
    if mode == "--engine-worker":
        import ast

        for _, out, _ in outs:
            for line in out.splitlines():
                if line.startswith("ENGINE_TOKENS "):
                    return ast.literal_eval(line[len("ENGINE_TOKENS "):])
        raise RuntimeError(f"no ENGINE_TOKENS line in worker output: {outs}")
    assert any("multihost selftest OK" in out for _, out, _ in outs), outs
    return None


if __name__ == "__main__":
    if "--worker" in sys.argv or "--engine-worker" in sys.argv:
        mode = "--worker" if "--worker" in sys.argv else "--engine-worker"
        i = sys.argv.index(mode)
        worker = _selftest_worker if mode == "--worker" else _engine_worker
        worker(int(sys.argv[i + 1]), int(sys.argv[i + 2]),
               int(sys.argv[i + 3]))
    elif "--selftest" in sys.argv:
        run_multihost_selftest()
        print("OK")
