"""What a machine offers a mesh of ranks on its CUDA cards.

Prints one JSON line: the card count, and for two ranks spawned on the
card(s) (both on card 0 when there is one) with each backend, NCCL and
gloo, which collectives take CUDA tensors: broadcast, all_reduce,
all_gather and a send / recv pair, each "ok" (the right values came back)
or the error it raised. It tells whether NCCL accepts two ranks on one
card and which collectives a gloo mesh can run on CUDA tensors directly
(`parallel/mesh.py` moves a gloo mesh's CUDA tensors through host memory
for every collective either way). On gloo it also times a dp exchange
(`Mesh.gather_rows` over dp=2) of one decode step's payload at Llama-3-8B's
widths: two rows' fp32 logits and the K / V cells they wrote in 32 layers.
The line also gives the ranks a host holds (`ranks_per_host`: torchrun's
LOCAL_WORLD_SIZE, else every card's rank) and the default mesh the engine
would lay for Llama-3-8B over one rank a card.

    python -m llmlb_tpu_torch.tools.mesh_probe
"""

from __future__ import annotations

import json
import sys


def _rank(backend: str, rank: int, world: int, port: int) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", torch.cuda.current_device())

    def broadcast():
        x = torch.full((1024,), float(rank + 1), device=dev)
        dist.broadcast(x, src=0)
        return bool((x == 1).all())

    def all_reduce():
        x = torch.full((1024,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        return bool((x == world * (world + 1) / 2).all())

    def all_gather():
        x = torch.full((1024,), float(rank + 1), device=dev)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return all(bool((p == i + 1).all()) for i, p in enumerate(parts))

    def send_recv():
        x = torch.full((1024,), float(rank + 1), device=dev)
        out = torch.empty_like(x)
        peer = (rank + 1) % world
        req = dist.isend(x, dst=peer)
        dist.recv(out, src=(rank - 1) % world)
        req.wait()
        return bool((out == (rank - 1) % world + 1).all())

    # the results so far go out after each step (the parent reads the last
    # line): gloo's send / recv on CUDA tensors can abort the process, so
    # the dp exchange is timed first
    results = {}
    if backend == "gloo":
        results["dp_exchange_ms"] = _dp_exchange_ms(dev)
        print("PROBE " + json.dumps(results), flush=True)
    for name, fn in (("broadcast", broadcast), ("all_reduce", all_reduce),
                     ("all_gather", all_gather), ("send_recv", send_recv)):
        try:
            ok = fn()
            torch.cuda.synchronize()
            results[name] = "ok" if ok else "wrong values"
        except Exception as e:  # boundary: the probe reports what failed
            results[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
            if backend == "nccl":
                print("PROBE " + json.dumps(results), flush=True)
                break  # a failed NCCL communicator is not usable after
        print("PROBE " + json.dumps(results), flush=True)
    try:
        dist.destroy_process_group()
    except Exception:  # boundary: a broken communicator may refuse teardown
        pass


def _dp_exchange_ms(dev, reps: int = 20) -> float:
    """Host ms of one dp exchange of a decode step (2 rows a group):
    128256 fp32 logits and 32 layers x 8 KV heads x 128 bf16 K and V
    cells a row, over a gloo dp=2 mesh."""
    import time

    import torch

    from llmlb_tpu_torch.parallel.distributed import build_hybrid_mesh
    from llmlb_tpu_torch.parallel.mesh import MeshConfig

    mesh = build_hybrid_mesh(MeshConfig(dp=2, tp=1))
    rows = mesh.dp_rows([0, 0, 1, 1])
    parts = [torch.zeros((2, 128256), device=dev)] + [
        torch.zeros((2, 32, 1, 8, 128), dtype=torch.bfloat16, device=dev)
        for _ in range(2)]
    mesh.gather_rows(parts, rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        mesh.gather_rows(parts, rows)
    torch.cuda.synchronize()
    return round((time.perf_counter() - t0) / reps * 1e3, 3)


def main() -> int:
    import torch

    from llmlb_tpu_torch.parallel.distributed import spawn_world

    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.parallel.distributed import (engine_mesh,
                                                      ranks_per_host)

    n = torch.cuda.device_count()
    out = {"cuda_devices": n, "torch": torch.__version__,
           "cuda": torch.version.cuda, "ranks_per_host": ranks_per_host(n),
           "default_mesh_llama_3_8b": engine_mesh(
               get_preset("llama-3-8b"), world=n, rank=0).shape}
    for backend in ("nccl", "gloo"):
        try:
            ranks = spawn_world(
                lambda rank, port: [sys.executable, "-m",
                                    "llmlb_tpu_torch.tools.mesh_probe",
                                    "--rank", backend, str(rank), "2",
                                    str(port)], 2, timeout_s=120)
        except RuntimeError as e:
            out[backend] = {"error": str(e)}
            continue
        res = {}
        for rank, (rc, stdout, stderr) in enumerate(ranks):
            lines = [ln for ln in stdout.splitlines() if ln.startswith("PROBE ")]
            res[f"rank{rank}"] = (json.loads(lines[-1][6:]) if lines else
                                  {"exit": rc, "stderr": stderr[-400:]})
        out[backend] = res
    print(json.dumps({"mesh_probe": out}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
              int(sys.argv[5]))
    else:
        sys.exit(main())
