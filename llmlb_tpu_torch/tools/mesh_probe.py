"""What a machine offers a mesh of ranks on its CUDA cards.

Prints one JSON line: the card count, and for two ranks spawned on the
card(s) (both on card 0 when there is one) with each backend, NCCL and
gloo, which collectives take CUDA tensors: broadcast, all_reduce,
all_gather and a send / recv pair, each "ok" (the right values came back)
or the error it raised. It tells whether NCCL accepts two ranks on one
card and which collectives a gloo mesh can run on CUDA tensors directly
(`parallel/mesh.py` moves a gloo mesh's CUDA tensors through host memory
for every collective either way).

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

    results = {}
    for name, fn in (("broadcast", broadcast), ("all_reduce", all_reduce),
                     ("all_gather", all_gather), ("send_recv", send_recv)):
        try:
            ok = fn()
            torch.cuda.synchronize()
            results[name] = "ok" if ok else "wrong values"
        except Exception as e:  # boundary: the probe reports what failed
            results[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
            if backend == "nccl":
                break  # a failed NCCL communicator is not usable after
    print("PROBE " + json.dumps(results), flush=True)
    try:
        dist.destroy_process_group()
    except Exception:  # boundary: a broken communicator may refuse teardown
        pass


def main() -> int:
    import torch

    from llmlb_tpu_torch.parallel.distributed import spawn_world

    out = {"cuda_devices": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda}
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
