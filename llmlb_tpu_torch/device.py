"""Device resolution for every entry point of the port.

The port serves on the CUDA card. The CPU is used only when the caller asks
for it (`device="cpu"`, as the tests do); asking for the card on a host that
has none raises instead of quietly running on the CPU.

A rank of a multi-rank engine runs on its own card, `rank_device`: the
card of its local rank, set as the current device before the process group
comes up (`parallel/distributed.init_from_env`), so `resolve_device(None)`
gives it.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch.device an entry point runs on. `None` means the card."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def rank_device(local_rank: int, share: bool = False) -> torch.device:
    """The card of the rank with this local rank: cuda:{local_rank}. Ranks
    that outnumber the cards raise, unless `share` (a gloo mesh, whose
    ranks may share a card: NCCL refuses two ranks on one device), when
    they wrap around the cards."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available for this rank")
    if local_rank >= n and not share:
        raise RuntimeError(
            f"local rank {local_rank} has no card of its own ({n} visible); "
            "LLMLB_MESH_BACKEND=gloo lets ranks share cards")
    return torch.device("cuda", local_rank % n)
