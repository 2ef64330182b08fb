"""Logical-axis -> mesh-axis sharding rules: counterpart of
`llmlb_tpu/parallel/sharding.py`.

Params are annotated with *logical* axis names (each family's
`param_logical_axes`); `ShardingRules` maps them onto mesh axes. In the
reference a rule becomes a NamedSharding and JAX places each device's
shard; here a rank holds its own shard as a plain tensor, so the rules'
other half is `rank_slice`: the slice of a full leaf that this rank keeps,
the same block `jax.device_put(leaf, sharding).addressable_shards` gives
the device at the same mesh coordinate.
"""

from __future__ import annotations

import dataclasses

import torch

from llmlb_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names to mesh axis names (or None = replicated)."""

    # the batch / slot axis: dp groups own blocks of slots (mesh.py
    # `slot_groups`); the dense slot cache is split on it, the page pool
    # (shared by every slot) is not
    batch: str | None = "dp"
    # attention heads / MLP hidden width — the Megatron tp axis
    heads: str | None = "tp"
    kv_heads: str | None = "tp"
    ffn: str | None = "tp"
    vocab: str | None = "tp"
    # MoE expert dim (ops/moe.py)
    experts: str | None = "ep"
    # residual-stream model dim: replicated (activations all-reduced after tp matmuls)
    embed: str | None = None
    head_dim: str | None = None
    seq: str | None = None
    layers: str | None = None

    def spec(self, *logical_axes: str | None) -> tuple[str | None, ...]:
        """The mesh axis of each dim (the reference's PartitionSpec)."""
        return tuple(getattr(self, ax) if ax is not None else None
                     for ax in logical_axes)


def rank_slice(x: torch.Tensor, spec: tuple[str | None, ...],
               mesh: Mesh) -> torch.Tensor:
    """This rank's block of the full array `x` under `spec` (one mesh axis
    or None per dim): each dim split over its axis into equal blocks, the
    block at this rank's coordinate kept (a view)."""
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} has {len(spec)} dims, the array "
                         f"{x.dim()}")
    for dim, axis in enumerate(spec):
        n = 1 if axis is None else mesh.shape[axis]
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split over {axis}={n}")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.coord[axis] * size, size)
    return x


def shard_leaf(x: torch.Tensor, logical_axes: tuple, rules: ShardingRules,
               mesh: Mesh) -> torch.Tensor:
    """`rank_slice` of a leaf by its logical axes."""
    return rank_slice(x, rules.spec(*logical_axes), mesh)
