"""Multi-rank serving for the port: counterpart of `llmlb_tpu/parallel`.

`mesh.py` (the (dp, sp, ep, tp) mesh of ranks and its collectives),
`sharding.py` (logical-axis rules and each rank's slice of a leaf) and
`distributed.py` (process-group bring-up from the LLMLB_* variables, the
hybrid mesh across hosts, and the spawned self-test worlds)."""

from llmlb_tpu_torch.parallel.mesh import Mesh, MeshConfig, build_mesh
from llmlb_tpu_torch.parallel.sharding import ShardingRules, rank_slice

__all__ = ["Mesh", "MeshConfig", "build_mesh", "ShardingRules", "rank_slice"]
