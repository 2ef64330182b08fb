"""The port's mesh and sharding rules against `llmlb_tpu/parallel` (no
processes: a Mesh without a process group is a layout).

- MeshConfig.resolve and build_hybrid_mesh's axes: twins of
  tests/ops/test_ring_attention.py::test_mesh_config_sp_resolution and
  tests/engine/test_multihost.py::test_hybrid_mesh_single_slice_axes, and
  a hybrid mesh across hosts against the reference's device layout.
- default_tp, validate_tp and is_power_of_two over a grid, against the
  reference's.
- Every leaf's rank slice equals, bit for bit, the JAX array's addressable
  shard at the same mesh coordinate (`jax.device_put` with the JAX
  `param_shardings`, `.addressable_shards`), for Llama bf16, Llama int8
  (the weights and their scales) and Mixtral's experts.
"""

import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from llmlb_tpu import quant as jquant
from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.models import llama as jllama
from llmlb_tpu.models import mixtral as jmixtral
from llmlb_tpu.parallel import mesh as jmesh
from llmlb_tpu.parallel.distributed import build_hybrid_mesh as jax_hybrid
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.models import llama, mixtral
from llmlb_tpu_torch.parallel.distributed import build_hybrid_mesh
from llmlb_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    MeshConfig,
    default_tp,
    is_power_of_two,
    validate_tp,
)
from llmlb_tpu_torch.parallel.sharding import rank_slice


def test_mesh_config_sp_resolution():
    cfg = MeshConfig(dp=2, tp=-1, sp=2).resolve(8)
    assert (cfg.dp, cfg.sp, cfg.tp) == (2, 2, 2)
    cfg = MeshConfig(dp=1, tp=1, sp=-1).resolve(8)
    assert cfg.sp == 8
    with pytest.raises(ValueError):
        MeshConfig(dp=3, tp=-1, sp=1).resolve(8)
    with pytest.raises(ValueError):
        MeshConfig(dp=-1, tp=-1).resolve(8)


def test_hybrid_mesh_single_slice_axes():
    mesh = build_hybrid_mesh(MeshConfig(dp=2, ep=2, tp=2), dcn_dp=1,
                             world=8, rank=0)
    assert mesh.shape == {"dp": 2, "sp": 1, "ep": 2, "tp": 2}


@pytest.mark.parametrize("dcn_dp,dcn_ep,ici", [
    (2, 1, MeshConfig(dp=1, ep=2, tp=2)),
    (1, 2, MeshConfig(dp=1, sp=2, tp=2)),
    (2, 2, MeshConfig(dp=1, ep=1, tp=2)),
])
def test_hybrid_mesh_lays_hosts_outermost(dcn_dp, dcn_ep, ici):
    """A host's ranks are consecutive, hosts the outer factor of dp / ep:
    each rank's coordinate is the reference's device's on a mesh whose
    devices are numbered host by host (the `process_is_granule` layout)."""
    world = 8
    ref = np.arange(world).reshape(dcn_dp, dcn_ep, ici.dp, ici.sp, ici.ep,
                                   ici.tp)
    for rank in range(world):
        mesh = build_hybrid_mesh(ici, dcn_dp=dcn_dp, dcn_ep=dcn_ep,
                                 world=world, rank=rank)
        h_dp, h_ep, i_dp, i_sp, i_ep, i_tp = np.argwhere(ref == rank)[0]
        assert mesh.coord == {"dp": h_dp * ici.dp + i_dp, "sp": i_sp,
                              "ep": h_ep * ici.ep + i_ep, "tp": i_tp}
        # sp and tp stay within one host: every group of those axes does
        for axis in ("sp", "tp"):
            grid = np.moveaxis(mesh.grid, AXES.index(axis), -1)
            hosts = grid // (world // (dcn_dp * dcn_ep))
            assert (hosts == hosts[..., :1]).all()


def test_single_process_hybrid_matches_reference_shape():
    mesh = jax_hybrid(jmesh.MeshConfig(dp=2, ep=2, tp=2), dcn_dp=1)
    port = build_hybrid_mesh(MeshConfig(dp=2, ep=2, tp=2), dcn_dp=1,
                             world=8, rank=3)
    assert dict(mesh.shape) == port.shape


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
def test_default_tp_and_validate_tp_match_reference(n):
    for heads, kv in itertools.product((1, 2, 4, 8, 12, 32), (1, 2, 4, 8)):
        if heads % kv:
            continue
        assert default_tp(n, heads, kv) == jmesh.default_tp(n, heads, kv)
        for tp in (1, 2, 3, 4, 8):
            try:
                jmesh.validate_tp(heads, kv, tp)
                ok = True
            except ValueError:
                ok = False
            if ok:
                validate_tp(heads, kv, tp)
            else:
                with pytest.raises(ValueError):
                    validate_tp(heads, kv, tp)
    assert [is_power_of_two(i) for i in range(9)] == [
        jmesh.is_power_of_two(i) for i in range(9)]


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _torch_np(t: torch.Tensor):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _check_leaves(jfamily, family, jcfg, cfg, jparams, config: MeshConfig):
    """Every leaf: the port's rank_slice at each device's coordinate equals
    that device's addressable shard."""
    jm = jmesh.build_mesh(jmesh.MeshConfig(dp=config.dp, sp=config.sp,
                                           ep=config.ep, tp=config.tp))
    jsh = jfamily.param_shardings(jcfg, jm)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                cfg, device="cpu")
    checked = 0
    for name, leaf in jparams.items():
        spec = family.param_shardings(cfg, Mesh(config))[name]
        assert spec == tuple(jsh[name].spec) + (None,) * (
            leaf.ndim - len(jsh[name].spec)), name
        placed = jax.device_put(leaf, jsh[name])
        for shard in placed.addressable_shards:
            coord = np.argwhere(jm.devices == shard.device)[0]
            rank = int(np.arange(jm.devices.size).reshape(
                jm.devices.shape)[tuple(coord)])
            got = rank_slice(tparams[name], spec, Mesh(config, rank=rank))
            np.testing.assert_array_equal(_torch_np(got), _np(shard.data))
            checked += 1
    return checked


def test_llama_bf16_leaf_slices_match_jax_shards():
    jcfg = dataclasses.replace(jax_preset("debug-tiny"),
                               dtype=jax.numpy.bfloat16)
    cfg = dataclasses.replace(get_preset("debug-tiny"), dtype=torch.bfloat16)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    n = _check_leaves(jllama, llama, jcfg, cfg, jparams,
                      MeshConfig(dp=1, sp=2, ep=1, tp=4))
    assert n == len(jparams) * 8


def test_llama_int8_leaf_slices_match_jax_shards():
    jcfg = jax_preset("debug-tiny")
    jparams = jquant.quantize_params(jllama.init_params(jcfg,
                                                        jax.random.PRNGKey(1)))
    assert "wo_scale" in jparams and jparams["wo"].dtype == np.int8
    _check_leaves(jllama, llama, jcfg, get_preset("debug-tiny"), jparams,
                  MeshConfig(dp=2, sp=1, ep=1, tp=4))


def test_mixtral_expert_slices_match_jax_shards():
    jcfg = jax_preset("debug-moe-tiny")
    jparams = jquant.quantize_params(jmixtral.init_params(
        jcfg, jax.random.PRNGKey(2)))
    assert "we_down_scale" in jparams
    _check_leaves(jmixtral, mixtral, jcfg, get_preset("debug-moe-tiny"),
                  jparams, MeshConfig(dp=2, sp=1, ep=2, tp=2))


def test_replicated_kv_heads_keep_the_heads_each_rank_reads():
    """tp=4 over 2 KV heads: the reference replicates wk / wv; a rank here
    keeps the one KV head its two q heads read (local q head i reads local
    KV head i // group in the kernels)."""
    cfg = dataclasses.replace(get_preset("debug-tiny"), num_kv_heads=2)
    full = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    d = cfg.head_dim_
    for rank in range(4):
        mesh = Mesh(MeshConfig(tp=4), rank=rank)
        local = llama.shard_params(full, cfg, mesh)
        kv_head = (rank * 2) // 4  # q heads 2r, 2r+1 of 8; group 4
        assert torch.equal(local["wk"], full["wk"][..., kv_head * d:
                                                   (kv_head + 1) * d])
        assert torch.equal(local["wq"], full["wq"][..., rank * 2 * d:
                                                   (rank + 1) * 2 * d])
        lc = llama.local_config(cfg, mesh)
        assert (lc.num_heads, lc.num_kv_heads, lc.head_dim_) == (2, 1, d)


def test_unconnected_mesh_refuses_collectives():
    mesh = Mesh(MeshConfig(tp=2), rank=1)
    assert not mesh.connected
    with pytest.raises(RuntimeError):
        mesh.all_reduce(torch.ones(2), "tp")
    assert torch.equal(mesh.all_gather(torch.ones(2), "sp"), torch.ones(2))
