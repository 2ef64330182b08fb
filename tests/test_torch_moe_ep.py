"""Mixtral-tiny on an expert-parallel mesh of the port against the JAX
family on its mesh.

One spawned world of two gloo CPU ranks (tests/torch_mesh_workers.py
`moe_ep`) holds debug-moe-tiny's experts split over ep=2 (two of the four
on each rank, the JAX package's weights carried across with
params_from_numpy); every rank routes every token with the replicated
router and the partial sums are reduced over ep. The JAX family runs the
same inputs with its params placed on an 8-device mesh (dp=2 x ep=2 x
tp=2, `param_shardings`). Both regimes: a prefill group above 4 *
num_experts tokens takes the capacity dispatch, one at or below it the
exact form, and the decode step after each is exact. Logits within 1e-4
(fp32, tests/test_torch_mixtral.py's limit), bit-equal on both ranks. The
same world runs the `--worker` step of parallel/distributed.py: the
sharded step within 1e-5 of the unsharded one on every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.models import mixtral as jmixtral
from llmlb_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from llmlb_tpu.parallel.mesh import build_mesh as jax_build_mesh
from tests.torch_mesh_workers import start_world

LOGIT_ATOL = 1e-4


def _inputs(seed, b, t):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, size=(b, t)).astype(np.int64)
    lens = rng.integers(t // 2, t + 1, size=(b,)).astype(np.int32)
    lens[0] = t
    return ids, lens


@pytest.fixture(scope="module")
def setup():
    cfg = jax_preset("debug-moe-tiny")
    jparams = jmixtral.init_params(cfg, jax.random.PRNGKey(0))
    weights = {k: np.asarray(v) for k, v in jparams.items()}
    cases = {"capacity": _inputs(1, 2, 16), "exact": _inputs(2, 2, 8)}
    inputs = {"weights": weights}
    for name, (ids, lens) in cases.items():
        inputs[name] = (ids, lens)
        # the decode step's tokens: any ids do for a logits comparison
        inputs[name + "_next"] = np.random.default_rng(3).integers(
            0, 512, size=(ids.shape[0],)).astype(np.int64)
    world = start_world("moe_ep", 2, inputs)
    mesh = jax_build_mesh(JaxMeshConfig(dp=2, ep=2, tp=2))
    sh = jmixtral.param_shardings(cfg, mesh)
    placed = {k: jax.device_put(v, sh[k]) for k, v in jparams.items()}
    jax_out = {}
    for name, (ids, lens) in cases.items():
        b, t = ids.shape
        assert (b * t <= 4 * cfg.num_experts) == (name == "exact")
        ck, cv = jmixtral.init_kv_cache(cfg, b, 32)
        logits, ck, cv = jmixtral.prefill_into_slots(
            placed, cfg, jnp.asarray(ids, jnp.int32), jnp.asarray(lens),
            jnp.arange(b, dtype=jnp.int32), ck, cv, mesh)
        dec, _, _ = jmixtral.decode_step(
            placed, cfg, jnp.asarray(inputs[name + "_next"], jnp.int32),
            jnp.asarray(lens), ck, cv, mesh)
        jax_out[name] = (np.asarray(logits), np.asarray(dec))
    return jax_out, world.result()


@pytest.mark.parametrize("form", ["capacity", "exact"])
def test_ep_mesh_matches_jax_family(setup, form):
    jax_out, ranks = setup
    assert ranks[0]["experts"][:2] == (2, 2)  # [L, experts on this rank]
    for r in ranks:
        for got, ref in zip(r[form], jax_out[form]):
            np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_ATOL)
        for got, lead in zip(r[form], ranks[0][form]):
            assert np.array_equal(got, lead)


def test_worker_mode_step(setup):
    _, ranks = setup
    for r in ranks:
        assert r["selftest"].startswith("multihost selftest OK: 2 ranks, "
                                        "mesh ep=2 tp=1")
