"""Ring attention, the context-parallel prefill and the sp / tp=4 engines
of the port on a world of four ranks, against the JAX package.

One spawned world of four gloo CPU ranks (tests/torch_mesh_workers.py
`ring`) runs every case; the JAX side runs in this process on the
8-device CPU mesh from tests/conftest.py.

- The ring (ops/ring_attention.py) at sp=4 (MHA, one full and one ragged
  row) and at sp=2 x tp=2 (GQA, each rank holding its query chunk and its
  share of the heads) against the reference's dense `gqa_attention_prefill`
  and the port's plain `dense_prefill_attention`, 2e-5 as the reference's
  ring tests allow.
- `make_context_parallel_prefill` at sp=2 x tp=2 against the reference's
  dense prefill: logits within 2e-4 and each rank's KV heads within 2e-5
  (the reference's test_context_parallel_prefill_matches_dense limits).
- Lockstep engines over the JAX package's weights of debug-tiny with two
  KV heads: sp=2 x tp=2, where the 40-token prompt (buckets 16 and 32)
  prefills in one ring pass (the CP engine twin of
  tests/engine/test_long_context.py::test_cp_prefill_engine_matches_chunked),
  and tp=4, where the KV heads are replicated and each rank keeps the one
  its two q heads read. Both give the JAX engine's greedy ids (its mesh
  sp=4 x tp=2, its own ring prefill), on every rank.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.models import llama as jllama
from llmlb_tpu.ops.attention import gqa_attention_prefill
from llmlb_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from llmlb_tpu_torch.ops.ring_attention import dense_prefill_attention
from tests.torch_mesh_workers import start_world

MAX_TOKENS = 6
PROMPT_LENS = (40, 9, 21)  # 40 > the largest bucket (32): the ring pass


def _qkv(seed, b, t, h, kh, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, d), np.float32),
            rng.standard_normal((b, t, kh, d), np.float32),
            rng.standard_normal((b, t, kh, d), np.float32))


def _cfg():
    return dataclasses.replace(jax_preset("debug-tiny"), num_kv_heads=2)


@pytest.fixture(scope="module")
def setup():
    cases = {
        "sp4": (*_qkv(0, 2, 64, 4, 4, 16), np.array([64, 37], np.int32)),
        "sp2tp2": (*_qkv(1, 2, 32, 8, 4, 8), np.array([32, 9], np.int32)),
    }
    jparams = jllama.init_params(_cfg(), jax.random.PRNGKey(3))
    weights = {k: np.asarray(v) for k, v in jparams.items()}
    rng = np.random.default_rng(4)
    cp_ids = (rng.integers(0, 512, size=(2, 32)).astype(np.int64),
              np.array([32, 21], np.int32))
    prompts = [rng.integers(1, 512, size=(n,)).tolist() for n in PROMPT_LENS]
    world = start_world("ring", 4, {**cases, "weights": weights,
                                    "cp_ids": cp_ids, "prompts": prompts,
                                    "max_tokens": MAX_TOKENS})

    jcore = JaxEngineCore(_cfg(), jparams, num_slots=2, slot_capacity=128,
                          prefill_buckets=(16, 32), kv_page_size=16,
                          eos_id=-1, seed=0, prefix_cache=False,
                          mesh_config=JaxMeshConfig(dp=1, sp=4, tp=2))
    assert jcore._use_cp_prefill
    jcore.start()
    try:
        reqs = [JaxRequest(prompt_ids=p, sampling=JaxSampling(
            temperature=0.0, max_tokens=MAX_TOKENS)) for p in prompts]
        for r in reqs:
            jcore.submit(r)
        jax_ids = []
        for r in reqs:
            toks = []
            while True:
                kind, val = r.events.get(timeout=120)
                if kind == "token":
                    toks.append(int(val))
                elif kind == "done":
                    break
                else:
                    raise AssertionError(val)
            jax_ids.append(toks)
    finally:
        jcore.stop()
    return cases, jparams, cp_ids, jax_ids, world.result()


def _assemble(ranks, name, heads_dim=2):
    """Rebuild [B, T, H, D] from each rank's (coord, chunk of its heads)."""
    parts = {}
    for r in ranks:
        coord, chunk = r[name][:2]
        parts[(coord["sp"], coord["tp"])] = chunk
    sp = 1 + max(k[0] for k in parts)
    tp = 1 + max(k[1] for k in parts)
    return np.concatenate([np.concatenate([parts[(i, j)] for j in range(tp)],
                                          axis=heads_dim)
                           for i in range(sp)], axis=1)


@pytest.mark.parametrize("name", ["sp4", "sp2tp2"])
def test_ring_matches_dense(setup, name):
    cases, _, _, _, ranks = setup
    q, k, v, lens = cases[name]
    ring = _assemble(ranks, name)
    dense = np.asarray(gqa_attention_prefill(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v),
                                             jnp.asarray(lens)))
    plain = dense_prefill_attention(*(torch.from_numpy(a)
                                      for a in (q, k, v, lens))).numpy()
    t = q.shape[1]
    valid = np.arange(t)[None, :, None, None] < lens[:, None, None, None]
    for ref in (dense, plain):
        np.testing.assert_allclose(np.where(valid, ring, 0.0),
                                   np.where(valid, ref, 0.0),
                                   rtol=2e-5, atol=2e-5)


def test_context_parallel_prefill_matches_dense(setup):
    _, jparams, (ids, lens), _, ranks = setup
    cfg = _cfg()
    b, t = ids.shape
    ck, cv = jllama.init_kv_cache(cfg, b, t)
    dense_logits, dense_k, dense_v = jllama.prefill(
        jparams, cfg, jnp.asarray(ids, jnp.int32), jnp.asarray(lens), ck, cv)
    valid = (np.arange(t)[None, None, :, None, None]
             < lens[None, :, None, None, None])
    for r in ranks:
        coord, logits, k_all, v_all = r["cp"]
        np.testing.assert_allclose(logits, np.asarray(dense_logits),
                                   rtol=2e-4, atol=2e-4)
        assert np.array_equal(logits, ranks[0]["cp"][1])  # bit-equal ranks
        kl = k_all.shape[3]  # this rank's KV heads: its tp share
        heads = slice(coord["tp"] * kl, (coord["tp"] + 1) * kl)
        for got, ref in ((k_all, dense_k), (v_all, dense_v)):
            ref = np.asarray(ref)[:, :, :, heads]
            np.testing.assert_allclose(np.where(valid, got, 0.0),
                                       np.where(valid, ref, 0.0),
                                       rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("engine", ["cp_engine", "tp4_engine"])
def test_lockstep_engine_matches_jax_engine(setup, engine):
    _, _, _, jax_ids, ranks = setup
    leader = ranks[0][engine]
    for r in ranks[1:]:
        assert r[engine] == leader
    assert [toks for toks, _ in leader] == jax_ids
    if engine == "cp_engine":
        # the 40-token prompt in ONE ring pass (chunked, it takes two), the
        # two short ones in one-shot groups
        assert ranks[0]["cp_engine_prefills"] <= 3
    else:
        # 8 q heads / 4 ranks = 2 a rank, reading one KV head of the two
        hq, hk, wk = ranks[0]["tp4_local_heads"]
        assert (hq, hk) == (2, 1) and wk[-1] == 16
