"""Multi-LoRA serving on a one-host mesh of ranks (tp=2), against the JAX
engine serving the same adapters on its CPU mesh.

One spawned world of two gloo CPU ranks (tests/torch_mesh_workers.py
`lora_mesh`) serves the JAX package's debug-tiny weights with adapters the
JAX store wrote: acme (rank 4, the attention projections), beta (rank 8,
all seven, alpha 16) and gamma (rank 4, all seven), in a pool of two rows
at rank cap 8. Each rank holds its shard of every pool leaf (A keeps its
weight's input axis, B its output axis); a row-parallel target's partial
delta joins the partial product before the tp sum. The JAX engine (dp=4 x
tp=2 on the 8-device CPU mesh, the XLA delta) serves the same mixed batch.

- Greedy ids of a batch mixing acme, beta and adapter-free rows equal the
  JAX engine's, on every rank.
- The paged entry points on each rank's shards, with the engine's pool
  rows, against the reference's on the full pools: logits within 1e-4
  (fp32; the row-parallel sums run in another order: the reference sums
  the rank-R middle over tp, here each rank's partial delta joins its
  partial product).
- A cold load mid-run (gamma, while another request decodes) evicts the
  idle adapter acquired least recently and lands in the same pool row on
  both ranks: the pool's state follows the tick plans.
- The adapter-free rows of the mixed batch equal a tp=2 engine without
  --lora-dir (row 0 of the pool is zero: its delta is +0.0).
- On an sp=2 mesh a long prompt with an adapter takes chunks, not the
  ring pass, as the reference: the JAX engine's ids, one fallback counted.
"""

import jax
import numpy as np
import pytest

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.lora import store as jstore
from llmlb_tpu.models import llama as jllama
from llmlb_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from tests.torch_mesh_workers import start_world

ALL = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
PROMPT_LENS = (5, 12, 20, 45)  # 45 > the largest bucket: two chunks
ADAPTERS = (None, "acme", "beta", "beta")
MAX_TOKENS = 8
CORE_KW = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
               kv_page_size=16, eos_id=-1, seed=0, prefix_cache=False)


def _drain(req, timeout=120):
    toks = []
    while True:
        kind, val = req.events.get(timeout=timeout)
        if kind == "token":
            toks.append(int(val))
        elif kind == "done":
            return toks
        else:
            raise AssertionError(f"engine error: {val}")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("adapters"))
    jcfg = jax_preset("debug-tiny")
    jstore.save_adapter(d, "acme", jcfg, rank=4)
    jstore.save_adapter(d, "beta", jcfg, rank=8, alpha=16.0, targets=ALL)
    jstore.save_adapter(d, "gamma", jcfg, rank=4, targets=ALL)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    weights = {k: np.asarray(v) for k, v in jparams.items()}
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, 512, size=(n,)).tolist() for n in PROMPT_LENS]
    entry = (rng.integers(0, 512, size=(3, 16)).astype(np.int64),
             np.array([5, 13, 16], np.int32),
             np.array([[3, 7, 1], [5, 2, 9], [4, 6, 8]], np.int32))
    world = start_world("lora_mesh", 2, {
        "weights": weights, "prompts": prompts, "adapters": list(ADAPTERS),
        "max_tokens": MAX_TOKENS, "lora_dir": d, "entry": entry})
    jcore = JaxEngineCore(jcfg, jparams, mesh_config=JaxMeshConfig(dp=4, tp=2),
                          kv_pages=33, lora_dir=d, lora_rank_cap=8,
                          lora_max_adapters=2, **CORE_KW)
    reqs = [jcore.submit(JaxRequest(prompt_ids=p, sampling=JaxSampling(
        temperature=0.0, max_tokens=MAX_TOKENS, lora=a)))
        for p, a in zip(prompts, ADAPTERS)]
    jcore.start()  # queued before the loop starts: the port's plan groups
    try:
        jax_ids = [_drain(r) for r in reqs]
    finally:
        jcore.stop()
    return d, weights, entry, jax_ids, world.result()


def _same_on_every_rank(ranks, case):
    leader = ranks[0][case]
    for r in ranks[1:]:
        assert r[case] == leader, (case, r[case], leader)
    return leader


def test_mixed_adapter_batch_matches_jax_engine_on_tp2(setup):
    _, _, _, jax_ids, ranks = setup
    got = [ids for ids, _ in _same_on_every_rank(ranks, "mixed")]
    assert got == jax_ids
    assert all(len(ids) == MAX_TOKENS for ids in got)


def test_pool_leaves_are_sharded_like_their_weights(setup):
    _, _, _, _, ranks = setup
    shapes = ranks[0]["leaf_shapes"]
    # [L, adapters + 1, in, R] / [L, adapters + 1, R, out]: A keeps the
    # weight's input axis, B its output axis (debug-tiny: E 128, 8 q and 4
    # KV heads of 16, ffn 256; tp=2 halves the sharded ones)
    assert shapes["wq_lora_a"] == (2, 3, 128, 8)
    assert shapes["wq_lora_b"] == (2, 3, 8, 64)
    assert shapes["wk_lora_b"] == (2, 3, 8, 32)
    assert shapes["wo_lora_a"] == (2, 3, 64, 8)
    assert shapes["wo_lora_b"] == (2, 3, 8, 128)
    assert shapes["wd_lora_a"] == (2, 3, 128, 8)
    assert shapes["wu_lora_b"] == (2, 3, 8, 128)
    assert ranks[1]["leaf_shapes"] == shapes


def test_entry_points_on_rank_shards_match_jax(setup):
    d, weights, entry, _, ranks = setup
    rows = _same_on_every_rank(ranks, "entry_rows")
    jcfg = jax_preset("debug-tiny")
    dims = {"wq": (128, 128), "wk": (128, 64), "wv": (128, 64),
            "wo": (128, 128), "wg": (128, 256), "wu": (128, 256),
            "wd": (256, 128)}
    leaves = {}
    for tgt, (i, o) in dims.items():
        leaves[tgt + "_lora_a"] = np.zeros((2, 3, i, 8), np.float32)
        leaves[tgt + "_lora_b"] = np.zeros((2, 3, 8, o), np.float32)
    infos = jstore.discover_adapters(d, rank_cap=8, allowed_targets=ALL)
    for name, row in rows.items():
        if name is None:
            continue
        host = jstore.load_adapter_tensors(infos[name], jcfg, pool_rank=8,
                                           dtype=np.float32)
        for tgt, (a, b) in host.items():
            leaves[tgt + "_lora_a"][:, row] = a
            leaves[tgt + "_lora_b"][:, row] = b
    ids, lens, tables = entry
    lidx = np.array(list(rows.values()), np.int32)
    jck, jcv = jllama.init_kv_pages(jcfg, 12, 8)
    want, _, _ = jllama.prefill_into_pages(
        {**weights, **leaves}, jcfg, ids.astype(np.int32), lens, tables, jck,
        jcv, lora_idx=lidx)
    for r in ranks:
        np.testing.assert_allclose(r["entry_logits"], np.asarray(want),
                                   atol=1e-4, rtol=0)
    assert np.array_equal(ranks[0]["entry_logits"], ranks[1]["entry_logits"])


def test_cold_load_lands_in_the_same_row_on_every_rank(setup):
    _, _, _, _, ranks = setup
    after = _same_on_every_rank(ranks, "rows_after")
    # beta was acquired last: acme, the least recently acquired, made room
    assert sorted(after) == ["beta", "gamma"]
    info = _same_on_every_rank(ranks, "lora_info")
    assert info == {"loads_total": 3, "evictions_total": 1, "active": {}}
    busy, cold = _same_on_every_rank(ranks, "cold")
    assert len(busy) == 30 and len(cold) == MAX_TOKENS


def test_adapter_free_rows_equal_the_lora_free_tp2_engine(setup):
    _, _, _, _, ranks = setup
    mixed = [ids for ids, _ in ranks[0]["mixed"]]
    plain = [ids for ids, _ in _same_on_every_rank(ranks, "plain")]
    for i, name in enumerate(ADAPTERS):
        if name is None:
            assert mixed[i] == plain[i]
    # the adapters matter: acme's row differs from the base model's
    assert mixed[1] != plain[1]


def test_adapter_rows_take_chunks_on_an_sp_mesh(setup):
    """As the reference: a long prompt with an adapter falls back from the
    ring pass (no adapter rows) to chunks, counted in cp_fallback_total,
    and gives the JAX engine's ids."""
    _, _, _, jax_ids, ranks = setup
    got = _same_on_every_rank(ranks, "sp_long")
    assert [ids for ids, _ in got] == [jax_ids[3]]
    assert ADAPTERS[3] is not None and PROMPT_LENS[3] > 32
    assert [r["sp_fallbacks"] for r in ranks] == [1, 1]
