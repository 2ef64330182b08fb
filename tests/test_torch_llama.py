"""The port's paged Llama entry points against the JAX reference.

Same weights (the reference's init_params carried across with
params_from_numpy), same inputs made from a seed with numpy, both sides in
fp32 on the CPU. Tolerances: logits within 1e-4 absolute (fp32 through two
layers and a 512-way vocab projection, summed in a different order); pool
cells at valid positions within 1e-5 (one projection plus rope).

The prefill, extend and decode checks run on debug-tiny and on two variants
of it that carry the presets' other model options: qwen2.5-0.5b's qkv bias
with tied embeddings (the biases drawn at random: the reference's
init_params makes them zero), and llama-3.1-8b's rope scaling and theta,
with original_max_position 16 so that the scaling acts at these lengths.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.models import llama as jllama
from llmlb_tpu.ops.rope import RopeScaling as JaxRopeScaling
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.models import llama
from llmlb_tpu_torch.ops.rope import RopeScaling

PS, PPN, NUM_PAGES = 8, 4, 12
# distinct scattered pages per row; page 0 stays the trash page
TABLES = np.array([[3, 7, 1, 10], [5, 2, 9, 0]], np.int32)


# llama-3.1-8b's scaling at an original context debug-tiny's lengths pass
SCALING = dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
               original_max_position=16)
VARIANTS = {
    "base": ({}, {}),
    "bias_tied": ({"attention_bias": True, "tie_word_embeddings": True},) * 2,
    "rope_scaling": ({"rope_theta": 500000.0,
                      "rope_scaling": JaxRopeScaling(**SCALING)},
                     {"rope_theta": 500000.0,
                      "rope_scaling": RopeScaling(**SCALING)}),
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    jax_opts, opts = VARIANTS[request.param]
    jcfg = dataclasses.replace(jax_preset("debug-tiny"), **jax_opts)
    np_params = {k: np.asarray(v)
                 for k, v in jllama.init_params(jcfg, jax.random.PRNGKey(0)).items()}
    rng = np.random.default_rng(4)
    for name in ("bq", "bk", "bv"):
        if name in np_params:
            np_params[name] = rng.standard_normal(
                np_params[name].shape).astype(np.float32)
    cfg = dataclasses.replace(get_preset("debug-tiny"), **opts)
    return jcfg, np_params, cfg, params_from_numpy(np_params, cfg, "cpu")


def _pools(cfg):
    return llama.init_kv_pages(cfg, NUM_PAGES, PS, "cpu")


def _jpools(jcfg):
    return jllama.init_kv_pages(jcfg, NUM_PAGES, PS)


def _assert_cells(ck, cv, jck, jcv, lens):
    """Pool cells at every valid position of every row are equal."""
    for b, n in enumerate(lens):
        for p in range(n):
            page, off = TABLES[b, p // PS], p % PS
            np.testing.assert_allclose(ck[:, page, off].numpy(),
                                       np.asarray(jck)[:, page, off], atol=1e-5)
            np.testing.assert_allclose(cv[:, page, off].numpy(),
                                       np.asarray(jcv)[:, page, off], atol=1e-5)


def _prefill_both(models, ids, lens):
    jcfg, np_params, cfg, params = models
    ck, cv = _pools(cfg)
    jck, jcv = _jpools(jcfg)
    logits, ck, cv = llama.prefill_into_pages(
        params, cfg, torch.from_numpy(ids), torch.from_numpy(lens),
        torch.from_numpy(TABLES), ck, cv)
    jlogits, jck, jcv = jllama.prefill_into_pages(
        np_params, jcfg, ids, lens, TABLES, jck, jcv)
    return (logits, ck, cv), (jlogits, jck, jcv)


def test_prefill_into_pages_matches_jax(models):
    rng = np.random.default_rng(0)
    lens = np.array([5, 13], np.int32)  # ragged, row 1 crosses a page
    ids = rng.integers(0, 512, size=(2, 16)).astype(np.int32)
    (logits, ck, cv), (jlogits, jck, jcv) = _prefill_both(models, ids, lens)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4)
    _assert_cells(ck, cv, jck, jcv, lens)


def test_extend_and_decode_match_jax(models):
    """A chunk that crosses a page boundary on top of a ragged prefill, then
    several decode steps, with a window bound on the decode sweep."""
    jcfg, np_params, cfg, params = models
    rng = np.random.default_rng(1)
    lens = np.array([5, 13], np.int32)
    ids = rng.integers(0, 512, size=(2, 16)).astype(np.int32)
    (_, ck, cv), (_, jck, jcv) = _prefill_both(models, ids, lens)

    chunk = rng.integers(0, 512, size=(2, 16)).astype(np.int32)
    chunk_lens = np.array([10, 3], np.int32)  # row 0: positions 5..14
    logits, ck, cv = llama.prefill_extend_pages(
        params, cfg, torch.from_numpy(chunk), torch.from_numpy(chunk_lens),
        torch.from_numpy(lens), torch.from_numpy(TABLES), ck, cv)
    jlogits, jck, jcv = jllama.prefill_extend_pages(
        np_params, jcfg, chunk, chunk_lens, lens, TABLES, jck, jcv)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4)
    seq = lens + chunk_lens  # [15, 16]
    _assert_cells(ck, cv, jck, jcv, seq)

    for step in range(4):
        toks = rng.integers(0, 512, size=(2,)).astype(np.int32)
        window = 24 if step < 2 else None
        logits, ck, cv = llama.decode_step_paged(
            params, cfg, torch.from_numpy(toks), torch.from_numpy(seq),
            ck, cv, torch.from_numpy(TABLES), window=window)
        jlogits, jck, jcv = jllama.decode_step_paged(
            np_params, jcfg, toks, seq, jck, jcv, TABLES, window=window)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4)
        seq = seq + 1
        _assert_cells(ck, cv, jck, jcv, seq)


def test_init_params_layout_and_scheme():
    """The port's own random init has the reference's leaves, shapes and
    scheme (normal * fan_in**-0.5, ones for the norms) and is reproducible
    from a seeded generator."""
    cfg = get_preset("debug-tiny")
    p1 = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p2 = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jshapes = {k: v.shape for k, v in jllama.init_params(
        jax_preset("debug-tiny"), jax.random.PRNGKey(0)).items()}
    assert {k: tuple(v.shape) for k, v in p1.items()} == jshapes
    for k in p1:
        assert torch.equal(p1[k], p2[k])
    assert torch.all(p1["ln_attn"] == 1) and torch.all(p1["ln_final"] == 1)
    # std of normal * fan_in**-0.5 with fan_in = hidden 128
    assert abs(p1["wq"].std().item() - 128**-0.5) < 0.1 * 128**-0.5


def test_profile_step_rehearses_on_cpu(capsys):
    """The card profiler's dispatches run end to end on the CPU at
    debug-tiny size and report no timing there (seven, the two decode
    bursts among them, which run eagerly on the CPU)."""
    from llmlb_tpu_torch import profile_step

    assert profile_step.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("rehearsal on cpu:") == 7
    assert "wall_ms" not in out
