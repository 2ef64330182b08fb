"""The port's diffusion model and image service against
`llmlb_tpu/models/diffusion.py` and `llmlb_tpu/engine/image.py`.

The reference's small test config (`ImageEngine.from_random`), its
init_params(PRNGKey(5)) carried across with params_from_numpy, fp32 on
the CPU. Tolerances: unet_eps within 1e-5 of eps ~ N(0, 1)-sized outputs;
a seeded ddim_sample within 2e-3 (its noise is JAX's within
_threefry's 1e-6, and DDIM's first step divides by sqrt(alpha_bar) ~ 0.0064,
so fp32 differences of the UNet grow ~156x there; 2e-3 is a quarter of one
8-bit pixel step, 2/255); PNG pixels within 1 level of the reference
engine's. PNG bytes of the same array are the reference's byte for byte.
Checkpoints cross between the packages both ways. Also the reference's
own contracts of tests/engine/test_multimodal.py for images.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmlb_tpu.engine import image as jimage
from llmlb_tpu.models import diffusion as jd
from llmlb_tpu_torch.engine.image import ImageEngine, encode_png
from llmlb_tpu_torch.models import diffusion

EPS_ATOL, SAMPLE_ATOL = 1e-5, 2e-3
FIELDS = ("img_size", "channels", "base_ch", "ch_mults", "text_vocab",
          "text_dim", "max_text_len", "train_steps")


@pytest.fixture(scope="module")
def models():
    jeng = jimage.ImageEngine.from_random(seed=5, sample_steps=4)
    np_params = jax.tree.map(np.asarray, jeng.params)
    cfg = diffusion.DiffusionConfig(**{f: getattr(jeng.cfg, f)
                                       for f in FIELDS})
    return (jeng, np_params, cfg,
            diffusion.params_from_numpy(np_params, cfg, "cpu"))


def test_unet_eps_matches_reference(models):
    jeng, _, cfg, params = models
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    ids = rng.integers(1, 257, (3, cfg.max_text_len)).astype(np.int32)
    lens = np.array([5, 0, 64], np.int32)
    t = np.array([999, 500, 0], np.int32)
    want = np.asarray(jd.unet_eps(jeng.params, jeng.cfg, jnp.asarray(x),
                                  jnp.asarray(t), jnp.asarray(ids),
                                  jnp.asarray(lens)))
    got = diffusion.unet_eps(params, cfg, *map(torch.from_numpy,
                                               (x, t, ids, lens)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EPS_ATOL)


def test_seeded_ddim_sample_matches_reference(models):
    jeng, _, cfg, params = models
    ids = np.zeros((1, cfg.max_text_len), np.int32)
    ids[0, :4] = [98, 99, 100, 101]
    lens = np.array([4], np.int32)
    want = np.asarray(jd.ddim_sample(jeng.params, jeng.cfg,
                                     jax.random.PRNGKey(11), jnp.asarray(ids),
                                     jnp.asarray(lens), 2, n_steps=4))
    got = diffusion.ddim_sample(params, cfg, 11, torch.from_numpy(ids),
                                torch.from_numpy(lens), 2, n_steps=4)
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SAMPLE_ATOL)


def test_generate_matches_reference_engine(models):
    jeng, np_params, cfg, _ = models
    port = ImageEngine(cfg, np_params, sample_steps=4, device="cpu")
    want = jeng.generate("a red square", n=2, seed=7)
    got = port.generate("a red square", n=2, seed=7)
    for a, b in zip(got, want):
        pa, pb = _pixels(a), _pixels(b)
        assert np.abs(pa.astype(int) - pb.astype(int)).max() <= 1


def test_encode_png_bytes_are_the_reference_bytes():
    rgb = np.random.default_rng(2).integers(0, 256, (20, 12, 3), np.uint8)
    assert encode_png(rgb) == jimage.encode_png(rgb)


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoints_cross_between_packages(models, tmp_path):
    """A checkpoint of the reference's save_checkpoint loads in the port,
    and one of the port's loads in the reference (absent skips and all),
    leaf for leaf."""
    jeng, np_params, cfg, params = models
    jd.save_checkpoint(str(tmp_path / "jax"), jeng.cfg, jeng.params)
    cfg2, params2 = diffusion.load_checkpoint(str(tmp_path / "jax"),
                                              device="cpu")
    assert cfg2 == cfg
    assert params2["down"][1]["skip"] is not None
    assert params2["mid1"]["skip"] is None
    _leaves_equal(jax.tree.map(lambda t: t.numpy(), params2), np_params)
    diffusion.save_checkpoint(str(tmp_path / "port"), cfg, params)
    jcfg, jparams = jd.load_checkpoint(str(tmp_path / "port"))
    assert jcfg == jeng.cfg
    _leaves_equal(jparams, np_params)


# ---------------------------------------------- the reference's contracts


def _pixels(png: bytes) -> np.ndarray:
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = int.from_bytes(png[16:20], "big"), int.from_bytes(png[20:24], "big")
    idat_start = png.index(b"IDAT") + 4
    idat_len = int.from_bytes(png[idat_start - 8: idat_start - 4], "big")
    raw = zlib.decompress(png[idat_start: idat_start + idat_len])
    rows = [raw[i * (1 + 3 * w) + 1: (i + 1) * (1 + 3 * w)] for i in range(h)]
    return np.frombuffer(b"".join(rows), np.uint8).reshape(h, w, 3)


def test_png_encoder_valid():
    rgb = np.arange(16 * 16 * 3, dtype=np.uint8).reshape(16, 16, 3)
    np.testing.assert_array_equal(_pixels(encode_png(rgb)), rgb)


def test_image_generate_shapes_and_determinism():
    eng = ImageEngine.from_random(seed=5, sample_steps=4, device="cpu")
    a = eng.generate("a red square", n=2, seed=7)
    b = eng.generate("a red square", n=2, seed=7)
    assert len(a) == 2
    assert a[0] == b[0]  # same seed -> same image
    c = eng.generate("a red square", n=1, seed=8)
    assert c[0] != a[0]  # different seed -> different image
    assert _pixels(a[0]).shape == (16, 16, 3)


def test_image_prompt_conditioning_changes_output():
    eng = ImageEngine.from_random(seed=5, sample_steps=4, device="cpu")
    a = eng.generate("a cat", n=1, seed=3)
    b = eng.generate("a dog", n=1, seed=3)
    assert a[0] != b[0]


def test_image_validation():
    eng = ImageEngine.from_random(seed=5, sample_steps=2, device="cpu")
    with pytest.raises(ValueError, match="'prompt' is required"):
        eng.generate("")
    with pytest.raises(ValueError, match="'n' must be between 1 and 10"):
        eng.generate("x", n=11)
    assert len(eng.generate_b64("x", n=1)) == 1  # the counter's seed


def test_diffusion_checkpoint_roundtrip(tmp_path):
    eng = ImageEngine.from_random(seed=6, sample_steps=2, device="cpu")
    diffusion.save_checkpoint(str(tmp_path / "diff"), eng.cfg, eng.params)
    cfg2, params2 = diffusion.load_checkpoint(str(tmp_path / "diff"),
                                              device="cpu")
    assert cfg2 == eng.cfg
    _leaves_equal(jax.tree.map(lambda t: t.numpy(), eng.params),
                  jax.tree.map(lambda t: t.numpy(), params2))
    again = ImageEngine.from_checkpoint(str(tmp_path / "diff"),
                                        sample_steps=2, device="cpu")
    assert again.generate("x", seed=1) == eng.generate("x", seed=1)


def test_fp32_guard_turns_cudnn_tf32_off_for_card_tensors_only(monkeypatch):
    """PyTorch lets cuDNN run fp32 convolutions in TF32 by default; the
    guard turns that off before a convolution on the card, and leaves the
    switch alone for a CPU tensor."""
    from types import SimpleNamespace

    from llmlb_tpu_torch.models._common import fp32_convolutions

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    fp32_convolutions(torch.zeros(1))
    assert torch.backends.cudnn.allow_tf32
    fp32_convolutions(SimpleNamespace(is_cuda=True))
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("family", ["diffusion", "whisper"])
def test_every_convolution_passes_the_fp32_guard(family, monkeypatch):
    """The UNet's and Whisper's convolutions call the guard on the padded
    input they convolve, so served convolutions stay fp32."""
    from llmlb_tpu_torch.models import whisper

    seen = []
    if family == "diffusion":
        monkeypatch.setattr(diffusion, "fp32_convolutions",
                            lambda x: seen.append(tuple(x.shape)))
        diffusion._conv(torch.zeros(1, 8, 8, 3), torch.zeros(3, 3, 3, 4),
                        torch.zeros(4), stride=2)
        assert seen == [(1, 3, 9, 9)]  # NCHW, "SAME" pads (0, 1) at stride 2
    else:
        monkeypatch.setattr(whisper, "fp32_convolutions",
                            lambda x: seen.append(tuple(x.shape)))
        whisper.conv1d_same(torch.zeros(1, 8, 5), torch.zeros(3, 5, 6),
                            torch.zeros(6), stride=2)
        assert seen == [(1, 5, 9)]
