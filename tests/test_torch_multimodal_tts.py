"""The port's TTS model and service against `llmlb_tpu/models/tts.py` and
`llmlb_tpu/engine/tts.py`.

The reference's small test config (`TtsEngine.from_random`), its
init_params(PRNGKey(3)) carried across with params_from_numpy, fp32 on the
CPU. Tolerances: the mel within 1e-5 (fp32 sums in another order);
Griffin-Lim's audio (peak 0.95) within 1e-5, its starting phase being
JAX's uniforms bit for bit and its 24 rounds of FFTs in complex64; a
synthesized WAV's PCM16 samples within 1 step of the reference engine's.
WAV bytes of the same array are the reference's byte for byte. Checkpoints
cross between the packages both ways. Also the reference's own contracts
of tests/engine/test_multimodal.py for speech.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmlb_tpu.engine import tts as jtts_engine
from llmlb_tpu.models import tts as jtts
from llmlb_tpu_torch.engine.asr import decode_wav
from llmlb_tpu_torch.engine.tts import TtsEngine, encode_wav
from llmlb_tpu_torch.models import tts

MEL_ATOL, AUDIO_ATOL = 1e-5, 1e-5
FIELDS = ("vocab_size", "d_model", "encoder_layers", "decoder_layers",
          "num_heads", "n_mels", "upsample", "max_text_len", "num_voices")


@pytest.fixture(scope="module")
def models():
    jeng = jtts_engine.TtsEngine.from_random(seed=3)
    np_params = jax.tree.map(np.asarray, jeng.params)
    cfg = tts.TtsConfig(**{f: getattr(jeng.cfg, f) for f in FIELDS})
    return jeng, np_params, cfg, tts.params_from_numpy(np_params, cfg, "cpu")


def test_synthesize_mel_matches_reference(models):
    jeng, _, cfg, params = models
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (2, 32)).astype(np.int32)
    lens, voices = np.array([32, 11], np.int32), np.array([1, 4], np.int32)
    want = np.asarray(jtts.synthesize_mel(jeng.params, jeng.cfg,
                                          jnp.asarray(ids), jnp.asarray(lens),
                                          jnp.asarray(voices)))
    got = tts.synthesize_mel(params, cfg, torch.from_numpy(ids),
                             torch.from_numpy(lens), torch.from_numpy(voices))
    assert got.shape == (2, 32 * cfg.upsample, cfg.n_mels)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MEL_ATOL)


@pytest.mark.parametrize("frames", [16, 200])
def test_griffin_lim_matches_reference(frames):
    mel = (np.random.default_rng(frames).standard_normal((frames, 80))
           * 0.5).astype(np.float32)
    want = np.asarray(jtts.griffin_lim(jnp.asarray(mel)))
    got = tts.griffin_lim(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == ((frames - 1) * 160 + 400,)
    np.testing.assert_allclose(got, want, rtol=0, atol=AUDIO_ATOL)


def test_overlap_add_matches_the_reference_istft():
    rng = np.random.default_rng(5)
    spec = (rng.standard_normal((40, 201))
            + 1j * rng.standard_normal((40, 201))).astype(np.complex64)
    n = 39 * 160 + 400
    want = np.asarray(jtts._istft(jnp.asarray(spec), n))
    got = tts._istft(torch.from_numpy(spec), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_encode_wav_bytes_are_the_reference_bytes():
    audio = (np.random.default_rng(1).uniform(-1.2, 1.2, 5000)
             .astype(np.float32))
    assert encode_wav(audio) == jtts_engine.encode_wav(audio)
    assert encode_wav(audio, 22050) == jtts_engine.encode_wav(audio, 22050)


def test_engine_wav_matches_reference_engine(models):
    jeng, np_params, cfg, _ = models
    port = TtsEngine(cfg, np_params, device="cpu")
    for text, voice, speed in (("hello world", "nova", 1.0),
                               ("a somewhat longer sentence", "x", 1.5)):
        want, _ = decode_wav(jeng.synthesize(text, voice, speed))
        got, rate = decode_wav(port.synthesize(text, voice, speed))
        assert rate == 16000 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1.5 / 32768)
    assert set(port.last_timings) == {"mel_s", "vocoder_s", "audio_s"}


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoints_cross_between_packages(models, tmp_path):
    """A checkpoint of the reference's save_checkpoint loads in the port,
    and one of the port's loads in the reference, leaf for leaf."""
    jeng, np_params, cfg, params = models
    jtts.save_checkpoint(str(tmp_path / "jax"), jeng.cfg, jeng.params)
    cfg2, params2 = tts.load_checkpoint(str(tmp_path / "jax"), device="cpu")
    assert cfg2 == cfg
    _leaves_equal(jax.tree.map(lambda t: t.numpy(), params2), np_params)
    tts.save_checkpoint(str(tmp_path / "port"), cfg, params)
    jcfg, jparams = jtts.load_checkpoint(str(tmp_path / "port"))
    assert jcfg == jeng.cfg
    _leaves_equal(jparams, np_params)


# ---------------------------------------------- the reference's contracts


def test_tts_produces_audio_and_respects_speed():
    eng = TtsEngine.from_random(seed=3, device="cpu")
    wav = eng.synthesize("hello world", voice="alloy")
    audio, rate = decode_wav(wav)
    assert rate == 16000
    assert len(audio) > 1000
    assert np.isfinite(audio).all()
    fast = eng.synthesize("hello world", voice="alloy", speed=2.0)
    fast_audio, _ = decode_wav(fast)
    assert abs(len(fast_audio) - len(audio) / 2) < 0.1 * len(audio)


def test_tts_voice_changes_output():
    eng = TtsEngine.from_random(seed=3, device="cpu")
    a, _ = decode_wav(eng.synthesize("same text", voice="alloy"))
    b, _ = decode_wav(eng.synthesize("same text", voice="echo"))
    assert not np.allclose(a, b)


def test_tts_validation():
    eng = TtsEngine.from_random(seed=3, device="cpu")
    with pytest.raises(ValueError, match="must not be empty"):
        eng.synthesize("")
    with pytest.raises(ValueError, match="between 0.25 and 4.0"):
        eng.synthesize("x", speed=9.0)
    with pytest.raises(ValueError, match="input too long"):
        eng.synthesize("x" * 4097)


def test_tts_is_deterministic():
    eng = TtsEngine.from_random(seed=3, device="cpu")
    assert eng.synthesize("twice the same") == eng.synthesize("twice the same")


def test_tts_checkpoint_roundtrip(tmp_path):
    eng = TtsEngine.from_random(seed=4, device="cpu")
    tts.save_checkpoint(str(tmp_path / "tts"), eng.cfg, eng.params)
    cfg2, params2 = tts.load_checkpoint(str(tmp_path / "tts"), device="cpu")
    assert cfg2 == eng.cfg
    _leaves_equal(jax.tree.map(lambda t: t.numpy(), eng.params),
                  jax.tree.map(lambda t: t.numpy(), params2))
    again = TtsEngine.from_checkpoint(str(tmp_path / "tts"), device="cpu")
    assert again.model_id == "tts"
    assert again.synthesize("hi") == eng.synthesize("hi")
