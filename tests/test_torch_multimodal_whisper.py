"""The port's whisper model and ASR service against
`llmlb_tpu/models/whisper.py` and `llmlb_tpu/engine/asr.py`.

The reference's tiny test config (`AsrEngine.from_random`), its
init_params(PRNGKey(1)) carried across with params_from_numpy, the same
numpy inputs on both sides, fp32 on the CPU. Tolerances (fp32 sums in
another order): the log-mel within 1e-5 (log10 of the same powers),
encoder states within 1e-5, logits within 1e-4; greedy ids identical (the
smallest top-2 margin met is printed). Also the reference's own contracts
of tests/engine/test_multimodal.py for the audio path.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from llmlb_tpu.engine import asr as jasr
from llmlb_tpu.models import whisper as jw
from llmlb_tpu_torch.engine.asr import AsrEngine, decode_wav, resample_linear
from llmlb_tpu_torch.engine.safetensors_io import save_file
from llmlb_tpu_torch.engine.tts import encode_wav
from llmlb_tpu_torch.models import whisper as tw

MEL_ATOL, ENC_ATOL, LOGIT_ATOL = 1e-5, 1e-5, 1e-4
FIELDS = ("vocab_size", "n_mels", "d_model", "encoder_layers",
          "decoder_layers", "num_heads", "n_audio_ctx", "n_text_ctx",
          "sot_token", "eot_token", "transcribe_token", "no_timestamps_token",
          "english_token")
# openai/whisper-large-v3's config.json (the fields from_hf_config reads)
LARGE_V3 = {"vocab_size": 51866, "num_mel_bins": 128, "d_model": 1280,
            "encoder_layers": 32, "decoder_layers": 32,
            "encoder_attention_heads": 20, "decoder_attention_heads": 20,
            "max_source_positions": 1500, "max_target_positions": 448,
            "decoder_start_token_id": 50258, "eos_token_id": 50257}


@pytest.fixture(scope="module")
def models():
    jeng = jasr.AsrEngine.from_random(seed=1)
    np_params = jax.tree.map(np.asarray, jeng.params)
    cfg = tw.WhisperConfig(**{f: getattr(jeng.cfg, f) for f in FIELDS})
    return jeng, np_params, cfg, tw.params_from_numpy(np_params, cfg, "cpu")


def _tone(freq=440.0, seconds=0.3, rate=16000):
    t = np.arange(int(seconds * rate)) / rate
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


@pytest.mark.parametrize("samples", [400, 4001, 16000])
def test_log_mel_matches_reference(samples):
    audio = (np.random.default_rng(samples).standard_normal(samples)
             * 0.3).astype(np.float32)
    want = np.asarray(jw.log_mel_spectrogram(jnp.asarray(audio), 80))
    got = tw.log_mel_spectrogram(torch.from_numpy(audio), 80).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL)


@pytest.mark.parametrize("length", [8, 9, 32])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_same_padding_matches_lax(length, stride):
    """"SAME" at stride 2 pads (0, 1) on an even length, (1, 1) on an odd
    one; a symmetric padding=1 conv would differ."""
    rng = np.random.default_rng(length * stride)
    x = rng.standard_normal((2, length, 5)).astype(np.float32)
    w = rng.standard_normal((3, 5, 4)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride,), "SAME",
        dimension_numbers=("NWC", "WIO", "NWC"))) + b
    got = tw.conv1d_same(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), stride).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_encoder_and_decoder_match_reference(models):
    jeng, _, cfg, params = models
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 64, cfg.n_mels)).astype(np.float32)
    want_enc = np.asarray(jw.encode_audio(jeng.params, jeng.cfg,
                                          jnp.asarray(mel)))
    enc = tw.encode_audio(params, cfg, torch.from_numpy(mel))
    assert isinstance(tw.AudioEncoder(params, cfg), torch.nn.Module)
    np.testing.assert_allclose(enc.numpy(), want_enc, rtol=0, atol=ENC_ATOL)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want = np.asarray(jw.decoder_logits(jeng.params, jeng.cfg,
                                        jnp.asarray(toks),
                                        jnp.asarray(want_enc)))
    got = tw.decoder_logits(params, cfg, torch.from_numpy(toks), enc)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("seconds", [0.2, 1.0])
def test_greedy_ids_identical(models, seconds):
    """Both services transcribe the same WAV to the same ids; the margins
    of the teacher-forced decode over those ids say how near a tie ran."""
    jeng, _, cfg, params = models
    port = AsrEngine(cfg, params, device="cpu")
    rng = np.random.default_rng(int(seconds * 10))
    wav = encode_wav((rng.standard_normal(int(seconds * 16000))
                      * 0.2).astype(np.float32))
    want = jeng.transcribe_wav_bytes(wav, max_tokens=24)
    assert port.transcribe_wav_bytes(wav, max_tokens=24) == want
    ids = port.last_tokens
    assert " ".join(map(str, ids)) == want
    audio, rate = decode_wav(wav)
    mel = port._mel_for(resample_linear(audio, rate, 16000))
    enc = tw.encode_audio(params, cfg, mel[None])
    prompt = tw.prompt_tokens(cfg)
    seq = torch.tensor([prompt + ids])
    logits = tw.decoder_logits(params, cfg, seq, enc)[0, len(prompt) - 1:]
    top2 = logits.topk(2, dim=-1).values
    print(f"whisper greedy ({seconds} s): {len(ids)} ids, smallest top-2 "
          f"margin {float((top2[:, 0] - top2[:, 1]).min()):.6f}")


def test_from_hf_config_matches_reference():
    en = {**LARGE_V3, "vocab_size": 51864, "eos_token_id": 50256,
          "decoder_start_token_id": 50257}
    forced = {**LARGE_V3, "forced_decoder_ids": [[1, 50262], [2, 50360]]}
    for hf in (LARGE_V3, en, forced):
        want, got = jw.WhisperConfig.from_hf_config(hf), \
            tw.WhisperConfig.from_hf_config(hf)
        assert {f: getattr(got, f) for f in FIELDS} == \
            {f: getattr(want, f) for f in FIELDS}
    v3 = tw.WhisperConfig.from_hf_config(LARGE_V3)
    assert (v3.transcribe_token, v3.no_timestamps_token) == (50360, 50364)
    assert 1.5e9 < tw.num_params(v3) < 1.6e9


def _hf_names(tree) -> dict:
    """The HF tensor names of a reference params tree (numpy)."""
    out = {}
    for i in range(2):
        for side, blocks in (("encoder", {"self_attn": "enc_attn"}),
                             ("decoder", {"self_attn": "dec_attn",
                                          "encoder_attn": "dec_cross"})):
            pre = f"model.{side}.layers.{i}."
            for hf, leaf in blocks.items():
                for proj, w, b in (("q_proj", "wq", "bq"), ("k_proj", "wk",
                                                             None),
                                   ("v_proj", "wv", "bv"),
                                   ("out_proj", "wo", "bo")):
                    out[pre + f"{hf}.{proj}.weight"] = tree[leaf][w][i].T
                    if b:
                        out[pre + f"{hf}.{proj}.bias"] = tree[leaf][b][i]
            mlp = tree["enc_mlp" if side == "encoder" else "dec_mlp"]
            out[pre + "fc1.weight"] = mlp["w1"][i].T
            out[pre + "fc1.bias"] = mlp["b1"][i]
            out[pre + "fc2.weight"] = mlp["w2"][i].T
            out[pre + "fc2.bias"] = mlp["b2"][i]
            lns = ({"self_attn_layer_norm": "enc_ln1",
                    "final_layer_norm": "enc_ln2"} if side == "encoder" else
                   {"self_attn_layer_norm": "dec_ln1",
                    "encoder_attn_layer_norm": "dec_lnx",
                    "final_layer_norm": "dec_ln2"})
            for hf, leaf in lns.items():
                out[pre + hf + ".weight"] = tree[leaf][0][i]
                out[pre + hf + ".bias"] = tree[leaf][1][i]
    for n in (1, 2):
        out[f"model.encoder.conv{n}.weight"] = np.transpose(
            tree[f"conv{n}_w"], (2, 1, 0))
        out[f"model.encoder.conv{n}.bias"] = tree[f"conv{n}_b"]
    out["model.encoder.embed_positions.weight"] = tree["enc_pos"]
    out["model.decoder.embed_tokens.weight"] = tree["tok_embed"]
    out["model.decoder.embed_positions.weight"] = tree["dec_pos"]
    for side, leaf in (("encoder", "enc_lnf"), ("decoder", "dec_lnf")):
        out[f"model.{side}.layer_norm.weight"] = tree[leaf][0]
        out[f"model.{side}.layer_norm.bias"] = tree[leaf][1]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


def test_from_checkpoint_reads_an_hf_directory(models, tmp_path,
                                               monkeypatch):
    """An HF-named checkpoint written with the port's writer loads through
    the port's reader into the reference's tree, leaf for leaf (the
    directory has no tokenizer files: ids come back digit-joined)."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    jeng, np_params, cfg, _ = models
    save_file(_hf_names(np_params), str(tmp_path / "model.safetensors"))
    hf = {"vocab_size": cfg.vocab_size, "num_mel_bins": cfg.n_mels,
          "d_model": cfg.d_model, "encoder_layers": 2, "decoder_layers": 2,
          "encoder_attention_heads": cfg.num_heads,
          "max_source_positions": cfg.n_audio_ctx,
          "max_target_positions": cfg.n_text_ctx,
          "decoder_start_token_id": cfg.sot_token,
          "eos_token_id": cfg.eot_token}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    eng = AsrEngine.from_checkpoint(str(tmp_path), device="cpu")
    assert eng.model_id == tmp_path.name
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), eng.params))
    for a, b in zip(got, jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    assert len(got) == len(jax.tree.leaves(np_params))


# ------------------------------------------ the reference's audio contracts


def test_wav_roundtrip():
    audio = _tone()
    data = encode_wav(audio)
    decoded, rate = decode_wav(data)
    assert rate == 16000
    np.testing.assert_allclose(decoded, audio, atol=1e-3)


def test_decode_wav_rejects_garbage_as_client_error():
    with pytest.raises(ValueError, match="WAV"):
        decode_wav(b"ID3\x04not audio at all" * 10)


def test_resample_halves_length():
    audio = _tone(rate=32000)
    out = resample_linear(audio, 32000, 16000)
    assert abs(len(out) - len(audio) // 2) <= 1


def test_mel_spectrogram_shape_and_finiteness():
    audio = _tone(seconds=0.5)
    mel = tw.log_mel_spectrogram(torch.from_numpy(audio)).numpy()
    assert mel.shape[1] == 80
    assert abs(mel.shape[0] - len(audio) // tw.HOP_LENGTH) <= 2
    assert np.isfinite(mel).all()


def test_whisper_decoder_causality():
    """Changing a future token must not affect earlier positions' logits."""
    eng = AsrEngine.from_random(seed=1, device="cpu")
    cfg, params = eng.cfg, eng.params
    enc = tw.encode_audio(params, cfg, torch.zeros((1, 32, cfg.n_mels)))
    toks = torch.tensor([[cfg.sot_token, 5, 7, 9]])
    toks2 = toks.clone()
    toks2[0, 3] = 11
    la = tw.decoder_logits(params, cfg, toks, enc).numpy()
    lb = tw.decoder_logits(params, cfg, toks2, enc).numpy()
    np.testing.assert_allclose(la[0, :3], lb[0, :3], rtol=1e-5, atol=1e-5)
    assert not np.allclose(la[0, 3], lb[0, 3])


def test_asr_transcribe_deterministic():
    eng = AsrEngine.from_random(seed=2, device="cpu")
    wav = encode_wav(_tone(seconds=0.2))
    a = eng.transcribe_wav_bytes(wav, max_tokens=6)
    b = eng.transcribe_wav_bytes(wav, max_tokens=6)
    assert a == b  # greedy decode is deterministic
    assert eng.total_requests == 2
