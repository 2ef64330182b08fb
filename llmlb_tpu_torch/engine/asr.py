"""ASR service: WAV bytes -> text through the port's whisper model
(`models/whisper.py`).

The port's counterpart of `llmlb_tpu/engine/asr.py`, behind POST
/v1/audio/transcriptions. Audio handling is the reference's: stdlib `wave`
for RIFF/PCM parsing, numpy linear resampling to 16 kHz; the mel, the
encoder and the greedy decode run on the engine's device.
"""

from __future__ import annotations

import io
import json
import os
import time
import wave

import numpy as np
import torch

from llmlb_tpu_torch.device import resolve_device
from llmlb_tpu_torch.models import whisper


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """RIFF/WAV bytes -> (mono float32 in [-1, 1], sample_rate).
    Accepts PCM16/PCM8/PCM32 via stdlib wave. Raises ValueError (a client
    error) for anything that is not a decodable WAV."""
    try:
        with wave.open(io.BytesIO(data), "rb") as wf:
            rate = wf.getframerate()
            n = wf.getnframes()
            width = wf.getsampwidth()
            channels = wf.getnchannels()
            raw = wf.readframes(n)
    except (wave.Error, EOFError) as e:
        raise ValueError(f"not a decodable WAV file: {e}") from None
    if rate <= 0:
        raise ValueError("WAV reports a non-positive sample rate")
    if width == 2:
        audio = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        audio = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif width == 1:  # unsigned 8-bit
        audio = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if channels > 1:
        audio = audio.reshape(-1, channels).mean(axis=1)
    return audio, rate


def resample_linear(audio: np.ndarray, src_rate: int,
                    dst_rate: int) -> np.ndarray:
    if src_rate == dst_rate:
        return audio
    n_out = int(round(len(audio) * dst_rate / src_rate))
    x_out = np.linspace(0.0, len(audio) - 1.0, n_out)
    return np.interp(x_out, np.arange(len(audio)), audio).astype(np.float32)


class AsrEngine:
    """One loaded whisper model and its transcription entry points, on the
    card unless `device="cpu"`."""

    def __init__(self, cfg: whisper.WhisperConfig, params, tokenizer=None,
                 model_id: str = "whisper", device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = whisper.params_from_numpy(params, cfg, self.device)
        self.tokenizer = tokenizer  # None => digit-joined token ids
        self.model_id = model_id
        self.total_requests = 0
        # the last request's greedy ids and phases (seconds): mel, encoder,
        # each decoder step
        self.last_tokens: list[int] = []
        self.last_timings: dict = {}

    # ------------------------------------------------------------ construction

    @classmethod
    def from_random(cls, cfg: whisper.WhisperConfig | None = None,
                    model_id: str = "whisper-random", seed: int = 0,
                    device=None):
        """Random weights from `seed` (the reference's tiny test config by
        default), drawn on the engine's device."""
        cfg = cfg or whisper.WhisperConfig(
            vocab_size=1024, n_mels=80, d_model=64, encoder_layers=2,
            decoder_layers=2, num_heads=4, n_audio_ctx=200, n_text_ctx=64,
            sot_token=1000, eot_token=1001, transcribe_token=1002,
            no_timestamps_token=1003, english_token=1004,
        )
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, whisper.init_params(cfg, gen, dev),
                   model_id=model_id, device=dev)

    @classmethod
    def from_checkpoint(cls, model_dir: str, model_id: str | None = None,
                        device=None):
        """An HF whisper checkpoint directory (config.json, safetensors,
        tokenizer files), read through the port's safetensors reader. The
        tokenizer needs `transformers`; without it the ids are returned
        digit-joined, as in the reference."""
        from llmlb_tpu_torch.engine.weights import _safetensors_getter

        with open(os.path.join(model_dir, "config.json")) as f:
            cfg = whisper.WhisperConfig.from_hf_config(json.load(f))
        params = whisper.convert_hf_tensors(cfg, _safetensors_getter(model_dir))
        tokenizer = None
        try:
            from transformers import WhisperTokenizer

            tokenizer = WhisperTokenizer.from_pretrained(model_dir)
        except Exception:  # allow-silent: optional dependency; the
            pass           # digit-joined fallback serves without it
        return cls(cfg, params, tokenizer,
                   model_id or os.path.basename(model_dir.rstrip("/")),
                   device=device)

    # --------------------------------------------------------------- serving

    def _mel_for(self, audio: np.ndarray) -> torch.Tensor:
        """Audio to mel frames, zero-padded to a power-of-two frame count
        (from 16) capped at the model's audio context."""
        mel = whisper.log_mel_spectrogram(
            torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(
                self.device), self.cfg.n_mels)
        max_frames = self.cfg.n_audio_ctx * 2
        frames = mel.shape[0]
        bucket = 16
        while bucket < frames:
            bucket *= 2
        bucket = min(bucket, max_frames)
        out = torch.zeros((bucket, self.cfg.n_mels), dtype=torch.float32,
                          device=self.device)
        out[: min(frames, bucket)] = mel[:bucket]
        return out

    def transcribe_audio(self, audio: np.ndarray, sample_rate: int,
                         max_tokens: int = 128) -> str:
        """Mono float32 audio at any rate -> transcript text."""
        self.total_requests += 1
        audio = resample_linear(audio, sample_rate, whisper.SAMPLE_RATE)
        max_samples = self.cfg.n_audio_ctx * 2 * whisper.HOP_LENGTH
        audio = audio[:max_samples]
        if len(audio) < whisper.N_FFT:
            audio = np.pad(audio, (0, whisper.N_FFT - len(audio)))
        t0 = time.perf_counter()
        mel = self._mel_for(audio)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timings = {"mel_s": time.perf_counter() - t0}
        tokens = whisper.greedy_transcribe_tokens(
            self.params, self.cfg, mel, max_tokens, timings=timings)
        self.last_tokens, self.last_timings = tokens, timings
        if self.tokenizer is not None:
            return self.tokenizer.decode(tokens, skip_special_tokens=True)
        return " ".join(str(t) for t in tokens)

    def transcribe_wav_bytes(self, data: bytes, max_tokens: int = 128) -> str:
        audio, rate = decode_wav(data)
        return self.transcribe_audio(audio, rate, max_tokens)
