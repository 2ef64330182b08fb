"""TTS service: text -> WAV bytes through the port's TTS model
(`models/tts.py`).

The port's counterpart of `llmlb_tpu/engine/tts.py`, behind POST
/v1/audio/speech: the reference's validation, power-of-two text buckets,
the vocoder run at the bucketed length and the audio trimmed after it,
the `speed` resampling and a PCM16 WAV written with stdlib `wave`.
"""

from __future__ import annotations

import io
import os
import time
import wave

import numpy as np
import torch

from llmlb_tpu_torch.device import resolve_device
from llmlb_tpu_torch.models import tts
from llmlb_tpu_torch.models.whisper import HOP_LENGTH, SAMPLE_RATE


def encode_wav(audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> bytes:
    """Mono float32 [-1, 1] -> RIFF/WAV PCM16 bytes."""
    pcm = np.clip(audio, -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm16.tobytes())
    return buf.getvalue()


class TtsEngine:
    """One loaded TTS model and its synthesis entry point, on the card
    unless `device="cpu"`."""

    MAX_INPUT_CHARS = 4096  # OpenAI's /v1/audio/speech input cap

    def __init__(self, cfg: tts.TtsConfig, params, model_id: str = "tts",
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tts.params_from_numpy(params, cfg, self.device)
        self.model_id = model_id
        self.total_requests = 0
        # the last request's phases (seconds) and its audio's length
        self.last_timings: dict = {}

    @classmethod
    def from_random(cls, cfg: tts.TtsConfig | None = None,
                    model_id: str = "tts-random", seed: int = 0, device=None):
        """Random weights from `seed` (the reference's small test config by
        default), drawn on the engine's device."""
        cfg = cfg or tts.TtsConfig(
            d_model=64, encoder_layers=2, decoder_layers=2, num_heads=4,
            upsample=4, max_text_len=128,
        )
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, tts.init_params(cfg, gen, dev), model_id=model_id,
                   device=dev)

    @classmethod
    def from_checkpoint(cls, model_dir: str, model_id: str | None = None,
                        device=None):
        cfg, params = tts.load_checkpoint(model_dir, device=device)
        return cls(cfg, params,
                   model_id or os.path.basename(model_dir.rstrip("/")),
                   device=device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def synthesize(self, text: str, voice: str = "alloy",
                   speed: float = 1.0) -> bytes:
        """Text -> WAV bytes. `speed` resamples the output (0.25-4.0)."""
        if not text:
            raise ValueError("'input' text must not be empty")
        if len(text) > self.MAX_INPUT_CHARS:
            raise ValueError(
                f"input too long ({len(text)} chars; max {self.MAX_INPUT_CHARS})"
            )
        if not 0.25 <= speed <= 4.0:
            raise ValueError("'speed' must be between 0.25 and 4.0")
        self.total_requests += 1

        data = text.encode("utf-8", errors="replace")[: self.cfg.max_text_len]
        n = len(data)
        bucket = 16
        while bucket < n:
            bucket *= 2
        bucket = min(bucket, self.cfg.max_text_len)
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :n] = np.frombuffer(data, np.uint8)
        t0 = time.perf_counter()
        mel = tts.synthesize_mel(
            self.params, self.cfg, torch.from_numpy(ids).to(self.device),
            torch.tensor([n], device=self.device),
            torch.tensor([tts.voice_id(voice)], device=self.device),
        )[0]
        self._sync()
        t1 = time.perf_counter()
        # vocode at the bucketed length, then trim the audio to the text's
        # frames (the reference's order)
        audio = tts.griffin_lim(mel).cpu().numpy()
        t2 = time.perf_counter()
        audio = audio[: n * self.cfg.upsample * HOP_LENGTH]
        if speed != 1.0:
            n_out = max(1, int(round(len(audio) / speed)))
            audio = np.interp(
                np.linspace(0, len(audio) - 1, n_out),
                np.arange(len(audio)), audio,
            ).astype(np.float32)
        self.last_timings = {"mel_s": t1 - t0, "vocoder_s": t2 - t1,
                             "audio_s": len(audio) / SAMPLE_RATE}
        return encode_wav(audio)
