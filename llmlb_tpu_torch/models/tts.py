"""Text-to-speech: a non-autoregressive byte -> mel transformer and a
Griffin-Lim vocoder, in PyTorch.

The port's counterpart of `llmlb_tpu/models/tts.py`:

- `synthesize_mel`: byte embedding plus a per-voice embedding, a pre-LN
  encoder masked to the text, a fixed-ratio length regulator (each byte's
  state repeated `upsample` times), a decoder stack, a linear mel head;
  one forward per utterance;
- `griffin_lim`: mel -> linear magnitude through the filterbank's
  pseudo-inverse (computed on the host with numpy, as the reference does),
  JAX's seeded uniform starting phase (`ops/_threefry.uniform`, bit for
  bit), then `n_iter` rounds of ISTFT/STFT phase refinement in complex64.

The reference's overlap-add is a scatter-add. Here it is three shifted
adds, one per hop phase of a frame (a frame of N_FFT = 400 samples spans
three hops of 160), in the order the reference's scatter visits a sample's
frames: deterministic on any device, so two runs of the same text give the
same WAV bytes on the card.

Weights are the framework-native flat safetensors of the reference
(`model.safetensors` with `.`-joined names, tuple pairs as `.0` / `.1`,
and `config.json` with `model_type` "llmlb_tpu_tts"), read and written
through `engine/safetensors_io.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from llmlb_tpu_torch.device import resolve_device
from llmlb_tpu_torch.models._common import (
    ONES,
    SINUSOIDS,
    ZEROS,
    init_tree,
    load_flat_checkpoint,
    params_from_numpy,
    save_flat_checkpoint,
    unflatten,
)
from llmlb_tpu_torch.models.whisper import (
    HOP_LENGTH,
    N_FFT,
    frames_of,
    gelu,
    hann_window,
    layer,
    layer_norm,
    mel_filterbank,
    mha,
)
from llmlb_tpu_torch.ops import _threefry

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TtsConfig:
    vocab_size: int = 256  # bytes
    d_model: int = 256
    encoder_layers: int = 4
    decoder_layers: int = 4
    num_heads: int = 4
    n_mels: int = 80
    upsample: int = 8  # mel frames per input byte (fixed-ratio regulator)
    max_text_len: int = 512
    num_voices: int = 8
    dtype: Any = torch.float32


VOICES = ("alloy", "echo", "fable", "onyx", "nova", "shimmer")


def voice_id(name: str) -> int:
    try:
        return 1 + VOICES.index(name.lower())
    except ValueError:
        return 0


def param_shapes(cfg: TtsConfig) -> Params:
    """The params tree as {leaf: (shape, init)} (whisper's spec)."""
    d, el, dl = cfg.d_model, cfg.encoder_layers, cfg.decoder_layers

    def attn(n):
        return {"wq": ((n, d, d), d), "bq": ((n, d), ZEROS),
                "wk": ((n, d, d), d),
                "wv": ((n, d, d), d), "bv": ((n, d), ZEROS),
                "wo": ((n, d, d), d), "bo": ((n, d), ZEROS)}

    def mlp(n):
        return {"w1": ((n, d, 4 * d), d), "b1": ((n, 4 * d), ZEROS),
                "w2": ((n, 4 * d, d), 4 * d), "b2": ((n, d), ZEROS)}

    def ln(n):
        return (((n, d), ONES), ((n, d), ZEROS))

    return {
        "byte_embed": ((cfg.vocab_size, d), d),
        "voice_embed": ((cfg.num_voices, d), d),
        "enc_pos": ((cfg.max_text_len, d), SINUSOIDS),
        "dec_pos": ((cfg.max_text_len * cfg.upsample, d), SINUSOIDS),
        "enc_attn": attn(el), "enc_mlp": mlp(el),
        "enc_ln1": ln(el), "enc_ln2": ln(el),
        "dec_attn": attn(dl), "dec_mlp": mlp(dl),
        "dec_ln1": ln(dl), "dec_ln2": ln(dl),
        "lnf": (((d,), ONES), ((d,), ZEROS)),
        "mel_head_w": ((d, cfg.n_mels), d),
        "mel_head_b": ((cfg.n_mels,), ZEROS),
    }


def init_params(cfg: TtsConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random init with the reference's scheme on `device` (the card
    unless "cpu"); the numbers are the generator's, not JAX's."""
    return init_tree(param_shapes(cfg), generator, resolve_device(device),
                     cfg.dtype)


def _transformer(cfg: TtsConfig, x, attn, mlp, ln1, ln2, n_layers,
                 mask=None):
    for i in range(n_layers):
        h = layer_norm(x, layer(ln1, i))
        x = x + mha(layer(attn, i), h, h, cfg.num_heads, mask=mask)
        h = layer_norm(x, layer(ln2, i))
        ml = layer(mlp, i)
        x = x + (gelu(h @ ml["w1"] + ml["b1"]) @ ml["w2"] + ml["b2"])
    return x


@torch.inference_mode()
def synthesize_mel(params: Params, cfg: TtsConfig,
                   byte_ids: torch.Tensor,  # [B, T] int, right-padded
                   text_lens: torch.Tensor,  # [B] int
                   voice_ids: torch.Tensor,  # [B] int
                   ) -> torch.Tensor:
    """[B, T*upsample, n_mels] mel frames (frames past text_lens*upsample
    come from padding; the caller trims them)."""
    t = byte_ids.shape[1]
    x = params["byte_embed"][byte_ids.long()] + params["enc_pos"][None, :t]
    x = x + params["voice_embed"][voice_ids.long()][:, None, :]
    valid = (torch.arange(t, device=x.device)[None, :]
             < text_lens.to(x.device)[:, None])  # [B, T]
    x = _transformer(cfg, x, params["enc_attn"], params["enc_mlp"],
                     params["enc_ln1"], params["enc_ln2"],
                     cfg.encoder_layers, mask=valid[:, None, None, :])
    frames = torch.repeat_interleave(x, cfg.upsample, dim=1)
    frames = frames + params["dec_pos"][None, : frames.shape[1]]
    fvalid = torch.repeat_interleave(valid, cfg.upsample, dim=1)
    frames = _transformer(cfg, frames, params["dec_attn"], params["dec_mlp"],
                          params["dec_ln1"], params["dec_ln2"],
                          cfg.decoder_layers, mask=fvalid[:, None, None, :])
    frames = layer_norm(frames, params["lnf"])
    return frames @ params["mel_head_w"] + params["mel_head_b"]


# ---------------------------------------------------------------------------
# Griffin-Lim vocoder
# ---------------------------------------------------------------------------

def _stft(audio: torch.Tensor) -> torch.Tensor:
    return torch.fft.rfft(frames_of(audio), dim=-1)


def _overlap_add(frames: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Sum [n_frames, N_FFT] frames placed every HOP_LENGTH samples into
    [n_samples]: one shifted add per hop phase of a frame, the last phase
    first, so a sample sums its frames in frame order (the reference's
    scatter order)."""
    n_frames = frames.shape[0]
    phases = -(-N_FFT // HOP_LENGTH)
    padded = torch.nn.functional.pad(frames, (0, phases * HOP_LENGTH - N_FFT))
    chunks = padded.view(n_frames, phases, HOP_LENGTH)
    out = torch.zeros((n_frames + phases - 1, HOP_LENGTH),
                      dtype=frames.dtype, device=frames.device)
    for j in reversed(range(phases)):
        out[j:j + n_frames] += chunks[:, j]
    return out.reshape(-1)[:n_samples]


def _istft(spec: torch.Tensor, n_samples: int) -> torch.Tensor:
    window = hann_window(spec.device)
    frames = torch.fft.irfft(spec, n=N_FFT, dim=-1) * window[None, :]
    audio = _overlap_add(frames, n_samples)
    norm = _overlap_add((window ** 2)[None, :].expand(spec.shape[0], -1),
                        n_samples)
    return audio / torch.clamp(norm, min=1e-8)


def mel_pinv(n_mels: int) -> np.ndarray:
    """The mel filterbank's pseudo-inverse [bins, n_mels], on the host."""
    return np.linalg.pinv(mel_filterbank(n_mels))


@torch.inference_mode()
def griffin_lim(mel: torch.Tensor, n_iter: int = 24,
                seed: int = 0) -> torch.Tensor:
    """[frames, n_mels] log-mel-ish magnitudes -> [samples] float32 audio,
    peak-normalised to 0.95. The starting phase is
    jax.random.uniform(PRNGKey(seed), [frames, bins], 0, 2 pi)."""
    pinv = torch.from_numpy(mel_pinv(mel.shape[1])).to(mel.device)
    mag = torch.clamp(torch.exp(mel.float()) @ pinv.T, min=0.0)
    n_samples = (mag.shape[0] - 1) * HOP_LENGTH + N_FFT
    phase = _threefry.uniform(seed, tuple(mag.shape), 0.0, 2 * np.pi,
                              device=mel.device)
    spec = torch.polar(mag, phase)
    for _ in range(n_iter):
        audio = _istft(spec, n_samples)
        re = _stft(audio)[: mag.shape[0]]
        spec = torch.polar(mag, torch.angle(re))
    audio = _istft(spec, n_samples)
    peak = audio.abs().max()
    return audio / torch.clamp(peak, min=1e-6) * 0.95


# ---------------------------------------------------------------------------
# Checkpoint round-trip (the reference's flat safetensors of the tree)
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, cfg: TtsConfig, params: Params) -> None:
    meta = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}
    save_flat_checkpoint(path, "llmlb_tpu_tts", meta, params)


def load_checkpoint(path: str, device=None) -> tuple[TtsConfig, Params]:
    """A checkpoint of either package's save_checkpoint, as params on
    `device` (the card unless "cpu")."""
    meta, flat = load_flat_checkpoint(path)
    cfg = TtsConfig(**meta)
    tree = unflatten(flat, param_shapes(cfg))
    return cfg, params_from_numpy(tree, cfg, resolve_device(device))
