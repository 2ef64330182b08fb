"""Whisper-family ASR (encoder-decoder transformer), in PyTorch.

The port's counterpart of `llmlb_tpu/models/whisper.py`, held to it leaf
for leaf and op for op:

- the log-mel frontend: a reflect pad, frames by a gather, `rfft`, the
  last frame dropped, a slaney mel filterbank built in numpy, log10 and the
  max - 8 clamp;
- the encoder (`AudioEncoder`, an nn.Module over a params tree): two exact
  gelu convs of width 3 with the reference's "SAME" padding (stride 1 pads
  (1, 1); stride 2 on an even length pads (0, 1), where HF's Whisper pads
  (1, 1)), fixed sinusoidal positions, pre-LN layers;
- the decoder: learned positions, causal self-attention, cross-attention
  over the encoder states, the vocab product against the token embedding
  in fp32;
- greedy decoding as the reference does it: the whole teacher-forced
  decoder re-run for each token over power-of-two padded lengths (no KV
  cache; the reference has none either).

Attention is two products and a softmax in fp32 as the reference's `_mha`:
q and k each scaled by head_dim^-0.25, k without a bias, masked scores at
-1e30. It is not SDPA. Params are a nested dict of tensors with the
reference's names and layouts (stacked [L, in, out] matrices, (gain, bias)
pairs for the norms, conv weights [width, in, out]); `params_from_numpy`
carries a JAX pytree across, `init_params` draws one from a
torch.Generator, and `convert_hf_tensors` maps an HF checkpoint.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from llmlb_tpu_torch.device import resolve_device
from llmlb_tpu_torch.models._common import (
    ONES,
    SINUSOIDS,
    ZEROS,
    fill_tree,
    fp32_convolutions,
    init_tree,
    params_from_numpy,
    same_pad,
)

Params = dict[str, Any]

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51865
    n_mels: int = 80
    d_model: int = 384  # whisper-tiny
    encoder_layers: int = 4
    decoder_layers: int = 4
    num_heads: int = 6
    n_audio_ctx: int = 1500  # 30 s of audio after conv stride 2
    n_text_ctx: int = 448
    # special tokens (multilingual vocab defaults)
    sot_token: int = 50258
    eot_token: int = 50257
    transcribe_token: int = 50359
    no_timestamps_token: int = 50363
    english_token: int = 50259
    dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @classmethod
    def from_hf_config(cls, hf: dict, dtype=torch.float32) -> "WhisperConfig":
        """The reference's reading of an HF config.json: special tokens from
        the checkpoint (`.en` checkpoints: eot 50256, sot 50257, no
        language or task tokens, marked -1); large-v3's vocab of 51866
        shifts the task block up by one; forced_decoder_ids win."""
        vocab_size = hf["vocab_size"]
        eot = hf.get("eos_token_id", 50257)
        sot = hf.get("decoder_start_token_id", 50258)
        if vocab_size >= 51865:
            shift = vocab_size - 51865
            transcribe = 50359 + shift
            no_timestamps = 50363 + shift
            english = 50259
            for pos, tok in (hf.get("forced_decoder_ids") or []):
                if pos == 1 and tok is not None:
                    english = tok
                elif pos == 2 and tok is not None:
                    transcribe = tok
        else:
            transcribe = -1
            no_timestamps = 50362 if vocab_size > 50362 else -1
            english = -1
        return cls(
            vocab_size=vocab_size,
            n_mels=hf.get("num_mel_bins", 80),
            d_model=hf["d_model"],
            encoder_layers=hf["encoder_layers"],
            decoder_layers=hf["decoder_layers"],
            num_heads=hf["encoder_attention_heads"],
            n_audio_ctx=hf.get("max_source_positions", 1500),
            n_text_ctx=hf.get("max_target_positions", 448),
            sot_token=sot,
            eot_token=eot,
            transcribe_token=transcribe,
            no_timestamps_token=no_timestamps,
            english_token=english,
            dtype=dtype,
        )


# ---------------------------------------------------------------------------
# Log-mel frontend
# ---------------------------------------------------------------------------

def mel_filterbank(n_mels: int = 80, n_fft: int = N_FFT,
                   sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-normalized triangular mel filters [n_mels, n_fft//2 + 1]
    (librosa.filters.mel's defaults, which whisper's frontend uses)."""

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = 3.0 * f / 200.0
        return np.where(
            f >= 1000.0,
            15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / (np.log(6.4) / 27.0),
            mel,
        )

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = 200.0 * m / 3.0
        return np.where(m >= 15.0,
                        1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)

    fft_freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0),
                                    n_mels + 2))
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lower, center, upper = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_freqs - lower) / max(center - lower, 1e-9)
        down = (upper - fft_freqs) / max(upper - center, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        fb[i] *= 2.0 / (upper - lower)  # slaney: unit area per filter
    return fb.astype(np.float32)


def hann_window(device) -> torch.Tensor:
    """The periodic Hann window of N_FFT samples, float32."""
    return torch.from_numpy(np.hanning(N_FFT + 1)[:-1].astype(np.float32)).to(
        device)


def frames_of(audio: torch.Tensor) -> torch.Tensor:
    """[samples] -> [n_frames, N_FFT] windowed frames every HOP_LENGTH."""
    n_frames = 1 + (audio.shape[0] - N_FFT) // HOP_LENGTH
    idx = (torch.arange(n_frames, device=audio.device)[:, None] * HOP_LENGTH
           + torch.arange(N_FFT, device=audio.device)[None, :])
    return audio[idx] * hann_window(audio.device)[None, :]


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """[T_samples] float32 in [-1, 1] -> [n_frames, n_mels] log-mel, with
    whisper's conventions (reflect pad, hann, log10, clamp to max - 8,
    /4 + 1 scaling)."""
    pad = N_FFT // 2
    audio = F.pad(audio.float()[None, None], (pad, pad), mode="reflect")[0, 0]
    spec = torch.fft.rfft(frames_of(audio), dim=-1)
    power = spec.abs() ** 2  # [n_frames, n_fft//2+1]
    power = power[:-1]  # whisper drops the last frame
    fb = torch.from_numpy(mel_filterbank(n_mels)).to(audio.device)
    mel = power @ fb.T
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def param_shapes(cfg: WhisperConfig) -> Params:
    """The params tree as {leaf: (shape, init)}: init is the fan-in of a
    random matrix, or ZEROS (biases), ONES (norm gains), SINUSOIDS."""
    d, el, dl = cfg.d_model, cfg.encoder_layers, cfg.decoder_layers

    def attn(n):
        return {"wq": ((n, d, d), d), "bq": ((n, d), ZEROS),
                "wk": ((n, d, d), d),
                "wv": ((n, d, d), d), "bv": ((n, d), ZEROS),
                "wo": ((n, d, d), d), "bo": ((n, d), ZEROS)}

    def mlp(n):
        return {"w1": ((n, d, 4 * d), d), "b1": ((n, 4 * d), ZEROS),
                "w2": ((n, 4 * d, d), 4 * d), "b2": ((n, d), ZEROS)}

    def ln(n=None):
        shape = (n, d) if n else (d,)
        return ((shape, ONES), (shape, ZEROS))

    return {
        "conv1_w": ((3, cfg.n_mels, d), 3 * cfg.n_mels),
        "conv1_b": ((d,), ZEROS),
        "conv2_w": ((3, d, d), 3 * d),
        "conv2_b": ((d,), ZEROS),
        "enc_pos": ((cfg.n_audio_ctx, d), SINUSOIDS),
        "enc_attn": attn(el), "enc_mlp": mlp(el),
        "enc_ln1": ln(el), "enc_ln2": ln(el), "enc_lnf": ln(),
        "tok_embed": ((cfg.vocab_size, d), d),
        "dec_pos": ((cfg.n_text_ctx, d), d),
        "dec_attn": attn(dl), "dec_cross": attn(dl), "dec_mlp": mlp(dl),
        "dec_ln1": ln(dl), "dec_lnx": ln(dl), "dec_ln2": ln(dl),
        "dec_lnf": ln(),
    }


def init_params(cfg: WhisperConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random init with the reference's scheme on `device` (the card
    unless "cpu"). The numbers are the generator's, not JAX's: tests carry
    the reference's weights across with params_from_numpy."""
    return init_tree(param_shapes(cfg), generator, resolve_device(device),
                     cfg.dtype)


def layer(tree, i: int):
    """Layer i of a stacked subtree (dict of [L, ...] or a (g, b) pair)."""
    if isinstance(tree, dict):
        return {k: v[i] for k, v in tree.items()}
    return tuple(v[i] for v in tree)


# ---------------------------------------------------------------------------
# Transformer pieces
# ---------------------------------------------------------------------------

def layer_norm(x, gb, eps=1e-5):
    g, b = gb
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def gelu(x):
    return F.gelu(x, approximate="none")


def mha(lp, x, kv, n_heads: int, mask=None):
    """Attention with whisper's conventions: k has no bias, q and k are each
    scaled by head_dim^-0.25, scores and softmax in fp32, masked at -1e30.
    x [B, T, D], kv [B, S, D], mask broadcast to [B, H, T, S]."""
    b, t, d = x.shape
    dh = d // n_heads
    q = (x @ lp["wq"] + lp["bq"]).view(b, t, n_heads, dh)
    k = (kv @ lp["wk"]).view(b, kv.shape[1], n_heads, dh)
    v = (kv @ lp["wv"] + lp["bv"]).view(b, kv.shape[1], n_heads, dh)
    scale = dh ** -0.25
    scores = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(),
                          (k * scale).float())
    if mask is not None:
        scores = torch.where(mask, scores, torch.full((), -1e30,
                                                      device=x.device))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(x.dtype)
    return out.reshape(b, t, d) @ lp["wo"] + lp["bo"]


def mlp(lp, x):
    return gelu(x @ lp["w1"] + lp["b1"]) @ lp["w2"] + lp["b2"]


def conv1d_same(x, w, b, stride: int = 1):
    """lax.conv_general_dilated(x, w, (stride,), "SAME") in NWC / WIO
    layouts: x [B, T, C_in], w [width, C_in, C_out] -> [B, T', C_out], in
    fp32 on the card too (fp32_convolutions)."""
    lo, hi = same_pad(x.shape[1], w.shape[0], stride)
    xt = F.pad(x.transpose(1, 2), (lo, hi))
    fp32_convolutions(xt)
    out = F.conv1d(xt, w.permute(2, 1, 0), stride=stride)
    return out.transpose(1, 2) + b


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

class AudioEncoder(torch.nn.Module):
    """The encoder as a module over a params tree (the tree's tensors are
    used in place, not copied): [B, n_frames, n_mels] -> [B, n_frames/2, D]
    encoder states. n_frames must be even (conv2 has stride 2)."""

    def __init__(self, params: Params, cfg: WhisperConfig):
        super().__init__()
        self.params = params
        self.cfg = cfg

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        p, cfg = self.params, self.cfg
        x = mel.to(cfg.dtype)
        x = gelu(conv1d_same(x, p["conv1_w"], p["conv1_b"], 1))
        x = gelu(conv1d_same(x, p["conv2_w"], p["conv2_b"], 2))
        x = x + p["enc_pos"][None, : x.shape[1]]
        for i in range(cfg.encoder_layers):
            h = layer_norm(x, layer(p["enc_ln1"], i))
            x = x + mha(layer(p["enc_attn"], i), h, h, cfg.num_heads)
            h = layer_norm(x, layer(p["enc_ln2"], i))
            x = x + mlp(layer(p["enc_mlp"], i), h)
        return layer_norm(x, p["enc_lnf"])


@torch.inference_mode()
def encode_audio(params: Params, cfg: WhisperConfig,
                 mel: torch.Tensor) -> torch.Tensor:
    """[B, n_frames, n_mels] -> [B, n_frames/2, D] encoder states."""
    return AudioEncoder(params, cfg)(mel)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

@torch.inference_mode()
def decoder_logits(params: Params, cfg: WhisperConfig,
                   tokens: torch.Tensor,  # [B, T]
                   enc_states: torch.Tensor) -> torch.Tensor:
    """Full-sequence (teacher-forced) decoder: [B, T, vocab] fp32 logits."""
    t = tokens.shape[1]
    x = params["tok_embed"][tokens.long()] + params["dec_pos"][None, :t]
    causal = torch.ones((t, t), dtype=torch.bool,
                        device=x.device).tril()[None, None]
    for i in range(cfg.decoder_layers):
        h = layer_norm(x, layer(params["dec_ln1"], i))
        x = x + mha(layer(params["dec_attn"], i), h, h, cfg.num_heads,
                    mask=causal)
        h = layer_norm(x, layer(params["dec_lnx"], i))
        x = x + mha(layer(params["dec_cross"], i), h, enc_states,
                    cfg.num_heads)
        h = layer_norm(x, layer(params["dec_ln2"], i))
        x = x + mlp(layer(params["dec_mlp"], i), h)
    x = layer_norm(x, params["dec_lnf"])
    return torch.einsum("btd,vd->btv", x.float(),
                        params["tok_embed"].float())


def prompt_tokens(cfg: WhisperConfig,
                  language_token: int | None = None) -> list[int]:
    """<|startoftranscript|> then the language, task and no-timestamps
    tokens the config has (English-only checkpoints mark them -1)."""
    lang = cfg.english_token if language_token is None else language_token
    tokens = [cfg.sot_token]
    for tok in (lang, cfg.transcribe_token, cfg.no_timestamps_token):
        if tok is not None and tok >= 0:
            tokens.append(tok)
    return tokens


def length_bucket(t: int, cfg: WhisperConfig) -> int:
    """The reference's decoder length: a power of two from 8, capped at
    the text context."""
    bucket = 8
    while bucket < t:
        bucket *= 2
    return min(bucket, cfg.n_text_ctx)


@torch.inference_mode()
def greedy_transcribe_tokens(params: Params, cfg: WhisperConfig,
                             mel: torch.Tensor, max_tokens: int = 128,
                             language_token: int | None = None,
                             timings: dict | None = None) -> list[int]:
    """Greedy decode one utterance: the teacher-forced decoder re-run for
    each token over the prompt and the ids so far, zero-padded to a
    power-of-two length. `timings`, when given, gains the encoder's
    seconds and each decoder step's (host clock, after a device sync)."""
    sync = (torch.cuda.synchronize if mel.device.type == "cuda"
            else (lambda: None))
    t0 = time.perf_counter()
    enc = encode_audio(params, cfg, mel[None])
    sync()
    if timings is not None:
        timings["encoder_s"] = time.perf_counter() - t0
        timings["step_s"] = []
    tokens = prompt_tokens(cfg, language_token)
    out: list[int] = []
    for _ in range(max_tokens):
        t0 = time.perf_counter()
        t = len(tokens)
        padded = torch.zeros((1, length_bucket(t, cfg)), dtype=torch.int64)
        padded[0, :t] = torch.tensor(tokens)
        logits = decoder_logits(params, cfg, padded.to(mel.device), enc)
        next_tok = int(logits[0, t - 1].argmax())
        if timings is not None:
            timings["step_s"].append(time.perf_counter() - t0)
        if next_tok == cfg.eot_token:
            break
        tokens.append(next_tok)
        out.append(next_tok)
        if len(tokens) >= cfg.n_text_ctx:
            break
    return out


# ---------------------------------------------------------------------------
# HF checkpoint mapping (openai/whisper-* as transformers stores it)
# ---------------------------------------------------------------------------

def convert_hf_tensors(cfg: WhisperConfig, get) -> Params:
    """Map transformers' whisper tensor names onto the stacked tree (numpy
    arrays; `get(name)` returns an array or a host tensor)."""

    def fetch(name):
        w = get(name)
        return (w.float().numpy() if isinstance(w, torch.Tensor)
                else np.asarray(w))

    def stack(fmt, layers, transpose=False):
        return np.stack([fetch(fmt.format(i=i)).T if transpose
                         else fetch(fmt.format(i=i)) for i in range(layers)])

    def attn(prefix, n):
        return {"wq": stack(prefix + ".q_proj.weight", n, True),
                "bq": stack(prefix + ".q_proj.bias", n),
                "wk": stack(prefix + ".k_proj.weight", n, True),
                "wv": stack(prefix + ".v_proj.weight", n, True),
                "bv": stack(prefix + ".v_proj.bias", n),
                "wo": stack(prefix + ".out_proj.weight", n, True),
                "bo": stack(prefix + ".out_proj.bias", n)}

    def mlp_(prefix, n):
        return {"w1": stack(prefix + ".fc1.weight", n, True),
                "b1": stack(prefix + ".fc1.bias", n),
                "w2": stack(prefix + ".fc2.weight", n, True),
                "b2": stack(prefix + ".fc2.bias", n)}

    def ln_pair(prefix, n=None):
        if n:
            return (stack(prefix + ".weight", n), stack(prefix + ".bias", n))
        return (fetch(prefix + ".weight"), fetch(prefix + ".bias"))

    el, dl = cfg.encoder_layers, cfg.decoder_layers
    e = "model.encoder.layers.{i}"
    d = "model.decoder.layers.{i}"
    return {
        # HF conv weight is [out, in, width] -> ours [width, in, out]
        "conv1_w": np.transpose(fetch("model.encoder.conv1.weight"), (2, 1, 0)),
        "conv1_b": fetch("model.encoder.conv1.bias"),
        "conv2_w": np.transpose(fetch("model.encoder.conv2.weight"), (2, 1, 0)),
        "conv2_b": fetch("model.encoder.conv2.bias"),
        "enc_pos": fetch("model.encoder.embed_positions.weight"),
        "enc_attn": attn(e + ".self_attn", el),
        "enc_mlp": mlp_(e, el),
        "enc_ln1": ln_pair(e + ".self_attn_layer_norm", el),
        "enc_ln2": ln_pair(e + ".final_layer_norm", el),
        "enc_lnf": ln_pair("model.encoder.layer_norm"),
        "tok_embed": fetch("model.decoder.embed_tokens.weight"),
        "dec_pos": fetch("model.decoder.embed_positions.weight"),
        "dec_attn": attn(d + ".self_attn", dl),
        "dec_cross": attn(d + ".encoder_attn", dl),
        "dec_mlp": mlp_(d, dl),
        "dec_ln1": ln_pair(d + ".self_attn_layer_norm", dl),
        "dec_lnx": ln_pair(d + ".encoder_attn_layer_norm", dl),
        "dec_ln2": ln_pair(d + ".final_layer_norm", dl),
        "dec_lnf": ln_pair("model.decoder.layer_norm"),
    }


def num_params(cfg: WhisperConfig) -> int:
    """Parameter count of a config."""
    counts = []
    fill_tree(param_shapes(cfg), lambda shape, init: counts.append(
        math.prod(shape)))
    return sum(counts)
