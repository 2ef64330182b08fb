"""Text-conditioned image diffusion (a pixel-space UNet and DDIM), in
PyTorch.

The port's counterpart of `llmlb_tpu/models/diffusion.py`, with the
reference's NHWC activations, HWIO conv weights and tree of params:

- `unet_eps`: the ε-prediction UNet. Convs have XLA's "SAME" padding
  (stride 1 pads (1, 1); stride 2 on an even side pads (0, 1) on H and
  W); group norm over min(8, c) groups; SiLU; residual blocks with the
  time + text embedding added per block; one self-attention block at the
  bottleneck; the up path doubles the side by nearest-neighbour
  repetition (`jax.image.resize` "nearest" at an exact factor of 2, the
  only factor the UNet produces), projects and concatenates the skip.
- `ddim_sample`: one loop over the DDIM steps with classifier-free
  guidance (a conditional and an unconditional UNet call a step), from
  the noise `jax.random.normal(PRNGKey(seed), [n, H, W, C])` draws
  (`ops/_threefry.normal`).

Weights are the reference's flat safetensors (`model.safetensors`,
list items and dict keys joined with ".", absent skips left out, and
`config.json` with `model_type` "llmlb_tpu_diffusion"), through
`engine/safetensors_io.py`; the tree's template comes from this module's
`param_shapes`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from llmlb_tpu_torch.device import resolve_device
from llmlb_tpu_torch.models._common import (
    ONES,
    ZEROS,
    fp32_convolutions,
    init_tree,
    load_flat_checkpoint,
    params_from_numpy,
    same_pad,
    save_flat_checkpoint,
    unflatten,
)
from llmlb_tpu_torch.ops import _threefry

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    img_size: int = 64
    channels: int = 3
    base_ch: int = 64
    ch_mults: tuple = (1, 2, 4)
    text_vocab: int = 256
    text_dim: int = 128
    max_text_len: int = 128
    train_steps: int = 1000
    dtype: Any = torch.float32


def _group_norm(x, g, b, groups=8, eps=1e-5):
    n, h, w, c = x.shape
    groups = min(groups, c)
    xg = x.reshape(n, h, w, groups, c // groups)
    mean = xg.mean((1, 2, 4), keepdim=True)
    var = ((xg - mean) ** 2).mean((1, 2, 4), keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return xg.reshape(n, h, w, c) * g + b


def _conv(x, w, b, stride=1):
    """lax.conv_general_dilated(x, w, (s, s), "SAME") in NHWC / HWIO, in
    fp32 on the card too (fp32_convolutions)."""
    ph = same_pad(x.shape[1], w.shape[0], stride)
    pw = same_pad(x.shape[2], w.shape[1], stride)
    xt = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    fp32_convolutions(xt)
    out = F.conv2d(xt, w.permute(3, 2, 0, 1), stride=stride)
    return out.permute(0, 2, 3, 1) + b


def _upsample2x(h, target: int):
    """jax.image.resize(h, (n, target, target, c), "nearest") where target
    is twice the side: each pixel repeated 2 x 2."""
    if target != 2 * h.shape[1] or target != 2 * h.shape[2]:
        raise ValueError(f"nearest resize from {tuple(h.shape[1:3])} to "
                         f"{target}: only an exact factor of 2 is served")
    return h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def param_shapes(cfg: DiffusionConfig) -> Params:
    """The params tree as {leaf: (shape, init)} (`_common`'s spec); a
    block's `skip` is None where its channels do not change."""
    emb_dim = cfg.base_ch * 4

    def conv_p(cin, cout, k=3):
        return {"w": ((k, k, cin, cout), k * k * cin), "b": ((cout,), ZEROS)}

    def res_block(cin, cout):
        return {
            "n1g": ((cin,), ONES), "n1b": ((cin,), ZEROS),
            "c1": conv_p(cin, cout),
            "emb_w": ((emb_dim, cout), emb_dim),
            "emb_b": ((cout,), ZEROS),
            "n2g": ((cout,), ONES), "n2b": ((cout,), ZEROS),
            "c2": conv_p(cout, cout),
            "skip": conv_p(cin, cout, k=1) if cin != cout else None,
        }

    chs = [cfg.base_ch * m for m in cfg.ch_mults]
    mid = chs[-1]
    shapes: Params = {
        "text_embed": ((cfg.text_vocab + 1, cfg.text_dim), cfg.text_dim),
        "null_text": ((cfg.text_dim,), cfg.text_dim),
        "text_w1": ((cfg.text_dim, emb_dim), cfg.text_dim),
        "text_b1": ((emb_dim,), ZEROS),
        "time_w1": ((cfg.base_ch, emb_dim), cfg.base_ch),
        "time_b1": ((emb_dim,), ZEROS),
        "emb_w2": ((emb_dim, emb_dim), emb_dim),
        "emb_b2": ((emb_dim,), ZEROS),
        "conv_in": conv_p(cfg.channels, chs[0]),
        "down": [], "down_samp": [],
        "mid1": res_block(mid, mid),
        "attn_g": ((mid,), ONES),
        "attn_b": ((mid,), ZEROS),
        "attn_qkv": conv_p(mid, mid * 3, k=1),
        "attn_out": conv_p(mid, mid, k=1),
        "mid2": res_block(mid, mid),
        "up": [], "up_samp": [],
        "norm_out_g": ((chs[0],), ONES),
        "norm_out_b": ((chs[0],), ZEROS),
        "conv_out": conv_p(chs[0], cfg.channels),
    }
    prev = chs[0]
    for ch in chs:
        shapes["down"].append(res_block(prev, ch))
        shapes["down_samp"].append(conv_p(ch, ch))  # stride 2 in forward
        prev = ch
    for ch in reversed(chs):
        shapes["up_samp"].append(conv_p(prev, ch))  # before the skip concat
        shapes["up"].append(res_block(ch + ch, ch))
        prev = ch
    return shapes


def init_params(cfg: DiffusionConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random init with the reference's scheme on `device` (the card
    unless "cpu"); the numbers are the generator's, not JAX's."""
    return init_tree(param_shapes(cfg), generator, resolve_device(device),
                     cfg.dtype)


def _res(p, x, emb):
    h = F.silu(_group_norm(x, p["n1g"], p["n1b"]))
    h = _conv(h, p["c1"]["w"], p["c1"]["b"])
    h = h + (F.silu(emb) @ p["emb_w"] + p["emb_b"])[:, None, None, :]
    h = F.silu(_group_norm(h, p["n2g"], p["n2b"]))
    h = _conv(h, p["c2"]["w"], p["c2"]["b"])
    if p["skip"] is not None:
        x = _conv(x, p["skip"]["w"], p["skip"]["b"])
    return x + h


def _timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _text_condition(params, text_ids, text_lens):
    """[B, T] byte ids (+1 offset; 0 = pad) -> [B, text_dim] pooled
    embedding; text_lens == 0 selects the learned null embedding (the
    guidance's unconditional row)."""
    emb = params["text_embed"][text_ids.long()]  # [B, T, text_dim]
    valid = (torch.arange(text_ids.shape[1], device=emb.device)[None, :]
             < text_lens[:, None]).to(emb.dtype)
    pooled = (emb * valid[..., None]).sum(1) / torch.clamp(
        text_lens[:, None].to(emb.dtype), min=1.0)
    null = params["null_text"].expand(pooled.shape)
    return torch.where((text_lens > 0)[:, None], pooled, null)


@torch.inference_mode()
def unet_eps(params: Params, cfg: DiffusionConfig,
             x: torch.Tensor,  # [B, H, W, C] noisy image
             t: torch.Tensor,  # [B] int timestep
             text_ids: torch.Tensor,  # [B, T]
             text_lens: torch.Tensor,  # [B]
             ) -> torch.Tensor:
    """Predict the noise ε added at timestep t."""
    temb = _timestep_embedding(t, cfg.base_ch)
    emb = temb @ params["time_w1"] + params["time_b1"]
    cond = _text_condition(params, text_ids, text_lens)
    emb = emb + (cond @ params["text_w1"] + params["text_b1"])
    emb = F.silu(emb) @ params["emb_w2"] + params["emb_b2"]

    h = _conv(x.to(cfg.dtype), params["conv_in"]["w"], params["conv_in"]["b"])
    skips = []
    for blk, samp in zip(params["down"], params["down_samp"]):
        h = _res(blk, h, emb)
        skips.append(h)
        h = _conv(h, samp["w"], samp["b"], stride=2)

    h = _res(params["mid1"], h, emb)
    # bottleneck self-attention
    n, hh, ww, c = h.shape
    a = _group_norm(h, params["attn_g"], params["attn_b"])
    qkv = _conv(a, params["attn_qkv"]["w"], params["attn_qkv"]["b"])
    q, k, v = qkv.reshape(n, hh * ww, 3 * c).split(c, dim=-1)
    att = torch.softmax(torch.einsum("nqc,nkc->nqk", q.float(), k.float())
                        * c ** -0.5, dim=-1).to(h.dtype)
    a = torch.einsum("nqk,nkc->nqc", att, v).reshape(n, hh, ww, c)
    h = h + _conv(a, params["attn_out"]["w"], params["attn_out"]["b"])
    h = _res(params["mid2"], h, emb)

    for blk, samp in zip(params["up"], params["up_samp"]):
        skip = skips.pop()
        h = _upsample2x(h, skip.shape[1])
        h = _conv(h, samp["w"], samp["b"])
        h = _res(blk, torch.cat([h, skip], dim=-1), emb)

    h = F.silu(_group_norm(h, params["norm_out_g"], params["norm_out_b"]))
    return _conv(h, params["conv_out"]["w"], params["conv_out"]["b"])


def _ddim_schedule(cfg: DiffusionConfig, n_steps: int):
    """(timesteps [n_steps] int32, alphas_bar [train_steps] float32), in
    numpy as the reference computes them."""
    betas = np.linspace(1e-4, 0.02, cfg.train_steps, dtype=np.float64)
    alphas_bar = np.cumprod(1.0 - betas)
    ts = np.linspace(cfg.train_steps - 1, 0, n_steps).round().astype(np.int32)
    return ts, alphas_bar.astype(np.float32)


def initial_noise(cfg: DiffusionConfig, seed: int, n_images: int,
                  device) -> torch.Tensor:
    """The sampler's starting x: jax.random.normal(PRNGKey(seed),
    [n, H, W, C], float32)."""
    shape = (n_images, cfg.img_size, cfg.img_size, cfg.channels)
    return _threefry.normal(seed, shape, device=device)


@torch.inference_mode()
def ddim_sample(params: Params, cfg: DiffusionConfig, seed: int,
                text_ids: torch.Tensor, text_lens: torch.Tensor,
                n_images: int, n_steps: int = 20,
                guidance: float = 3.0) -> torch.Tensor:
    """Generate [n, H, W, C] images in [-1, 1] with classifier-free
    guidance, from the noise of `seed`. The step's scalars (alphas and
    their square roots) are float32, computed on the host."""
    device = text_ids.device
    ts, alphas_bar = _ddim_schedule(cfg, n_steps)
    x = initial_noise(cfg, seed, n_images, device)
    text_ids = text_ids.expand((n_images,) + tuple(text_ids.shape[1:]))
    text_lens = text_lens.to(device).expand((n_images,))
    zero_lens = torch.zeros_like(text_lens)
    one = np.float32(1.0)
    for i in range(n_steps):
        t = int(ts[i])
        t_batch = torch.full((n_images,), t, dtype=torch.int32, device=device)
        eps_c = unet_eps(params, cfg, x, t_batch, text_ids, text_lens)
        eps_u = unet_eps(params, cfg, x, t_batch, text_ids, zero_lens)
        eps = eps_u + np.float32(guidance) * (eps_c - eps_u)
        a_t = alphas_bar[t]
        a_prev = alphas_bar[ts[i + 1]] if i + 1 < n_steps else one
        x0 = (x - float(np.sqrt(one - a_t)) * eps) / float(np.sqrt(a_t))
        x0 = torch.clamp(x0, -1.0, 1.0)
        x = float(np.sqrt(a_prev)) * x0 + float(np.sqrt(one - a_prev)) * eps
    return torch.clamp(x, -1.0, 1.0)


# ---------------------------------------------------------------------------
# Checkpoint round-trip (the reference's flat safetensors, `_common`)
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, cfg: DiffusionConfig, params: Params) -> None:
    meta = {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}
    save_flat_checkpoint(path, "llmlb_tpu_diffusion", meta, params)


def load_checkpoint(path: str,
                    device=None) -> tuple[DiffusionConfig, Params]:
    """A checkpoint of either package's save_checkpoint, as params on
    `device` (the card unless "cpu")."""
    meta, flat = load_flat_checkpoint(path)
    if "ch_mults" in meta:
        meta["ch_mults"] = tuple(meta["ch_mults"])
    cfg = DiffusionConfig(**meta)
    tree = unflatten(flat, param_shapes(cfg))
    return cfg, params_from_numpy(tree, cfg, resolve_device(device))
