"""Image generation service: prompt -> PNG through the port's diffusion
model (`models/diffusion.py`).

The port's counterpart of `llmlb_tpu/engine/image.py`, behind POST
/v1/images/generations; PNG encoding is stdlib-only (zlib + struct), byte
for byte the reference's.
"""

from __future__ import annotations

import base64
import itertools
import os
import struct
import zlib

import numpy as np
import torch

from llmlb_tpu_torch.device import resolve_device
from llmlb_tpu_torch.models import diffusion


def encode_png(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> PNG bytes (8-bit truecolor, no filtering)."""
    h, w, _ = rgb.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def to_uint8(images: torch.Tensor) -> np.ndarray:
    """[n, H, W, C] in [-1, 1] -> uint8 pixels, as the reference rounds
    them: (x + 1) * 127.5 in float32, clipped, truncated."""
    arr = ((images.float() + 1.0) * 127.5).cpu().numpy()
    return arr.clip(0, 255).astype(np.uint8)


class ImageEngine:
    """One loaded diffusion model and its generation entry points, on the
    card unless `device="cpu"`."""

    def __init__(self, cfg: diffusion.DiffusionConfig, params,
                 model_id: str = "diffusion", sample_steps: int = 20,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = diffusion.params_from_numpy(params, cfg, self.device)
        self.model_id = model_id
        self.sample_steps = sample_steps
        self.total_requests = 0
        # a distinct default seed per request (itertools.count's __next__
        # is atomic under the GIL), starting from fresh entropy
        self._seed_counter = itertools.count(
            int(np.random.SeedSequence().entropy % (2**30)))

    @classmethod
    def from_random(cls, cfg: diffusion.DiffusionConfig | None = None,
                    model_id: str = "diffusion-random", seed: int = 0,
                    sample_steps: int = 8, device=None):
        """Random weights from `seed` (the reference's small test config by
        default), drawn on the engine's device."""
        cfg = cfg or diffusion.DiffusionConfig(
            img_size=16, base_ch=16, ch_mults=(1, 2), text_dim=32,
            max_text_len=64,
        )
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, diffusion.init_params(cfg, gen, dev),
                   model_id=model_id, sample_steps=sample_steps, device=dev)

    @classmethod
    def from_checkpoint(cls, model_dir: str, model_id: str | None = None,
                        sample_steps: int = 20, device=None):
        cfg, params = diffusion.load_checkpoint(model_dir, device=device)
        return cls(cfg, params,
                   model_id or os.path.basename(model_dir.rstrip("/")),
                   sample_steps, device=device)

    def prompt_ids(self, prompt: str) -> tuple[torch.Tensor, torch.Tensor]:
        """([1, max_text_len] byte ids + 1, 0 = pad; [1] length)."""
        data = prompt.encode("utf-8", errors="replace")[: self.cfg.max_text_len]
        ids = np.zeros((1, self.cfg.max_text_len), np.int32)
        ids[0, :len(data)] = np.frombuffer(data, np.uint8) + 1
        return (torch.from_numpy(ids).to(self.device),
                torch.tensor([len(data)], device=self.device))

    def sample(self, prompt: str, n: int = 1,
               seed: int | None = None) -> torch.Tensor:
        """Prompt -> [n, H, W, C] images in [-1, 1] (validated as
        `generate`)."""
        if not prompt:
            raise ValueError("'prompt' is required")
        if not 1 <= n <= 10:
            raise ValueError("'n' must be between 1 and 10")
        self.total_requests += 1
        if seed is None:
            seed = next(self._seed_counter) % (2**31)
        ids, lens = self.prompt_ids(prompt)
        return diffusion.ddim_sample(self.params, self.cfg, seed, ids, lens,
                                     n, n_steps=self.sample_steps)

    def generate(self, prompt: str, n: int = 1,
                 seed: int | None = None) -> list[bytes]:
        """Prompt -> n PNG images; `seed` draws the reference's noise."""
        pixels = to_uint8(self.sample(prompt, n, seed))
        return [encode_png(p) for p in pixels]

    def generate_b64(self, prompt: str, n: int = 1,
                     seed: int | None = None) -> list[str]:
        return [base64.b64encode(p).decode()
                for p in self.generate(prompt, n, seed)]
