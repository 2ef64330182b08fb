"""High-level engine service: text in, streamed text out.

Counterpart of `Engine` in `llmlb_tpu/engine/service.py`: chat templating,
token encode/decode, stop-sequence handling and usage accounting over the
core's thread-side event queues. The port's HTTP server runs one thread per
connection, so `stream` is a plain generator (the reference's is async).
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Iterator

import torch

from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import EngineCore, Request, SamplingParams
from llmlb_tpu_torch.engine.tokenizer import (
    ByteTokenizer,
    IncrementalDetokenizer,
    Tokenizer,
)


class EngineError(RuntimeError):
    pass


@dataclasses.dataclass
class StreamDelta:
    text: str = ""
    finish_reason: str | None = None
    prompt_tokens: int = 0
    completion_tokens: int = 0
    ttft_s: float | None = None


class Engine:
    """One served model: config + weights + tokenizer + scheduler core."""

    def __init__(self, model_id: str, core: EngineCore, tokenizer: Tokenizer):
        self.model_id = model_id
        self.core = core
        self.tokenizer = tokenizer

    @classmethod
    def from_preset(
        cls,
        preset: str,
        *,
        model_id: str | None = None,
        device: str | torch.device | None = None,
        params: dict[str, torch.Tensor] | None = None,
        **core_kwargs,
    ) -> "Engine":
        """Build from a named preset with random weights from `seed` (or the
        given params) and start the step loop. Runs on the card unless
        `device="cpu"`. `eos_id` defaults to the tokenizer's; pass -1 to
        decode every request to its max_tokens. Other keywords go to
        EngineCore, e.g. `quantize="all"` for int8 weights and KV pages,
        `kv_layout="dense"` for the slot cache, `lora_dir=` for adapters."""
        cfg = get_preset(preset)
        tokenizer = ByteTokenizer(cfg.vocab_size)
        core_kwargs.setdefault("eos_id", tokenizer.eos_id)
        core = EngineCore(cfg, params, device=device, **core_kwargs)
        core.start()
        return cls(model_id or preset, core, tokenizer)

    def shutdown(self) -> None:
        self.core.stop()

    def encode_chat(self, messages: list[dict]) -> list[int]:
        return self.tokenizer.encode(self.tokenizer.apply_chat_template(messages))

    def stream(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams,
        stop: list[str] | None = None,
        request_id: str | None = None,
    ) -> Iterator[StreamDelta]:
        """Submit now (a refused prompt raises ValueError here, before any
        output) and return a generator of deltas; the final delta carries
        finish_reason and usage.

        A request that names an adapter pins it (loading it if cold) here,
        on the caller's thread, before the submit; a submit that fails
        releases it again.

        Stop sequences may straddle token boundaries, so the last
        `max(len(stop)) - 1` characters are held back until the stream
        resolves; a stop hit truncates before anything past it is emitted.
        Closing the generator early cancels the request so its slot frees.
        """
        rid = uuid.uuid4().hex
        request = Request(
            prompt_ids=list(prompt_ids), sampling=sampling,
            request_id=f"{request_id}.{rid[:8]}" if request_id else rid,
        )
        self.core.prepare_lora(request)
        try:
            self.core.submit(request)
        except BaseException:
            self.core._release_lora(request)  # idempotent
            raise
        return self._deltas(request, stop)

    def _deltas(self, request: Request,
                stop: list[str] | None) -> Iterator[StreamDelta]:
        detok = IncrementalDetokenizer(self.tokenizer)
        stop = [s for s in (stop or []) if s]
        holdback = max((len(s) for s in stop), default=1) - 1
        acc = ""  # decoded text; acc[:emitted] has been yielded
        emitted = 0
        completion_tokens = 0
        ttft: float | None = None
        finished = False

        def final(text: str, reason: str) -> StreamDelta:
            return StreamDelta(text=text, finish_reason=reason,
                               prompt_tokens=len(request.prompt_ids),
                               completion_tokens=completion_tokens,
                               ttft_s=ttft)

        try:
            while True:
                kind, value = request.events.get()
                if kind == "error":
                    raise EngineError(str(value))
                if kind == "token":
                    completion_tokens += 1
                    if completion_tokens == 1 and request.first_token_at:
                        ttft = request.first_token_at - request.submitted_at
                    acc += detok.push(int(value))
                else:  # done
                    acc += detok.flush()
                hit = _find_stop(acc, stop)
                if hit is not None:
                    finished = True
                    request.cancel()
                    yield final(acc[emitted:hit], "stop")
                    return
                if kind == "done":
                    finished = True
                    yield final(acc[emitted:], str(value))
                    return
                boundary = max(emitted, len(acc) - holdback)
                if boundary > emitted:
                    delta = StreamDelta(text=acc[emitted:boundary], ttft_s=ttft)
                    ttft = None  # report once
                    emitted = boundary
                    yield delta
        finally:
            if not finished:
                request.cancel()

    def complete(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams,
        stop: list[str] | None = None,
        request_id: str | None = None,
    ) -> StreamDelta:
        """Non-streaming: collect the full completion."""
        text = []
        final: StreamDelta | None = None
        for delta in self.stream(prompt_ids, sampling, stop,
                                 request_id=request_id):
            text.append(delta.text)
            if delta.finish_reason is not None:
                final = delta
        if final is None:
            raise EngineError("stream ended without a finish reason")
        return dataclasses.replace(final, text="".join(text))

    def health(self) -> dict:
        stats = self.core.stats()
        dev = self.core.device
        device = {"type": dev.type}
        if dev.type == "cuda":
            device["name"] = torch.cuda.get_device_name(dev)
        return {
            "status": "ok",
            "model": self.model_id,
            "engine": {
                "num_slots": stats.num_slots,
                "active_slots": stats.active_slots,
                "queued": stats.queued,
                "total_requests": stats.total_requests,
                "total_tokens": stats.total_tokens,
                "uptime_s": round(stats.uptime_s, 3),
                "decode_burst": self.core.decode_burst,
            },
            "device": device,
            "kv_cache": self.core.kv_cache_info(),
            # int8 knobs and the byte footprints they produce
            "quant": self.core.quant_info(),
            # adapter pool: resident names (the gateway's lora_loaded)
            "lora": self.core.lora_info(),
        }


def _find_stop(text: str, stops: list[str]) -> int | None:
    best: int | None = None
    for s in stops:
        idx = text.find(s)
        if idx != -1 and (best is None or idx < best):
            best = idx
    return best
