"""High-level engine service: text in, streamed text out.

Counterpart of `Engine` in `llmlb_tpu/engine/service.py`: chat templating,
token encode/decode, stop-sequence handling and usage accounting over the
core's thread-side event queues, the prefill side of a cross-process
handoff (`prefill_handoff`, behind /v1/handoff/prefill), the adoption of a
stream another engine started (`adopt_stream`, behind /v1/handoff and
/v1/resume, landing its KV pages when the origin shipped them) and the
embedding forward (`embed`, behind /v1/embeddings). The port's HTTP server
runs one thread per connection, so `stream` and `adopt_stream` are plain
generators and `prefill_handoff` a plain function (the reference's are
async), and a request's grammar constraint compiles on the caller's thread
before the submit (the reference's executor): never on the step loop.
"""

from __future__ import annotations

import dataclasses
import os
import time
import uuid
from typing import Iterator

import numpy as np
import torch

from llmlb_tpu_torch.engine.kv_transfer import (
    KVTransferError,
    parse_kv_payload,
)
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import (
    EngineCore,
    Request,
    SamplingParams,
)
from llmlb_tpu_torch.engine.telemetry import device_telemetry
from llmlb_tpu_torch.engine.tokenizer import (
    ByteTokenizer,
    HFTokenizer,
    IncrementalDetokenizer,
    Tokenizer,
)
from llmlb_tpu_torch.engine.weights import load_checkpoint, load_config
from llmlb_tpu_torch.quant import parse_quant_mode
from llmlb_tpu_torch.structured import ConstraintCompiler


class EngineError(RuntimeError):
    pass


@dataclasses.dataclass
class StreamDelta:
    text: str = ""
    finish_reason: str | None = None
    prompt_tokens: int = 0
    completion_tokens: int = 0
    ttft_s: float | None = None
    # Token ids committed since the previous delta: the server sends them
    # as `llmlb.replay` frames, before the text they produced, to a stream
    # armed with `llmlb_replay`, so the gateway's ledger covers every
    # character its client has seen.
    token_ids: list[int] = dataclasses.field(default_factory=list)


class Engine:
    """One served model: config + weights + tokenizer + scheduler core."""

    def __init__(self, model_id: str, core: EngineCore, tokenizer: Tokenizer):
        self.model_id = model_id
        self.core = core
        self.tokenizer = tokenizer
        # The grammar compiler needs the tokenizer, so the service owns it
        # and installs it on the core (whose _prepare_constraint compiles
        # for core-level submitters), as in the reference.
        self.constraint_compiler = ConstraintCompiler(
            tokenizer, core.cfg.vocab_size, metrics=core.structured_metrics)
        core.constraint_compiler = self.constraint_compiler

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

    @classmethod
    def from_checkpoint(
        cls,
        checkpoint_dir: str,
        *,
        model_id: str | None = None,
        device: str | torch.device | None = None,
        tokenizer: Tokenizer | None = None,
        **core_kwargs,
    ) -> "Engine":
        """Build from a HF checkpoint directory (`config.json`, safetensors
        shards, tokenizer files) and start the step loop. Runs on the card
        unless `device="cpu"`. The weights stream onto the device one HF
        tensor at a time; when `quantize` asks for int8 weights they
        quantize layer by layer while streaming (the core's own pass then
        passes them through). The model id defaults to the directory's
        basename. `tokenizer` defaults to `HFTokenizer(checkpoint_dir)`,
        which needs `transformers`; pass another (a ByteTokenizer) where
        that package is missing, as on the card's machine. The server never
        passes one. Other keywords go to EngineCore, as in from_preset."""
        cfg = load_config(checkpoint_dir)
        if tokenizer is None:
            tokenizer = HFTokenizer(checkpoint_dir)
        params = load_checkpoint(
            checkpoint_dir, cfg, device=device,
            quantize_weights=parse_quant_mode(
                core_kwargs.get("quantize")).weights)
        core_kwargs.setdefault("eos_id", tokenizer.eos_id)
        core = EngineCore(cfg, params, device=device, **core_kwargs)
        core.start()
        return cls(model_id or os.path.basename(checkpoint_dir.rstrip("/")),
                   core, tokenizer)

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
        request = Request(prompt_ids=list(prompt_ids), sampling=sampling,
                          request_id=_request_id(request_id),
                          compiled_constraint=self._compile(sampling))
        self._submit(request)
        return self._deltas(request, stop)

    def _compile(self, sampling: SamplingParams):
        """The request's token DFA (an LRU hit for a repeated schema), or
        None; a spec that cannot compile raises ValueError (a 400)."""
        if sampling.constraint is None:
            return None
        return self.constraint_compiler.compile_spec(sampling.constraint)

    def prefill_handoff(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams,
        emit_tokens: int = 1,
        request_id: str | None = None,
    ) -> tuple[list[int], str | None, dict | None]:
        """The prefill side of the cross-process handoff: admission and
        prefill, then the first `emit_tokens` tokens committed, then stop.
        Returns (committed ids, finish reason, kv_pages). The finish is
        None when the request has more to generate (the handoff: the caller
        wraps the ids in a wire payload for a decode engine to adopt), else
        its natural finish ("stop", "length") inside the window. kv_pages
        is the row's serialized KV pages in the handoff case when this
        engine ships pages, else None. Token-level on purpose: the adopter
        owns detokenization and stop sequences, so it sees the token
        sequence an uninterrupted run would."""
        k = max(1, int(emit_tokens))
        bounded = dataclasses.replace(
            sampling, max_tokens=min(sampling.max_tokens, k))
        request = Request(prompt_ids=list(prompt_ids), sampling=bounded,
                          request_id=_request_id(request_id),
                          compiled_constraint=self._compile(sampling))
        # the budgeted finish serializes the row's pages before they free
        request.export_kv = self.core.kv_ship
        self._submit(request)
        committed: list[int] = []
        finish: str | None = None
        try:
            while True:
                kind, value = request.events.get()
                if kind == "error":
                    raise EngineError(str(value))
                if kind == "token":
                    committed.append(int(value))
                else:  # done
                    finish = str(value)
                    break
        finally:
            if finish is None:
                request.cancel()
        if (finish == "length" and len(committed) >= k
                and sampling.max_tokens > k):
            # cut at the window, not a real finish: the stream goes on on
            # whichever engine adopts it
            self.core.metrics.record_handoff("emitted")
            if self.core.flightrec.enabled:
                self.core.flightrec.emit(request.request_id,
                                         "handoff_emitted",
                                         tokens=len(committed))
            return committed, None, request.kv_export
        return committed, finish, None

    def adopt_stream(
        self,
        prompt_ids: list[int],
        committed_ids: list[int],
        sampling: SamplingParams,
        stop: list[str] | None = None,
        request_id: str | None = None,
        kv_pages: dict | None = None,
        emitted_at: float = 0.0,
    ) -> Iterator[StreamDelta]:
        """Continue a stream another engine started (or this one, before a
        failover): `committed_ids` are the tokens its client already holds.
        With `kv_pages`, the origin's serialized pages (POST /v1/kv/export
        there), parsed here on the caller's thread and checked against this
        pool (`kv_restore_reason`), the pages land and the stream enters
        decode with no prefill. Without them, or on any refusal (counted
        under its labelled reason: disabled, absent, version, dtype,
        page_size, geometry, capacity or error), the request resumes as a
        parked one does: the prompt prefills in its cold chunks, the
        committed tokens are fed through decode steps, and decoding goes on
        from there, token-identical to an uninterrupted run. The deltas carry the FULL completion, committed
        text included (the gateway cuts what its client has): the first,
        yielded as soon as the request is submitted, carries the committed
        text and ids, so a second failover from this engine replays the
        full sequence. A stream already
        terminal in its committed tokens (a stop string, or max_tokens
        reached) ends here without a submit. A constrained stream's grammar
        cursor is rebuilt by walking the committed tokens, and a speculating
        one's drafter is indexed over the prompt and the committed tokens
        (the origin's drafter at the handoff point). Every adoption counts
        as an "adopted" handoff, with its latency since `emitted_at`, the
        wire's wall-clock stamp (/v1/handoff; 0 for /v1/resume, which has
        none)."""
        committed = [int(t) for t in committed_ids]
        bad = [t for t in committed if not 0 <= t < self.core.cfg.vocab_size]
        if bad:
            raise ValueError(f"committed token id {bad[0]} out of range for "
                             f"vocab size {self.core.cfg.vocab_size}")
        # the wire stamp is time.time(): the latency stays in that clock
        latency = max(0.0, time.time() - emitted_at) if emitted_at else None
        self.core.metrics.record_handoff("adopted", latency)
        if request_id and self.core.flightrec.enabled:
            attrs = {"committed": len(committed)}
            if latency is not None:
                attrs["wire_latency_s"] = round(latency, 6)
            self.core.flightrec.emit(request_id, "adopted", **attrs)
        detok = IncrementalDetokenizer(self.tokenizer)
        text = "".join(detok.push(t) for t in committed)
        hit = _find_stop(text, [s for s in (stop or []) if s])
        if hit is not None or len(committed) >= sampling.max_tokens:
            return iter([StreamDelta(
                text=text[:hit] if hit is not None else text + detok.flush(),
                finish_reason="stop" if hit is not None else "length",
                prompt_tokens=len(prompt_ids),
                completion_tokens=len(committed), token_ids=committed)])
        compiled = self._compile(sampling)
        # the cursor at its handoff position and the drafter, as every rank
        # of a mesh rebuilds them from the tick plan
        request = Request(
            prompt_ids=list(prompt_ids), sampling=sampling,
            request_id=_request_id(request_id),
            parked=self.core.adopted_state(prompt_ids, committed, sampling,
                                           compiled),
            kv_restore=self._kv_restore_of(kv_pages, committed),
            compiled_constraint=compiled)
        self._submit(request)
        return self._deltas(request, stop, committed)

    def _kv_restore_of(self, kv_pages: dict | None, committed: list[int]):
        """The parsed pages an adoption lands, or None after counting the
        reason the replay path takes instead, as the reference counts it."""
        core = self.core
        if kv_pages is None:
            if core.kv_ship:
                # shipping is on but the origin sent nothing: a replay that
                # could have been a page move
                core.record_kv_ship_fallback("absent")
            return None
        if not core.kv_ship:
            core.record_kv_ship_fallback("disabled")
            return None
        if not committed:
            # nothing committed: the replay is already the exact path
            core.record_kv_ship_fallback("capacity")
            return None
        try:
            parsed = parse_kv_payload(kv_pages)
        except KVTransferError as e:
            core.record_kv_ship_fallback(e.reason)
            return None
        except Exception:  # boundary: a bad payload is never a client error
            core.record_kv_ship_fallback("error")
            return None
        reason = core.kv_restore_reason(parsed.header)
        if reason is not None:
            core.record_kv_ship_fallback(reason)
            return None
        return parsed

    def _submit(self, request: Request) -> None:
        """Pin the request's adapter on the caller's thread, then submit; a
        submit that fails releases the pin again."""
        self.core.prepare_lora(request)
        try:
            self.core.submit(request)
        except BaseException:
            self.core._release_lora(request)  # idempotent
            raise

    def _deltas(self, request: Request, stop: list[str] | None,
                committed: list[int] = ()) -> Iterator[StreamDelta]:
        detok = IncrementalDetokenizer(self.tokenizer)
        stop = [s for s in (stop or []) if s]
        holdback = max((len(s) for s in stop), default=1) - 1
        # decoded text; acc[:emitted] has been yielded
        acc = "".join(detok.push(t) for t in committed)
        emitted = 0
        completion_tokens = len(committed)
        # ids committed since the last yielded delta: they ride the next
        pending_ids: list[int] = []
        ttft: float | None = None
        finished = False

        def final(text: str, reason: str) -> StreamDelta:
            return StreamDelta(text=text, finish_reason=reason,
                               prompt_tokens=len(request.prompt_ids),
                               completion_tokens=completion_tokens,
                               ttft_s=ttft, token_ids=pending_ids)

        try:
            if committed:
                # an adoption's committed text and ids go out at once: its
                # exact resume feeds them through decode steps first (~one
                # step a token), and the client should not wait on that
                boundary = max(0, len(acc) - holdback)
                emitted = boundary
                pending_ids = []
                yield StreamDelta(text=acc[:boundary],
                                  token_ids=list(committed))
            while True:
                kind, value = request.events.get()
                if kind == "error":
                    raise EngineError(str(value))
                if kind == "token":
                    completion_tokens += 1
                    if (completion_tokens == len(committed) + 1
                            and request.first_token_at):
                        ttft = request.first_token_at - request.submitted_at
                    pending_ids.append(int(value))
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
                # a delta for every committed token, with whatever text is
                # ready (none, for a token that decodes to nothing yet): the
                # replay ledger then never lags the stream by more than one
                # token
                boundary = max(emitted, len(acc) - holdback)
                if boundary > emitted or pending_ids:
                    delta = StreamDelta(text=acc[emitted:boundary],
                                        ttft_s=ttft, token_ids=pending_ids)
                    pending_ids = []
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

    # One encode forward takes at most this many rows, and a request at
    # most MAX_EMBED_INPUTS inputs (OpenAI's limit), as in the reference.
    _EMBED_CHUNK = 64
    # padded ids in one forward, at most: a forward rides a tick plan on a
    # mesh, whose budget (engine/multihost.py) it must fit
    _EMBED_IDS = 1 << 20
    MAX_EMBED_INPUTS = 2048

    def supports_embeddings(self) -> bool:
        """Whether the model family has an `encode` forward (the dense
        Llama class does, the MoE class does not), as the reference
        decides it."""
        return hasattr(self.core.family, "encode")

    def embed(self, batch_ids: list[list[int]]) -> list[list[float]]:
        """Token id lists -> L2-normalised embedding vectors, as lists of
        floats. Raises ValueError (a client error) for a family without an
        embedding forward and for empty, oversized or out-of-vocab inputs,
        with the reference's messages."""
        if not self.supports_embeddings():
            raise ValueError(
                "embeddings are not supported for the "
                f"{self.core.family.__name__.rsplit('.', 1)[-1]} model family")
        if not batch_ids or any(len(x) == 0 for x in batch_ids):
            raise ValueError("each input must contain at least one token")
        if len(batch_ids) > self.MAX_EMBED_INPUTS:
            raise ValueError(f"at most {self.MAX_EMBED_INPUTS} inputs per "
                             f"request (got {len(batch_ids)})")
        longest = max(len(x) for x in batch_ids)
        limit = self.core.cfg.max_position_embeddings
        if longest > limit:
            raise ValueError(f"input of {longest} tokens exceeds the model "
                             f"context ({limit})")
        vocab = self.core.cfg.vocab_size
        flat = np.fromiter((t for toks in batch_ids for t in toks), np.int64)
        if flat.size and (flat.min() < 0 or flat.max() >= vocab):
            bad = int(flat[(flat < 0) | (flat >= vocab)][0])
            raise ValueError(f"token id {bad} out of range for vocab size "
                             f"{vocab}")
        return self._embed_sync(batch_ids)

    def _embed_sync(self, batch_ids: list[list[int]]) -> list[list[float]]:
        """Encode forwards of at most _EMBED_CHUNK rows and _EMBED_IDS
        padded ids, each row padded to its OWN power-of-two bucket (16 and
        up), one forward per bucket: a row's vector then depends on no
        other input of the request (on the card, cuBLAS picks a product's
        sums by its shape). The forwards run
        on the step loop's thread, between its iterations (on a mesh on
        every rank, from the tick plan: `EngineCore.encode`)."""
        out: list[list[float] | None] = [None] * len(batch_ids)
        by_bucket: dict[int, list[int]] = {}
        for i, toks in enumerate(batch_ids):
            bucket = 16
            while bucket < len(toks):
                bucket *= 2
            by_bucket.setdefault(bucket, []).append(i)
        for bucket, rows in sorted(by_bucket.items()):
            step = max(1, min(self._EMBED_CHUNK, self._EMBED_IDS // bucket))
            for start in range(0, len(rows), step):
                chunk = rows[start:start + step]
                ids = np.zeros((len(chunk), bucket), np.int32)
                lens = np.zeros((len(chunk),), np.int32)
                for r, i in enumerate(chunk):
                    ids[r, :len(batch_ids[i])] = batch_ids[i]
                    lens[r] = len(batch_ids[i])
                vecs = self.core.encode(ids, lens)
                for r, vec in zip(chunk, vecs.tolist()):
                    out[r] = vec
        return out

    def health(self) -> dict:
        stats = self.core.stats()
        lora = self.core.lora_info()
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
                # the engine's mesh of ranks, as the reference reports it,
                # and the slots of each dp group (the batch rows it computes)
                "mesh": dict(self.core.mesh.shape),
                "dp_slots": [self.core._slot_groups.count(g) for g in
                             range(self.core.mesh.shape["dp"])],
                # the prefix cache's counters (the reference's metric names)
                # and the dense hits' row copies
                **dataclasses.asdict(stats.prefix),
            },
            "device": device,
            # the reference's device telemetry block (its "tpu"), under the
            # key the gateway's health probe also reads
            "gpu": device_telemetry(dev),
            "kv_cache": self.core.kv_cache_info(),
            "prefix_cache": self.core.prefix_cache_info(),
            # int8 knobs and the byte footprints they produce
            "quant": self.core.quant_info(),
            # adapter pool: resident names (the gateway's lora_loaded)
            "lora": lora,
            # overload protection: queue depths by class, preemption and
            # deadline-shed counters
            "sched": self.core.sched_info(),
            # KV page shipping and the host-RAM offload tier
            "kv_transfer": self.core.kv_transfer_info(),
            # structured outputs: the compiler's mask cache, live
            # constrained rows and the device grammar table
            "structured": self.core.structured_info(),
            # speculative decoding: the knobs and acceptance figures
            "spec": self.core.spec_info(),
            # disaggregation: the role, the split's pools, the handoffs
            "disagg": self.core.disagg_info(),
            # live roofline: MFU and memory-bandwidth utilization against
            # the device's spec-sheet peaks
            "perf": self.core.perf_info(),
            # latency percentiles and counters, read from the same tallies
            # as /metrics and core.stats()
            "metrics": self.core.metrics.summary(stats, lora),
        }


def _request_id(request_id: str | None) -> str:
    """A fresh engine request id, after the caller's (gateway) id if any."""
    rid = uuid.uuid4().hex
    return f"{request_id}.{rid[:8]}" if request_id else rid


def _find_stop(text: str, stops: list[str]) -> int | None:
    best: int | None = None
    for s in stops:
        idx = text.find(s)
        if idx != -1 and (best is None or idx < best):
            best = idx
    return best
