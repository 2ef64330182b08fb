"""The cross-process handoff wire: everything a decode engine needs to adopt
a stream a prefill engine started. The port's copy of
`llmlb_tpu/disagg/wire.py`, built over the port's SamplingParams, which
declares the reference's fields: a payload either package makes parses in
the other, so a gateway may pair a JAX prefill engine with a port decode
engine.

`sampling` is `dataclasses.asdict(SamplingParams)` on the way out and
`SamplingParams(**payload["sampling"])` on the way back, so every declared
field (priority, deadline_ms, constraint, speculative, seed, ...) rides
the wire, and a field this engine does not declare is refused rather than
dropped. The gateway relays the payload verbatim between engines.
"""

from __future__ import annotations

import dataclasses
import time

HANDOFF_WIRE_VERSION = 1

# Hard cap on wire token counts: the payload crosses processes as JSON, and
# an absurd length means a corrupted or hostile payload, not a real request
# (slot capacities are orders of magnitude below it).
_MAX_WIRE_TOKENS = 4_000_000


class HandoffError(ValueError):
    """Malformed or unsupported handoff payload."""


def handoff_payload(
    prompt_ids: list[int],
    committed_ids: list[int],
    sampling,
    *,
    stop: list[str] | None = None,
    request_id: str | None = None,
    kv_pages: dict | None = None,
) -> dict:
    """JSON-safe wire form of an in-flight request at its handoff point.

    `kv_pages` optionally carries the origin's serialized KV pages
    (engine/kv_transfer.py), so the adopter can land them instead of
    prefilling again. It rides beside the token fields: an adopter that
    does not know it replays, one that does validates the payload's own
    versioned header, so it needs no wire version bump."""
    out = {
        "version": HANDOFF_WIRE_VERSION,
        "request_id": request_id,
        "prompt_ids": [int(t) for t in prompt_ids],
        "committed_ids": [int(t) for t in committed_ids],
        "stop": [str(s) for s in (stop or []) if s],
        "sampling": dataclasses.asdict(sampling),
        # the emission stamp (wall clock, the only one two processes
        # share): the adopter reports now - t as the handoff's latency
        "t": time.time(),
    }
    if kv_pages is not None:
        out["kv_pages"] = kv_pages
    return out


def _token_list(payload: dict, key: str, *, min_len: int = 0) -> list[int]:
    raw = payload.get(key)
    if not isinstance(raw, list) or len(raw) < min_len:
        raise HandoffError(f"'{key}' must be a list of token ids")
    if len(raw) > _MAX_WIRE_TOKENS:
        raise HandoffError(f"'{key}' is implausibly long ({len(raw)} tokens)")
    try:
        return [int(t) for t in raw]
    except (TypeError, ValueError):
        raise HandoffError(f"'{key}' must contain only integers") from None


def parse_handoff(payload: dict):
    """Validate and rebuild the adoption's inputs: (prompt_ids,
    committed_ids, SamplingParams, stop, request_id, t). Raises HandoffError
    on anything malformed: the server answers it with a 400."""
    from llmlb_tpu_torch.engine.scheduler import SamplingParams

    if not isinstance(payload, dict):
        raise HandoffError("handoff payload must be a JSON object")
    if payload.get("version") != HANDOFF_WIRE_VERSION:
        raise HandoffError(
            f"unsupported handoff wire version {payload.get('version')!r} "
            f"(this engine speaks {HANDOFF_WIRE_VERSION})")
    prompt_ids = _token_list(payload, "prompt_ids", min_len=1)
    committed_ids = _token_list(payload, "committed_ids")
    raw_sampling = payload.get("sampling")
    if not isinstance(raw_sampling, dict):
        raise HandoffError("'sampling' must be an object")
    known = {f.name for f in dataclasses.fields(SamplingParams)}
    unknown = set(raw_sampling) - known
    if unknown:
        # a newer prefill engine added a field this one does not know;
        # dropping it would desync the continuation
        raise HandoffError(
            f"unknown sampling fields on the handoff wire: {sorted(unknown)}")
    try:
        sampling = SamplingParams(**raw_sampling)
    except TypeError as e:
        raise HandoffError(f"bad sampling block: {e}") from None
    stop = payload.get("stop") or []
    if not isinstance(stop, list) or any(not isinstance(s, str) for s in stop):
        raise HandoffError("'stop' must be a list of strings")
    request_id = payload.get("request_id")
    if request_id is not None and not isinstance(request_id, str):
        raise HandoffError("'request_id' must be a string")
    t = payload.get("t")
    t = float(t) if isinstance(t, (int, float)) else 0.0
    return prompt_ids, committed_ids, sampling, list(stop), request_id, t
