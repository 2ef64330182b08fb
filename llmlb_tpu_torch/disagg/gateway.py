"""Role-aware gateway routing for disaggregated prefill/decode serving.

The gateway learns each endpoint's serving role from two places that are
deliberately redundant (docs/disaggregation.md):

- the health probe: tpu:// engines report ``disagg.role`` in /api/health,
  re-parsed on EVERY probe cycle — a restarted engine that changed role
  re-routes within one probe interval with no endpoint re-registration;
- model sync: roles ride the /v1/models capability list ("prefill" /
  "decode" entries, the structured-outputs advertisement as template),
  so role-aware selection composes with the existing capability routing.

Routing policy (soft preferences — the filters always fall back to the
full candidate set rather than 404ing a servable request):

- prefill-heavy requests (long prompt, cold prefix) steer to
  prefill-capable endpoints;
- everything else steers AWAY from prefill-only endpoints (their slots are
  reserved for prefill bursts);
- when the chosen endpoint is prefill-ONLY, the proxy orchestrates the
  two-phase handoff: POST /v1/handoff/prefill there, then hand the wire
  payload to a decode-capable adopter's /v1/handoff, which streams the
  full completion. Prefix affinity composes: the affinity hash steers
  WITHIN the role-filtered candidate list, so a warm prefix still lands on
  the engine whose KV cache holds it.

Non-TPU endpoints never advertise a role and default to "both" — they are
candidates everywhere, exactly as before this module existed.
"""

from __future__ import annotations

import os

from llmlb_tpu_torch.disagg import ROLES

# A prompt at or above this many (estimated) tokens counts as prefill-heavy
# and is steered to prefill-capable endpoints. 0 disables role steering of
# fresh requests (role surfaces and handoff orchestration stay live).
PREFILL_HEAVY_TOKENS = 256


def prefill_heavy_threshold() -> int:
    raw = os.environ.get("LLMLB_DISAGG_PREFILL_THRESHOLD")
    if raw:
        try:
            return max(0, int(raw))
        except ValueError:
            pass
    return PREFILL_HEAVY_TOKENS


def _caps_role(model) -> str | None:
    """Role derived from an EndpointModel's capability list (the /v1/models
    advertisement, persisted through model sync). The capability fallback
    matters in multi-worker gateways: the pull health checker runs in the
    elected primary only, so sibling workers have no probe telemetry — but
    every worker reloads the synced capability list from the shared DB."""
    if model is None:
        return None
    caps = {getattr(c, "value", c) for c in getattr(model, "capabilities", [])}
    p, d = "prefill" in caps, "decode" in caps
    if p and not d:
        return "prefill"
    if d and not p:
        return "decode"
    if p and d:
        return "both"  # both/split are indistinguishable here; routing
    return None        # only needs capability, not the loop topology


def endpoint_role(ep, model=None) -> str:
    """The endpoint's served role: the last health probe's disagg block
    first, the model's capability advertisement second, "both" when
    neither says anything (full-service, the pre-disaggregation default)."""
    role = getattr(getattr(ep, "accelerator", None), "role", None)
    if role in ROLES:
        return role
    return _caps_role(model) or "both"


def prefill_capable(ep, model=None) -> bool:
    return endpoint_role(ep, model) in ("prefill", "both", "split")


def decode_capable(ep, model=None) -> bool:
    return endpoint_role(ep, model) in ("decode", "both", "split")


def role_filter(endpoints: list, *, prefill_heavy: bool,
                models: list | None = None) -> list:
    """Role-preference filter over a candidate list (`models` is the
    optional parallel EndpointModel list for the capability fallback).
    Soft: an empty preferred set falls back to the input unchanged, so
    role steering can never make a servable model unroutable."""
    ms = models if models is not None else [None] * len(endpoints)
    if prefill_heavy:
        preferred = [ep for ep, m in zip(endpoints, ms)
                     if prefill_capable(ep, m)]
    else:
        # keep prefill-only endpoints free for prefill bursts
        preferred = [ep for ep, m in zip(endpoints, ms)
                     if endpoint_role(ep, m) != "prefill"]
    return preferred or endpoints


def is_prefill_heavy(state, model: str, prompt_tokens_estimate: int,
                     prefix_hash: str | None) -> bool:
    """Long prompt AND cold prefix. A warm prefix makes the prefill nearly
    free on the endpoint that holds it, so affinity wins over role
    steering. Cold-prefix detection reads the lru affinity map; in ring
    mode ownership is a pure hash (no warmth signal), so a long prompt
    counts as heavy and the consistent-hash owner is consulted within the
    role-filtered set."""
    threshold = prefill_heavy_threshold()
    if threshold <= 0 or prompt_tokens_estimate < threshold:
        return False
    lm = state.load_manager
    if prefix_hash is not None and lm.affinity_mode == "lru":
        if lm._affinity_endpoint(model, prefix_hash) is not None:
            return False  # warm prefix: stick with the cache
    return True


def speaks_handoff_wire(ep, model=None) -> bool:
    """True only when the endpoint EXPLICITLY advertises decode capability
    — a probed disagg role or a "decode" entry on its capability list.
    `decode_capable`'s "both" DEFAULT is deliberately not enough here: a
    generic OpenAI-compatible endpoint defaults to "both" for steering
    purposes but has no /v1/handoff route, and POSTing a wire payload at
    it would 404 a perfectly servable request."""
    role = getattr(getattr(ep, "accelerator", None), "role", None)
    if role in ROLES:
        return role in ("decode", "both", "split")
    return _caps_role(model) in ("decode", "both")


def adopter_candidates(state, model: str, capability,
                       exclude: set[str] | None = None) -> list:
    """Online endpoints serving `model` that explicitly speak the handoff
    wire — where a payload can be adopted. The originating prefill-only
    endpoint is never in this list, and neither is a non-TPU endpoint that
    merely DEFAULTS to "both" (it has no /v1/handoff)."""
    return [
        ep for ep, m in state.registry.find_by_model(model, capability)
        if speaks_handoff_wire(ep, m)
        and (not exclude or ep.id not in exclude)
    ]
