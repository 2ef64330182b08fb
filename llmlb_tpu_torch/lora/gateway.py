"""Gateway-side LoRA routing (docs/lora.md), the disagg/gateway.py sibling.

Resolution order for a request naming adapter `a` on model `m`:

1. HOT — some online endpoint advertises the `m:a` model entry (resident
   adapters are mirrored into model entries every health probe), so
   selection runs over exactly those endpoints: the adapter is already in
   their device pool and decode starts without a load.
2. LOAD — no endpoint has it hot, but some serve `m` with the `lora`
   capability: selection runs over those, and the chosen engine hot-loads
   the adapter at admission (one disk→device transfer, then it advertises
   hot within a probe interval).
3. Neither → 400 naming the `lora` field (the fleet cannot serve this
   adapter), EXCEPT when the adapter came only from a model-name suffix
   and the full string is itself a servable model — then it was never an
   adapter reference at all (`llama3:8b` on an ollama endpoint) and normal
   routing proceeds.

Validation of the field's SHAPE is shared with the engine server
(llmlb_tpu/lora/api.py), so both dialects 400 identically on malformed
values — the `speculative`/`response_format` validation pattern.
"""

from __future__ import annotations

import dataclasses

from llmlb_tpu_torch.lora.api import adapter_from_body


@dataclasses.dataclass(frozen=True)
class LoraRoute:
    """How one adapter request routes."""

    adapter: str
    base_canonical: str  # canonical BASE model (affinity + accounting)
    canonical: str  # the model name selection runs over
    kind: str  # "hot" | "load"
    # capability the selection must require (None = leave unchanged);
    # set for "load" so only adapter-store-bearing endpoints are eligible
    capability: object | None = None


def lora_route_for(state, body: dict) -> LoraRoute | None:
    """Resolve a request's adapter reference against the live registry.
    None when the request references no adapter (or the "adapter" was a
    literal colon-model). Raises ValueError naming the `lora` field for
    malformed values and for adapters no online endpoint can serve."""
    from llmlb_tpu_torch.gateway.model_names import to_canonical
    from llmlb_tpu_torch.gateway.types import Capability

    model = body.get("model")
    explicit = body.get("lora")
    if explicit is None and (not isinstance(model, str)
                             or ":" not in model):
        return None
    base, adapter = adapter_from_body(body)  # raises on malformed/conflict
    if adapter is None:
        return None
    base_canonical = to_canonical(base) if base else ""
    # The adapter interpretation is only live when the BASE model has a
    # lora-capable endpoint: `llama3:8b` on an ollama fleet is a literal
    # model name, not adapter "8b" of model "llama3" — even though the
    # full string resolves. The explicit `lora` field is always an adapter
    # reference and refuses loudly when the fleet cannot serve it.
    if not state.registry.find_by_model(base_canonical, Capability.LORA):
        if explicit is None:
            return None  # literal colon-model; normal routing proceeds
        raise ValueError(
            f"'lora' adapter {adapter!r} is not available for model "
            f"{base or model!r}: no online endpoint serves it with an "
            "adapter store"
        )
    qualified = f"{base_canonical}:{adapter}"
    if state.registry.find_by_model(qualified):
        return LoraRoute(adapter=adapter, base_canonical=base_canonical,
                         canonical=qualified, kind="hot")
    # Cold-load route — but refuse outright when the fleet's advertised
    # stores say NO endpoint could load this adapter: a clean 400 naming
    # the field beats a proxied engine-side 400 (which the resilience
    # layer would normalize to 502). Endpoints without a fresh probe
    # advertisement (lora_available is None) are given the benefit of the
    # doubt — the engine is the authority and rescans its store on a miss.
    lora_eps = state.registry.find_by_model(base_canonical, Capability.LORA)
    advertised = [
        getattr(getattr(ep, "accelerator", None), "lora_available", None)
        for ep, _m in lora_eps
    ]
    if all(a is not None for a in advertised) and not any(
        adapter in a for a in advertised
    ):
        raise ValueError(
            f"'lora' adapter {adapter!r} is not available for model "
            f"{base or model!r}: no online endpoint's adapter store "
            "contains it"
        )
    return LoraRoute(adapter=adapter, base_canonical=base_canonical,
                     canonical=base_canonical, kind="load",
                     capability=Capability.LORA)


def forward_model_name(route: LoraRoute, engine_model: str | None,
                       fallback: str) -> str:
    """The model name the upstream engine should see: its own
    adapter-qualified entry on the hot path, `base:adapter` synthesized on
    the load path (the engine parses the suffix and hot-loads)."""
    if route.kind == "hot" and engine_model:
        return engine_model
    base = engine_model or fallback
    if base.endswith(f":{route.adapter}"):
        return base
    return f"{base}:{route.adapter}"
