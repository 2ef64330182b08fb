"""Core gateway domain types.

Counterpart of the reference's types/endpoint.rs + common/auth.rs, re-designed:
the `TPU` endpoint type is first-class (detection priority #1) and telemetry
fields are accelerator-generic (chip/HBM) rather than CUDA-specific
(reference types/endpoint.rs:308-379 carries GPU VRAM fields).
"""

from __future__ import annotations

import dataclasses
import enum
import time
import uuid


class EndpointType(str, enum.Enum):
    TPU = "tpu"  # the in-tree engines (JAX and the port) — probed first
    XLLM = "xllm"
    OLLAMA = "ollama"
    VLLM = "vllm"
    LM_STUDIO = "lm_studio"
    LLAMA_CPP = "llama_cpp"
    OPENAI_COMPATIBLE = "openai_compatible"


class EndpointStatus(str, enum.Enum):
    PENDING = "pending"
    ONLINE = "online"
    OFFLINE = "offline"
    ERROR = "error"


class Capability(str, enum.Enum):
    CHAT_COMPLETION = "chat_completion"
    EMBEDDINGS = "embeddings"
    IMAGE_GENERATION = "image_generation"
    AUDIO_TRANSCRIPTION = "audio_transcription"
    AUDIO_SPEECH = "audio_speech"
    # Grammar-constrained decoding (response_format json_schema / forced
    # tool_choice). Advertised by tpu:// engines in /v1/models; the gateway
    # steers constrained requests to endpoints that have it.
    STRUCTURED_OUTPUTS = "structured_outputs"
    # Disaggregated prefill/decode roles (docs/disaggregation.md): tpu://
    # engines advertise which phase(s) they serve on the /v1/models
    # capability list; the balancer steers prefill-heavy requests toward
    # PREFILL-capable endpoints and handoff adoption toward DECODE-capable
    # ones. Engines running --role both/split advertise both.
    PREFILL = "prefill"
    DECODE = "decode"
    # Multi-LoRA serving (docs/lora.md): a tpu:// engine started with
    # --lora-dir advertises "lora" on its base model entry ("I can hot-load
    # any adapter in my store") and one extra model entry per RESIDENT
    # adapter (`base:adapter`). The balancer routes adapter traffic to
    # endpoints where it is already hot and falls back to any lora-capable
    # endpoint — triggering a hot-load — before 404ing.
    LORA = "lora"


class Role(str, enum.Enum):
    ADMIN = "admin"
    VIEWER = "viewer"


class Permission(str, enum.Enum):
    """API-key permission scopes (parity: reference common/auth.rs:59-97)."""

    OPENAI_INFERENCE = "openai.inference"
    OPENAI_MODELS_READ = "openai.models.read"
    ENDPOINTS_READ = "endpoints.read"
    ENDPOINTS_MANAGE = "endpoints.manage"
    USERS_MANAGE = "users.manage"
    INVITATIONS_MANAGE = "invitations.manage"
    LOGS_READ = "logs.read"
    METRICS_READ = "metrics.read"
    REGISTRY_READ = "registry.read"


class TpsApiKind(str, enum.Enum):
    """Which API family a TPS measurement belongs to."""

    CHAT = "chat"
    COMPLETION = "completion"
    RESPONSES = "responses"
    EMBEDDINGS = "embeddings"
    OTHER = "other"


@dataclasses.dataclass
class AcceleratorInfo:
    """Chip/HBM + engine-load telemetry reported by an endpoint's health probe.

    The scheduler (balancer.select_endpoint) folds these into placement:
    HBM pressure and engine queue depth demote an endpoint relative to its
    measured TPS (the reference read GPU fields for display only,
    health/endpoint_checker.rs:515 — acting on them is a TPU-native extension).
    """

    accelerator: str | None = None  # "tpu" | "gpu" | ...
    chip_count: int = 0
    hbm_used_bytes: int = 0
    hbm_total_bytes: int = 0
    utilization: float | None = None
    # Engine load figures (tpu:// engines report these in /api/health):
    queue_depth: int = 0  # requests waiting for a slot
    active_slots: int = 0
    num_slots: int = 0
    # Disaggregation role from the engine's /api/health disagg block
    # (docs/disaggregation.md): "both" | "split" | "prefill" | "decode";
    # None for endpoints that do not advertise one (treated as "both").
    # Re-parsed on every probe, so a restarted engine whose role changed
    # re-routes within one probe interval.
    role: str | None = None
    # Graceful drain advertisement (docs/deployment.md): a draining engine
    # still answers probes (status stays online — its models must not 404)
    # but is ejected from selection (balancer._permitted) within one probe
    # interval; `drain_remaining_s` feeds the gateway's Retry-After when
    # every endpoint for a model is draining.
    draining: bool = False
    drain_remaining_s: float = 0.0
    # Multi-LoRA advertisement from the engine's /api/health lora block
    # (docs/lora.md): None when the endpoint does not serve adapters;
    # otherwise the RESIDENT (hot) adapter names. Re-parsed every probe —
    # the health checker mirrors it into `base:adapter` model entries so
    # adapter routing sees hot-loads/evictions within one probe interval.
    lora_loaded: tuple[str, ...] | None = None
    # Every SERVABLE adapter in the endpoint's store (resident or not).
    # Lets the gateway refuse an adapter NO endpoint could hot-load with a
    # clean 400 naming the field, instead of proxying to a certain
    # engine-side 400 (which the resilience layer normalizes to 502). An
    # adapter dropped into a store propagates here within one probe.
    lora_available: tuple[str, ...] | None = None
    sampled_at: float = 0.0  # when the probe captured this; 0 = never

    @property
    def hbm_pressure(self) -> float | None:
        if self.hbm_total_bytes <= 0:
            return None
        return self.hbm_used_bytes / self.hbm_total_bytes


@dataclasses.dataclass
class Endpoint:
    name: str
    base_url: str
    id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)
    api_key: str | None = None
    endpoint_type: EndpointType = EndpointType.OPENAI_COMPATIBLE
    status: EndpointStatus = EndpointStatus.PENDING
    latency_ms: float | None = None
    consecutive_failures: int = 0
    # In-band circuit-breaker state (gateway/resilience.py), mirrored here by
    # the registry so every endpoint listing carries it. Transient: not
    # persisted — a restarted gateway starts with closed breakers.
    breaker_state: str = "closed"
    accelerator: AcceleratorInfo = dataclasses.field(default_factory=AcceleratorInfo)
    created_at: float = dataclasses.field(default_factory=time.time)
    updated_at: float = dataclasses.field(default_factory=time.time)
    last_checked_at: float | None = None

    @property
    def url(self) -> str:
        return self.base_url.rstrip("/")


@dataclasses.dataclass
class EndpointModel:
    endpoint_id: str
    model_id: str  # engine-local name (e.g. "llama3:8b" on ollama)
    canonical_name: str  # canonical name exposed by the gateway
    capabilities: list[Capability] = dataclasses.field(
        default_factory=lambda: [Capability.CHAT_COMPLETION]
    )
    context_length: int | None = None
    created_at: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass
class HealthCheckResult:
    endpoint_id: str
    ok: bool
    latency_ms: float | None
    error: str | None = None
    accelerator: AcceleratorInfo | None = None
    models_payload: dict | None = None  # /v1/models body captured by the probe
    checked_at: float = dataclasses.field(default_factory=time.time)
