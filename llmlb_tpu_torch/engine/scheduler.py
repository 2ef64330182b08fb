"""Continuous-batching engine core: counterpart of `EngineCore` in
`llmlb_tpu/engine/scheduler.py`.

The step loop runs on one thread and owns every device tensor. Each
iteration it:

1. admits queued requests into free slots (`_try_insert`): a prompt whose
   head the prefix cache holds claims a slot for its uncached suffix alone
   (`_insert_cached`); otherwise pages are reserved for the whole prompt up
   front, same-bucket prompts prefill together in one dispatch
   (`_prefill_group`, at most MAX_PREFILL_GROUP, padded to a power of two
   by repeating the last row), and prompts longer than the largest bucket
   claim a slot for chunked prefill (`_insert_long`);
2. feeds ONE chunk of one long prompt (`_advance_prefill`), so decode steps
   interleave with a long prefill;
3. runs a k-step decode burst over every decoding slot (`_decode_active`):
   each step's sampled tokens feed the next on the device, and the host
   syncs once per burst, through one `.cpu()` of the [k+1, slots] token block
   (row 0 carries first tokens sampled at activation). On the card the burst
   is one CUDA graph replay per (window bucket, seeded) key
   (`engine/decode_graph.py`, the JAX engine's one program per burst),
   captured after the key's first burst, which runs eagerly; on the CPU, or
   with `decode_graphs=False`, every burst runs eagerly.

KV layout (`kv_layout=` / LLMLB_KV_LAYOUT): "paged" (the default) backs
every slot with pages of a shared pool through a block table; "dense" keeps
one contiguous row of `slot_capacity` positions per slot, [L, slots, cap, K,
D], and dispatches the slot entry points (`prefill_into_slots`,
`prefill_extend_slots`, `decode_step`); the page pool and tables do not
exist then.

int8 quantization (`quantize=` / LLMLB_QUANTIZE, off by default) is the
reference's: projection weights quantized on the device one layer at a
time, and int8 KV pools with one float32 scale per (token, head) vector
(paged only: the dense cache stays in the model dtype, with the reference's
warning).

Prefix KV cache (`prefix_cache=` / LLMLB_PREFIX_CACHE, on by default, as
in the reference): a request that finishes with "stop" or "length" donates
its prompt's head, aligned down to `prefix_align`, to a radix tree keyed on
token ids (engine/prefix_cache.py), one tree per adapter. A later prompt
sharing that head takes it from the cache: paged, the donor's page ids go
into the new row's block table with a refcount (no KV byte moves); dense,
the donor slot stays pinned out of the serving pool and a hit copies its
rows [0, use_len) on the device. Either way only the uncached suffix
prefills, through the extend entry points at start = use_len. Donors are
evicted LRU under page pressure (paged), slot pressure with requests
queued (dense), or when the budget of `prefix_cache_slots` entries is full.

Multi-LoRA (`lora_dir=` / LLMLB_LORA_DIR, off by default): a LoraManager
pool rides the params as `<name>_lora_a/_lora_b` leaves (added after any
weight quantization), a request names its adapter in `SamplingParams.lora`,
pinned at submit and released at its terminal event, and every dispatch
carries per-row pool rows (`lora_idx`); the decode rows live on the device
in `_d_lora_idx`, set at activation, so a burst copies none.

Overload protection, as in the reference: requests queue by priority class
(0 high, 1 normal, 2 low; strict between classes, FIFO within one), a
request still queued past its deadline is shed before it costs a prefill
(`_shed_expired`), and a decoding row of a less important class is parked
(`_park_slot`: pages back to the pool, requeued at the front of its class)
when a more important request finds no free slot, when a more important
row needs pages, or, as a last resort before "length", when the pool
cannot cover a row while others decode. Parks happen only between bursts
(a burst is one graph replay; no buffer is reallocated). A drain
(`begin_drain`) admits nothing more; the server then asks the loop to park
every decoding row (`request_drain_park`) and to end everything queued
(`request_drain_flush`).

Exact resume. The reference resumes by chunk-prefilling prompt + committed
tokens in one pass; on the card that writes the committed tokens' KV
through another product shape than the decode steps that wrote it first,
and its logits move (ROADMAP C4). Here a resumed row prefills its PROMPT
alone, in the cold run's own chunks and buckets; its last token going in
is committed[0] (the activation sample is not used, and nothing is
emitted); then decode steps are fed committed[1:] in place of their samples
through the burst's forced-token buffer (`engine/decode_graph.py`), so
every committed token's KV is written by a decode step, as in the
uninterrupted run, while the other rows decode on. The first new token's
logits are then the uninterrupted run's, bit for bit on the card. The
same path serves the service's `adopt_stream` (/v1/resume).

KV page shipping (`kv_ship=` / LLMLB_KV_SHIP, on by default as in the
reference, paged layout only): a row parked while the engine drains, or
parked on request for a migration (`request_park`, behind POST
/v1/kv/export {"park": true}), leaves its pages' bytes behind as a KVSH
payload (engine/kv_transfer.py: one `index_select` over the pools and one
device-to-host copy per section), taken once by `take_kv_export`. A request
that arrives with such a payload on `Request.kv_restore` (an adoption,
`Engine.adopt_stream`) lands it into fresh pages with one `index_copy_`
per section and enters decode at seq_len = n - 1 with its last committed
token pending (`_insert_restored`): no prefill and no forced tokens; the
next decode step writes position n - 1 as the uninterrupted run did, so
the exact-resume contract holds by construction, the landed rows being the
origin's own. The land is not captured in a graph (it runs between bursts),
so unlike the reference it pads nothing, and a landed row adds no decode
graph key. Any refusal counts its labelled reason and takes the replay
path.

Host-RAM offload tier (`kv_offload_bytes=` / LLMLB_KV_OFFLOAD_BYTES, 0 =
off by default, paged only; engine/kv_offload.py): a prefix entry evicted
under page pressure and a parked row's pages spill to host memory; a later
prompt with that head lands it back before the live-cache match, and the
parked row re-activates from it instead of replaying.

Structured outputs (`SamplingParams.constraint`, compiled by the
service's `ConstraintCompiler` onto `Request.compiled_constraint`), as in
the reference: each constrained row carries a host FSM cursor
(`ConstraintState`, advanced in `_emit` on every emitted token, the source
of truth). Its first token is sampled under its start state's mask, and a
constrained activation makes one synchronous fetch to advance the cursor.
With `fused_decode` (kwarg, then LLMLB_FUSED_DECODE, then on for paged and
off for dense) the schema is registered in the device grammar table
(`ops/grammar.py`) and its rows decode inside the burst's graph under the
grammar key, the host writing each row's cursor before a burst. A schema
the table's budget cannot hold (or `fused_decode` off) takes the host-mask
fallback: one step (k = 1) biased by a static [slots, V] buffer whose rows
the host refreshes, counted as a constrained-burst fallback where the burst
is longer. Once a schema is refused, every constrained row keeps a host row
too (the reference's one-way `_grammar_fallback`); a step whose constrained
rows are all resident still runs the grammar key. A park keeps the cursor,
which already stands after every committed token, so the forced cells of a
resume leave it where it is; a landed row takes it as it was parked.

Speculative decoding (`spec_decode=` / LLMLB_SPEC_DECODE, off by default,
as in the reference; a request opts in or out with `speculative:
{"enabled", "max_draft_tokens"}`): a speculating row carries a
prompt-lookup drafter (llmlb_tpu_torch/spec), attached at activation
(`_activate_group`, `_insert_restored`) and indexed over the prompt and
every emitted token. When any active row proposes drafts, ONE verify step
replaces the burst (`_verify_active`): every active row's last token plus
its drafts (a 1-token chunk for a row with none; an empty chunk for a slot
outside the step) run as a K+1-token extend, every
position is sampled (seeded rows fold their seed by global position, as
plain decode does), the accepted count and each row's advance are computed
on the device, and the host emits 1..K+1 tokens a row and releases the
pages of rejected drafts (`_trim_slot_pages`). On the card the step is one
graph replay per verify key (window bucket, seeded, mode), the burst's
graphs' own kind (engine/decode_graph.py `verify_body`), with one host
fetch; a constrained row rides it under the grammar key (its columns'
masks walked from the device table) or, off the table or with fused decode
off, under the mask key (a [slots, K+1, V] buffer the host writes from its
FSM lookahead along drafts cut at the grammar). A verify step takes no
row with forced tokens pending (a C4 resume): while one is fed, the step
is a burst, in which the drafting rows decode plainly. A parked row keeps its drafter. No n-gram
match: the burst, with no trace.

Prefill chunk budget (`prefill_chunk_budget=` / LLMLB_PREFILL_CHUNK_BUDGET,
0 = off): while some row decodes, an iteration prefills at most `budget`
prompt tokens (at least one chunk), so the decoders' fetches are never
further apart than about one budget-sized chunk. C3 (a prefix hit equals
its cold run bit for bit) needs a row's chunking not to depend on whether
others decode, so with a budget set EVERY prompt longer than the budget's
bucket (the largest prefill bucket within it) runs in chunks of that
bucket, whether or not rows decode, and a hit's suffix follows those
chunks; the budget itself only decides whether a chunk or a one-shot group
waits for the next iteration. (The reference caps chunks only while rows
decode, so a prompt's chunks there depend on the traffic.)

Observability, as in the reference: every dispatch (a prefill group or
chunk, a decode burst, a verify step) writes one step record
(engine/stepstats.py, `_record_step`) with its phases on the host clock
and, on the card, `device_ms`: the time between two CUDA events recorded
around the dispatch, outside any capture. A burst's or verify step's
`compute` phase is the host's wait on the second event, the wait its one
fetch paid before (no second sync); a prefill is never waited for, so its
events are read at a later record, once they completed. Each lifecycle edge
of a request writes a flight-recorder event (engine/flightrec.py,
`_fr_emit`; every terminal event goes through `_finish`, which emits it),
and `metrics` (engine/metrics.py) keeps the latency and step histograms;
`perf_info()` is the live roofline from the records' decode window.

Disaggregation (`role=` / LLMLB_ROLE, "both" by default, as in the
reference). "split" runs a prefill pool and a decode pool of slots as two
step-loop threads over the one page pool (llmlb_tpu_torch/disagg/split.py):
a prefill-loop activation stages the row instead (`_activate_group`), and
the handoff pump adopts it into a decode slot by moving its block-table
row; the decode loop decodes its pool only. Every prefill and decode
dispatch is counted by the loop that ran it (`prefill_dispatch_by_loop`,
`decode_dispatch_by_loop`: "main", "prefill", "decode", or "handoff" for an
adoption), so the split's invariant, no prefill on the decode loop, is
read off a ledger. "prefill" and "decode" serve the cross-process handoff
(the server's /v1/handoff routes): a request with `export_kv` that finishes
on its "length" budget leaves its pages' bytes on `kv_export`
(`_kv_export_payload`), for the decode engine to land. Split needs the
paged layout and at least two slots, and turns KV shipping and the
offload tier off, as in the reference.

Multi-rank serving (`mesh_config=`, parallel/): with a torch.distributed
world of more than one rank, the engine's params are each rank's shard of
a (dp, sp, ep, tp) mesh (`family.shard_params`; the mesh laid as the
reference lays it, parallel/distributed.py `engine_mesh`: by default ep =
gcd(ranks of a host, experts) for MoE, then tp = default_tp within the
host, dp the rest, multiplied across hosts), and the model's entry points
run with the mesh, whose collectives join the ranks. Every rank runs this
loop in lockstep (engine/multihost.py): the leader (rank 0) takes requests
through `submit` into an intake queue, and at the top of each iteration
broadcasts a plan (new requests, cancellations, stop; `_lockstep_tick`);
every rank applies it, so all ranks make the same scheduling decisions and
dispatch the same forwards. Cancellations act only through the plan
(`_is_cancelled`), deadlines are shed at the leader only
(`_collect_plan`), adapters are pinned in plan order on every rank
(`_plan_acquire`; `--lora-dir` is refused across hosts, as the
reference). Everything else the leader's HTTP threads set rides the plan
too, so it acts on the same tick on every rank: a new request's parked
state (an adoption's committed ids: each rank rebuilds the grammar cursor
and the drafter), its shipped pages' header and its handoff export flag,
the drain and its parks and flush, a migration's parks, and the encode
forwards of /v1/embeddings (`encode`, whose work items every rank runs).
KV shipping, the offload tier and `--role split` serve on one host's
ranks, as the reference's one-process mesh serves them, and are off or
refused across hosts: an export gathers the row's KV heads over tp to
the leader (`Mesh.gather_heads`), which writes the whole model's KVSH
payload; a landed payload goes from the leader to every rank over the
mesh (`Mesh.broadcast`), each keeping its heads; the offload tier holds
each rank's share, charged at the whole payload's bytes, so every rank's
tier admits and evicts alike. At dp > 1 slot s belongs to dp group
`_slot_groups[s]`, and every dispatch passes its rows' groups
(`_mesh_kw`): a group computes its own rows, and one collective over dp a
dispatch gives every rank the batch's logits (the sampler runs unchanged
over the whole batch on every rank) and, paged, the KV cells each group
wrote (the pool is replicated over dp, so a prefix hit, a park and resume
or a chunk reads any page); the dense cache holds a group's slots. An
MoE's capacity dispatch stays the whole batch's: a dispatch spanning dp
groups gathers each layer's tokens over dp (models/mixtral.py). On an
sp > 1 mesh a prompt longer than the largest bucket prefills in one
ring-attention pass (`_cp_prefill_into_slot`, models/llama.py
`make_context_parallel_prefill`) instead of chunks. On one
rank (no process group) every collective is the identity and the model's
entry points get `mesh=None`: the one-rank engine runs as it did.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import math
import os
import queue
import threading
import time
import uuid

import numpy as np
import torch

from llmlb_tpu_torch.device import resolve_device
from llmlb_tpu_torch.disagg import normalize_role
from llmlb_tpu_torch.disagg.split import SplitRuntime
from llmlb_tpu_torch.engine.decode_graph import (
    BurstGraphs,
    BurstState,
    burst_body,
    count_nan_rows,
    cuda_capture,
    verify_body,
)
from llmlb_tpu_torch.engine.flightrec import FlightRecorder, gateway_rid
from llmlb_tpu_torch.engine.kv_offload import KVOffloadTier
from llmlb_tpu_torch.engine.kv_transfer import (
    KV_WIRE_VERSION,
    KVPages,
    KVWireHeader,
    expected_sections,
    kv_compat_reason,
    serialize_kv_pages,
)
from llmlb_tpu_torch.engine.metrics import EngineMetrics
from llmlb_tpu_torch.engine.multihost import (
    _MAX_PLAN_BYTES,
    PlanTooLarge,
    StepCoordinator,
)
from llmlb_tpu_torch.engine.paging import PagePool
from llmlb_tpu_torch.engine.prefix_cache import PrefixCache, PrefixEntry
from llmlb_tpu_torch.engine.stepstats import StepRecorder
from llmlb_tpu_torch.engine.telemetry import (
    chip_spec_for,
    device_kind,
    model_bytes_per_token,
    model_flops_per_token,
)
from llmlb_tpu_torch.lora import LoraManager
from llmlb_tpu_torch.models import family_for
from llmlb_tpu_torch.models.llama import LlamaConfig
from llmlb_tpu_torch.ops.grammar import GrammarTables
from llmlb_tpu_torch.ops.sampling import sample_tokens
from llmlb_tpu_torch.parallel.distributed import engine_mesh, ranks_per_host
from llmlb_tpu_torch.parallel.mesh import MeshConfig, slot_groups
from llmlb_tpu_torch.quant import (
    SCALE_SUFFIX,
    kv_cell_bytes,
    parse_quant_mode,
    quantize_params,
)
from llmlb_tpu_torch.spec import PromptLookupDrafter, SpecConfig
from llmlb_tpu_torch.structured.constraint import (
    ConstraintState,
    TokenConstraint,
)

log = logging.getLogger("llmlb_tpu_torch.engine.scheduler")

# Priority classes, as the reference's: lower is more important.
PRIORITY_HIGH, PRIORITY_NORMAL, PRIORITY_LOW = 0, 1, 2
PRIORITY_CLASSES = (PRIORITY_HIGH, PRIORITY_NORMAL, PRIORITY_LOW)
PRIORITY_NAMES = {PRIORITY_HIGH: "high", PRIORITY_NORMAL: "normal",
                  PRIORITY_LOW: "low"}

# The reasons a KV page move falls back to the replay path, the reference's
# closed label set.
KV_FALLBACK_REASONS = ("disabled", "absent", "version", "dtype",
                       "page_size", "geometry", "capacity", "error")

@dataclasses.dataclass
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    max_tokens: int = 128
    # Rows with a seed draw JAX's fold_in(PRNGKey(seed), position) stream,
    # so the token sequence reproduces whatever else shares the batch and
    # matches the JAX engine's.
    seed: int | None = None
    # LoRA adapter name (the `lora` field or a `model:adapter` suffix);
    # None serves the base model (pool row 0, the identity adapter).
    lora: str | None = None
    # Priority class: 0 high, 1 normal, 2 low. Admission is strict by
    # class, and a less important decoding row may be parked for a more
    # important request, to resume token-identical.
    priority: int = 1
    # Speculative decoding knobs, {"enabled": bool, "max_draft_tokens": int}:
    # absent keys take the engine's defaults, and max_draft_tokens clamps
    # into the engine's verify width.
    speculative: dict | None = None
    # Relative deadline from submission (X-Request-Deadline-Ms): a request
    # still queued past it is shed before its prefill.
    deadline_ms: float | None = None
    # Grammar constraint spec (the `spec_regex` forms of
    # structured/constraint.py); the compiled token DFA rides
    # Request.compiled_constraint.
    constraint: dict | None = None


@dataclasses.dataclass
class ParkedState:
    """What a parked request needs to resume token-identical: the tokens it
    already committed (every one emitted), its generation count, its
    grammar cursor, which already stands after every committed token (a
    resume must never re-walk it from the start state), and its drafter,
    whose index already holds prompt and committed tokens, with its draft
    budget. Seeded rows fold their seed by absolute position, so sampling
    needs no state here."""

    generated: int
    tokens: list[int]
    constraint: ConstraintState | None = None
    drafter: PromptLookupDrafter | None = None
    spec_k: int = 0


@dataclasses.dataclass
class Request:
    prompt_ids: list[int]
    sampling: SamplingParams
    request_id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)
    # events: ("token", token_id) ... ("done", finish_reason) | ("error", msg)
    events: queue.SimpleQueue = dataclasses.field(default_factory=queue.SimpleQueue)
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    first_token_at: float | None = None
    finished_at: float | None = None
    # Set by the consumer (stop hit / client gone); the step loop frees the
    # slot at its next emit for this request. A plain bool write.
    cancelled: bool = False
    # Set when the request is parked (or adopted with committed tokens) and
    # consumed at its re-activation: the prompt prefills, then the
    # committed tokens are fed through decode steps.
    parked: ParkedState | None = None
    # A parked request's KV pages as a parsed payload (an adoption's wire
    # payload, or the offload tier's spill): landed at re-activation in
    # place of the replay. One-shot: cleared at first use, landed or not.
    kv_restore: KVPages | None = None
    # The token DFA of sampling.constraint, compiled by the service before
    # the submit (or by the core at admission, `_prepare_constraint`).
    compiled_constraint: TokenConstraint | None = None
    # A handoff's prefill side (the service's `prefill_handoff`) asks for
    # this request's KV pages at its budgeted "length" finish, before they
    # free: the serialized payload lands on `kv_export`.
    export_kv: bool = False
    kv_export: dict | None = None

    def cancel(self) -> None:
        self.cancelled = True

    def deadline_expired(self) -> bool:
        dl = self.sampling.deadline_ms
        return (dl is not None
                and time.monotonic() > self.submitted_at + float(dl) / 1000.0)


@dataclasses.dataclass
class _Slot:
    request: Request | None = None
    generated: int = 0
    # Chunked prefill: while prefilling, the slot is excluded from decode
    # emission and its device seq_len is parked at capacity-1, so the batched
    # decode step's garbage writes land in the unused last cell.
    prefilling: bool = False
    prefill_pos: int = 0
    # The first token is sampled on the device at activation and emitted
    # with the next decode fetch instead of its own host readback.
    first_pending: bool = False
    # A prefix-cache hit holds its donor entry until the suffix lands.
    cache_entry: PrefixEntry | None = None
    # Every token emitted so far (EOS excluded): a park keeps them.
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    # A resumed row's committed tokens still to be fed through decode steps
    # in place of their samples (emitted before the park: not again).
    forced: list[int] = dataclasses.field(default_factory=list)
    # The grammar cursor of a constrained row, and its schema's row offset
    # in the device grammar table (-1: not resident, the host-mask path).
    constraint: ConstraintState | None = None
    gram_offset: int = -1
    # the cursor already stands after the pending first token (activation
    # advanced it): its emission must not advance it again
    first_advanced: bool = False
    # a speculating row's prompt-lookup drafter and draft budget a step
    drafter: PromptLookupDrafter | None = None
    spec_k: int = 0
    # monotonic time of the row's last emitted token (0: none yet)
    last_emit_at: float = 0.0
    # Split mode: a prefill-pool row whose prompt KV has landed waits here
    # for a decode slot, its final logits row held on the device (the first
    # token samples from it at adoption), since `handoff_ready_at`
    # (monotonic).
    handoff_ready: bool = False
    handoff_logits: torch.Tensor | None = None
    handoff_ready_at: float = 0.0
    handoff_seq: int = 0  # its place in the staging order

    def clear(self) -> None:
        self.request = None
        self.generated = 0
        self.prefilling = False
        self.prefill_pos = 0
        self.first_pending = False
        self.cache_entry = None
        self.out_tokens = []
        self.forced = []
        self.constraint = None
        self.gram_offset = -1
        self.first_advanced = False
        self.drafter = None
        self.spec_k = 0
        self.last_emit_at = 0.0
        self.handoff_ready = False
        self.handoff_logits = None
        self.handoff_ready_at = 0.0
        self.handoff_seq = 0


def kv_cache_bytes(cfg: LlamaConfig, num_slots: int, slot_capacity: int) -> int:
    """Device bytes of the DENSE slot cache [L, slots, cap, K, D] x 2 (K and
    V) in the model dtype."""
    return (cfg.num_layers * num_slots * slot_capacity * cfg.num_kv_heads
            * cfg.head_dim_ * 2 * cfg.dtype.itemsize)


def kv_page_bytes(cfg: LlamaConfig, page_size: int,
                  quantized: bool = False) -> int:
    """Device bytes ONE page holds across all layers, K and V included: a
    cell is D values of the model dtype, or D int8 codes plus one float32
    scale (quant.kv_cell_bytes)."""
    itemsize = cfg.dtype.itemsize
    cell = kv_cell_bytes(cfg.head_dim_, quantized, itemsize)
    return int(cfg.num_layers * page_size * cfg.num_kv_heads * 2 * cell)


def kv_pool_bytes(cfg: LlamaConfig, num_pages: int, page_size: int,
                  quantized: bool = False) -> int:
    """Device bytes of the paged pool [L, pages, page_size, K, D] x 2 (K and
    V; int8 pools include their scale arrays)."""
    return num_pages * kv_page_bytes(cfg, page_size, quantized)


@dataclasses.dataclass
class PrefixCounters:
    """The prefix cache's event counters, under the reference's metric
    names: hits and misses per admitted prompt long enough to match,
    prompt tokens served from cached KV, donations and the tokens they
    cover, and LRU evictions; and the dense hits' device row copies (a
    paged hit makes none)."""

    prefix_hits_total: int = 0
    prefix_misses_total: int = 0
    prefix_cached_tokens_total: int = 0
    prefix_insertions_total: int = 0
    prefix_inserted_tokens_total: int = 0
    prefix_evictions_total: int = 0
    kv_copy_dispatches: int = 0


@dataclasses.dataclass
class KVShipCounters:
    """KV page movement, under the reference's metric names: payloads
    gathered to the host (exports and offload spills) with their bytes and
    seconds, payloads landed in the pool (wire or offload), and the moves
    that fell back to the replay path, by reason."""

    kv_ship_total: int = 0
    kv_ship_bytes_total: int = 0
    kv_ship_seconds_total: float = 0.0
    kv_restored_total: int = 0
    kv_restored_bytes_total: int = 0
    kv_ship_fallback_total: dict = dataclasses.field(
        default_factory=lambda: {r: 0 for r in KV_FALLBACK_REASONS})


@dataclasses.dataclass
class StructuredCounters:
    """Structured outputs, under the reference's metric names: constrained
    requests attached (resumes not counted again), masked decode bursts,
    constraint violations (a grammar cut short, or a sample it refused),
    bursts cut to one step by a schema off the device table, and the
    compiler's mask-cache hits, misses and evictions (its compile seconds
    are EngineMetrics' histogram)."""

    structured_requests_total: int = 0
    masked_decode_steps_total: int = 0
    constraint_violations_total: int = 0
    constrained_burst_fallback_total: int = 0
    mask_cache_hits_total: int = 0
    mask_cache_misses_total: int = 0
    mask_cache_evictions_total: int = 0


@dataclasses.dataclass
class SpecCounters:
    """Speculative decoding, under the reference's `spec_info` names: verify
    steps run, draft tokens proposed, drafts accepted, and the tokens the
    speculating rows emitted (accepted + 1 a row a step)."""

    verify_steps_total: int = 0
    draft_tokens_total: int = 0
    accepted_tokens_total: int = 0
    emitted_tokens_total: int = 0

    @property
    def acceptance_rate(self) -> float | None:
        drafted = self.draft_tokens_total
        return (round(self.accepted_tokens_total / drafted, 4) if drafted
                else None)


class _StructuredMetrics:
    """The ConstraintCompiler's metric hooks (the reference hands it its
    EngineMetrics), counting into the core's StructuredCounters under the
    core's lock (the compiler runs on HTTP threads), and its compile
    seconds into the core's EngineMetrics."""

    def __init__(self, counters: StructuredCounters, lock,
                 metrics: EngineMetrics):
        self._c, self._lock, self._metrics = counters, lock, metrics

    def record_mask_cache_hit(self) -> None:
        with self._lock:
            self._c.mask_cache_hits_total += 1

    def record_mask_cache_miss(self) -> None:
        with self._lock:
            self._c.mask_cache_misses_total += 1

    def record_mask_cache_eviction(self) -> None:
        with self._lock:
            self._c.mask_cache_evictions_total += 1

    def record_schema_compile(self, seconds: float) -> None:
        self._metrics.record_schema_compile(float(seconds))


@dataclasses.dataclass(frozen=True)
class EngineStats:
    num_slots: int
    active_slots: int
    queued: int
    total_requests: int
    total_tokens: int
    uptime_s: float
    # decode bursts run as graph replays and eagerly (a key's warm-up, or
    # every burst without graphs), and the (window, seeded, mode) keys
    # captured: the counterpart of the JAX engine's per-step `dispatches`
    decode_graph_replays: int = 0
    decode_eager_bursts: int = 0
    decode_graphs: int = 0
    # a copy of the prefix cache's counters
    prefix: PrefixCounters = dataclasses.field(default_factory=PrefixCounters)
    # overload protection, under the reference's names: parks (priority,
    # pages or drain), re-activations of parked or adopted requests,
    # requests shed at admission past their deadline, and the drain's parks
    preemptions_total: int = 0
    preempt_resumes_total: int = 0
    deadline_shed_total: int = 0
    drain_parked_total: int = 0
    # a copy of the KV page movement counters
    kv: KVShipCounters = dataclasses.field(default_factory=KVShipCounters)
    # a copy of the structured-output counters
    structured: StructuredCounters = dataclasses.field(
        default_factory=StructuredCounters)
    # verify steps run as graph replays and eagerly, and the verify keys
    # captured; and a copy of the speculative decoding counters
    verify_graph_replays: int = 0
    verify_eager_steps: int = 0
    verify_graphs: int = 0
    spec: SpecCounters = dataclasses.field(default_factory=SpecCounters)
    # steps the slow-step detector flagged, and whether the engine drains
    slow_steps_total: int = 0
    draining: bool = False


class EngineCore:
    """The compute side of the engine: owns params, the KV cache (page pool
    or slot cache), the adapter pool and the step loop."""

    # Same-bucket pending prompts prefill together in one dispatch; bounded
    # so a deep backlog cannot starve decode for longer than one group.
    MAX_PREFILL_GROUP = 8

    def __init__(
        self,
        cfg: LlamaConfig,
        params: dict[str, torch.Tensor] | None = None,
        *,
        num_slots: int = 8,
        slot_capacity: int = 512,
        prefill_buckets: tuple[int, ...] = (32, 64, 128, 256, 512),
        eos_id: int = -1,
        seed: int = 0,
        decode_burst: int | None = None,
        kv_page_size: int | None = None,
        kv_pages: int | None = None,
        device: str | torch.device | None = None,
        quantize: str | None = None,
        kv_layout: str | None = None,
        lora_dir: str | None = None,
        lora_max_adapters: int | None = None,
        lora_rank_cap: int | None = None,
        decode_graphs: bool | None = None,
        prefix_cache: bool | None = None,
        prefix_cache_slots: int | None = None,
        min_prefix_len: int | None = None,
        kv_ship: bool | None = None,
        kv_offload_bytes: int | None = None,
        fused_decode: bool | None = None,
        spec_decode: bool | None = None,
        spec_max_draft: int | None = None,
        spec_ngram: int | None = None,
        prefill_chunk_budget: int | None = None,
        role: str | None = None,
        disagg_prefill_slots: int | None = None,
        mesh_config: MeshConfig | None = None,
    ):
        self.device = resolve_device(device)
        # The serving role: "both" (the combined loop), "split" (a prefill
        # pool and a decode pool in this process, built at the end of
        # __init__ once the slots exist), or "prefill" / "decode", which
        # the server advertises and serves (the cross-process handoff).
        self.role = normalize_role(role if role is not None
                                   else os.environ.get("LLMLB_ROLE"))
        self.split: SplitRuntime | None = None
        # one CUDA graph per decode burst key: on by default on the card
        # (the JAX engine's fused_decode); the CPU never captures
        self.cfg = cfg
        # the model family's module (models/llama.py or models/mixtral.py):
        # every init and dispatch below goes through it
        self.family = family_for(cfg)
        # The mesh of ranks (one rank without a process group), the
        # rank's local view of the config (its heads, ffn width) that its
        # KV and forwards use, and the mesh the entry points get (None on
        # one rank, so the one-rank engine runs exactly as before).
        self.mesh = self._build_mesh(cfg, mesh_config)
        self.model_cfg = self.family.local_config(cfg, self.mesh)
        self._model_mesh = None if self.mesh.trivial else self.mesh
        if decode_graphs is None:
            decode_graphs = self.device.type == "cuda" and self.mesh.capturable
            if self.device.type == "cuda" and not self.mesh.capturable:
                log.warning("decode graphs off: the %s mesh's collectives "
                            "cannot be captured in a CUDA graph",
                            self.mesh.backend)
        if decode_graphs and not self.mesh.capturable:
            raise ValueError(
                f"decode_graphs=True needs collectives a CUDA graph can "
                f"capture (NCCL); this mesh's backend is {self.mesh.backend}, "
                "whose collectives go through host memory: pass "
                "decode_graphs=False")
        if decode_graphs and self.device.type != "cuda":
            raise ValueError("decode_graphs needs the CUDA card; the engine "
                             f"runs on {self.device}")
        self.decode_graphs = bool(decode_graphs)
        # Observability: latency and step histograms, the step records
        # (always on, a few clock reads a step) and the flight recorder
        # (LLMLB_FLIGHTREC=0 turns it off before its first clock read).
        self.metrics = EngineMetrics()
        self.step_stats = StepRecorder()
        self.flightrec = FlightRecorder()
        # admission time with no dispatch of its own, absorbed as the next
        # record's plan phase; and the (record seq, start, end) event pairs
        # of prefill records not read yet
        self._pending_plan_s = 0.0
        self._pending_device: list[tuple[int, object, object]] = []
        # the inter-token latency _emit records: the current dispatch's
        # per-token pacing
        self._emit_itl: float | None = None
        if kv_layout is None:
            kv_layout = os.environ.get("LLMLB_KV_LAYOUT", "paged")
        if kv_layout not in ("paged", "dense"):
            raise ValueError(
                f"kv_layout must be 'paged' or 'dense', got {kv_layout!r}")
        self.kv_layout = kv_layout
        # int8 knobs from `quantize` or LLMLB_QUANTIZE (off by default: every
        # path below is then the unquantized engine)
        self.quant = parse_quant_mode(quantize)
        if self.quant.kv and kv_layout != "paged":
            log.warning(
                "int8 KV quantization requires the paged layout; the dense "
                "slot cache stays %s (weights quantization, if requested, "
                "still applies)", str(cfg.dtype).replace("torch.", ""))
            self.quant = dataclasses.replace(self.quant, kv=False)
        self.num_slots = num_slots
        self.slot_capacity = min(slot_capacity, cfg.max_position_embeddings)
        self.prefill_buckets = tuple(
            b for b in sorted(prefill_buckets) if b <= self.slot_capacity
        )
        if not self.prefill_buckets:
            raise ValueError("no prefill bucket fits the slot capacity "
                             f"({self.slot_capacity})")
        self.eos_id = eos_id
        # The prefill chunk budget, resolved as the reference resolves it:
        # the prompt tokens an iteration may prefill while some row decodes
        # (0 = no cap). See the module's docstring for its chunking.
        if prefill_chunk_budget is None:
            try:
                prefill_chunk_budget = int(os.environ.get(
                    "LLMLB_PREFILL_CHUNK_BUDGET", "0") or 0)
            except ValueError:
                log.warning("LLMLB_PREFILL_CHUNK_BUDGET is not an integer; "
                            "budget disabled")
                prefill_chunk_budget = 0
        self.prefill_chunk_budget = max(0, int(prefill_chunk_budget))
        if (self.prefill_chunk_budget
                and self.prefill_chunk_budget < self.prefill_buckets[0]):
            # chunks run at prefill buckets, so a budget below the smallest
            # cannot be honored exactly
            log.warning(
                "prefill chunk budget %d is below the smallest prefill "
                "bucket; effective per-chunk floor is %d tokens",
                self.prefill_chunk_budget, self.prefill_buckets[0])
        # the bucket a chunked prompt's chunks run at: the budget's, or the
        # largest; prompts longer than it are chunked
        self._chunk_bucket = (
            self._budget_chunk_len(self.prefill_chunk_budget)
            if self.prefill_chunk_budget else self.prefill_buckets[-1])
        # prompt tokens the current iteration's one-shot group prefilled
        self._prefill_spent_iter = 0

        # Speculative decoding, resolved as the reference resolves it:
        # `spec_decode` is the default of requests without their own knob;
        # max_draft_tokens (at most 16) fixes the verify chunk's width K+1,
        # so the verify keys never vary per request.
        if spec_decode is None:
            spec_decode = os.environ.get("LLMLB_SPEC_DECODE", "0").lower() in (
                "1", "true", "on", "yes")
        if spec_max_draft is None:
            spec_max_draft = int(os.environ.get("LLMLB_SPEC_MAX_DRAFT", "4"))
        if spec_ngram is None:
            spec_ngram = int(os.environ.get("LLMLB_SPEC_NGRAM", "3"))
        self.spec = SpecConfig(
            enabled=bool(spec_decode),
            max_draft_tokens=max(1, min(int(spec_max_draft), 16)),
            max_ngram=max(1, int(spec_ngram)), min_ngram=1)
        self.spec_counters = SpecCounters()

        # Page size: 128 tokens by default, clamped into the slot capacity.
        self.kv_page_size = max(1, min(kv_page_size or 128, self.slot_capacity))
        self.pages_per_slot = -(-self.slot_capacity // self.kv_page_size)
        # dp groups: slot s belongs to group slot_groups(...)[s]; a group
        # computes its own rows of every dispatch. The dense cache holds a
        # group's slots (so dp must divide them, as the reference's
        # sharding demands); the page pool is replicated over dp.
        dp = self.mesh.shape["dp"]
        self._slot_groups = slot_groups(num_slots, dp)
        if dp > 1 and kv_layout == "dense" and num_slots % dp:
            raise ValueError(
                f"the dense slot cache shards its {num_slots} slots over "
                f"dp={dp}, which must divide them (the paged layout takes "
                "any slot count)")
        # Default pool: every slot's full capacity plus the trash page; at
        # dp the reference's per-device dense budget, ceil(slots / dp)
        # slots' pages plus the trash page.
        self.kv_num_pages = 0
        if kv_layout == "paged":
            self.kv_num_pages = max(
                int(kv_pages or -(-num_slots // dp) * self.pages_per_slot + 1),
                self.pages_per_slot + 1,
            )
            if dp > 1:
                log.info(
                    "paged KV pool replicates over dp=%d; defaulting to the "
                    "per-device dense budget (%d pages) — raise --kv-pages "
                    "to trade HBM for aggregate capacity", dp,
                    self.kv_num_pages)

        # Prefix KV cache, resolved as the reference resolves it. Matched
        # lengths align DOWN to the smallest prefill bucket, and paged to
        # whole pages as well (only FULL pages can be shared zero-copy), so
        # the quantum is lcm(bucket, page size) there.
        if prefix_cache is None:
            prefix_cache = os.environ.get(
                "LLMLB_PREFIX_CACHE", "1").lower() not in ("0", "false", "off",
                                                           "no")
        self.prefix_align = self.prefill_buckets[0]
        if kv_layout == "paged":
            self.prefix_align = math.lcm(self.prefix_align, self.kv_page_size)
        self.min_prefix_len = (max(1, int(min_prefix_len))
                               if min_prefix_len is not None
                               else self.prefix_align)
        if prefix_cache_slots is None:
            prefix_cache_slots = max(1, num_slots // 2)
        # pinned donors must always leave at least one slot serving traffic
        budget = max(0, min(int(prefix_cache_slots), num_slots - 1))
        self.prefix_cache: PrefixCache | None = (
            PrefixCache(max_entries=budget, min_len=self.min_prefix_len,
                        align=self.prefix_align)
            if prefix_cache and budget > 0 else None)
        self.prefix_counters = PrefixCounters()
        # page REFERENCES the cache's entries hold (entries sharing head
        # pages each count theirs)
        self._prefix_pinned_pages = 0

        self.init_seconds: float | None = None  # the random init's, if any
        sharded = False
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            t_init = time.perf_counter()
            # int8 weights are filled and quantized a matrix at a time:
            # Mixtral-8x7B's bf16 leaves (93 GB) would not fit the card
            # on a mesh each rank keeps its shard of each leaf as it fills
            params = self.family.init_params(
                cfg, gen, self.device, quantize_weights=self.quant.weights,
                mesh=self._model_mesh)
            sharded = not self.mesh.trivial
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.init_seconds = time.perf_counter() - t_init
            log.info("weights: random init from seed %d in %.1f s%s", seed,
                     self.init_seconds,
                     " (int8 as filled)" if self.quant.weights else "")
        for name, p in params.items():
            if p.device != self.device:
                raise ValueError(f"param {name!r} is on {p.device}, the engine "
                                 f"runs on {self.device}")
        if self.quant.weights:
            # on the device, one layer at a time; an already-quantized
            # pytree passes through
            params = quantize_params(params)
        if not (self.mesh.trivial or sharded):
            # each rank keeps its shard of the full leaves (quantized
            # whole: a row-parallel weight's scale spans every rank's rows)
            params = self.family.shard_params(params, cfg, self.mesh)

        # Multi-LoRA: the adapter pool leaves join the params AFTER weight
        # quantization (adapters stay in the model dtype over int8 bases).
        # Off, no leaf is added and every forward is the LoRA-free one.
        if lora_dir is None:
            lora_dir = os.environ.get("LLMLB_LORA_DIR") or None
        self.lora: LoraManager | None = None
        if lora_dir:
            if ranks_per_host(self.mesh.world) < self.mesh.world:
                # the reference refuses adapters across processes; one
                # host's ranks mirror the pool through the tick plan
                raise ValueError(
                    "--lora-dir is single-host only for now: followers have "
                    "no deterministic mirror of the leader's adapter pool "
                    "slot assignment")
            if lora_max_adapters is None:
                lora_max_adapters = int(os.environ.get(
                    "LLMLB_LORA_MAX_ADAPTERS", "8"))
            if lora_rank_cap is None:
                lora_rank_cap = int(os.environ.get("LLMLB_LORA_RANK_CAP", "16"))
            # its targets follow the family (an MoE engine pools the
            # attention projections only, as the reference)
            # on a mesh each rank holds its shard of the pools, by the
            # family's axes (A as its weight's input, B as its output)
            shard = (None if self.mesh.trivial else
                     lambda name, full: self.family.shard_params(
                         {name: full}, cfg, self.mesh)[name])
            self.lora = LoraManager(cfg, lora_dir=lora_dir,
                                    max_adapters=lora_max_adapters,
                                    rank_cap=lora_rank_cap, shard=shard)
            params = {**params,
                      **self.lora.init_pool_leaves(cfg.dtype, self.device)}
            self.lora.attach(params)
            self.lora.metrics = self.metrics
            log.info("lora: pool of %d adapter slots at rank cap %d over %s "
                     "(%d adapter(s) discovered in %s)",
                     self.lora.max_adapters, self.lora.rank_cap,
                     "/".join(self.lora.targets), len(self.lora.available),
                     lora_dir)
        self.params = params
        # parameter count without the scale and adapter-pool leaves; bytes
        # with them
        # the full model's count on a mesh (a rank holds a shard of it)
        self.n_params = (sum(p.numel() for k, p in params.items()
                             if not (k.endswith(SCALE_SUFFIX)
                                     or "_lora_" in k))
                         if self.mesh.trivial else
                         sum(math.prod(shape) for shape, _ in
                             self.family.param_shapes(cfg).values()))
        self.param_bytes = sum(p.numel() * p.element_size()
                               for p in params.values())

        # Paged state (page pool, per-slot pages, block tables) exists only
        # in the paged layout; the dense layout's slot s is cache row s.
        self.page_pool: PagePool | None = None
        self._slot_pages: list[list[int]] = [[] for _ in range(num_slots)]
        # host block tables + their device copy [slots, pages_per_slot],
        # refreshed in place before the next dispatch whenever a row changed
        self._block_tables = np.zeros((num_slots, self.pages_per_slot),
                                      np.int32)
        self._d_block_tables = None
        self._tables_dirty = False
        # A request the pool cannot cover yet waits here, retried first.
        self._held_request: Request | None = None
        if kv_layout == "paged":
            self.page_pool = PagePool(self.kv_num_pages)
            self.cache_k, self.cache_v = self.family.init_kv_pages(
                self.model_cfg, self.kv_num_pages, self.kv_page_size,
                self.device, quantized=self.quant.kv)
            self._d_block_tables = self._to_device(self._block_tables)
            log.info(
                "KV cache: paged%s, %d pages x %d tokens (%d slots, %d "
                "pages/slot) = %.2f GiB on %s",
                " int8" if self.quant.kv else "", self.kv_num_pages,
                self.kv_page_size, num_slots, self.pages_per_slot,
                kv_pool_bytes(self.model_cfg, self.kv_num_pages,
                              self.kv_page_size, self.quant.kv) / 2**30,
                self.device,
            )
        else:
            # a rank holds its dp group's slots
            local_slots = num_slots // dp
            self.cache_k, self.cache_v = self.family.init_kv_cache(
                self.model_cfg, local_slots, self.slot_capacity, self.device)
            log.info("KV cache: dense, %d slots x %d capacity = %.2f GiB on %s",
                     local_slots, self.slot_capacity,
                     kv_cache_bytes(self.model_cfg, local_slots,
                                    self.slot_capacity) / 2**30,
                     self.device)

        # Decode burst: k decode+sample steps per host sync, from the kwarg,
        # then LLMLB_DECODE_BURST, then 8 on the card and 1 on the CPU, like
        # the reference off its accelerator.
        if decode_burst is None:
            env = os.environ.get("LLMLB_DECODE_BURST")
            if env:
                try:
                    decode_burst = max(1, int(env))
                except ValueError:
                    log.warning("LLMLB_DECODE_BURST=%r is not an integer; "
                                "using the auto default", env)
        if decode_burst is None:
            decode_burst = 8 if self.device.type == "cuda" else 1
        self.decode_burst = max(1, int(decode_burst))

        # Host mirrors of the slot state (lengths for stop checks without a
        # device read; seeds to know without a device read whether a burst
        # has seeded rows). Sampling params, seeds and tokens live on the
        # device and are only touched at activation — a decode burst does no
        # host-to-device copy. Every device buffer a burst touches is
        # allocated here once and written only in place, so a captured
        # burst's addresses stay valid.
        self.slots = [_Slot() for _ in range(num_slots)]
        self._seq_lens = np.zeros((num_slots,), np.int64)
        self._seeds = np.full((num_slots,), -1, np.int64)
        z32 = dict(dtype=torch.int32, device=self.device)
        self._d_seq_lens = torch.zeros(num_slots, **z32)
        self._d_last_tokens = torch.zeros(num_slots, **z32)
        self._d_top_ks = torch.zeros(num_slots, **z32)
        self._d_seeds = torch.full((num_slots,), -1, dtype=torch.int64,
                                   device=self.device)
        self._d_temps = torch.ones(num_slots, dtype=torch.float32,
                                   device=self.device)
        self._d_top_ps = torch.ones(num_slots, dtype=torch.float32,
                                    device=self.device)
        # adapter pool row per slot (0 = none), consulted only with LoRA on
        self._d_lora_idx = torch.zeros(num_slots, **z32)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        # Rows of NaN logits seen by any dispatch, counted on the device and
        # read only on request (nan_logit_rows()).
        self._d_nan_rows = torch.zeros((), dtype=torch.int64, device=self.device)
        # a burst's [k+1, slots] token block, fetched once per burst
        self._d_tokens = torch.zeros((self.decode_burst + 1, num_slots), **z32)
        # the forced tokens of resumed rows: written on the host, copied in
        # place before a burst that feeds some (or must clear the last's)
        self._force_tokens = np.zeros((self.decode_burst, num_slots), np.int32)
        self._force_mask = np.zeros((self.decode_burst, num_slots), bool)
        self._d_force_tokens = torch.zeros_like(self._d_tokens[1:])
        self._d_force_mask = torch.zeros((self.decode_burst, num_slots),
                                         dtype=torch.bool, device=self.device)
        self._force_dirty = False
        # the grammar key's cursors (0: the free row), written before a burst
        self._d_gram_state = torch.zeros(num_slots, **z32)
        # The verify step's inputs, one int32 buffer written with one copy
        # a step: ids [slots, K+1], chunk lengths, start positions and the
        # active-row flag; its output [slots, K+3]. A few KiB: allocated
        # whether or not any row speculates (the [slots, K+1, V] mask is
        # allocated at its first use).
        k1 = self.spec.max_draft_tokens + 1
        self._verify_host = np.zeros((num_slots * (k1 + 3),), np.int32)
        self._d_verify_in = torch.zeros(num_slots * (k1 + 3), **z32)
        vin = self._d_verify_in
        nk = num_slots * k1
        self._d_verify_out = torch.zeros((num_slots, k1 + 2), **z32)
        self._d_verify_mask: torch.Tensor | None = None
        self._spec_masked_prev: set[int] = set()
        self._burst_state = BurstState(
            params=self.params, cfg=self.model_cfg, mesh=self._model_mesh,
            cache_k=self.cache_k,
            cache_v=self.cache_v, block_tables=self._d_block_tables,
            last_tokens=self._d_last_tokens, seq_lens=self._d_seq_lens,
            tokens=self._d_tokens, temps=self._d_temps,
            top_ps=self._d_top_ps, top_ks=self._d_top_ks,
            seeds=self._d_seeds, lora_idx=(self._d_lora_idx if self.lora
                                           is not None else None),
            nan_rows=self._d_nan_rows, generator=self._generator,
            force_tokens=self._d_force_tokens, force_mask=self._d_force_mask,
            gram_state=self._d_gram_state,
            verify_ids=vin[:nk].view(num_slots, k1),
            verify_lens=vin[nk:nk + num_slots],
            verify_start=vin[nk + num_slots:nk + 2 * num_slots],
            verify_active=vin[nk + 2 * num_slots:],
            verify_out=self._d_verify_out,
            dp_rows=self.mesh.dp_rows(self._slot_groups))
        # the bursts' and the verify steps' graphs share one capture
        # function (one memory pool)
        capture = (cuda_capture(self.device, self._generator)
                   if self.decode_graphs else None)
        # adapter uploads from HTTP threads wait for a capture or replay
        lock = self.lora.device_lock if self.lora is not None else None
        self._bursts = BurstGraphs(self._burst_body, capture, lock=lock)
        self._verifies = BurstGraphs(self._verify_body, capture, lock=lock,
                                     kind="verify/")

        # Context-window buckets (pow2 up to capacity): a decode reads only
        # the smallest bucket covering every active sequence.
        buckets = []
        w = 256
        while w < self.slot_capacity:
            buckets.append(w)
            w *= 2
        buckets.append(self.slot_capacity)
        self._window_buckets = tuple(buckets)

        self.pending: queue.Queue[Request] = queue.Queue()
        # admission queues, one per priority class
        self._class_queues: dict[int, collections.deque[Request]] = {
            p: collections.deque() for p in PRIORITY_CLASSES}
        # drain: admission stops (one-way); the flags are plain bool writes
        # from the server's thread, consumed by the step loop
        self.draining = False
        self._drain_park_requested = False
        self._drain_flush_requested = False
        self.preemptions_total = 0
        self.preempt_resumes_total = 0
        self.deadline_shed_total = 0
        self.drain_parked_total = 0
        # the gateway ids of streams to park for a migration: added by HTTP
        # threads, swapped out by the step loop
        self._park_rids: set[str] = set()
        # KV page shipping and the host-RAM tier, paged only (dense rows
        # have no pages to name), resolved as the reference resolves them
        if kv_ship is None:
            kv_ship = os.environ.get("LLMLB_KV_SHIP", "1").lower() not in (
                "0", "false", "off", "no")
        # split mode ships nothing: a handoff moves its block-table row;
        # across hosts neither serves, as in the reference (a mesh of one
        # host's ranks moves the pages over its collectives)
        one_host = ranks_per_host(self.mesh.world) >= self.mesh.world
        self.kv_ship = (bool(kv_ship) and self.page_pool is not None
                        and self.role != "split" and one_host)
        # exports of parked streams by gateway id, taken once
        self._kv_exports: dict[str, dict] = {}
        if kv_offload_bytes is None:
            try:
                kv_offload_bytes = int(
                    os.environ.get("LLMLB_KV_OFFLOAD_BYTES", "0") or 0)
            except ValueError:
                log.warning("LLMLB_KV_OFFLOAD_BYTES is not an integer; "
                            "offload disabled")
                kv_offload_bytes = 0
        self.kv_offload: KVOffloadTier | None = (
            KVOffloadTier(kv_offload_bytes)
            if (kv_offload_bytes > 0 and self.page_pool is not None
                and self.role != "split" and one_host)
            else None)
        if self.kv_offload is not None:
            log.info("KV offload tier: %.1f MiB host-RAM budget",
                     self.kv_offload.budget_bytes / 2**20)
        self.kv_counters = KVShipCounters()
        # work another thread hands the loop (call_in_loop)
        self._calls: queue.SimpleQueue = queue.SimpleQueue()
        self._running = False
        self._thread: threading.Thread | None = None
        self._started_at = time.monotonic()
        self._lock = threading.Lock()
        self.total_requests = 0
        self.prefill_dispatches = 0
        self.decode_bursts = 0
        self._prefill_rr = 0  # rotation among concurrently-prefilling slots

        # Structured outputs. The compiler needs the tokenizer: the service
        # installs its own (core-level submitters may pre-compile
        # Request.compiled_constraint themselves).
        self.constraint_compiler = None
        self.structured_counters = StructuredCounters()
        self.structured_metrics = _StructuredMetrics(self.structured_counters,
                                                     self._lock, self.metrics)
        # Fused decode, resolved as the reference resolves it: kwarg, then
        # LLMLB_FUSED_DECODE, then on for paged and off for dense. On, a
        # constrained row's schema goes into the device grammar table and
        # the row rides the burst under the grammar key; off, every
        # constrained burst takes the host-mask path.
        if fused_decode is None:
            env = os.environ.get("LLMLB_FUSED_DECODE", "").strip().lower()
            if env in ("1", "true", "on", "yes"):
                fused_decode = True
            elif env in ("0", "false", "off", "no"):
                fused_decode = False
            elif env:
                log.warning("LLMLB_FUSED_DECODE=%r is not a boolean; using "
                            "the auto default", env)
        if fused_decode is None:
            fused_decode = self.kv_layout == "paged"
        self.fused_decode = bool(fused_decode)
        self._grammar_tables: GrammarTables | None = (
            GrammarTables(cfg.vocab_size, device=self.device)
            if self.fused_decode else None)
        self._grammar_warned = False
        # one-way: a schema missed the table, so every constrained row keeps
        # a host mask row too (a mixed batch's fallback masks all of them)
        self._grammar_fallback = False
        # the host-mask path: [slots, V] float32 rows on the host, and their
        # device copy (allocated once, refreshed per dirty row in place)
        self._mask_bias: np.ndarray | None = None
        self._d_mask: torch.Tensor | None = None
        self._mask_dirty_rows: set[int] = set()

        # The loop each thread belongs to ("main" for the combined loop;
        # split mode tags its two threads "prefill" and "decode", and the
        # adoption "handoff"), and the dispatches each loop ran: prefill
        # dispatches, and decode and verify steps' model calls.
        self._tls = threading.local()
        self.prefill_dispatch_by_loop: dict[str, int] = {
            "main": 0, "prefill": 0, "decode": 0, "handoff": 0}
        self.decode_dispatch_by_loop: dict[str, int] = {
            "main": 0, "prefill": 0, "decode": 0, "handoff": 0}
        # Multi-rank lockstep (engine/multihost.py): the leader's intake and
        # its budget-spilled backlog, mirrored into `pending` on every rank
        # by the tick plan; cancellations act through the plan only.
        self.coordinator: StepCoordinator | None = None
        self._stop_requested = False
        self._cancelled_effective: set[str] = set()
        self._intake: queue.SimpleQueue[Request] = queue.SimpleQueue()
        self._plan_backlog: list[Request] = []
        # what the loop acts on this tick, from the plan: the drain as the
        # plan last carried it, the loop's flags (drain park, migration
        # parks, drain flush); and the forwards queued by `encode` and this
        # tick's, each (inputs, done, box): a follower's carry no caller
        self._plan_draining = False
        self._tick_flags: tuple[bool, set[str], bool] = (False, set(), False)
        self._plan_calls: collections.deque = collections.deque()
        self._tick_calls: list = []
        # context-parallel prefill (sp > 1): built at the first long prompt
        self._use_cp_prefill = self.mesh.shape["sp"] > 1
        self.lora_cp_fallback_total = 0
        self._cp_prefill_fn = None
        if not self.mesh.trivial:
            if self.role == "split" and not one_host:
                raise ValueError(
                    "--role split is single-host only (a split across hosts "
                    "has no handoff mirror; one host's ranks run it)")
            self.coordinator = StepCoordinator(self.mesh)
            log.info("multihost lockstep: %s of %d ranks, mesh %s",
                     "leader" if self.coordinator.is_leader else "follower",
                     self.mesh.world, self.mesh.shape)
        if self.role == "split":
            if self.page_pool is None:
                raise ValueError(
                    "--role split requires the paged KV layout: the handoff "
                    "is a block-table page-id exchange")
            self.split = SplitRuntime(self, disagg_prefill_slots)

    @staticmethod
    def _build_mesh(cfg: LlamaConfig, mesh_config: MeshConfig | None):
        """The engine's mesh over the torch.distributed world (one rank
        without a process group), laid as the reference lays it
        (parallel/distributed.py `engine_mesh`): the default sizes ep and tp
        within one host's ranks, dp takes the rest and multiplies across
        hosts. dp > 1 splits the batch rows into dp groups."""
        return engine_mesh(cfg, mesh_config)

    def _mesh_kw(self, slot_ids) -> dict:
        """The mesh keywords of a dispatch over `slot_ids` (its batch rows
        in order): the mesh (None on one rank), and at dp > 1 the rows'
        dp groups."""
        rows = self.mesh.dp_rows([self._slot_groups[s] for s in slot_ids])
        if rows is None:
            return {"mesh": self._model_mesh}
        return {"mesh": self._model_mesh, "dp_rows": rows}

    # ------------------------------------------------------------------ public

    def start(self) -> None:
        self._running = True
        if self.split is not None:
            self.split.start()
            # call_in_loop's work runs on the prefill loop, under the lock
            self._thread = self.split.threads[0]
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="engine-step-loop", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self.coordinator is not None and self.coordinator.is_leader:
            # the shutdown rides the tick plan, so the followers leave their
            # loops too (flipping _running here would strand them blocked
            # in the next exchange)
            self._stop_requested = True
            if self._thread is None or not self._thread.is_alive():
                self._running = False
        else:
            self._running = False
        if self.split is not None:
            self.split.join(timeout=30)
        if self._thread is not None:
            self._thread.join(timeout=30)
        self._running = False
        # terminal events for everything still in flight so waiters unblock
        self._fail_all("engine shutting down")
        self._run_calls(RuntimeError("engine shutting down"))
        self._refuse_plan_calls(RuntimeError("engine shutting down"))
        with self._lock:
            self._kv_exports.clear()

    def call_in_loop(self, fn):
        """Run `fn()` on the step loop's thread, between two iterations, and
        return its result (or raise its exception): the loop owns every
        device tensor, so other threads' forwards (embeddings) go through
        here. Runs inline when the loop is not running."""
        thread = self._thread
        if (not self._running or thread is None or not thread.is_alive()
                or threading.current_thread() is thread):
            return fn()
        done = threading.Event()
        box: dict = {}
        self._calls.put((fn, done, box))
        while not done.wait(0.5):
            if not thread.is_alive():  # stopped after the put
                self._run_calls(RuntimeError("engine shutting down"))
        if "error" in box:
            raise box["error"]
        return box["value"]

    def encode(self, ids: np.ndarray, lens: np.ndarray) -> torch.Tensor:
        """The family's encode forward (/v1/embeddings) of one padded batch
        (ids [B, T], lens [B]) as [B, E] fp32 on the host, run on the step
        loop's thread between iterations: queued for the loop's next tick,
        which on a mesh carries it to every rank in the tick plan; the
        leader's result (or exception) comes back here. Runs inline on one
        rank when the loop is not running."""
        thread = self._thread
        looping = (self._running and thread is not None
                   and thread.is_alive())
        if self.coordinator is None:
            if not looping or threading.current_thread() is thread:
                return self._encode(ids, lens)
        elif not self.coordinator.is_leader or not looping:
            raise RuntimeError("a planned forward needs the leader's running "
                               "step loop")
        done = threading.Event()
        box: dict = {}
        self._plan_calls.append(((ids, lens), done, box))
        while not done.wait(0.5):
            if not thread.is_alive():  # stopped after the append
                self._refuse_plan_calls(RuntimeError("engine shutting down"))
        if "error" in box:
            raise box["error"]
        return box["value"]

    def _encode(self, ids: np.ndarray, lens: np.ndarray) -> torch.Tensor:
        return self.family.encode(self.params, self.model_cfg,
                                  self._to_device(ids), self._to_device(lens),
                                  mesh=self._model_mesh).cpu()

    def _take_calls(self) -> None:
        """One rank: every queued forward runs at this tick."""
        while True:
            try:
                self._tick_calls.append(self._plan_calls.popleft())
            except IndexError:
                return

    def _run_plan_calls(self) -> bool:
        """Run this tick's forwards (on a mesh every rank, in plan order);
        the leader hands each result to its caller (a follower's calls
        have none)."""
        calls, self._tick_calls = self._tick_calls, []
        for args, done, box in calls:
            try:
                value = self._encode(*args)
                if box is not None:
                    box["value"] = value
            except Exception as e:  # boundary: the caller re-raises it
                if box is None:
                    log.exception("a planned encode failed on a follower")
                else:
                    box["error"] = e
            finally:
                if done is not None:
                    done.set()
        return bool(calls)

    @staticmethod
    def _refuse_calls(calls: list, error: BaseException) -> None:
        for _, done, box in calls:
            if box is not None:
                box["error"] = error
                done.set()

    def _refuse_plan_calls(self, error: BaseException) -> None:
        """Fail the forwards not run yet (queued or this tick's) with
        `error`."""
        calls, self._tick_calls = self._tick_calls, []
        while True:
            try:
                calls.append(self._plan_calls.popleft())
            except IndexError:
                break
        self._refuse_calls(calls, error)

    def _run_calls(self, refuse: BaseException | None = None) -> bool:
        """Run (or, with `refuse`, fail) the calls queued by call_in_loop."""
        ran = False
        while True:
            try:
                fn, done, box = self._calls.get_nowait()
            except queue.Empty:
                return ran
            ran = True
            try:
                if refuse is not None:
                    raise refuse
                box["value"] = fn()
            except Exception as e:  # boundary: the caller re-raises it
                box["error"] = e
            finally:
                done.set()

    def submit(self, request: Request) -> Request:
        n = len(request.prompt_ids)
        try:
            if n == 0:
                raise ValueError("prompt must contain at least one token")
            # Prompts beyond the largest one-shot bucket run through chunked
            # prefill; the only hard cap is slot capacity.
            if n + 1 >= self.slot_capacity:
                raise ValueError(
                    f"prompt of {n} tokens does not fit the slot capacity "
                    f"({self.slot_capacity}) with room to generate"
                )
            bad = [t for t in request.prompt_ids
                   if not 0 <= int(t) < self.cfg.vocab_size]
            if bad:
                raise ValueError(f"token id {bad[0]} out of range for vocab "
                                 f"size {self.cfg.vocab_size}")
        except ValueError:
            # a refused submit must not leak a pin the service layer's
            # prepare_lora already took for this request
            self._release_lora(request)
            raise
        # pin (and load) the adapter before the request can reach a slot:
        # the step loop never waits on disk, and eviction sees queued
        # requests as active. Idempotent after the service's own call.
        self.prepare_lora(request)
        with self._lock:
            self.total_requests += 1
        self._fr_emit(request, "admitted", prompt_tokens=n,
                      queue_depth=self.pending.qsize())
        if self.coordinator is not None:
            # multi-rank: requests enter through the tick plan, so every
            # rank mirrors the same queue in the same order
            self._intake.put(request)
        else:
            self.pending.put(request)
        return request

    @property
    def total_tokens(self) -> int:
        """Tokens emitted so far (EngineMetrics' tally)."""
        return self.metrics.tokens_total

    def stats(self) -> EngineStats:
        active = sum(1 for s in self.slots if s.request is not None)
        queued = self.pending.qsize() + sum(
            len(q) for q in self._class_queues.values())
        if self._held_request is not None:
            queued += 1
        if self.coordinator is not None:
            # the leader's intake and the plan's spilled backlog are queued
            # work the gateway's placement must see
            queued += self._intake.qsize() + len(self._plan_backlog)
        return EngineStats(
            num_slots=self.num_slots, active_slots=active, queued=queued,
            total_requests=self.total_requests, total_tokens=self.total_tokens,
            uptime_s=time.monotonic() - self._started_at,
            decode_graph_replays=self._bursts.replays,
            decode_eager_bursts=self._bursts.eager_bursts,
            decode_graphs=len(self._bursts.graphs),
            prefix=dataclasses.replace(self.prefix_counters),
            preemptions_total=self.preemptions_total,
            preempt_resumes_total=self.preempt_resumes_total,
            deadline_shed_total=self.deadline_shed_total,
            drain_parked_total=self.drain_parked_total,
            kv=self._kv_counters_copy(),
            structured=self._structured_counters_copy(),
            verify_graph_replays=self._verifies.replays,
            verify_eager_steps=self._verifies.eager_bursts,
            verify_graphs=len(self._verifies.graphs),
            spec=self._spec_counters_copy(),
            slow_steps_total=self.step_stats.slow_steps_total,
            draining=self.draining,
        )

    def _spec_counters_copy(self) -> SpecCounters:
        with self._lock:
            return dataclasses.replace(self.spec_counters)

    def spec_info(self) -> dict:
        """The `spec` block of /api/health and /api/system, the reference's
        keys: the configuration and the live acceptance figures."""
        c = self._spec_counters_copy()
        return {
            "enabled": self.spec.enabled,
            "available": True,
            "max_draft_tokens": self.spec.max_draft_tokens,
            "ngram": [self.spec.min_ngram, self.spec.max_ngram],
            "verify_steps_total": c.verify_steps_total,
            "draft_tokens_total": c.draft_tokens_total,
            "accepted_tokens_total": c.accepted_tokens_total,
            "emitted_tokens_total": c.emitted_tokens_total,
            "acceptance_rate": c.acceptance_rate,
        }

    def _structured_counters_copy(self) -> StructuredCounters:
        with self._lock:
            return dataclasses.replace(self.structured_counters)

    def _count(self, name: str, n: int = 1) -> None:
        """Add to one structured-output counter (the step loop's side)."""
        with self._lock:
            setattr(self.structured_counters, name,
                    getattr(self.structured_counters, name) + n)

    def structured_info(self) -> dict:
        """The `structured` block of /api/health and /api/system: the
        constraint compiler's mask-cache figures plus live load, as the
        reference's, and the device grammar table's occupancy."""
        if self.constraint_compiler is None:
            return {"enabled": False}
        info = self.constraint_compiler.info()
        info["active_constrained_slots"] = sum(
            1 for s in self.slots if s.constraint is not None)
        info["fused_decode"] = self.fused_decode
        info["grammar_fallback"] = self._grammar_fallback
        info["grammar_table"] = (self._grammar_tables.info()
                                 if self._grammar_tables is not None
                                 else {"enabled": False})
        return info

    def queue_class_depths(self) -> dict[str, int]:
        """Queued requests per priority class (the held one included)."""
        depths = {PRIORITY_NAMES[p]: len(self._class_queues[p])
                  for p in PRIORITY_CLASSES}
        held = self._held_request
        if held is not None:
            depths[PRIORITY_NAMES[self._priority_of(held)]] += 1
        return depths

    def sched_info(self) -> dict:
        """The `sched` block of /api/health and /api/system: the prefill
        chunk budget, queue depths by class and the overload-protection
        counters; in split mode also the depths by role (work waiting for
        a prefill slot, and staged work waiting for a decode slot)."""
        info = {
            "prefill_chunk_budget": self.prefill_chunk_budget,
            "queued_by_class": self.queue_class_depths(),
            "preemptions_total": self.preemptions_total,
            "preempt_resumes_total": self.preempt_resumes_total,
            "deadline_shed_total": self.deadline_shed_total,
        }
        if self.split is not None:
            info["queued_by_role"] = {
                "prefill": sum(info["queued_by_class"].values()),
                "decode": self.split.backlog(),
            }
        return info

    def disagg_info(self) -> dict:
        """The `disagg` block of /api/health and /api/system: the served
        role, the split's pool sizes, and the handoff counters."""
        handoffs, backlog = self.metrics.handoff_counts()
        info = {"role": self.role, "split": self.split is not None,
                "handoff_total": handoffs, "handoff_backlog": backlog}
        if self.split is not None:
            info["prefill_slots"] = len(self.split.prefill_pool)
            info["decode_slots"] = len(self.split.decode_pool)
        return info

    # ------------------------------------------------------------- drain

    def begin_drain(self) -> None:
        """Stop admitting (and re-activating) work; decoding rows go on.
        One-way: a draining process exits or is restarted."""
        self.draining = True

    def request_drain_park(self) -> None:
        """Ask the step loop to park every decoding row at its next
        iteration (the drain's grace is spent)."""
        self._drain_park_requested = True

    def request_drain_flush(self) -> None:
        """Ask the step loop to end everything still queued (parked work
        included) with an error, after the server closed their sockets, so
        the handlers waiting on their events return."""
        self._drain_flush_requested = True

    def request_park(self, gateway_id: str) -> None:
        """Ask the step loop to park ONE stream (by gateway request id) at
        its next iteration and leave its KV for export: a migration pulls
        the stream to another engine while this one serves everyone else.
        The set is swapped out only by the loop thread."""
        self._park_rids.add(gateway_id)

    @property
    def _loop_draining(self) -> bool:
        """The drain as the step loop reads it: the live flag on one rank;
        on a mesh the plan's, so every rank stops admitting on one tick."""
        return self.draining if self.coordinator is None else (
            self._plan_draining)

    def _take_loop_flags(self) -> tuple[bool, set[str], bool]:
        """Take (and reset) what other threads asked of the loop: the
        drain park, the migration parks, the drain flush. The leader of a
        mesh takes them into the tick plan; one rank acts on them at
        once."""
        park_all = self._drain_park_requested
        self._drain_park_requested = False
        rids, self._park_rids = self._park_rids, set()
        flush = self._drain_flush_requested
        self._drain_flush_requested = False
        return park_all, rids, flush

    def _act_on_flags(self, park_all: bool, rids: set[str],
                      flush: bool) -> None:
        if park_all:
            self._drain_park_all()
        if rids:
            self._park_requested(rids)
        if flush:
            self._drain_flush_all()

    def decode_graph_info(self) -> dict:
        """The decode graphs: keys captured, replays, eager bursts, capture
        seconds, pool bytes and each key's per-replay kernel launches; the
        same for the verify keys under "verify" (eager steps as
        "eager_bursts")."""
        return {"enabled": self.decode_graphs, **self._bursts.info(),
                "verify": self._verifies.info()}

    def prepare_lora(self, request: Request) -> None:
        """Resolve and pin a request's adapter (loading it if cold).
        Callable from the service's thread or from submit; idempotent per
        request. Raises ValueError naming the `lora` field when this engine
        cannot serve the adapter."""
        name = request.sampling.lora
        if not name:
            return
        if self.lora is None:
            raise ValueError("'lora' adapters are not enabled on this engine "
                             "(start it with --lora-dir)")
        if self.coordinator is not None:
            # a mesh: every rank pins in tick-plan order (_apply_plan)
            self.lora.validate(name)
            return
        t0 = time.perf_counter()
        self.lora.acquire(name, request.request_id)
        # once per call: the submit's re-acquire of an adapter the service
        # pinned shows as a second event with ~0 wait, as in the reference
        self._fr_emit(request, "lora_acquire", adapter=name,
                      wait_s=round(time.perf_counter() - t0, 6))

    def _fr_emit(self, request: Request, event: str, **attrs) -> None:
        """One flight-recorder event for a request (a no-op with the
        recorder off). Every terminal event goes through `_finish`, which
        emits it next to its put."""
        if self.flightrec.enabled:
            self.flightrec.emit(request.request_id, event, **attrs)

    def _release_lora(self, request: Request) -> None:
        """Unpin a request's adapter (idempotent: a request may reach more
        than one terminal path)."""
        if self.lora is not None and request.sampling.lora:
            self.lora.release(request.request_id)

    def _lora_rows(self, requests) -> np.ndarray:
        """Adapter pool rows of an ordered request list."""
        return np.asarray([self.lora.slot_of(r.sampling.lora)
                           for r in requests], np.int32)

    def lora_info(self) -> dict:
        """The multi-LoRA block of /api/health and /api/system."""
        if self.lora is None:
            return {"enabled": False}
        # LoRA prompts that took chunks on an sp > 1 mesh (_cp_capable)
        return {**self.lora.info(),
                "cp_fallback_total": self.lora_cp_fallback_total}

    def _kv_dtype(self) -> str:
        return ("int8" if self.quant.kv
                else str(self.cfg.dtype).replace("torch.", ""))

    def kv_cache_info(self) -> dict:
        if self.page_pool is None:
            return {
                "layout": "dense",
                "kv_dtype": self._kv_dtype(),
                # what the cache serves: int8 KV downgrades on this layout
                "effective_kv_dtype": self._kv_dtype(),
                "num_slots": self.num_slots,
                "slot_capacity": self.slot_capacity,
                "hbm_bytes": kv_cache_bytes(self.cfg, self.num_slots,
                                            self.slot_capacity),
            }
        pool = self.page_pool
        active = active_pages = waste = 0
        for i, s in enumerate(self.slots):
            if s.request is None:
                continue
            active += 1
            held = len(self._slot_pages[i])
            active_pages += held
            used = s.prefill_pos if s.prefilling else int(self._seq_lens[i])
            waste += max(0, held * self.kv_page_size - used)
        return {
            "layout": "paged",
            # the pool's ACTUAL dtype: capacity math from an implied model
            # dtype would be 2x off under int8
            "kv_dtype": self._kv_dtype(),
            "effective_kv_dtype": self._kv_dtype(),
            "page_size": self.kv_page_size,
            "num_slots": self.num_slots,
            "slot_capacity": self.slot_capacity,
            "pages_total": pool.total,
            "pages_free": pool.available(),
            "pages_active": active_pages,
            "pages_pinned": self._prefix_pinned_pages,
            "utilization": round(pool.used() / max(1, pool.total), 4),
            # allocated but unfilled cells of occupied rows
            "fragmentation": round(
                waste / max(1, active_pages * self.kv_page_size), 4),
            "waste_tokens_mean": round(waste / active, 1) if active else 0.0,
            "bytes_per_page": kv_page_bytes(self.cfg, self.kv_page_size,
                                            self.quant.kv),
            "hbm_bytes": kv_pool_bytes(self.cfg, self.kv_num_pages,
                                       self.kv_page_size, self.quant.kv),
        }

    def prefix_cache_info(self) -> dict:
        """The prefix cache block of /api/health and /api/system, with the
        reference's keys. Reads only ints and a dict size, so an HTTP
        thread may call it while the step loop runs."""
        if self.prefix_cache is None:
            return {"enabled": False}
        pinned = len(self.prefix_cache)
        info = {
            "enabled": True,
            "entries": pinned,
            "budget_slots": self.prefix_cache.max_entries,
            "cached_tokens": self.prefix_cache.cached_tokens(),
            "min_prefix_len": self.min_prefix_len,
            "align": self.prefix_align,
        }
        if self.page_pool is not None:
            # zero-copy donors pin pages, never slots
            info["pinned_slots"] = 0
            info["pinned_pages"] = self._prefix_pinned_pages
            info["pinned_hbm_bytes"] = (
                self._prefix_pinned_pages
                * kv_page_bytes(self.cfg, self.kv_page_size, self.quant.kv))
        else:
            # a pinned donor holds its whole slot row out of the serving pool
            info["pinned_slots"] = pinned
            info["pinned_hbm_bytes"] = (
                pinned * kv_cache_bytes(self.cfg, 1, self.slot_capacity))
        return info

    def quant_info(self) -> dict:
        """The resolved int8 knobs and the byte footprints they produce."""
        itemsize = self.cfg.dtype.itemsize
        return {
            "mode": self.quant.mode,
            "weights_int8": self.quant.weights,
            "kv_int8": self.quant.kv,
            "effective_kv_dtype": self._kv_dtype(),
            "param_bytes": self.param_bytes,
            "param_bytes_bf16": self.n_params * itemsize,
            "kv_cell_bytes": kv_cell_bytes(self.cfg.head_dim_, self.quant.kv,
                                           itemsize),
        }

    def perf_info(self) -> dict:
        """The live roofline block of /api/health, /api/system, /api/steps
        and /metrics, as the reference's: model FLOPs and bytes per token
        over the step records' decode window (busy seconds, tokens) against
        the device's spec-sheet peaks (engine/telemetry.py). `available` is
        False on a device outside the table (the CPU included) or before
        any decode traffic: the gauges are then absent, never wrong."""
        kind = device_kind(self.device)
        spec = chip_spec_for(kind)
        busy_s, toks = self.step_stats.window_throughput()
        tok_per_s = toks / busy_s if busy_s > 0 else 0.0
        # the live rows' mean context and batch, a point-in-time read
        contexts = [int(self._seq_lens[i]) for i, s in enumerate(self.slots)
                    if s.request is not None and not s.prefilling]
        mean_ctx = sum(contexts) / len(contexts) if contexts else 0.0
        batch = max(1, len(contexts))
        flops_tok = model_flops_per_token(self.cfg, self.n_params)
        # the measured parameter bytes (int8 codes and scales when weights
        # are quantized) and the pool's actual cell size
        # every rank's parameter bytes over every row: a token reads its
        # dp group's shards, (world / dp) ranks' bytes over its group's
        # batch / dp rows, which is the same share
        n_chips = self.mesh.world
        bytes_tok = model_bytes_per_token(
            self.cfg, self.n_params, mean_ctx, batch=batch,
            weight_bytes=self.param_bytes * n_chips,
            kv_cell_bytes=kv_cell_bytes(self.cfg.head_dim_, self.quant.kv,
                                        self.cfg.dtype.itemsize))
        info = {
            "device_kind": kind,
            "n_chips": n_chips,
            "n_params": self.n_params,
            "quantize": self.quant.mode,
            "flops_per_token": flops_tok,
            "bytes_per_token": round(bytes_tok, 1),
            "mean_context_tokens": round(mean_ctx, 1),
            "window_tokens": toks,
            "window_busy_s": round(busy_s, 4),
            "tokens_per_sec_busy": round(tok_per_s, 2),
            "available": spec is not None and tok_per_s > 0,
        }
        if spec is not None:
            info["chip"] = {
                "generation": spec.generation,
                "peak_flops": spec.peak_flops,
                "peak_flops_int8": spec.int8_flops,
                "peak_hbm_bw": spec.peak_hbm_bw,
            }
        if info["available"]:
            # int8-weight engines against the int8 column, the reference's
            # rule (the port widens int8 weights to bf16 today)
            peak = spec.int8_flops if self.quant.weights else spec.peak_flops
            info["mfu"] = round(flops_tok * tok_per_s / (peak * n_chips), 6)
            info["hbm_bw_utilization"] = round(
                bytes_tok * tok_per_s / (spec.peak_hbm_bw * n_chips), 6)
        return info

    def nan_logit_rows(self) -> int:
        """Logit rows with a NaN in any dispatch so far (syncs the device)."""
        return int(self._d_nan_rows.item())

    # ------------------------------------------------------------------- loop

    def _loop_tag(self) -> str:
        return getattr(self._tls, "tag", "main")

    def _note_prefill_dispatch(self) -> None:
        """Count one prefill dispatch, in total and by the loop that ran
        it: split mode's invariant (no prefill on the decode loop) is read
        off this ledger."""
        self.prefill_dispatches += 1
        self.prefill_dispatch_by_loop[self._loop_tag()] += 1

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # ---------------------------------------------------------- step records

    def _timing_events(self) -> tuple | None:
        """A (start, end) pair of CUDA timing events with start recorded
        now, on the loop's stream; None on the CPU."""
        if self.device.type != "cuda":
            return None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        return start, end

    def _record_step(self, kind: str, phases: dict[str, float], *,
                     active_slots: int = 0, tokens: int = 0,
                     slots: list[int] | None = None, dispatches: int = 0,
                     fused: bool = False, events: tuple | None = None,
                     waited: bool = False) -> None:
        """Finish one step record, as the reference's: absorb the plan
        time accrued since the last dispatch, name the slots' gateway ids,
        feed the ring and slow-step detector, the phase histograms and (for
        decode and verify) the dispatch tallies; a flagged step writes a
        slow_step event for each of its requests. `events` is the
        dispatch's timing pair: read now when the host `waited` on its end
        (a burst's or verify step's fetch), else at a later record once it
        completed (a prefill, never waited for)."""
        if self._pending_plan_s > 0.0:
            phases["plan"] = phases.get("plan", 0.0) + self._pending_plan_s
            self._pending_plan_s = 0.0
        request_ids: dict[str, str] | None = None
        if slots:
            request_ids = {str(i): gateway_rid(self.slots[i].request.request_id)
                           for i in slots if self.slots[i].request is not None}
        if kind in ("decode", "verify") and dispatches > 0:
            self.decode_dispatch_by_loop[self._loop_tag()] += dispatches
            self.metrics.record_decode_dispatches(dispatches, fused=fused)
        device_ms = (events[0].elapsed_time(events[1])
                     if events is not None and waited else None)
        slow = self.step_stats.observe(
            kind, phases, active_slots=active_slots, tokens=tokens,
            request_ids=request_ids, dispatches=dispatches,
            device_ms=device_ms)
        self.metrics.record_step_phases(phases)
        if slow and request_ids and self.flightrec.enabled:
            total = round(sum(phases.values()), 6)
            seq = self.step_stats.seq
            for rid in request_ids.values():
                self.flightrec.emit(rid, "slow_step", kind=kind,
                                    total_s=total, step_seq=seq)
        if self._pending_device:
            # earlier prefills' pairs: read those that completed
            kept = []
            for seq, start, end in self._pending_device:
                if end.query():
                    self.step_stats.set_device_ms(seq, start.elapsed_time(end))
                else:
                    kept.append((seq, start, end))
            self._pending_device = kept[-self.step_stats.capacity:]
        if events is not None and not waited:
            self._pending_device.append((self.step_stats.seq, *events))

    def _loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while self._running:
            try:
                did_work = self._iteration()
            except Exception:  # boundary: fail the requests, keep serving
                log.exception("engine step failed; resetting engine state")
                self._fail_all("engine step error")
                self._reset_caches()
                did_work = False
            if not did_work:
                time.sleep(0.001)

    def _iteration(self) -> bool:
        """One pass of the step loop; whether it did any work. On a mesh it
        starts with the tick plan's exchange, and the loop's flags and the
        forwards come from the plan, so every rank acts on them at this
        tick."""
        if self.coordinator is not None:
            self._lockstep_tick()
            if not self._running:
                return False
            flags, self._tick_flags = self._tick_flags, (False, set(), False)
        else:
            flags = self._take_loop_flags()
            self._take_calls()
        self._act_on_flags(*flags)
        did_work = self._run_plan_calls()
        did_work |= self._run_calls()
        did_work |= self._try_insert()
        # At most ONE prefill chunk per iteration: decode steps run between
        # chunks, so active slots keep emitting tokens during a long
        # prompt's prefill.
        did_work |= self._advance_prefill()
        did_work |= self._decode_active()
        return did_work

    def _reset_caches(self) -> None:
        # the zeroed cache holds no prefix any more
        self._drop_prefix_cache()
        for pool in (self.cache_k, self.cache_v):
            for t in (pool.values() if isinstance(pool, dict) else (pool,)):
                t.zero_()
        if self.page_pool is not None:
            self.page_pool.reset()
            self._slot_pages = [[] for _ in range(self.num_slots)]
            self._block_tables[:] = 0
            self._d_block_tables.zero_()
            self._tables_dirty = False
        self._seq_lens[:] = 0
        self._d_seq_lens.zero_()
        self._d_last_tokens.zero_()

    # ------------------------------------------------------ multi-rank plans

    def _is_cancelled(self, request: Request) -> bool:
        """One rank reads the live flag; a lockstep mesh reads the plan's
        mirrored set, so every rank sees a cancellation on the same tick."""
        if self.coordinator is None:
            return request.cancelled
        return request.request_id in self._cancelled_effective

    def _collect_plan(self, section: str | None = None) -> dict:
        """Leader: drain the intake into this tick's plan and gather the
        cancellations, the drain, the loop's flags and the planned
        forwards (`section`: the split's lock section this tick runs). A
        request cancelled or past its deadline before any plan ends here,
        on the leader alone (no rank runs a forward for it), and the
        plan's payload is bounded here: its requests' ids and its
        forwards' inputs share one budget, what is over it waits for the
        next tick in arrival order, and a single request or forward too
        large for any plan ends with an error, never a raise
        mid-broadcast."""
        # ~ids: a request's are pickled ints (at most 5 bytes each), a
        # forward's an int32 array, so the plan's other items have room
        budget = _MAX_PLAN_BYTES // 8
        candidates = self._plan_backlog
        self._plan_backlog = []
        while True:
            try:
                candidates.append(self._intake.get_nowait())
            except queue.Empty:
                break
        new = []
        tokens = 0
        for idx, req in enumerate(candidates):
            if req.cancelled:
                self._finish(req, "done", "cancelled")
                continue
            if req.deadline_expired():
                self.deadline_shed_total += 1
                self._finish(req, "error", "deadline exceeded before prefill",
                             event="shed", reason="deadline")
                continue
            n = len(req.prompt_ids)
            if req.parked is not None:
                n += len(req.parked.tokens)
            if n > budget:
                self._finish(req, "error", "prompt too large for a tick plan")
                continue
            if tokens + n > budget:
                self._plan_backlog = candidates[idx:]
                break
            tokens += n
            new.append(req)
        in_flight = [s.request for s in self.slots if s.request is not None]
        if self._held_request is not None:
            in_flight.append(self._held_request)
        with self.pending.mutex:
            in_flight += list(self.pending.queue)
        for q in self._class_queues.values():
            in_flight += list(q)
        cancelled = [r.request_id for r in in_flight
                     if r.cancelled
                     and r.request_id not in self._cancelled_effective]
        # the loop's flags (a split engine serves none of them: C8) and the
        # planned forwards (on the split's prefill side only)
        flags = ((False, set(), False) if self.split is not None
                 else self._take_loop_flags())
        calls = []
        while section in (None, "admit"):
            try:
                call = self._plan_calls.popleft()
            except IndexError:
                break
            n = sum(a.size for a in call[0])
            if n > budget:
                self._refuse_calls([call], ValueError(
                    f"a forward of {n} ids is too large for a tick plan"))
                continue
            if tokens + n > budget:
                self._plan_calls.appendleft(call)
                break
            tokens += n
            calls.append(call)
        return {"new": new, "cancelled": cancelled,
                "stop": self._stop_requested, "draining": self.draining,
                "flags": flags, "calls": calls, "section": section}

    def _plan_wire(self, plan: dict) -> dict:
        """The wire form of a plan: payloads in place of Request objects and
        of the callers waiting on the planned forwards."""
        return {
            "new": [EngineCore._request_wire(r) for r in plan["new"]],
            "cancelled": plan["cancelled"],
            "stop": plan["stop"],
            "draining": plan["draining"],
            "flags": (plan["flags"][0], sorted(plan["flags"][1]),
                      plan["flags"][2]),
            "calls": [args for args, _, _ in plan["calls"]],
            "section": plan["section"],
        }

    @staticmethod
    def _request_wire(r: Request) -> dict:
        """A new request as the plan carries it: its id, prompt and
        sampling (the handoff's emit window is its max_tokens), and what
        the leader's service set on it: an adoption's committed ids and
        generation count, the header of its shipped pages (the bytes go
        over the mesh when they land), and the handoff's export flag."""
        wire = {"request_id": r.request_id, "prompt_ids": list(r.prompt_ids),
                "sampling": dataclasses.asdict(r.sampling)}
        if r.parked is not None:
            wire["parked"] = {"generated": r.parked.generated,
                              "tokens": list(r.parked.tokens)}
        if r.kv_restore is not None:
            wire["kv_restore"] = dataclasses.asdict(r.kv_restore.header)
        if r.export_kv:
            wire["export_kv"] = True
        return wire

    def _shadow(self, payload: dict) -> Request:
        """A follower's copy of a planned request (its events go unread):
        an adoption's parked state rebuilt here, the grammar cursor and the
        drafter from its committed ids, as the leader's service built them;
        shipped pages as their header alone."""
        req = Request(prompt_ids=payload["prompt_ids"],
                      sampling=SamplingParams(**payload["sampling"]),
                      request_id=payload["request_id"],
                      export_kv=payload.get("export_kv", False))
        parked = payload.get("parked")
        if parked is not None:
            try:
                self._prepare_constraint(req)
            except Exception:  # boundary: admission ends it with the error
                pass
            req.parked = self.adopted_state(
                req.prompt_ids, parked["tokens"], req.sampling,
                req.compiled_constraint, generated=parked["generated"])
        header = payload.get("kv_restore")
        if header is not None:
            req.kv_restore = KVPages(header=KVWireHeader(**header),
                                     sections={})
        return req

    def adopted_state(self, prompt_ids, committed: list[int],
                      sampling: SamplingParams, compiled=None, *,
                      generated: int | None = None) -> ParkedState:
        """The parked state of a stream adopted at its `committed` ids, as
        the reference's adopt_stream builds it (and every rank of a mesh
        from the plan): the grammar cursor walked over the committed ids
        (a start-state cursor would mask the continuation as if at the
        start of the string) and, for a speculating request, the drafter
        indexed over the prompt and the committed ids with its budget."""
        cursor = None
        if compiled is not None:
            cursor = ConstraintState(compiled)
            for t in committed:
                cursor.advance(t)
        spec_k = self.spec_budget(sampling)
        drafter = None
        if spec_k:
            drafter = PromptLookupDrafter(prompt_ids,
                                          max_ngram=self.spec.max_ngram,
                                          min_ngram=self.spec.min_ngram)
            for t in committed:
                drafter.append(int(t))
        return ParkedState(
            generated=len(committed) if generated is None else generated,
            tokens=list(committed), constraint=cursor, drafter=drafter,
            spec_k=spec_k)

    def _apply_plan(self, plan: dict, local: dict | None) -> None:
        """Every rank: queue this tick's requests in plan order (the leader
        its real Requests, followers shadows whose events go unread),
        mirror the cancellations, the drain, the stop, and keep the loop's
        flags and the planned forwards for this tick."""
        if local is not None:
            new, calls = local["new"], local["calls"]
        else:
            new = [self._shadow(payload) for payload in plan["new"]]
            calls = [(args, None, None) for args in plan["calls"]]
        for req in new:
            if not self._plan_acquire(req):
                continue
            self.pending.put(req)
        self._cancelled_effective |= set(plan["cancelled"])
        self._plan_draining = plan["draining"]
        if local is None:
            self.draining = plan["draining"]
        park_all, rids, flush = plan["flags"]
        self._tick_flags = (park_all, set(rids), flush)
        self._tick_calls = calls
        if plan["stop"]:
            self._running = False
            self._refuse_plan_calls(RuntimeError("engine shutting down"))

    def _plan_acquire(self, request: Request) -> bool:
        """Pin a planned request's adapter, on every rank in plan order, so
        every rank loads it into the same pool row and evicts the same
        idle one (the pool's state is a function of the plans). A refusal
        (a pool full of adapters in use) ends the request on every rank
        alike. False when it ended."""
        if self.lora is None or not request.sampling.lora:
            return True
        t0 = time.perf_counter()
        try:
            self.lora.acquire(request.sampling.lora, request.request_id)
        except ValueError as e:
            self._finish(request, "error", str(e))
            return False
        self._fr_emit(request, "lora_acquire", adapter=request.sampling.lora,
                      wait_s=round(time.perf_counter() - t0, 6))
        return True

    def _lockstep_tick(self, section: str | None = None) -> str | None:
        """One exchange of the tick plan, applied on every rank. A split
        engine names the lock section the leader runs next (`section`);
        returns the plan's, which a follower runs."""
        if not self.coordinator.is_leader:
            plan = self.coordinator.exchange(None)
            self._apply_plan(plan, None)
            return plan["section"]
        local = self._collect_plan(section)
        try:
            plan = self.coordinator.exchange(self._plan_wire(local))
        except PlanTooLarge as e:
            # refused before a byte went out: this plan's requests and
            # forwards end here, and the rest of it goes without them
            self._drop_planned(local, str(e))
            local = dict(local, new=[], calls=[])
            plan = self.coordinator.exchange(self._plan_wire(local))
        except BaseException:
            self._drop_planned(local, "engine step error")
            raise
        self._apply_plan(plan, local)
        return plan["section"]

    def _drop_planned(self, local: dict, message: str) -> None:
        """End a collected plan's requests and forwards that no rank will
        apply, on the leader, whose callers wait on them."""
        for req in local["new"]:
            self._finish(req, "error", message)
        self._refuse_calls(local["calls"], RuntimeError(message))

    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"no prefill bucket for prompt of {n} tokens")

    def _free_slots(self) -> list[int]:
        """Unoccupied slots, less the dense layout's pinned prefix donors
        (paged donors pin pages, not slots). Split mode admits into the
        prefill pool only: the decode pool fills by adoption."""
        if self.split is not None:
            return self.split.free_prefill_slots()
        pinned = (self.prefix_cache.pinned_slots()
                  if self.prefix_cache is not None else ())
        return [i for i, s in enumerate(self.slots)
                if s.request is None and i not in pinned]

    # ------------------------------------------ priority classes / preemption

    @staticmethod
    def _priority_of(request: Request) -> int:
        try:
            p = int(request.sampling.priority)
        except (TypeError, ValueError):
            p = PRIORITY_NORMAL
        return min(PRIORITY_LOW, max(PRIORITY_HIGH, p))

    def _drain_pending(self) -> None:
        while True:
            try:
                r = self.pending.get_nowait()
            except queue.Empty:
                return
            cls = self._priority_of(r)
            self._class_queues[cls].append(r)
            self._fr_emit(r, "queued", cls=PRIORITY_NAMES[cls],
                          position=len(self._class_queues[cls]) - 1)

    def _pop_request(self) -> Request | None:
        """Next request to admit: strictly by class. The held (page-starved)
        request keeps the front of its own class only: a more important
        class pops first, else a less important request wedged on the pool
        would block the arrival whose page-pressure preemption could free
        it."""
        self._drain_pending()
        held = self._held_request
        held_prio = self._priority_of(held) if held is not None else None
        for p in PRIORITY_CLASSES:
            if held_prio is not None and p >= held_prio:
                break
            if self._class_queues[p]:
                return self._class_queues[p].popleft()
        if held is not None:
            self._held_request = None
            return held
        for p in PRIORITY_CLASSES:
            if self._class_queues[p]:
                return self._class_queues[p].popleft()
        return None

    def _head_priority(self) -> int | None:
        """Class of the request _pop_request would return next."""
        best: int | None = None
        if self._held_request is not None:
            best = self._priority_of(self._held_request)
        for p in PRIORITY_CLASSES:
            if self._class_queues[p]:
                return p if best is None else min(best, p)
        return best

    def _hold_on_pool(self, request: Request) -> None:
        """Keep a page-starved request for the next iteration's retry. There
        is one hold: a request popped past a held one (a more important
        class) goes back to the front of its class instead of overwriting
        it, whose events would then never answer."""
        if self._held_request is None:
            self._held_request = request
        else:
            self._class_queues[self._priority_of(request)].appendleft(request)

    def _parkable(self, slot: _Slot) -> bool:
        """A decoding row whose committed tokens are all on the host: not
        prefilling (its KV is incomplete) and not first_pending (its first
        token lives only on the device)."""
        return (slot.request is not None and not slot.prefilling
                and not slot.first_pending)

    def _preempt_candidates(self, prio: int) -> list[int]:
        """Rows a class-`prio` request may park: parkable rows of a less
        important class, least important first, then fewest tokens (the
        cheapest resume), then slot id."""
        out = [i for i, s in enumerate(self.slots)
               if self._parkable(s) and self._priority_of(s.request) > prio]
        out.sort(key=lambda i: (-self._priority_of(self.slots[i].request),
                                int(self._seq_lens[i]), i))
        return out

    def _park_slot(self, slot_id: int, reason: str = "preempt") -> None:
        """Park one decoding row between bursts: its committed tokens go on
        the request, its pages back to the pool (shared prefix pages drop
        this row's reference), the donor entry of a hit is released, and the
        request goes back to the front of its class. Not a finish: its
        adapter stays pinned and no terminal event is sent. `reason`:
        preempt (priority), pages (pool exhaustion), drain or migrate."""
        slot = self.slots[slot_id]
        request = slot.request
        if not self._parkable(slot):
            raise RuntimeError(f"slot {slot_id} cannot park (prefilling or "
                               "first token pending)")
        # the grammar cursor and the drafter park with the request
        request.parked = ParkedState(generated=slot.generated,
                                     tokens=list(slot.out_tokens),
                                     constraint=slot.constraint,
                                     drafter=slot.drafter,
                                     spec_k=slot.spec_k)
        # the KV leaves before the pool reclaims its pages: an export for
        # the gateway, and the offload tier's copy for a local restore
        self._spill_parked_slot(slot_id, request, reason)
        self._release_cache_entry(slot)
        self._free_slot_kv(slot_id)
        self._clear_constraint(slot_id)  # the live mask row only
        slot.clear()
        self.preemptions_total += 1
        self._fr_emit(request, "parked", reason=reason,
                      generated=len(request.parked.tokens))
        log.info("parked request %s at %d committed tokens (priority %s, %s)",
                 request.request_id, len(request.parked.tokens),
                 PRIORITY_NAMES[self._priority_of(request)], reason)
        self._class_queues[self._priority_of(request)].appendleft(request)

    def _preempt_for_pages(self, prio: int) -> bool:
        """Page pressure: park one less important row that holds pages;
        False when there is none."""
        for i in self._preempt_candidates(prio):
            if self._slot_pages[i]:
                self._park_slot(i, reason="pages")
                return True
        return False

    def _shed_expired(self, request: Request) -> bool:
        """Deadline shedding at admission: a request past its deadline ends
        with an error before it costs a prefill. A resumed request is never
        shed: its client already holds part of the stream."""
        if (self.coordinator is not None or request.parked is not None
                or not request.deadline_expired()):
            # multi-rank: the leader sheds in _collect_plan, before the plan
            return False
        self.deadline_shed_total += 1
        self._finish(request, "error", "deadline exceeded before prefill",
                     event="shed", reason="deadline")
        return True

    def _drain_flush_all(self) -> None:
        """End every queued request (parked ones included) with an error."""
        self._drain_pending()
        flushed = []
        for p in PRIORITY_CLASSES:
            flushed.extend(self._class_queues[p])
            self._class_queues[p].clear()
        if self._held_request is not None:
            flushed.append(self._held_request)
            self._held_request = None
        for request in flushed:
            self._finish(request, "error", "engine draining")
        if flushed:
            log.info("drain flushed %d queued request(s)", len(flushed))

    def _park_requested(self, rids: set[str]) -> None:
        """Park the rows serving these gateway ids for a migration. A row
        that cannot park (prefilling, first token pending) or an id not
        decoding here is dropped: the export poll then times out and the
        migration aborts with the stream untouched."""
        for i, slot in enumerate(self.slots):
            if (self._parkable(slot)
                    and gateway_rid(slot.request.request_id) in rids):
                self._park_slot(i, reason="migrate")

    def _drain_park_all(self) -> None:
        """Park every parkable row (the drain's grace is spent). Prefilling
        and first_pending rows cannot park: the server closes their
        connections, and the gateway resumes them from its own ledger."""
        for i, slot in enumerate(self.slots):
            if self._parkable(slot):
                self._park_slot(i, reason="drain")
                self.drain_parked_total += 1

    def _finish(self, request: Request, kind: str, value: str, *,
                event: str | None = None, **attrs) -> None:
        """Every terminal event of a request goes through here, with its
        flight-recorder event ("finished" with the reason, "errored" with
        the message; or `event` with `attrs` alone: "shed" for a
        deadline), its count, and the release of its adapter."""
        request.finished_at = time.monotonic()
        self._cancelled_effective.discard(request.request_id)
        self._release_lora(request)
        if self.kv_offload is not None:
            # a parked spill of a request that ended is dead bytes
            self.kv_offload.drop_parked(request.request_id)
        if kind == "done":
            self.metrics.record_request_done(value)
            if event is None:
                event, attrs = "finished", {"reason": value, **attrs}
            self._fr_emit(request, event, **attrs)
            request.events.put(("done", value))
        else:
            self.metrics.record_request_done("error")
            if event is None:
                event, attrs = "errored", {"message": value, **attrs}
            self._fr_emit(request, event, **attrs)
            request.events.put(("error", value))

    def _finish_slot(self, slot_id: int, reason: str,
                     donate: bool = False) -> None:
        """Terminal teardown of an occupied slot: terminal event, the
        prompt's head donated to the prefix cache (`donate`: a decoding
        row's stop or length finish, as in the reference), the donor entry
        of a hit released, KV pages back to the pool (shared pages drop
        this row's reference only), every slot field reset."""
        slot = self.slots[slot_id]
        request = slot.request
        self._finish(request, "done", reason, generated=slot.generated)
        if donate and self.prefix_cache is not None:
            self._maybe_cache_prefix(slot_id, request)
        self._release_cache_entry(slot)
        self._free_slot_kv(slot_id)
        self._clear_constraint(slot_id)
        slot.clear()

    # ------------------------------------------------------------- paged KV

    def _pages_for_tokens(self, n: int) -> int:
        return -(-n // self.kv_page_size)

    def _try_reserve_pages(self, count: int) -> list[int] | None:
        """Alloc `count` fresh pages, evicting prefix-cache donors LRU under
        pool pressure; None (no side effects beyond the evictions) when the
        pool still cannot cover it. The dense layout needs none."""
        if count <= 0 or self.page_pool is None:
            return []
        while True:
            pages = self.page_pool.alloc(count)
            if pages is not None:
                return pages
            if self.prefix_cache is None or not self._evict_one_prefix():
                return None

    def _assign_slot_pages(self, slot_id: int, shared, fresh) -> None:
        """Install a slot's block-table row: `shared` donor pages first
        (zero-copy prefix reuse: the row takes a reference on each, no KV
        byte moves), then `fresh` pages (refcount 1 from alloc, owned)."""
        if self.page_pool is None:
            return
        for p in shared:
            self.page_pool.ref(p)
        row = list(shared) + list(fresh)
        self._slot_pages[slot_id] = row
        self._block_tables[slot_id, :] = 0
        self._block_tables[slot_id, :len(row)] = row
        self._tables_dirty = True

    def _extend_slot_pages(self, slot_id: int, fresh: list[int]) -> None:
        row = self._slot_pages[slot_id]
        start = len(row)
        row.extend(fresh)
        self._block_tables[slot_id, start:start + len(fresh)] = fresh
        self._tables_dirty = True

    def _free_slot_kv(self, slot_id: int) -> None:
        """Return a slot's pages to the pool (a shared prefix page just
        drops this row's reference; the cache or another row keeps it) and
        point its table row at the trash page, so the batched decode step's
        ongoing garbage writes for the freed row never land in a page a new
        owner holds."""
        pages = self._slot_pages[slot_id]
        if pages:
            for p in pages:
                self.page_pool.unref(p)
            self._slot_pages[slot_id] = []
            self._block_tables[slot_id, :] = 0
            self._tables_dirty = True

    def _sync_block_tables(self) -> None:
        """Refresh the device block tables before a dispatch that reads them
        (one small host-to-device copy into the same buffer, which captured
        bursts read, only when a row changed)."""
        if self._tables_dirty and self.page_pool is not None:
            self._d_block_tables.copy_(torch.from_numpy(self._block_tables))
            self._tables_dirty = False

    def _ensure_decode_pages(self, active: list[int], k: int,
                             per_row: dict[int, int] | None = None
                             ) -> list[int]:
        """Alloc-on-extend before a decode burst: grow each active row's
        pages to cover the k tokens the burst writes (a verify step: each
        row's own chunk, `per_row`). When the pool cannot
        cover a row once the prefix cache has given up every donor it can,
        the row parks less important rows for their pages; failing that it
        parks itself while another row decodes (to resume token-identical
        when pages free up); only a row decoding alone, or one whose first
        token is still on the device, finishes with "length". Returns the
        rows that remain active. The dense layout's rows hold their whole
        capacity already."""
        if self.page_pool is None:
            return active
        kept = []
        for i in active:
            slot = self.slots[i]
            if slot.request is None:
                continue  # parked for pages earlier in this walk
            n_write = k if per_row is None else per_row.get(i, k)
            target = min(int(self._seq_lens[i]) + n_write + 1,
                         self.slot_capacity)
            need = self._pages_for_tokens(target) - len(self._slot_pages[i])
            if need > 0:
                fresh = self._try_reserve_pages(need)
                while fresh is None and self._preempt_for_pages(
                        self._priority_of(slot.request)):
                    fresh = self._try_reserve_pages(need)
                if fresh is None:
                    request = slot.request
                    if not slot.first_pending and len(active) > 1:
                        log.warning("page pool exhausted mid-decode; parking "
                                    "request %s at %d tokens",
                                    request.request_id, int(self._seq_lens[i]))
                        self._park_slot(i, reason="pages")
                        continue
                    log.warning("page pool exhausted mid-decode; finishing "
                                "request %s at %d tokens", request.request_id,
                                int(self._seq_lens[i]))
                    if (slot.constraint is not None
                            and not slot.constraint.is_accepting):
                        # a grammar cut short: _emit's length rule
                        self._count("constraint_violations_total")
                    self._finish_slot(i, "length")
                    continue
                self._extend_slot_pages(i, fresh)
            kept.append(i)
        # a row kept earlier in the walk may have been parked for pages since
        return [i for i in kept if self.slots[i].request is not None]

    # -------------------------------------------------------------- admission

    def _try_insert(self) -> bool:
        self._prefill_spent_iter = 0  # the first call of every iteration
        plan_start = time.perf_counter()
        if self._loop_draining:
            # nothing new is admitted or re-activated: parked work stays
            # queued until the drain's flush
            return False
        self._drain_pending()
        queued = (sum(len(q) for q in self._class_queues.values())
                  + (self._held_request is not None))
        free = self._free_slots()
        if (not free and self.page_pool is None
                and self.prefix_cache is not None and len(self.prefix_cache)):
            # Slot pressure (dense only): live traffic beats cached prefixes,
            # so the LRU donor makes room for a queued request. Paged donors
            # pin no slot; page pressure evicts in _try_reserve_pages.
            if queued and self._evict_one_prefix():
                free = self._free_slots()
        if not free and queued and self.split is None:
            # Slot pressure: a queued request of a more important class
            # than some decoding row parks the least important one. (Split
            # mode's preemption point is the adoption: parking a decoding
            # row frees no prefill slot.)
            head = self._head_priority()
            if head is not None:
                victims = self._preempt_candidates(head)
                if victims:
                    self._park_slot(victims[0])
                    free = self._free_slots()
        if not free:
            return False
        # prompts longer than the chunk bucket take the chunked path (with a
        # budget set, whether or not rows decode: C3)
        max_oneshot = self._chunk_bucket
        # while rows decode, a one-shot group stops growing at the budget
        budget = self._prefill_budget_now()
        handled = False
        inserted = 0  # long inserts count toward the group cap too
        batch: list[tuple[int, Request, int]] = []  # (slot_id, request, n)
        batch_tokens = 0
        while free and len(batch) + inserted < self.MAX_PREFILL_GROUP:
            request = self._pop_request()
            if request is None:
                break
            if self._is_cancelled(request):
                self._finish(request, "done", "cancelled")
                handled = True
                continue
            if self._shed_expired(request):
                handled = True
                continue
            try:
                self._prepare_constraint(request)
            except Exception as e:  # boundary: the request's own error
                self._finish(request, "error", f"constraint rejected: {e}")
                handled = True
                continue
            n = len(request.prompt_ids)
            committed = (len(request.parked.tokens)
                         if request.parked is not None else 0)
            if self.slot_capacity - (n + committed) - 1 <= 0:
                if request.parked is not None:
                    # parked at the capacity edge: no room left to decode, a
                    # clean finish of a stream the client is consuming
                    self._finish(request, "done", "length")
                else:
                    self._finish(request, "error",
                                 "prompt does not fit slot capacity")
                handled = True
                continue
            # A parked request whose KV travelled as bytes (an adoption's
            # wire payload, or a spill to the offload tier) lands its pages
            # and re-enters decode: no prefill. A refusal falls through to
            # the replay below.
            if request.parked is not None:
                if (request.kv_restore is None
                        and self.kv_offload is not None):
                    request.kv_restore = self.kv_offload.pop_parked(
                        request.request_id)
                if request.kv_restore is not None:
                    slot_id = free.pop(0)
                    if self._insert_restored(slot_id, request, n + committed):
                        handled = True
                        inserted += 1
                        continue
                    free.insert(0, slot_id)
            if (budget and batch_tokens + min(n, max_oneshot) > budget
                    and (batch or inserted)):
                # this iteration's budget is spent: the request keeps the
                # front of its class for the next one
                self._class_queues[self._priority_of(request)].appendleft(
                    request)
                break
            # A prompt too short to match (at least one suffix token must
            # prefill, for the first sampled logits) bypasses the cache and
            # counts as no miss. So does a resumed request: its prompt
            # prefills cold, in the uninterrupted run's chunks.
            if (self.prefix_cache is not None and request.parked is None
                    and n - 1 >= self.min_prefix_len):
                # the offload tier first: a spilled head lands back into
                # fresh pages and re-enters the cache, which serves it below
                self._maybe_restore_prefix(request, n)
                # namespaced by adapter: under LoRA the prompt's KV depends
                # on the adapter's wq/wk/wv deltas
                hit = self.prefix_cache.match(request.prompt_ids,
                                              max_len=n - 1,
                                              ns=request.sampling.lora)
                if hit is not None and not self._prefer_cp_over(hit[1], n):
                    entry, use_len = hit
                    # Paged: the shared head rides the donor's pages, only
                    # the suffix needs fresh ones. The donor stays pinned
                    # ACROSS the reservation: its LRU eviction inside
                    # _try_reserve_pages would free the very pages about to
                    # be shared (and could hand them back as fresh ones).
                    # No pool operation runs between the release and
                    # _insert_cached's acquire, so the donor stays.
                    self.prefix_cache.acquire(entry)
                    fresh = self._try_reserve_pages(
                        self._pages_for_tokens(n)
                        - use_len // self.kv_page_size)
                    self.prefix_cache.release(entry)
                    if fresh is None:
                        self._hold_on_pool(request)
                        break
                    self._insert_cached(free.pop(0), request, entry, use_len,
                                        fresh)
                    handled = True
                    inserted += 1
                    continue
                self.prefix_counters.prefix_misses_total += 1
            # a resumed request reserves the pages its committed tokens and
            # the burst after them will fill: re-admitted into a pool that
            # cannot hold them, it would only park again
            need = self._pages_for_tokens(min(
                n + committed + (self.decode_burst if committed else 0),
                self.slot_capacity))
            pages = self._try_reserve_pages(need)
            while pages is None and self._preempt_for_pages(
                    self._priority_of(request)):
                pages = self._try_reserve_pages(need)
            if pages is None:
                self._hold_on_pool(request)
                break
            slot_id = free.pop(0)
            self._assign_slot_pages(slot_id, (), pages)
            if n > max_oneshot:
                if self._cp_capable(request):
                    # one ring-attention pass over the sp ranks fills the
                    # whole prompt's KV
                    self._cp_prefill_into_slot(slot_id, request, n)
                else:
                    self._insert_long(slot_id, request)
                handled = True
                inserted += 1
                continue
            # claim the slot before any dispatch: a failed prefill then
            # reaches the request through _fail_all
            self.slots[slot_id].request = request
            self.slots[slot_id].generated = 0
            batch.append((slot_id, request, n))
            batch_tokens += n
        if not batch:
            if handled:
                # admission work with no prefill of its own (hits, long
                # claims, restores): the next record's plan phase
                self._pending_plan_s += time.perf_counter() - plan_start
            return handled
        # plan ends where the dispatches begin
        self._pending_plan_s += time.perf_counter() - plan_start
        self._prefill_spent_iter = batch_tokens
        by_bucket: dict[int, list[tuple[int, Request, int]]] = {}
        for entry in batch:
            by_bucket.setdefault(self._bucket_for(entry[2]), []).append(entry)
        for bucket, group in by_bucket.items():
            self._prefill_group(bucket, group)
        return True

    def _insert_long(self, slot_id: int, request: Request,
                     start: int = 0) -> None:
        """Claim a slot for a prompt beyond the largest one-shot bucket, or
        for the suffix of a prefix-cache hit (from `start`): park its
        device seq_len at capacity-1 and let _advance_prefill feed chunks
        between decode steps."""
        slot = self.slots[slot_id]
        slot.request = request
        slot.generated = 0
        slot.prefilling = True
        slot.prefill_pos = start
        self._seq_lens[slot_id] = 0
        self._d_seq_lens[slot_id] = self.slot_capacity - 1

    def _cp_capable(self, request: Request) -> bool:
        """Whether a long prompt prefills in one ring-attention pass (an
        sp > 1 mesh and a family with a context-parallel prefill). A
        resumed row takes the chunked path: its prompt replays in the
        uninterrupted run's chunks. So does a request with an adapter, as
        in the reference: the ring pass carries no adapter rows (counted
        in lora_cp_fallback_total, warned once)."""
        if not (self._use_cp_prefill and hasattr(
                self.family, "make_context_parallel_prefill")):
            return False
        n = len(request.prompt_ids)
        if request.parked is not None or self._cp_bucket_for(n) < n:
            return False
        if self.lora is not None and request.sampling.lora:
            self.lora_cp_fallback_total += 1
            if self.lora_cp_fallback_total == 1:
                log.warning(
                    "LoRA request %s (adapter %r, %d prompt tokens) fell "
                    "back from context-parallel to chunked prefill: the CP "
                    "pass carries no adapter indices. Further fallbacks "
                    "count on llmlb_engine_lora_cp_fallback_total.",
                    request.request_id, request.sampling.lora, n)
            return False
        return True

    def _prefer_cp_over(self, use_len: int, n: int) -> bool:
        """On an sp > 1 mesh a long prompt prefills in ONE ring pass, while
        a cache hit's suffix goes through chunks: take the hit only when it
        covers at least half the prompt."""
        return (self._use_cp_prefill
                and hasattr(self.family, "make_context_parallel_prefill")
                and n > self._chunk_bucket and use_len < n // 2)

    def _cp_bucket_for(self, n: int) -> int:
        """The ring pass's padded length: the next power of two from the
        largest bucket, capped at the slot capacity rounded down to a
        multiple of sp (every rank holds T / sp tokens)."""
        sp = self.mesh.shape["sp"]
        b = max(self.prefill_buckets[-1], 1)
        while b < n:
            b *= 2
        return min(b, self.slot_capacity - self.slot_capacity % sp)

    def _cp_prefill_into_slot(self, slot_id: int, request: Request,
                              n: int) -> None:
        """One-shot ring-attention prefill of a long prompt over the sp
        ranks; its KV (gathered over sp on every rank) is written into the
        slot's pages or row, and the slot activates on the last token's
        logits. The slot is claimed before the dispatch, so a failure
        reaches the request through _fail_all."""
        if self._cp_prefill_fn is None:
            self._cp_prefill_fn = self.family.make_context_parallel_prefill(
                self.model_cfg, self.mesh)
        slot = self.slots[slot_id]
        slot.request = request
        slot.generated = 0
        ids = np.zeros((1, self._cp_bucket_for(n)), np.int64)
        ids[0, :n] = request.prompt_ids
        prefill_start = time.monotonic()
        t_dispatch = time.perf_counter()
        events = self._timing_events()
        # at dp the slot's group runs the ring (over its sp ranks), and the
        # dp exchange brings the logits and the written pages to the rest
        rows = self.mesh.dp_rows([self._slot_groups[slot_id]])
        if self.page_pool is not None:
            self._sync_block_tables()
        if rows is None or rows.mine:
            logits, k_all, v_all = self._cp_prefill_fn(
                self.params, self._to_device(ids),
                self._to_device(np.asarray([n], np.int32)))
            if self.page_pool is not None:
                self.family.scatter_prefill_kv(
                    self.cache_k, self.cache_v, k_all[:, :, :n],
                    v_all[:, :, :n], block_table=self._d_block_tables[slot_id])
            else:
                self.family.scatter_prefill_kv(
                    self.cache_k, self.cache_v, k_all[:, :, :n],
                    v_all[:, :, :n], slot=slot_id - self.family.dp_slot_offset(
                        self.cache_k, self._model_mesh))
        else:
            logits = torch.zeros((0, self.cfg.vocab_size),
                                 dtype=torch.float32, device=self.device)
        if rows is not None:
            cells = None
            if self.page_pool is not None:
                pos = torch.arange(n, device=self.device)[None]
                cells = self.family.page_cells(
                    self._d_block_tables[slot_id:slot_id + 1], pos,
                    self.kv_page_size)
            logits = self.family.dp_exchange(
                rows, self.mesh, logits, (self.cache_k, self.cache_v), cells)
        if events is not None:
            events[1].record()
        t_done = time.perf_counter()
        self._note_prefill_dispatch()
        self.metrics.record_prefill_step(time.monotonic() - prefill_start)
        self._fr_emit(request, "prefill_chunk", tokens=n, cached_tokens=0,
                      cp=True)
        self._activate_group([(slot_id, request, n)],
                             np.asarray([slot_id], np.int64),
                             np.asarray([n], np.int32), logits)
        self._record_step(
            "prefill", {"dispatch": t_done - t_dispatch,
                        "emit": time.perf_counter() - t_done},
            active_slots=1, tokens=n, slots=[slot_id], events=events)

    def _insert_cached(self, slot_id: int, request: Request,
                       entry: PrefixEntry, use_len: int,
                       fresh: list[int]) -> None:
        """Prefix-cache hit: the slot is claimed (before any dispatch, so a
        failure reaches the request through _fail_all) and prefilling from
        `use_len`; _advance_prefill then prefills only the uncached suffix.
        Paged, the donor's page ids for the head go into the row's table
        with a reference each, then the `fresh` suffix pages: no dispatch.
        Dense, the donor slot's rows [0, use_len) are copied on the device.
        The entry stays acquired until the suffix lands (or the request
        ends), so the donor cannot be evicted mid-flight."""
        self._insert_long(slot_id, request, start=use_len)
        self.slots[slot_id].cache_entry = entry
        self.prefix_cache.acquire(entry)
        if self.page_pool is not None:
            shared = entry.pages[:use_len // self.kv_page_size]
            self._assign_slot_pages(slot_id, shared, fresh)
        else:
            # at dp a donor in another group's slots comes over dp
            self.family.copy_slot_prefix(self.cache_k, self.cache_v, slot_id,
                                         entry.slot, use_len,
                                         self._model_mesh)
            self.prefix_counters.kv_copy_dispatches += 1
        self.prefix_counters.prefix_hits_total += 1
        self.prefix_counters.prefix_cached_tokens_total += use_len
        self._fr_emit(request, "prefill_chunk", tokens=0,
                      cached_tokens=use_len)

    def _prefill_group(self, bucket: int,
                       group: list[tuple[int, Request, int]]) -> None:
        """Prefill G same-bucket prompts in one dispatch, padded to the next
        power of two by repeating the last row — the duplicate scatters write
        identical data to the same cells."""
        g = len(group)
        padded = 1
        while padded < g:
            padded *= 2
        ids = np.zeros((padded, bucket), np.int64)
        lens = np.zeros((padded,), np.int32)
        slot_ids = np.zeros((padded,), np.int64)
        for row, (slot_id, request, n) in enumerate(group):
            ids[row, :n] = request.prompt_ids
            lens[row] = n
            slot_ids[row] = slot_id
        ids[g:] = ids[g - 1]
        lens[g:] = lens[g - 1]
        slot_ids[g:] = slot_ids[g - 1]
        # per-row adapter rows: a mixed-adapter group prefills in this one
        # dispatch; padding rows repeat the last real row
        lora_idx = None
        if self.lora is not None:
            lidx = np.zeros((padded,), np.int32)
            lidx[:g] = self._lora_rows([r for _, r, _ in group])
            lidx[g:] = lidx[g - 1]
            lora_idx = self._to_device(lidx)
        prefill_start = time.monotonic()
        t_dispatch = time.perf_counter()
        events = self._timing_events()
        mesh_kw = self._mesh_kw(slot_ids)
        if self.page_pool is not None:
            self._sync_block_tables()
            logits, _, _ = self.family.prefill_into_pages(
                self.params, self.model_cfg, self._to_device(ids),
                self._to_device(lens),
                self._to_device(self._block_tables[slot_ids]),
                self.cache_k, self.cache_v, lora_idx=lora_idx, **mesh_kw)
        else:
            logits, _, _ = self.family.prefill_into_slots(
                self.params, self.model_cfg, self._to_device(ids),
                self._to_device(lens), self._to_device(slot_ids),
                self.cache_k, self.cache_v, lora_idx=lora_idx, **mesh_kw)
        if events is not None:
            events[1].record()
        t_done = time.perf_counter()
        self._note_prefill_dispatch()
        # the host wall of the launches: the host never waits for a prefill
        self.metrics.record_prefill_step(time.monotonic() - prefill_start)
        if self.flightrec.enabled:
            for _slot_id, request, n in group:
                self.flightrec.emit(request.request_id, "prefill_chunk",
                                    tokens=n, cached_tokens=0)
        self._activate_group(group, slot_ids, lens, logits)
        self._record_step(
            "prefill", {"dispatch": t_done - t_dispatch,
                        "emit": time.perf_counter() - t_done},
            active_slots=len(group), tokens=sum(n for _, _, n in group),
            slots=[s for s, _, _ in group], events=events)

    def _advance_prefill(self) -> bool:
        """Feed ONE chunk of ONE prefilling slot's prompt into the pool,
        rotating among prefilling slots."""
        prefilling = [i for i, s in enumerate(self.slots)
                      if s.prefilling and not s.handoff_ready]
        if not prefilling:
            return False
        slot_id = prefilling[self._prefill_rr % len(prefilling)]
        self._prefill_rr += 1
        slot = self.slots[slot_id]
        request = slot.request
        if self._is_cancelled(request):
            self._finish_slot(slot_id, "cancelled")
            return True
        prompt = request.prompt_ids
        n = len(prompt)
        start = slot.prefill_pos
        # A cold prompt's chunks start at multiples of the chunk bucket (the
        # largest bucket, or the budget's; a prompt within one bucket
        # prefills in one dispatch from 0). A prefix-cache hit's suffix
        # starts inside such a chunk: it runs that chunk's rest padded to the
        # chunk's own bucket, and the next chunks as a cold run does. Each
        # row then meets the product shapes a cold run gives it, and on the
        # card, where cuBLAS picks its sums by shape, its logits equal the
        # cold run's bit for bit (a 95-token suffix at bucket 128 moved
        # Llama-3-8B's logits by 3.5x the bf16 limit from the 479-token
        # chunk's at bucket 512).
        largest = self._chunk_bucket
        chunk_start = start - start % largest
        chunk_end = min(chunk_start + largest, n)
        chunk_len = chunk_end - start
        budget = self._prefill_budget_now()
        if (budget and self._prefill_spent_iter
                and chunk_len > budget - self._prefill_spent_iter):
            # the iteration's one-shot group left too little of the budget
            # for this chunk, which is never cut (its bucket is the cold
            # run's): it runs in the next iteration
            return False
        bucket = self._bucket_for(chunk_end - chunk_start)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :chunk_len] = prompt[start:start + chunk_len]
        lora_idx = (self._to_device(self._lora_rows([request]))
                    if self.lora is not None else None)
        prefill_start = time.monotonic()
        t_dispatch = time.perf_counter()
        events = self._timing_events()
        args = (self.params, self.model_cfg, self._to_device(ids),
                self._to_device(np.asarray([chunk_len], np.int32)),
                self._to_device(np.asarray([start], np.int32)))
        mesh_kw = self._mesh_kw([slot_id])
        if self.page_pool is not None:
            logits, _, _ = self.family.prefill_extend_pages(
                *args, self._to_device(self._block_tables[slot_id:slot_id + 1]),
                self.cache_k, self.cache_v, lora_idx=lora_idx, **mesh_kw)
        else:
            logits, _, _ = self.family.prefill_extend_slots(
                *args, self._to_device(np.asarray([slot_id], np.int64)),
                self.cache_k, self.cache_v, lora_idx=lora_idx, **mesh_kw)
        if events is not None:
            events[1].record()
        t_done = time.perf_counter()
        self._note_prefill_dispatch()
        self.metrics.record_prefill_step(time.monotonic() - prefill_start)
        slot.prefill_pos = start + chunk_len
        self._fr_emit(request, "prefill_chunk", tokens=chunk_len,
                      cached_tokens=0, pos=start)
        if slot.prefill_pos >= n:
            slot.prefilling = False
            self._release_cache_entry(slot)  # suffix landed: donor evictable
            self._activate_group([(slot_id, request, n)],
                                 np.asarray([slot_id], np.int64),
                                 np.asarray([n], np.int32), logits)
        self._record_step(
            "prefill", {"dispatch": t_done - t_dispatch,
                        "emit": time.perf_counter() - t_done},
            active_slots=1, tokens=chunk_len, slots=[slot_id], events=events)
        return True

    def _prefill_budget_now(self) -> int:
        """Prompt tokens this iteration may prefill (0 = no cap): the budget
        applies only while some row decodes; an idle engine's iterations
        prefill without a cap (in the same chunks)."""
        b = self.prefill_chunk_budget
        if b <= 0:
            return 0
        if not any(s.request is not None and not s.prefilling
                   for s in self.slots):
            return 0
        return b

    def _budget_chunk_len(self, budget: int) -> int:
        """The largest prefill bucket within the budget (floor: the
        smallest bucket, since chunks run at buckets)."""
        best = self.prefill_buckets[0]
        for bkt in self.prefill_buckets:
            if bkt <= budget:
                best = bkt
        return best

    def _activate_group(self, group: list[tuple[int, Request, int]],
                        padded_slot_ids: np.ndarray, padded_lens: np.ndarray,
                        logits: torch.Tensor) -> None:
        """Sample each row's first token on the device and scatter the
        sampling params, lengths and first tokens into the per-slot device
        state. Padding rows repeat the last real row. In split mode a
        prefill-loop activation stages the group instead, and the handoff
        pump adopts each row into a decode slot, coming back here under the
        "handoff" tag."""
        if self.split is not None and self._loop_tag() == "prefill":
            self.split.stage_group(group, logits)
            self.split.pump_handoffs()
            return
        count_nan_rows(self._d_nan_rows, logits)
        # every insert path funnels through here (or _insert_restored): the
        # cursor and mask row go in before the first token is sampled, and
        # the drafter (a parked one as it was)
        for slot_id, request, _n in group:
            self._attach_constraint(slot_id, request)
            self._attach_spec(slot_id, request)
        padded = len(padded_slot_ids)
        temps = np.ones((padded,), np.float32)
        top_ps = np.ones((padded,), np.float32)
        top_ks = np.zeros((padded,), np.int32)
        seeds = np.full((padded,), -1, np.int64)
        for row, (_slot_id, request, _n) in enumerate(group):
            s = request.sampling
            temps[row] = s.temperature
            top_ps[row] = s.top_p
            top_ks[row] = s.top_k
            if s.seed is not None:
                seeds[row] = s.seed & 0x7FFFFFFF
        for arr in (temps, top_ps, top_ks, seeds):
            arr[len(group):] = arr[len(group) - 1]
        d_temps = self._to_device(temps)
        d_top_ps = self._to_device(top_ps)
        d_top_ks = self._to_device(top_ks)
        # steps = lens - 1: decode samples with the pre-increment seq_len, so
        # the activation sample must use a different step for seeded rows
        d_seeds = self._to_device(seeds)
        seeded = bool((seeds >= 0).any())
        # constrained rows sample their first token under their cursor's
        # mask row (padding rows repeat the last real row)
        constrained = [row for row, (slot_id, _r, _n) in enumerate(group)
                       if self.slots[slot_id].constraint is not None]
        mask = None
        if constrained:
            bias = np.zeros((padded, logits.shape[-1]), np.float32)
            for row in constrained:
                bias[row] = self.slots[group[row][0]].constraint.bias_row()
            bias[len(group):] = bias[len(group) - 1]
            mask = self._to_device(bias)
        firsts = sample_tokens(logits, self._generator, d_temps, d_top_ps,
                               d_top_ks, mask_bias=mask,
                               seeds=d_seeds if seeded else None,
                               steps=self._to_device(padded_lens - 1))
        # a resumed row's last token going in is its first committed token,
        # not the activation sample (an unseeded row's would be another
        # draw); nothing is emitted for it again. Padding rows repeat the
        # last real row, and scatter into its slot too.
        parked = [group[min(row, len(group) - 1)][1].parked
                  for row in range(padded)]
        resumed = [row for row, p in enumerate(parked) if p and p.tokens]
        if resumed:
            firsts[self._to_device(np.asarray(resumed, np.int64))] = (
                self._to_device(np.asarray([parked[r].tokens[0]
                                            for r in resumed], np.int32)))
        idx = self._to_device(padded_slot_ids)
        self._d_temps[idx] = d_temps
        self._d_top_ps[idx] = d_top_ps
        self._d_top_ks[idx] = d_top_ks
        self._d_seeds[idx] = d_seeds
        if self.lora is not None:
            # adapter rows ride the activation scatter with the sampling
            # params: a decode burst then copies none
            lidx = np.zeros((padded,), np.int32)
            lidx[:len(group)] = self._lora_rows([r for _, r, _ in group])
            lidx[len(group):] = lidx[len(group) - 1]
            self._d_lora_idx[idx] = self._to_device(lidx)
        self._d_seq_lens[idx] = self._to_device(padded_lens)
        self._d_last_tokens[idx] = firsts
        # The next burst needs each constrained row's cursor past its first
        # token, which exists only on the device: one synchronous fetch per
        # constrained activation (the reference's constrained-TTFT cost). A
        # resumed row's first token is its first committed one, which its
        # parked cursor already stands after: no advance.
        fresh = [row for row in constrained
                 if not (parked[row] and parked[row].tokens)]
        if fresh:
            first_host = firsts.cpu().numpy()
            for row in fresh:
                slot_id = group[row][0]
                state = self.slots[slot_id].constraint
                if state.advance(int(first_host[row])):
                    self._set_mask_row(slot_id, state)
                else:
                    self._count("constraint_violations_total")
                self.slots[slot_id].first_advanced = True
        for row, (slot_id, request, n) in enumerate(group):
            self._seq_lens[slot_id] = n
            self._seeds[slot_id] = seeds[row]
            slot = self.slots[slot_id]
            slot.request = request
            parked = request.parked
            if parked is None:
                slot.generated = 0
                slot.out_tokens = []
                slot.first_pending = True
                continue
            # resume: the committed tokens after the first are fed through
            # decode steps; with none committed (an adoption of a stream
            # with no tokens yet) the activation sample is emitted as usual
            request.parked = None
            slot.generated = parked.generated
            slot.out_tokens = list(parked.tokens)
            slot.forced = list(parked.tokens[1:])
            slot.first_pending = not parked.tokens
            self.preempt_resumes_total += 1
            self._fr_emit(request, "resumed", generated=parked.generated)

    # ----------------------------------------------------------------- decode

    def _window_for(self, active: list[int], k: int) -> int:
        """Smallest context-window bucket covering every active sequence
        plus the k tokens this dispatch adds."""
        needed = max(int(self._seq_lens[i]) for i in active) + k + 1
        for w in self._window_buckets:
            if w >= needed:
                return w
        return self.slot_capacity

    def _decode_active(self) -> bool:
        pool = (self.split.decode_pool if self.split is not None
                else range(self.num_slots))
        active = [i for i in pool if self.slots[i].request is not None
                  and not self.slots[i].prefilling]
        if not active:
            # the occupancy gauge would otherwise freeze at the last batch
            self.metrics.set_batch_occupancy(0)
            return False
        # Speculative decoding: when any active row proposes drafts, ONE
        # verify step replaces this burst. A row being fed forced tokens (a
        # resume) keeps the step a burst until it is fed, so its committed
        # tokens' KV is written by decode steps (C4). No draft: the burst,
        # whose record carries the drafting time.
        draft_s = 0.0
        if (any(self.slots[i].drafter is not None for i in active)
                and not any(self.slots[i].forced for i in active)):
            t_draft = time.perf_counter()
            fused = self._fused_step_ok(active)
            drafts, lookahead = self._collect_drafts(active, fused)
            draft_s = time.perf_counter() - t_draft
            if any(drafts.values()):
                return self._verify_active(active, drafts, lookahead, fused,
                                           draft_s)
        burst_start = time.monotonic()
        t_sync = time.perf_counter()
        # alloc-on-extend: every page the burst writes exists before the
        # tables ship to the device
        active = self._ensure_decode_pages(active, self.decode_burst)
        if not active:
            self.metrics.set_batch_occupancy(0)
            return True
        self._sync_block_tables()
        k, mode = self.decode_burst, "free"
        if any(self.slots[i].constraint is not None for i in active):
            if self._fused_step_ok(active):
                # every constrained row's schema is in the device table
                mode = "grammar"
                self._sync_gram_state(active)
            else:
                # the host-mask fallback: one step under the host's rows
                mode = "mask"
                if k > 1:
                    self._count("constrained_burst_fallback_total")
                k = 1
                self._sync_mask()
            self._count("masked_decode_steps_total")
        self._sync_forced(active, k)
        window = self._window_for(active, k)
        # seeded rows draw threefry noise, another graph: decided on the host
        seeded = bool((self._seeds[active] >= 0).any())
        t_dispatch = time.perf_counter()
        sync_s = t_dispatch - t_sync
        events = self._timing_events()
        replays = self._bursts.replays
        self._bursts.run(window, seeded, mode)
        replayed = self._bursts.replays > replays
        t_compute = time.perf_counter()
        if events is not None:
            # the ONE host wait per burst; the fetch below then copies
            events[1].record()
            events[1].synchronize()
        t_fetch = time.perf_counter()
        tokens = self._d_tokens[:k + 1].cpu().numpy()
        t_emit = time.perf_counter()
        self.decode_bursts += 1
        # the burst's tokens reach the host together: its per-token pacing
        # is the inter-token latency
        step_s = (time.monotonic() - burst_start) / k
        self.metrics.record_decode_step(step_s, len(active))
        self._emit_itl = step_s
        self._emit_fetched(tokens, active)
        self._record_step(
            "decode",
            {"draft": draft_s, "host_sync": sync_s,
             "dispatch": t_compute - t_dispatch,
             "compute": t_fetch - t_compute,
             "fetch": t_emit - t_fetch,
             "emit": time.perf_counter() - t_emit},
            active_slots=len(active), tokens=k * len(active), slots=active,
            dispatches=1 if replayed else k, fused=replayed, events=events,
            waited=True)
        return True

    def _sync_forced(self, active: list[int], k: int) -> None:
        """Write the burst's forced tokens: each resumed row's next
        committed tokens, one a step of the burst's k, into the device
        buffer and mask the burst reads (in place; copied only when this
        burst or the last one forces anything)."""
        self._force_mask[:] = False
        for i in active:
            feed = self.slots[i].forced[:k]
            self._force_tokens[:len(feed), i] = feed
            self._force_mask[:len(feed), i] = True
        forcing = bool(self._force_mask.any())
        if forcing or self._force_dirty:
            self._d_force_tokens.copy_(torch.from_numpy(self._force_tokens))
            self._d_force_mask.copy_(torch.from_numpy(self._force_mask))
        self._force_dirty = forcing

    def _burst_body(self, window: int, seeded: bool, mode: str) -> None:
        """The k steps of one burst over the static buffers (eager, or under
        capture). The mask key runs one step: the first two rows of the
        token block and the first row of the forced buffers, views of the
        same static storage."""
        state = self._burst_state
        if mode == "mask":
            state = dataclasses.replace(
                state, tokens=state.tokens[:2],
                force_tokens=state.force_tokens[:1],
                force_mask=state.force_mask[:1])
        burst_body(state, window, seeded, mode)

    def _verify_body(self, window: int, seeded: bool, mode: str) -> None:
        """One verify step over the static buffers (eager, or under
        capture)."""
        verify_body(self._burst_state, window, seeded, mode)

    # ---------------------------------------------------- speculative decode

    def _attach_spec(self, slot_id: int, request: Request) -> None:
        """Install the row's drafter at activation: a parked one as it was
        (its index holds prompt and committed tokens: a park and
        `Engine.adopt_stream` both carry one whenever the knob enables
        speculation); else, when the request's knob (or the engine's
        default) enables it, a new one over the prompt. The draft budget
        clamps into the engine's verify width."""
        slot = self.slots[slot_id]
        parked = request.parked
        if parked is not None and parked.drafter is not None:
            slot.drafter, slot.spec_k = parked.drafter, parked.spec_k
            return
        slot.spec_k = self.spec_budget(request.sampling)
        slot.drafter = (PromptLookupDrafter(request.prompt_ids,
                                            max_ngram=self.spec.max_ngram,
                                            min_ngram=self.spec.min_ngram)
                        if slot.spec_k else None)

    def spec_budget(self, sampling: SamplingParams) -> int:
        """A request's draft budget a verify step, 0 when it does not
        speculate: its `speculative` knob, or the engine's defaults for the
        keys it leaves out, clamped into the verify width."""
        knobs = sampling.speculative
        knobs = knobs if isinstance(knobs, dict) else {}
        if not bool(knobs.get("enabled", self.spec.enabled)):
            return 0
        try:
            k = int(knobs.get("max_draft_tokens")
                    or self.spec.max_draft_tokens)
        except (TypeError, ValueError):
            k = self.spec.max_draft_tokens
        return max(1, min(k, self.spec.max_draft_tokens))

    def _collect_drafts(self, active: list[int], fused: bool
                        ) -> tuple[dict[int, list[int]], dict[int, list[int]]]:
        """Each active row's drafts this step (none for a row that does not
        speculate, has no n-gram match or no room), and each constrained
        row's FSM states along its kept drafts (the mask key's lookahead).
        Under the grammar key (`fused`) drafts are not cut on the host: the
        device walks the table, and a disallowed draft fails its masked
        comparison where the cut would have been."""
        drafts: dict[int, list[int]] = {}
        lookahead: dict[int, list[int]] = {}
        for i in active:
            slot = self.slots[i]
            d: list[int] = []
            # a first_pending row's last token is on the device only, which
            # its drafter has not seen: a 1-token chunk this step
            if slot.drafter is not None and not slot.first_pending:
                room = self.slot_capacity - 2 - int(self._seq_lens[i])
                budget = slot.request.sampling.max_tokens - slot.generated - 1
                k = min(slot.spec_k, room, budget)
                if k > 0:
                    d = slot.drafter.propose(k)
                if d and slot.constraint is not None and not fused:
                    d, lookahead[i] = self._constrained_draft_prefix(
                        slot.constraint, d)
            drafts[i] = d
        return drafts, lookahead

    @staticmethod
    def _constrained_draft_prefix(state: ConstraintState, drafts: list[int]
                                  ) -> tuple[list[int], list[int]]:
        """Cut a proposal at the first token the grammar refuses, walking a
        copy of the cursor (the live one advances on emitted tokens only).
        Returns (kept drafts, FSM states after each, the current first). EOS
        never drafts: accepting a stop is the model's call."""
        tc = state.tc
        s = state.state
        kept: list[int] = []
        states = [s]
        if state.violated:
            return kept, states
        for t in drafts:
            if (t == tc.eos_id or not 0 <= t < tc.allowed.shape[1]
                    or not tc.allowed[s, t]):
                break
            nxt = tc.advance(s, t)
            if nxt is None:
                break
            kept.append(t)
            s = nxt
            states.append(s)
        return kept, states

    def _trim_slot_pages(self, slot_id: int, keep_tokens: int) -> None:
        """Rejected-draft rollback: release the trailing pages a verify step
        allocated beyond what `keep_tokens` needs. Trailing pages are the
        row's own fresh ones (shared prefix pages sit at the front, and the
        committed length never rolls back below the prompt), so one unref
        each is exact and the pool's double-free guard stays armed."""
        if self.page_pool is None:
            return
        keep = self._pages_for_tokens(keep_tokens)
        row = self._slot_pages[slot_id]
        if len(row) <= keep:
            return
        for p in row[keep:]:
            self.page_pool.unref(p)
        del row[keep:]
        self._block_tables[slot_id, keep:] = 0
        self._tables_dirty = True

    def _sync_verify_mask(self, masked: list[int],
                          lookahead: dict[int, list[int]]) -> None:
        """The mask key's [slots, K+1, V] bias from the host FSMs: column 0
        the live cursor's row, column j the state after the kept drafts
        1..j, the last live state repeated past them. Only rows masked now
        or last step are written (a row that left the masked set is zeroed),
        in place: the buffer is allocated once, at its first use, since the
        mask key's graph reads its address."""
        rows = sorted(set(masked) | self._spec_masked_prev)
        k1 = self.spec.max_draft_tokens + 1
        v = self.cfg.vocab_size
        if self._d_verify_mask is None:
            self._d_verify_mask = torch.zeros((self.num_slots, k1, v),
                                              dtype=torch.float32,
                                              device=self.device)
            self._burst_state = dataclasses.replace(
                self._burst_state, verify_mask=self._d_verify_mask)
        stripes = np.zeros((len(rows), k1, v), np.float32)
        for n, i in enumerate(rows):
            state = self.slots[i].constraint
            if state is None or i not in masked:
                continue  # left the masked set: the zero stripe clears it
            stripes[n, 0] = state.bias_row()
            states = lookahead.get(i, [state.state])
            for j, st in enumerate(states[1:], start=1):
                stripes[n, j] = state.tc.bias_row(st)
            stripes[n, len(states):] = stripes[n, len(states) - 1]
        if rows:
            self._d_verify_mask.index_copy_(
                0, torch.as_tensor(rows, dtype=torch.int64, device=self.device),
                self._to_device(stripes))
        self._spec_masked_prev = set(masked)

    def _verify_active(self, active: list[int], drafts: dict[int, list[int]],
                       lookahead: dict[int, list[int]], fused: bool,
                       draft_s: float = 0.0) -> bool:
        """One speculative verify step (the reference's fused verify): each
        active row's last token and drafts as a K+1-token chunk through the
        extend path, every position sampled, the longest prefix of drafts
        matching the samples accepted, accepted + 1 tokens emitted a row,
        and the pages of rejected drafts released. Every other row is an
        empty chunk (length 0) at the capacity's last cell: its K/V writes
        land there, the garbage contract of decode, and the extend kernels
        skip its queries, so it reads no keys (as a 1-token chunk, the
        reference's, a row parked at the last cell would sweep the whole
        capacity). One graph replay (or eager step) and one host fetch. Its
        record carries `draft_s`, the drafting time, as its draft phase."""
        k1 = self.spec.max_draft_tokens + 1
        step_start = time.monotonic()
        t_sync = time.perf_counter()
        per_row = {i: len(drafts.get(i, ())) + 1 for i in active}
        active = self._ensure_decode_pages(active, 1, per_row)
        if not active:
            self.metrics.set_batch_occupancy(0)
            return True
        self._sync_block_tables()
        b = self.num_slots
        host = self._verify_host
        nk = b * k1
        ids = host[:nk].reshape(b, k1)
        lens = host[nk:nk + b]
        start = host[nk + b:nk + 2 * b]
        act = host[nk + 2 * b:]
        ids[:] = 0
        lens[:] = 0
        start[:] = self.slot_capacity - 1
        act[:] = 0
        for i in active:
            d = drafts.get(i, ())
            ids[i, 1:1 + len(d)] = d
            lens[i] = 1 + len(d)
            start[i] = self._seq_lens[i]
            act[i] = 1
        self._d_verify_in.copy_(torch.from_numpy(host))
        masked = [i for i in active if self.slots[i].constraint is not None]
        mode = "free"
        if fused:
            if masked:
                mode = "grammar"
                self._sync_gram_state(active)
        elif masked or self._spec_masked_prev:
            self._sync_verify_mask(masked, lookahead)
            mode = "mask" if masked else "free"
        if masked:
            self._count("masked_decode_steps_total")
        window = self._window_for(active, k1)
        seeded = bool((self._seeds[active] >= 0).any())
        t_dispatch = time.perf_counter()
        sync_s = t_dispatch - t_sync
        events = self._timing_events()
        replays = self._verifies.replays
        self._verifies.run(window, seeded, mode)
        replayed = self._verifies.replays > replays
        t_compute = time.perf_counter()
        if events is not None:
            # the ONE host wait of the step; the fetch below then copies
            events[1].record()
            events[1].synchronize()
        t_fetch = time.perf_counter()
        out = self._d_verify_out.cpu().numpy()  # [slots, K+3]
        t_emit = time.perf_counter()
        step_s = time.monotonic() - step_start

        drafted = sum(len(drafts.get(i, ())) for i in active)
        accepted_total = 0
        emitted_total = 0  # every row's tokens (the throughput window's)
        spec_emitted = 0  # the speculating rows' (accepted + 1 each)
        # (request id, drafted, accepted) a speculating row, taken before
        # its emits can finish it
        spec_accepts: list[tuple[str, int, int]] = []
        for i in active:
            slot = self.slots[i]
            self._emit_itl = step_s
            if slot.first_pending and slot.request is not None:
                slot.first_pending = False
                self._emit(i, int(out[i, 0]))
            if slot.request is None or slot.prefilling:
                continue
            rid = slot.request.request_id
            d = drafts.get(i, [])
            # the row's expected span (matches up to the first miss, + 1):
            # its tokens' pacing, before a finish can cut it
            span = 1
            for j, dj in enumerate(d):
                if int(out[i, 1 + j]) != dj or dj == self.eos_id:
                    break
                span += 1
            self._emit_itl = step_s / span
            j = 0
            emitted = 0
            while True:
                tok = int(out[i, 1 + j])
                self._seq_lens[i] += 1
                emitted += 1
                matched = j < len(d) and tok == d[j]
                self._emit(i, tok)
                if matched:
                    j += 1
                if slot.request is None or not matched:
                    break
            accepted_total += j
            emitted_total += emitted
            if d:
                spec_emitted += emitted
                spec_accepts.append((rid, len(d), j))
            if slot.request is not None:
                # keep the pages of the committed length and the next write
                self._trim_slot_pages(i, int(self._seq_lens[i]) + 1)
        with self._lock:
            c = self.spec_counters
            c.verify_steps_total += 1
            c.draft_tokens_total += drafted
            c.accepted_tokens_total += accepted_total
            c.emitted_tokens_total += spec_emitted
        self.metrics.record_decode_step(
            step_s / max(1.0, emitted_total / max(1, len(active))),
            len(active))
        if self.flightrec.enabled:
            for rid, n_drafted, n_accepted in spec_accepts:
                self.flightrec.emit(rid, "spec_accept", drafted=n_drafted,
                                    accepted=n_accepted)
        self._record_step(
            "verify",
            {"draft": draft_s, "host_sync": sync_s,
             "dispatch": t_compute - t_dispatch,
             "compute": t_fetch - t_compute,
             "fetch": t_emit - t_fetch,
             "emit": time.perf_counter() - t_emit},
            active_slots=len(active), tokens=emitted_total, slots=active,
            dispatches=1, fused=replayed, events=events, waited=True)
        return True

    def _emit_fetched(self, tokens: np.ndarray, active: list[int]) -> None:
        """Deliver one fetched token block [k+1, slots]: row 0 holds first
        tokens of slots activated since the previous fetch (no seq_len
        advance — the first token is prefill output); rows 1.. are decode
        steps. Tokens of a slot that finishes mid-block are dropped."""
        for i in active:
            slot = self.slots[i]
            if slot.first_pending and slot.request is not None:
                slot.first_pending = False
                self._emit(i, int(tokens[0, i]))
        for t in range(1, tokens.shape[0]):
            for i in active:
                slot = self.slots[i]
                if slot.request is None or slot.prefilling:
                    continue
                self._seq_lens[i] += 1
                if slot.forced:
                    # a committed token fed back: its KV is written, it was
                    # emitted before the park
                    slot.forced.pop(0)
                    if self._is_cancelled(slot.request):
                        self._finish_slot(i, "cancelled")
                    continue
                self._emit(i, int(tokens[t, i]))

    def _emit(self, slot_id: int, token: int) -> None:
        """Deliver one generated token and apply the finish rules: EOS,
        max_tokens, and the slot-capacity edge. A constrained row's cursor
        advances on the token (not on a first token whose cursor activation
        advanced), and the new state's mask row governs the next burst.
        `_emit_itl`, the dispatch's per-token pacing (its tokens reach the
        host together, so their wall gaps are ~0), is recorded as the
        inter-token latency of every token but a row's first."""
        slot = self.slots[slot_id]
        request = slot.request
        if self._is_cancelled(request):
            self._finish_slot(slot_id, "cancelled")
            return
        slot.generated += 1
        now = time.monotonic()
        if request.first_token_at is None:
            request.first_token_at = now
            self.metrics.record_ttft(now - request.submitted_at)
        itl = self._emit_itl
        self.metrics.record_emit(
            None if not slot.last_emit_at
            else itl if itl is not None else now - slot.last_emit_at)
        slot.last_emit_at = now
        # The mask makes a refused sample impossible, so a failed advance
        # means a vocabulary gap forced the EOS fallback: counted.
        state = slot.constraint
        first_advanced, slot.first_advanced = slot.first_advanced, False
        if state is not None and not first_advanced:
            if not state.advance(token):
                self._count("constraint_violations_total")
            elif token != self.eos_id:
                self._set_mask_row(slot_id, state)
        finish: str | None = None
        if token == self.eos_id:
            finish = "stop"  # EOS itself is not emitted as content
        else:
            slot.out_tokens.append(token)
            if slot.drafter is not None:
                # every emitted token extends the prompt-lookup index
                slot.drafter.append(token)
            request.events.put(("token", token))
            if slot.generated >= request.sampling.max_tokens:
                finish = "length"
            elif self._seq_lens[slot_id] + 1 >= self.slot_capacity:
                finish = "length"
        if (finish == "length" and state is not None
                and not state.is_accepting):
            # cut short before the grammar accepted
            self._count("constraint_violations_total")
        if finish == "length" and request.export_kv and self.kv_ship:
            # a handoff's prefill side: the pages leave before they free
            request.kv_export = self._kv_export_payload(slot_id, request)
        if finish is not None:
            self._finish_slot(slot_id, finish, donate=True)

    # ------------------------------------------------------------ constraints

    def _prepare_constraint(self, request: Request) -> None:
        """A constrained request carries its compiled token DFA before it
        claims a slot: the service compiles it off the step loop; this is
        the fallback for core-level submitters and for a multi-rank
        follower, whose shadow carries only the spec: a cold schema
        compiles here, on its loop, while the leader compiles it in its
        service, and the compiler's LRU makes that once a schema. Raises for
        uncompilable specs (the caller ends the request with the error)."""
        if (request.compiled_constraint is None
                and request.sampling.constraint is not None):
            if self.constraint_compiler is None:
                raise ValueError("request carries a constraint but the engine "
                                 "has no constraint compiler")
            request.compiled_constraint = self.constraint_compiler.compile_spec(
                request.sampling.constraint)

    def _attach_constraint(self, slot_id: int, request: Request) -> None:
        """Install the row's cursor (a parked one as it was, else a fresh
        one at the start state) and its mask row. With fused decode the
        schema registers in the device table (once per schema); a schema
        the budget refuses keeps the host-mask path, and from then on every
        constrained row keeps a host row as well."""
        if request.compiled_constraint is None:
            return
        parked = request.parked
        if parked is not None and parked.constraint is not None:
            state = parked.constraint
        else:
            state = ConstraintState(request.compiled_constraint)
            self._count("structured_requests_total")
        slot = self.slots[slot_id]
        slot.constraint = state
        slot.gram_offset = -1
        tables = self._grammar_tables
        if tables is not None:
            off = tables.register(request.compiled_constraint)
            if off is not None:
                slot.gram_offset = off
                if self._burst_state.gram_table is None:
                    # allocated once: captured grammar graphs hold it
                    self._burst_state = dataclasses.replace(
                        self._burst_state, gram_table=tables.table())
            elif not self._grammar_fallback:
                self._grammar_fallback = True
                if not self._grammar_warned:
                    self._grammar_warned = True
                    log.warning("grammar table budget exceeded "
                                "(LLMLB_GRAMMAR_TABLE_MB=%d MiB); constrained "
                                "decoding falls back to the host-mask path",
                                tables.budget_bytes >> 20)
                for j, other in enumerate(self.slots):
                    if other.constraint is not None and j != slot_id:
                        self._set_mask_row(j, other.constraint, force=True)
        self._set_mask_row(slot_id, state)

    def _set_mask_row(self, slot_id: int, state: ConstraintState, *,
                      force: bool = False) -> None:
        """The row's host mask row from its cursor, unless the grammar key
        derives it on the device (a resident schema, no fallback yet)."""
        if (not force and self.fused_decode and not self._grammar_fallback
                and self.slots[slot_id].gram_offset >= 0):
            return
        if self._mask_bias is None:
            self._mask_bias = np.zeros((self.num_slots, self.cfg.vocab_size),
                                       np.float32)
        self._mask_bias[slot_id] = state.bias_row()
        self._mask_dirty_rows.add(slot_id)

    def _clear_constraint(self, slot_id: int) -> None:
        """Drop a row's cursor and zero its host mask row (a park took the
        cursor onto the request first)."""
        slot = self.slots[slot_id]
        slot.gram_offset = -1
        if slot.constraint is None:
            return
        slot.constraint = None
        if self._mask_bias is not None:
            self._mask_bias[slot_id] = 0.0
            self._mask_dirty_rows.add(slot_id)

    def _sync_mask(self) -> None:
        """The device copy of the host mask, refreshed per dirty row in
        place (one row per cursor advance), as the reference's. Allocated
        at the first fallback burst and never again: the mask key's graph
        reads its address."""
        if self._d_mask is None:
            # a copy: on the CPU a tensor from numpy would share the rows
            self._d_mask = self._to_device(self._mask_bias.copy())
            self._burst_state = dataclasses.replace(self._burst_state,
                                                    mask_bias=self._d_mask)
        elif self._mask_dirty_rows:
            rows = sorted(self._mask_dirty_rows)
            self._d_mask.index_copy_(
                0, torch.as_tensor(rows, dtype=torch.int64, device=self.device),
                self._to_device(self._mask_bias[rows]))
        self._mask_dirty_rows.clear()

    def _sync_gram_state(self, active: list[int]) -> None:
        """The grammar key's cursors from the host FSMs (the source of
        truth, advanced in _emit): offset + state per constrained row, 0
        (the free row) for every other slot; one [slots] copy in place."""
        gs = np.zeros((self.num_slots,), np.int32)
        for i in active:
            slot = self.slots[i]
            if slot.constraint is not None and slot.gram_offset >= 0:
                gs[i] = slot.gram_offset + slot.constraint.state
        self._d_gram_state.copy_(torch.from_numpy(gs))

    def _fused_step_ok(self, active: list[int]) -> bool:
        """The burst can run under the grammar key: fused decode on and
        every active constrained row's schema in the device table (one row
        off it takes the whole burst to the host-mask path)."""
        if not self.fused_decode:
            return False
        return all(self.slots[i].constraint is None
                   or self.slots[i].gram_offset >= 0 for i in active)

    # ------------------------------------------------------------ kv transfer

    def _kv_counters_copy(self) -> KVShipCounters:
        with self._lock:
            c = self.kv_counters
            return dataclasses.replace(
                c, kv_ship_fallback_total=dict(c.kv_ship_fallback_total))

    def _record_kv_ship(self, nbytes: int, seconds: float) -> None:
        with self._lock:
            self.kv_counters.kv_ship_total += 1
            self.kv_counters.kv_ship_bytes_total += int(nbytes)
            self.kv_counters.kv_ship_seconds_total += float(seconds)

    def _record_kv_restore(self, nbytes: int) -> None:
        with self._lock:
            self.kv_counters.kv_restored_total += 1
            self.kv_counters.kv_restored_bytes_total += int(nbytes)

    def record_kv_ship_fallback(self, reason: str) -> None:
        """A page move that took the replay path instead (any thread); an
        unknown reason counts as "error", so the label set stays closed."""
        with self._lock:
            fallbacks = self.kv_counters.kv_ship_fallback_total
            if reason not in fallbacks:
                reason = "error"
            fallbacks[reason] += 1

    def _kv_header(self, tokens: int, num_pages: int) -> KVWireHeader:
        return KVWireHeader(
            version=KV_WIRE_VERSION, layers=self.cfg.num_layers,
            page_size=self.kv_page_size, num_kv_heads=self.cfg.num_kv_heads,
            head_dim=self.cfg.head_dim_, kv_dtype=self._kv_dtype(),
            tokens=tokens, num_pages=num_pages)

    def kv_restore_reason(self, header: KVWireHeader) -> str | None:
        """None when a payload can land in THIS pool verbatim, else the
        fallback reason (dtype | page_size | geometry)."""
        return kv_compat_reason(
            header, layers=self.cfg.num_layers, page_size=self.kv_page_size,
            num_kv_heads=self.cfg.num_kv_heads, head_dim=self.cfg.head_dim_,
            kv_dtype=self._kv_dtype())

    def _pool_sections(self) -> dict[str, torch.Tensor]:
        """The pools by wire section name: {k, v}, or {k_q, k_s, v_q, v_s}
        for int8 pools ([L, P, PS, K, D] codes, [L, P, PS, K] scales)."""
        if self.quant.kv:
            return {"k_q": self.cache_k["q"], "k_s": self.cache_k["s"],
                    "v_q": self.cache_v["q"], "v_s": self.cache_v["s"]}
        return {"k": self.cache_k, "v": self.cache_v}

    def _gather_kv_sections(self, pages: list[int], *,
                            whole: bool = False) -> dict[str, np.ndarray]:
        """The named pool pages as host wire sections [L, P', PS, K, D]
        (int8 pools: codes and scales): one index_select over each pool and
        one device-to-host copy per section. A plain read: the pool is
        untouched, so gathering before a free is safe. This rank's KV
        heads, or with `whole` the model's, gathered over tp in head order
        (a collective: every rank of the mesh calls it)."""
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        out = {}
        for name, pool in self._pool_sections().items():
            t = pool.index_select(1, idx)
            if whole:
                t = self.mesh.gather_heads(t, 3, self.cfg.num_kv_heads)
            t = t.cpu()
            out[name] = (t.view(torch.int16) if t.dtype == torch.bfloat16
                         else t).numpy()
        return out

    def _capture_kv(self, pages: list[int], tokens: int, *,
                    whole: bool = False) -> KVPages:
        return KVPages(header=self._kv_header(tokens, len(pages)),
                       sections=self._gather_kv_sections(pages, whole=whole))

    def _kv_export_payload(self, slot_id: int,
                           request: Request) -> dict | None:
        """The serialized pages of a finishing row's KV (the /v1/handoff
        envelope's `kv_pages`), or None when it holds none. The tokens are
        the host's seq_len, as a park's spill counts them: nothing the
        burst wrote past the finish. On a mesh every rank gathers its heads
        to the leader, which alone serializes (a follower returns None)."""
        tokens = int(self._seq_lens[slot_id])
        if tokens <= 0 or not self._slot_pages[slot_id]:
            return None
        pages = self._slot_pages[slot_id][:self._pages_for_tokens(tokens)]
        t0 = time.monotonic()
        kvp = self._capture_kv(pages, tokens, whole=True)
        payload = (serialize_kv_pages(kvp.header, kvp.sections)
                   if self.mesh.is_leader else None)
        dt = time.monotonic() - t0
        self._record_kv_ship(kvp.nbytes, dt)
        self._fr_emit(request, "kv_shipped", tokens=tokens, pages=len(pages),
                      bytes=kvp.nbytes, seconds=round(dt, 6))
        return payload

    def take_kv_export(self, gateway_id: str) -> dict | None:
        """Take a parked stream's export (POST /v1/kv/export): handed over
        exactly once."""
        with self._lock:
            return self._kv_exports.pop(gateway_id, None)

    def _land_kv_pages(self, kvp: KVPages, fresh: list[int]) -> None:
        """Land the first len(fresh) shipped pages into pool pages `fresh`:
        one host-to-device copy and one index_copy_ per section. (The
        reference pads the page list to a power of two for XLA's program
        cache; the land is not captured here, so it pads nothing.) On a
        mesh a wire payload is the leader's, of the model's every KV head:
        its pages go to every rank in one broadcast a section, and each
        keeps its own heads; the offload tier's copies are this rank's own
        share already."""
        n = len(fresh)
        idx = torch.as_tensor(fresh, dtype=torch.int64, device=self.device)
        over_mesh = not self.mesh.trivial and kvp.source == "wire"
        shapes = expected_sections(kvp.header)
        heads = self.mesh.kv_heads(self.cfg.num_kv_heads)
        for name, pool in self._pool_sections().items():
            if over_mesh:
                shape = (shapes[name][0][0], n, *shapes[name][0][2:])
                src = None
                if self.mesh.is_leader:
                    src = torch.from_numpy(np.ascontiguousarray(
                        kvp.sections[name][:, :n])).view(pool.dtype)
                src = self.mesh.broadcast(src, shape, pool.dtype,
                                          self.device)[:, :, :, heads]
            else:
                # writable and contiguous (a wire section is a read-only
                # view)
                rows = np.require(kvp.sections[name][:, :n],
                                  requirements=["C", "W"])
                src = torch.from_numpy(rows)
                if pool.dtype == torch.bfloat16:
                    src = src.view(torch.bfloat16)
            pool.index_copy_(1, idx, src.to(self.device))

    def _insert_restored(self, slot_id: int, request: Request,
                         n: int) -> bool:
        """Re-activate a parked request from its shipped pages: land them
        into fresh pool pages and enter decode at seq_len = n - 1 (n =
        prompt + committed tokens) with the last committed token pending,
        so the next decode step writes position n - 1 and samples the first
        new token, as the uninterrupted run's step did: no prefill, no
        forced tokens, no new graph key. A refusal drops the payload,
        counts the "capacity" fallback and returns False: the caller
        replays."""
        kvp, request.kv_restore = request.kv_restore, None
        st = request.parked
        t0 = time.monotonic()
        need_tokens = n - 1
        if (st is None or not st.tokens or need_tokens < 1
                or kvp.header.tokens < need_tokens
                or self._pages_for_tokens(need_tokens) > kvp.header.num_pages):
            self.record_kv_ship_fallback("capacity")
            return False
        need_pages = self._pages_for_tokens(need_tokens)
        fresh = self._try_reserve_pages(need_pages)
        while fresh is None and self._preempt_for_pages(
                self._priority_of(request)):
            fresh = self._try_reserve_pages(need_pages)
        if fresh is None:
            self.record_kv_ship_fallback("capacity")
            return False
        self._land_kv_pages(kvp, fresh)
        self._assign_slot_pages(slot_id, (), fresh)
        s = request.sampling
        seed = -1 if s.seed is None else s.seed & 0x7FFFFFFF
        self._d_temps[slot_id] = float(s.temperature)
        self._d_top_ps[slot_id] = float(s.top_p)
        self._d_top_ks[slot_id] = int(s.top_k)
        self._d_seeds[slot_id] = seed
        if self.lora is not None:
            self._d_lora_idx[slot_id] = int(self._lora_rows([request])[0])
        self._d_seq_lens[slot_id] = need_tokens
        self._d_last_tokens[slot_id] = int(st.tokens[-1])
        self._seq_lens[slot_id] = need_tokens
        self._seeds[slot_id] = seed
        slot = self.slots[slot_id]
        slot.request = request
        slot.generated = st.generated
        slot.out_tokens = list(st.tokens)
        slot.forced = []
        slot.first_pending = False
        # the parked cursor and drafter as they were: both stand after every
        # committed token
        self._attach_constraint(slot_id, request)
        self._attach_spec(slot_id, request)
        request.parked = None
        self.preempt_resumes_total += 1
        self._record_kv_restore(kvp.nbytes)
        self._fr_emit(request, "kv_restored", source=kvp.source,
                      kind="stream", tokens=need_tokens, pages=need_pages,
                      bytes=kvp.nbytes,
                      seconds=round(time.monotonic() - t0, 6))
        self._fr_emit(request, "resumed", generated=st.generated,
                      via="kv_restore")
        log.info("kv restore: request %s re-entered decode at %d tokens from "
                 "%s (%d pages, %.1f KiB, no prefill)", request.request_id,
                 need_tokens, kvp.source, need_pages, kvp.nbytes / 1024)
        return True

    def _spill_parked_slot(self, slot_id: int, request: Request,
                           reason: str) -> None:
        """At a park, before the pages free: the row's pages as an export
        (a draining engine exports every park, a serving one only the
        parks a migration asked for) and as the offload tier's copy. A row
        with no committed token is skipped: its faithful resume is the
        replay."""
        slot = self.slots[slot_id]
        if (self.page_pool is None or not self._slot_pages[slot_id]
                or not slot.out_tokens):
            return
        tokens = int(self._seq_lens[slot_id])
        if tokens <= 0:
            return
        pages = self._slot_pages[slot_id][:self._pages_for_tokens(tokens)]
        nbytes = len(pages) * kv_page_bytes(self.cfg, self.kv_page_size,
                                            self.quant.kv)
        want_export = self.kv_ship and (self._loop_draining
                                        or reason == "migrate")
        tier = self.kv_offload
        want_tier = tier is not None and tier.would_admit(nbytes)
        if not (want_export or want_tier):
            return
        t0 = time.monotonic()
        # the tier keeps this rank's heads; an export the model's, gathered
        # over tp to the leader, which alone serializes it
        if want_export and self.mesh.shape["tp"] > 1:
            whole = self._capture_kv(pages, tokens, whole=True)
            kvp = whole
            if want_tier:
                heads = self.mesh.kv_heads(self.cfg.num_kv_heads)
                kvp = KVPages(header=whole.header, sections={
                    name: np.ascontiguousarray(a[:, :, :, heads])
                    for name, a in whole.sections.items()})
        else:
            kvp = whole = self._capture_kv(pages, tokens)
        kvp.source = "offload"
        self._record_kv_ship(kvp.nbytes, time.monotonic() - t0)
        dest = []
        if want_export:
            if self.mesh.is_leader:
                payload = serialize_kv_pages(whole.header, whole.sections)
                with self._lock:
                    self._kv_exports[gateway_rid(request.request_id)] = (
                        payload)
            dest.append("export")
        if want_tier and tier.put_parked(request.request_id, kvp):
            dest.append("offload")
        if dest:
            self._fr_emit(request, "kv_spilled", reason=reason, tokens=tokens,
                          bytes=kvp.nbytes, dest=",".join(dest))

    def _spill_prefix_entry(self, entry: PrefixEntry) -> None:
        """A prefix entry evicted under page pressure: its pages to the
        offload tier before their references drop."""
        tier = self.kv_offload
        if tier is None or not entry.pages:
            return
        nbytes = len(entry.pages) * kv_page_bytes(
            self.cfg, self.kv_page_size, self.quant.kv)
        if not tier.would_admit(nbytes):
            return
        t0 = time.monotonic()
        kvp = self._capture_kv(list(entry.pages), len(entry.tokens))
        kvp.source = "offload"
        self._record_kv_ship(kvp.nbytes, time.monotonic() - t0)
        tier.put_prefix(entry.ns, entry.tokens, kvp)

    def _maybe_restore_prefix(self, request: Request, n: int) -> None:
        """At admission: when the offload tier holds a usable head of this
        prompt that the live cache lacks, land it into fresh pages and
        insert it as a live entry (the cache its only owner), so the
        ordinary zero-copy match serves it and only the suffix prefills.
        Never fatal: on any refusal the cold path proceeds."""
        tier, cache = self.kv_offload, self.prefix_cache
        if tier is None or cache is None:
            return
        ns = request.sampling.lora
        hit = tier.match_prefix(ns, request.prompt_ids, n - 1)
        if hit is None:
            return
        stored, kvp = hit
        t0 = time.monotonic()
        # capped at n - 1 (a suffix token must prefill) and aligned down to
        # the cache's grain, as every donation is
        usable = min(len(stored), n - 1) // self.prefix_align \
            * self.prefix_align
        if usable < cache.min_len:
            return
        tokens = tuple(stored[:usable])
        if cache.covers(tokens, ns) or self.kv_restore_reason(
                kvp.header) is not None:
            return
        pages_needed = usable // self.kv_page_size
        if pages_needed > kvp.header.num_pages:
            return
        fresh = self._try_reserve_pages(pages_needed)
        if fresh is None:
            return  # page pressure: the cold prefill is the fallback
        self._land_kv_pages(kvp, fresh)
        for stale in cache.evict_subsumed_entries(tokens, ns):
            self._release_entry_pages(stale)
        if ((len(cache) >= cache.max_entries and not self._evict_one_prefix())
                or cache.insert(tokens, -1, pages=tuple(fresh),
                                ns=ns) is None):
            for p in fresh:
                self.page_pool.unref(p)
            return
        # the cache owns the fresh pages alone (refcount 1 from alloc)
        self._prefix_pinned_pages += pages_needed
        self._record_kv_restore(kvp.nbytes)
        self.prefix_counters.prefix_insertions_total += 1
        self.prefix_counters.prefix_inserted_tokens_total += len(tokens)
        self._fr_emit(request, "kv_restored", source="offload", kind="prefix",
                      tokens=len(tokens), pages=pages_needed,
                      bytes=kvp.nbytes,
                      seconds=round(time.monotonic() - t0, 6))

    def kv_transfer_info(self) -> dict:
        """The `kv_transfer` block of /api/health and /api/system: the
        shipping knob, the move and fallback counters, and the offload
        tier's occupancy."""
        c = self._kv_counters_copy()
        return {
            "ship_enabled": self.kv_ship,
            "ship_total": c.kv_ship_total,
            "ship_bytes_total": c.kv_ship_bytes_total,
            "restored_total": c.kv_restored_total,
            "restored_bytes_total": c.kv_restored_bytes_total,
            "ship_fallback_total": c.kv_ship_fallback_total,
            "pending_exports": len(self._kv_exports),
            "offload": (self.kv_offload.info()
                        if self.kv_offload is not None
                        else {"enabled": False}),
        }

    # ----------------------------------------------------------- prefix cache

    def _release_cache_entry(self, slot: _Slot) -> None:
        if slot.cache_entry is not None:
            if self.prefix_cache is not None:
                self.prefix_cache.release(slot.cache_entry)
            slot.cache_entry = None

    def _release_entry_pages(self, entry: PrefixEntry) -> None:
        """Drop the cache's page references of a removed entry."""
        if self.page_pool is not None and entry.pages:
            for p in entry.pages:
                self.page_pool.unref(p)
            self._prefix_pinned_pages -= len(entry.pages)

    def _evict_one_prefix(self) -> bool:
        entry = self.prefix_cache.evict_lru_entry()
        if entry is None:
            return False  # every donor has an in-flight reader
        # a demotion, not a loss, with the offload tier on: the cold prefix
        # moves to host memory before its pages free
        self._spill_prefix_entry(entry)
        self._release_entry_pages(entry)
        self.prefix_counters.prefix_evictions_total += 1
        return True

    def _maybe_cache_prefix(self, slot_id: int, request: Request) -> None:
        """On a stop or length finish: donate the prompt's KV head, aligned
        down to prefix_align, when it is long enough and not covered yet.
        Dense pins the whole slot (out of the serving pool until evicted);
        paged pins only the head's pages, and the slot frees at once."""
        cache = self.prefix_cache
        n = len(request.prompt_ids)
        length = (n // cache.align) * cache.align
        if length < cache.min_len:
            return
        tokens = tuple(request.prompt_ids[:length])
        ns = request.sampling.lora
        if cache.covers(tokens, ns):
            cache.touch(tokens, ns)  # a re-served prefix is a use
            return
        # A longer prefix subsumes its ancestors (any match they could
        # serve routes through this entry's subtree): reclaim them first,
        # not counted as evictions (coverage is kept).
        for stale in cache.evict_subsumed_entries(tokens, ns):
            self._release_entry_pages(stale)
        if len(cache) >= cache.max_entries and not self._evict_one_prefix():
            return
        if self.page_pool is not None:
            pages = tuple(self._slot_pages[slot_id][:length // self.kv_page_size])
            if not pages or cache.insert(tokens, -1, pages=pages,
                                         ns=ns) is None:
                return
            for p in pages:  # the cache is now a co-owner of the head
                self.page_pool.ref(p)
            self._prefix_pinned_pages += len(pages)
        elif cache.insert(tokens, slot_id, ns=ns) is None:
            return
        self.prefix_counters.prefix_insertions_total += 1
        self.prefix_counters.prefix_inserted_tokens_total += length

    def _drop_prefix_cache(self) -> None:
        """Forget every entry and drop its page references (reset and
        failure paths: no in-flight reader is left)."""
        if self.prefix_cache is None:
            return
        for entry in self.prefix_cache.entries():
            self._release_entry_pages(entry)
        self.prefix_cache.clear()

    def _fail_all(self, message: str) -> None:
        for slot_id, slot in enumerate(self.slots):
            if slot.request is not None:
                self._finish(slot.request, "error", message)
            self._release_cache_entry(slot)
            self._free_slot_kv(slot_id)
            self._clear_constraint(slot_id)
            slot.clear()
        self._drop_prefix_cache()
        while True:
            request = self._pop_request()
            if request is None:
                break
            self._finish(request, "error", message)
