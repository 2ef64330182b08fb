"""Continuous-batching engine core: counterpart of `EngineCore` in
`llmlb_tpu/engine/scheduler.py`.

The step loop runs on one thread and owns every device tensor. Each
iteration it:

1. admits queued requests into free slots (`_try_insert`): pages are
   reserved for the whole prompt up front, same-bucket prompts prefill
   together in one dispatch (`_prefill_group`, at most MAX_PREFILL_GROUP,
   padded to a power of two by repeating the last row), and prompts longer
   than the largest bucket claim a slot for chunked prefill (`_insert_long`);
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

Multi-LoRA (`lora_dir=` / LLMLB_LORA_DIR, off by default): a LoraManager
pool rides the params as `<name>_lora_a/_lora_b` leaves (added after any
weight quantization), a request names its adapter in `SamplingParams.lora`,
pinned at submit and released at its terminal event, and every dispatch
carries per-row pool rows (`lora_idx`); the decode rows live on the device
in `_d_lora_idx`, set at activation, so a burst copies none.

Left out of this slice (see ROADMAP.md): priority classes and preemption,
park/resume, speculative decoding, grammar constraints, the prefix cache,
context-parallel prefill, disaggregation and KV shipping. Without
preemption a page-starved decoding row finishes with "length", the
reference's behavior before parking existed.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import queue
import threading
import time
import uuid

import numpy as np
import torch

from llmlb_tpu_torch.device import resolve_device
from llmlb_tpu_torch.engine.decode_graph import (
    BurstGraphs,
    BurstState,
    burst_body,
    count_nan_rows,
    cuda_capture,
)
from llmlb_tpu_torch.engine.paging import PagePool
from llmlb_tpu_torch.lora import LoraManager
from llmlb_tpu_torch.models import llama
from llmlb_tpu_torch.models.llama import LlamaConfig
from llmlb_tpu_torch.ops.sampling import sample_tokens
from llmlb_tpu_torch.quant import (
    SCALE_SUFFIX,
    kv_cell_bytes,
    parse_quant_mode,
    quantize_params,
)

log = logging.getLogger("llmlb_tpu_torch.engine.scheduler")


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
    # Carried as the reference's server validates them; the scheduler does
    # not act on them yet (no priority classes, deadline shedding or
    # speculative decoding in the port).
    priority: int = 1  # 0 high, 1 normal, 2 low
    speculative: dict | None = None  # {enabled, max_draft_tokens}
    deadline_ms: float | None = None  # X-Request-Deadline-Ms


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

    def cancel(self) -> None:
        self.cancelled = True


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

    def clear(self) -> None:
        self.request = None
        self.generated = 0
        self.prefilling = False
        self.prefill_pos = 0
        self.first_pending = False


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


@dataclasses.dataclass(frozen=True)
class EngineStats:
    num_slots: int
    active_slots: int
    queued: int
    total_requests: int
    total_tokens: int
    uptime_s: float
    # decode bursts run as graph replays and eagerly (a key's warm-up, or
    # every burst without graphs), and the (window, seeded) keys captured:
    # the counterpart of the JAX engine's per-step `dispatches`
    decode_graph_replays: int = 0
    decode_eager_bursts: int = 0
    decode_graphs: int = 0


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
    ):
        self.device = resolve_device(device)
        # one CUDA graph per decode burst key: on by default on the card
        # (the JAX engine's fused_decode); the CPU never captures
        if decode_graphs is None:
            decode_graphs = self.device.type == "cuda"
        if decode_graphs and self.device.type != "cuda":
            raise ValueError("decode_graphs needs the CUDA card; the engine "
                             f"runs on {self.device}")
        self.decode_graphs = bool(decode_graphs)
        self.cfg = cfg
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

        # Page size: 128 tokens by default, clamped into the slot capacity.
        self.kv_page_size = max(1, min(kv_page_size or 128, self.slot_capacity))
        self.pages_per_slot = -(-self.slot_capacity // self.kv_page_size)
        # Default pool: every slot's full capacity plus the trash page.
        self.kv_num_pages = 0
        if kv_layout == "paged":
            self.kv_num_pages = max(
                int(kv_pages or num_slots * self.pages_per_slot + 1),
                self.pages_per_slot + 1,
            )

        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = llama.init_params(cfg, gen, self.device)
        for name, p in params.items():
            if p.device != self.device:
                raise ValueError(f"param {name!r} is on {p.device}, the engine "
                                 f"runs on {self.device}")
        if self.quant.weights:
            # on the device, one layer at a time; an already-quantized
            # pytree passes through
            params = quantize_params(params)

        # Multi-LoRA: the adapter pool leaves join the params AFTER weight
        # quantization (adapters stay in the model dtype over int8 bases).
        # Off, no leaf is added and every forward is the LoRA-free one.
        if lora_dir is None:
            lora_dir = os.environ.get("LLMLB_LORA_DIR") or None
        self.lora: LoraManager | None = None
        if lora_dir:
            if lora_max_adapters is None:
                lora_max_adapters = int(os.environ.get(
                    "LLMLB_LORA_MAX_ADAPTERS", "8"))
            if lora_rank_cap is None:
                lora_rank_cap = int(os.environ.get("LLMLB_LORA_RANK_CAP", "16"))
            self.lora = LoraManager(cfg, lora_dir=lora_dir,
                                    max_adapters=lora_max_adapters,
                                    rank_cap=lora_rank_cap)
            params = {**params,
                      **self.lora.init_pool_leaves(cfg.dtype, self.device)}
            self.lora.attach(params)
            log.info("lora: pool of %d adapter slots at rank cap %d over %s "
                     "(%d adapter(s) discovered in %s)",
                     self.lora.max_adapters, self.lora.rank_cap,
                     "/".join(self.lora.targets), len(self.lora.available),
                     lora_dir)
        self.params = params
        # parameter count without the scale and adapter-pool leaves; bytes
        # with them
        self.n_params = sum(p.numel() for k, p in params.items()
                            if not (k.endswith(SCALE_SUFFIX) or "_lora_" in k))
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
            self.cache_k, self.cache_v = llama.init_kv_pages(
                cfg, self.kv_num_pages, self.kv_page_size, self.device,
                quantized=self.quant.kv)
            self._d_block_tables = self._to_device(self._block_tables)
            log.info(
                "KV cache: paged%s, %d pages x %d tokens (%d slots, %d "
                "pages/slot) = %.2f GiB on %s",
                " int8" if self.quant.kv else "", self.kv_num_pages,
                self.kv_page_size, num_slots, self.pages_per_slot,
                kv_pool_bytes(cfg, self.kv_num_pages, self.kv_page_size,
                              self.quant.kv) / 2**30,
                self.device,
            )
        else:
            self.cache_k, self.cache_v = llama.init_kv_cache(
                cfg, num_slots, self.slot_capacity, self.device)
            log.info("KV cache: dense, %d slots x %d capacity = %.2f GiB on %s",
                     num_slots, self.slot_capacity,
                     kv_cache_bytes(cfg, num_slots, self.slot_capacity) / 2**30,
                     self.device)

        # Decode burst: k decode+sample steps per host sync. 8 on the card;
        # 1 on the CPU, like the reference off its accelerator.
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
        self._burst_state = BurstState(
            params=self.params, cfg=cfg, cache_k=self.cache_k,
            cache_v=self.cache_v, block_tables=self._d_block_tables,
            last_tokens=self._d_last_tokens, seq_lens=self._d_seq_lens,
            tokens=self._d_tokens, temps=self._d_temps,
            top_ps=self._d_top_ps, top_ks=self._d_top_ks,
            seeds=self._d_seeds, lora_idx=(self._d_lora_idx if self.lora
                                           is not None else None),
            nan_rows=self._d_nan_rows, generator=self._generator)
        self._bursts = BurstGraphs(
            self._burst_body,
            cuda_capture(self.device, self._generator)
            if self.decode_graphs else None,
            # adapter uploads from HTTP threads wait for a capture or replay
            lock=self.lora.device_lock if self.lora is not None else None)

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
        self._queue: collections.deque[Request] = collections.deque()
        self._running = False
        self._thread: threading.Thread | None = None
        self._started_at = time.monotonic()
        self._lock = threading.Lock()
        self.total_requests = 0
        self.total_tokens = 0
        self.prefill_dispatches = 0
        self.decode_bursts = 0
        self._prefill_rr = 0  # rotation among concurrently-prefilling slots

    # ------------------------------------------------------------------ public

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="engine-step-loop", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=30)
        # terminal events for everything still in flight so waiters unblock
        self._fail_all("engine shutting down")

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
        self.pending.put(request)
        return request

    def stats(self) -> EngineStats:
        active = sum(1 for s in self.slots if s.request is not None)
        queued = self.pending.qsize() + len(self._queue)
        if self._held_request is not None:
            queued += 1
        return EngineStats(
            num_slots=self.num_slots, active_slots=active, queued=queued,
            total_requests=self.total_requests, total_tokens=self.total_tokens,
            uptime_s=time.monotonic() - self._started_at,
            decode_graph_replays=self._bursts.replays,
            decode_eager_bursts=self._bursts.eager_bursts,
            decode_graphs=len(self._bursts.graphs),
        )

    def decode_graph_info(self) -> dict:
        """The decode graphs: keys captured, replays, eager bursts, capture
        seconds, pool bytes and each key's per-replay kernel launches."""
        return {"enabled": self.decode_graphs, **self._bursts.info()}

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
        self.lora.acquire(name, request.request_id)

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
        # no context-parallel prefill in the port: no LoRA prompt falls
        # back from it
        return {**self.lora.info(), "cp_fallback_total": 0}

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
        return {
            "layout": "paged",
            # the pool's ACTUAL dtype: capacity math from an implied model
            # dtype would be 2x off under int8
            "kv_dtype": self._kv_dtype(),
            "effective_kv_dtype": self._kv_dtype(),
            "page_size": self.kv_page_size,
            "pages_total": self.page_pool.total,
            "pages_free": self.page_pool.available(),
            "bytes_per_page": kv_page_bytes(self.cfg, self.kv_page_size,
                                            self.quant.kv),
            "hbm_bytes": kv_pool_bytes(self.cfg, self.kv_num_pages,
                                       self.kv_page_size, self.quant.kv),
        }

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

    def nan_logit_rows(self) -> int:
        """Logit rows with a NaN in any dispatch so far (syncs the device)."""
        return int(self._d_nan_rows.item())

    # ------------------------------------------------------------------- loop

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while self._running:
            did_work = False
            try:
                did_work |= self._try_insert()
                # At most ONE prefill chunk per iteration: decode steps run
                # between chunks, so active slots keep emitting tokens during
                # a long prompt's prefill.
                did_work |= self._advance_prefill()
                did_work |= self._decode_active()
            except Exception:  # boundary: fail the requests, keep serving
                log.exception("engine step failed; resetting engine state")
                self._fail_all("engine step error")
                self._reset_caches()
            if not did_work:
                time.sleep(0.001)

    def _reset_caches(self) -> None:
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

    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"no prefill bucket for prompt of {n} tokens")

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.request is None]

    def _pop_request(self) -> Request | None:
        """Next request to admit: the page-starved held one first, then FIFO."""
        while True:
            try:
                self._queue.append(self.pending.get_nowait())
            except queue.Empty:
                break
        if self._held_request is not None:
            request, self._held_request = self._held_request, None
            return request
        return self._queue.popleft() if self._queue else None

    def _finish(self, request: Request, kind: str, value: str) -> None:
        """Every terminal event of a request goes through here, and so does
        the release of its adapter."""
        request.finished_at = time.monotonic()
        self._release_lora(request)
        request.events.put((kind, value))

    def _finish_slot(self, slot_id: int, reason: str) -> None:
        """Terminal teardown of an occupied slot: terminal event, KV pages
        back to the pool, every slot field reset."""
        slot = self.slots[slot_id]
        self._finish(slot.request, "done", reason)
        self._free_slot_kv(slot_id)
        slot.clear()

    # ------------------------------------------------------------- paged KV

    def _pages_for_tokens(self, n: int) -> int:
        return -(-n // self.kv_page_size)

    def _try_reserve_pages(self, count: int) -> list[int] | None:
        """Alloc `count` fresh pages; None when the pool cannot cover it.
        The dense layout needs none."""
        if count <= 0 or self.page_pool is None:
            return []
        return self.page_pool.alloc(count)

    def _assign_slot_pages(self, slot_id: int, fresh: list[int]) -> None:
        if self.page_pool is None:
            return
        self._slot_pages[slot_id] = list(fresh)
        self._block_tables[slot_id, :] = 0
        self._block_tables[slot_id, :len(fresh)] = fresh
        self._tables_dirty = True

    def _extend_slot_pages(self, slot_id: int, fresh: list[int]) -> None:
        row = self._slot_pages[slot_id]
        start = len(row)
        row.extend(fresh)
        self._block_tables[slot_id, start:start + len(fresh)] = fresh
        self._tables_dirty = True

    def _free_slot_kv(self, slot_id: int) -> None:
        """Return a slot's pages to the pool and point its table row at the
        trash page, so the batched decode step's ongoing garbage writes for
        the freed row never land in a page a new owner holds."""
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

    def _ensure_decode_pages(self, active: list[int], k: int) -> list[int]:
        """Alloc-on-extend before a decode burst: grow each active row's
        pages to cover the k tokens the burst writes. A row the pool cannot
        cover finishes with "length" (no preemption in this slice). Returns
        the rows that remain active. The dense layout's rows hold their
        whole capacity already."""
        if self.page_pool is None:
            return active
        kept = []
        for i in active:
            target = min(int(self._seq_lens[i]) + k + 1, self.slot_capacity)
            need = self._pages_for_tokens(target) - len(self._slot_pages[i])
            if need > 0:
                fresh = self._try_reserve_pages(need)
                if fresh is None:
                    log.warning("page pool exhausted mid-decode; finishing "
                                "request %s at %d tokens",
                                self.slots[i].request.request_id,
                                int(self._seq_lens[i]))
                    self._finish_slot(i, "length")
                    continue
                self._extend_slot_pages(i, fresh)
            kept.append(i)
        return kept

    # -------------------------------------------------------------- admission

    def _try_insert(self) -> bool:
        free = self._free_slots()
        if not free:
            return False
        max_oneshot = self.prefill_buckets[-1]
        handled = False
        inserted = 0  # long inserts count toward the group cap too
        batch: list[tuple[int, Request, int]] = []  # (slot_id, request, n)
        while free and len(batch) + inserted < self.MAX_PREFILL_GROUP:
            request = self._pop_request()
            if request is None:
                break
            if request.cancelled:
                self._finish(request, "done", "cancelled")
                handled = True
                continue
            n = len(request.prompt_ids)
            if self.slot_capacity - n - 1 <= 0:
                self._finish(request, "error", "prompt does not fit slot capacity")
                handled = True
                continue
            pages = self._try_reserve_pages(self._pages_for_tokens(n))
            if pages is None:
                self._held_request = request
                break
            slot_id = free.pop(0)
            self._assign_slot_pages(slot_id, pages)
            if n > max_oneshot:
                self._insert_long(slot_id, request)
                handled = True
                inserted += 1
                continue
            # claim the slot before any dispatch: a failed prefill then
            # reaches the request through _fail_all
            self.slots[slot_id].request = request
            self.slots[slot_id].generated = 0
            batch.append((slot_id, request, n))
        if not batch:
            return handled
        by_bucket: dict[int, list[tuple[int, Request, int]]] = {}
        for entry in batch:
            by_bucket.setdefault(self._bucket_for(entry[2]), []).append(entry)
        for bucket, group in by_bucket.items():
            self._prefill_group(bucket, group)
        return True

    def _insert_long(self, slot_id: int, request: Request) -> None:
        """Claim a slot for a prompt beyond the largest one-shot bucket:
        park its device seq_len at capacity-1 and let _advance_prefill feed
        chunks between decode steps."""
        slot = self.slots[slot_id]
        slot.request = request
        slot.generated = 0
        slot.prefilling = True
        slot.prefill_pos = 0
        self._seq_lens[slot_id] = 0
        self._d_seq_lens[slot_id] = self.slot_capacity - 1

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
        if self.page_pool is not None:
            self._sync_block_tables()
            logits, _, _ = llama.prefill_into_pages(
                self.params, self.cfg, self._to_device(ids),
                self._to_device(lens),
                self._to_device(self._block_tables[slot_ids]),
                self.cache_k, self.cache_v, lora_idx=lora_idx,
            )
        else:
            logits, _, _ = llama.prefill_into_slots(
                self.params, self.cfg, self._to_device(ids),
                self._to_device(lens), self._to_device(slot_ids),
                self.cache_k, self.cache_v, lora_idx=lora_idx,
            )
        self.prefill_dispatches += 1
        self._activate_group(group, slot_ids, lens, logits)

    def _advance_prefill(self) -> bool:
        """Feed ONE chunk of ONE prefilling slot's prompt into the pool,
        rotating among prefilling slots."""
        prefilling = [i for i, s in enumerate(self.slots) if s.prefilling]
        if not prefilling:
            return False
        slot_id = prefilling[self._prefill_rr % len(prefilling)]
        self._prefill_rr += 1
        slot = self.slots[slot_id]
        request = slot.request
        if request.cancelled:
            self._finish_slot(slot_id, "cancelled")
            return True
        prompt = request.prompt_ids
        n = len(prompt)
        start = slot.prefill_pos
        chunk_len = min(self.prefill_buckets[-1], n - start)
        bucket = self._bucket_for(chunk_len)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :chunk_len] = prompt[start:start + chunk_len]
        lora_idx = (self._to_device(self._lora_rows([request]))
                    if self.lora is not None else None)
        args = (self.params, self.cfg, self._to_device(ids),
                self._to_device(np.asarray([chunk_len], np.int32)),
                self._to_device(np.asarray([start], np.int32)))
        if self.page_pool is not None:
            logits, _, _ = llama.prefill_extend_pages(
                *args, self._to_device(self._block_tables[slot_id:slot_id + 1]),
                self.cache_k, self.cache_v, lora_idx=lora_idx)
        else:
            logits, _, _ = llama.prefill_extend_slots(
                *args, self._to_device(np.asarray([slot_id], np.int64)),
                self.cache_k, self.cache_v, lora_idx=lora_idx)
        self.prefill_dispatches += 1
        slot.prefill_pos = start + chunk_len
        if slot.prefill_pos >= n:
            slot.prefilling = False
            self._activate_group([(slot_id, request, n)],
                                 np.asarray([slot_id], np.int64),
                                 np.asarray([n], np.int32), logits)
        return True

    def _activate_group(self, group: list[tuple[int, Request, int]],
                        padded_slot_ids: np.ndarray, padded_lens: np.ndarray,
                        logits: torch.Tensor) -> None:
        """Sample each row's first token on the device and scatter the
        sampling params, lengths and first tokens into the per-slot device
        state. Padding rows repeat the last real row."""
        count_nan_rows(self._d_nan_rows, logits)
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
        firsts = sample_tokens(logits, self._generator, d_temps, d_top_ps,
                               d_top_ks, seeds=d_seeds if seeded else None,
                               steps=self._to_device(padded_lens - 1))
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
        for row, (slot_id, request, n) in enumerate(group):
            self._seq_lens[slot_id] = n
            self._seeds[slot_id] = seeds[row]
            slot = self.slots[slot_id]
            slot.request = request
            slot.generated = 0
            slot.first_pending = True

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
        active = [i for i, s in enumerate(self.slots)
                  if s.request is not None and not s.prefilling]
        if not active:
            return False
        # alloc-on-extend: every page the burst writes exists before the
        # tables ship to the device
        active = self._ensure_decode_pages(active, self.decode_burst)
        if not active:
            return True
        self._sync_block_tables()
        window = self._window_for(active, self.decode_burst)
        # seeded rows draw threefry noise, another graph: decided on the host
        seeded = bool((self._seeds[active] >= 0).any())
        self._bursts.run(window, seeded)
        tokens = self._d_tokens.cpu().numpy()  # the ONE host sync per burst
        self.decode_bursts += 1
        self._emit_fetched(tokens, active)
        return True

    def _burst_body(self, window: int, seeded: bool) -> None:
        """The k steps of one burst over the static buffers (eager, or under
        capture)."""
        burst_body(self._burst_state, window, seeded)

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
                self._emit(i, int(tokens[t, i]))

    def _emit(self, slot_id: int, token: int) -> None:
        """Deliver one generated token and apply the finish rules: EOS,
        max_tokens, and the slot-capacity edge."""
        slot = self.slots[slot_id]
        request = slot.request
        if request.cancelled:
            self._finish_slot(slot_id, "cancelled")
            return
        slot.generated += 1
        if request.first_token_at is None:
            request.first_token_at = time.monotonic()
        with self._lock:
            self.total_tokens += 1
        finish: str | None = None
        if token == self.eos_id:
            finish = "stop"  # EOS itself is not emitted as content
        else:
            request.events.put(("token", token))
            if slot.generated >= request.sampling.max_tokens:
                finish = "length"
            elif self._seq_lens[slot_id] + 1 >= self.slot_capacity:
                finish = "length"
        if finish is not None:
            self._finish_slot(slot_id, finish)

    def _fail_all(self, message: str) -> None:
        for slot_id, slot in enumerate(self.slots):
            if slot.request is not None:
                self._finish(slot.request, "error", message)
            self._free_slot_kv(slot_id)
            slot.clear()
        if self._held_request is not None:
            self._finish(self._held_request, "error", message)
            self._held_request = None
        while True:
            request = self._pop_request()
            if request is None:
                break
            self._finish(request, "error", message)
