"""The decode burst as one CUDA graph per (window bucket, seeded, mode)
key: counterpart of the JAX engine's `_build_decode_many` and
`_decode_many_for` (`llmlb_tpu/engine/scheduler.py`), which compile a
k-step decode scan, with sampling inside, into one program per (burst,
window) and dispatch it once per burst, and of its grammar-masked variant
`_build_decode_many_gram`.

The mode says what masks the samples. "free": nothing. "grammar": each
step's bias is gathered from the device grammar table at the rows'
cursors (`ops/grammar.py`) and the cursors advance on the step's tokens,
so constrained rows ride the burst; a forced cell keeps its row's
cursor, since the host wrote the cursor after every committed token.
"mask": the host-mask fallback of a schema the table could not hold, one
step (k = 1) biased by the static [slots, V] mask the host writes before
it, the reference's legacy single step, here a graph key of its own like
the others.

`BurstState` names every device tensor a burst reads or writes: the params
(adapter pools included), the KV caches, the block tables, the per-slot
last tokens, sequence lengths, sampling parameters and adapter rows, the
NaN counter, the [k + 1, slots] token block the host fetches, and the
forced tokens: a [k, slots] token buffer and mask that the host writes in
place before a burst, whose set cells replace that step's sample (a
resumed row's committed tail is fed through decode steps this way, as the
uninterrupted run wrote it, while the other rows decode on). Each is
allocated once and only ever written in place (`copy_`, index assignment),
so a graph captured over their addresses stays valid for the engine's
life.

`burst_body` runs the k steps: decode step, NaN count, sampling, each
step's tokens fed into the next; it ends with `copy_` into the static
buffers and allocates nothing that outlives it. It reads host values only
through its arguments (the window bucket, whether rows are seeded) and
shapes, so the same Python code runs eagerly (the CPU, and the first burst
of a key on the card) and under capture.

`BurstGraphs` runs the bursts. With a `capture` function (the card) a key's
first burst runs eagerly, as the graph's warm-up, its tokens emitted as
usual, and the graph is captured right after it; every later burst of the
key is one `replay()`. Capture executes nothing: it writes no KV cell and
does not advance the generator, whose state is registered with each graph
so that every replay draws fresh noise for unseeded rows. Without one (the
CPU, or `decode_graphs=False`) every burst runs eagerly. All graphs share
one memory pool: they never replay concurrently, and what they produce
lives in the static buffers, outside the pool.

The speculative verify step is a graph key of its own kind, counterpart of
the reference's fused verify (`_build_verify_fused`): `verify_body` runs
one K+1-token step over the static verify buffers of `BurstState` (the
drafts `verify_ids` [slots, K+1], `verify_lens`, `verify_start`,
`verify_active`, the output `verify_out` [slots, K+3]): the last-token
splice into column 0, the extend (`verify_step_paged` or `verify_step`),
per-position samples, the accepted count (a cumprod of matches, the
reference's `finish`), and each active row's advance by accepted + 1, the
other rows (empty chunks) keeping their lengths and last tokens. Its
modes: "free"; "grammar", where column j's bias walks the device grammar
table through drafts 1..j, a disallowed draft clamping (its sample then
never matches); "mask", a static [slots, K+1, V] bias the host writes for
the rows masked now or last step. The engine runs the verify keys through
a `BurstGraphs` of their own, on the same capture function and memory
pool.

Kernel launches are counted in the Python wrappers (`kernels/build.py
LAUNCHES`), which a replay does not run. So the launches the wrappers count
during a capture are taken back out of the totals (capture launches
nothing) and kept as the graph's per-replay count, which every replay adds.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
from typing import Any, Callable

import torch

from llmlb_tpu_torch.kernels import build
from llmlb_tpu_torch.models import family_for, llama
from llmlb_tpu_torch.ops.grammar import grammar_advance, grammar_bias
from llmlb_tpu_torch.ops.sampling import sample_chunk, sample_tokens


@dataclasses.dataclass(frozen=True)
class BurstState:
    """The device tensors of a decode burst, each allocated once."""

    params: dict[str, torch.Tensor]
    cfg: llama.LlamaConfig
    cache_k: Any  # page pool, int8 {"q", "s"} pair, or dense slot cache
    cache_v: Any
    block_tables: torch.Tensor | None  # [slots, pages_per_slot]; None: dense
    last_tokens: torch.Tensor  # [slots] int32
    seq_lens: torch.Tensor  # [slots] int32
    tokens: torch.Tensor  # [k + 1, slots] int32; row 0: the tokens going in
    temps: torch.Tensor  # [slots] float32
    top_ps: torch.Tensor  # [slots] float32
    top_ks: torch.Tensor  # [slots] int32
    seeds: torch.Tensor  # [slots] int64; < 0: the generator's noise
    lora_idx: torch.Tensor | None  # [slots] int32 adapter pool rows
    nan_rows: torch.Tensor  # () int64
    generator: torch.Generator
    # [k, slots] int32 tokens and bool mask: step i + 1 of the burst takes
    # force_tokens[i, b] in place of row b's sample where force_mask[i, b]
    force_tokens: torch.Tensor | None = None
    force_mask: torch.Tensor | None = None
    # the grammar key's device table [rows, V] int32 and the rows' cursors
    # [slots] int32 (0: the free row), written by the host before a burst
    gram_table: torch.Tensor | None = None
    gram_state: torch.Tensor | None = None
    # the mask key's additive [slots, V] float32 bias, written by the host
    mask_bias: torch.Tensor | None = None
    # the verify step's buffers: ids [slots, K+1] int32 (column 0 is spliced
    # from last_tokens), chunk lengths, start positions and the active-row
    # flag [slots] int32 (views of one buffer the host writes with one
    # copy), the output [slots, K+3] int32 (echoed last token, K+1 samples,
    # accepted count), and the mask key's [slots, K+1, V] float32 bias
    verify_ids: torch.Tensor | None = None
    verify_lens: torch.Tensor | None = None
    verify_start: torch.Tensor | None = None
    verify_active: torch.Tensor | None = None
    verify_out: torch.Tensor | None = None
    verify_mask: torch.Tensor | None = None
    # the rank's mesh (parallel/mesh.py) the forwards' collectives join;
    # None on one rank. A captured burst records its collectives, which
    # only NCCL's allow: the engine refuses graphs on a gloo mesh.
    mesh: Any = None
    # at dp > 1 the slots' dp groups (parallel/mesh.py DpRows): a rank's
    # forward runs its group's rows, then the dp exchange
    dp_rows: Any = None


def _mesh_kw(s: BurstState) -> dict:
    """The mesh keywords of a forward: the mesh, and the dp rows when the
    mesh has dp groups (an MoE family, refused at dp, never takes them)."""
    if s.dp_rows is None:
        return {"mesh": s.mesh}
    return {"mesh": s.mesh, "dp_rows": s.dp_rows}


def count_nan_rows(nan_rows: torch.Tensor, logits: torch.Tensor) -> None:
    """Add the logit rows holding a NaN to the device counter, in place."""
    nan_rows.add_(torch.isnan(logits).any(dim=-1).sum())


def burst_body(s: BurstState, window: int, seeded: bool,
               mode: str) -> None:
    """k = tokens.shape[0] - 1 decode steps over every slot. Row 0 of the
    token block takes the last tokens going in, row i the tokens of step i
    (a forced cell's token where the mask is set); last_tokens and seq_lens
    end advanced by k. `mode` picks the samples' bias: none ("free"), the
    grammar table at the cursors ("grammar"), or the host's mask ("mask")."""
    last, lens = s.last_tokens, s.seq_lens
    gs = s.gram_state if mode == "grammar" else None
    family = family_for(s.cfg)
    kw = _mesh_kw(s)
    s.tokens[0].copy_(last)
    for step in range(1, s.tokens.shape[0]):
        if s.block_tables is not None:
            logits, _, _ = family.decode_step_paged(
                s.params, s.cfg, last, lens, s.cache_k, s.cache_v,
                s.block_tables, window=window, lora_idx=s.lora_idx, **kw)
        else:
            logits, _, _ = family.decode_step(
                s.params, s.cfg, last, lens, s.cache_k, s.cache_v,
                window=window, lora_idx=s.lora_idx, **kw)
        count_nan_rows(s.nan_rows, logits)
        bias = (grammar_bias(s.gram_table, gs) if gs is not None
                else s.mask_bias if mode == "mask" else None)
        # seeded rows fold in the pre-increment length, as the reference
        toks = sample_tokens(logits, s.generator, s.temps, s.top_ps, s.top_ks,
                             mask_bias=bias,
                             seeds=s.seeds if seeded else None,
                             steps=lens if seeded else None)
        forced = None
        if s.force_mask is not None:
            forced = s.force_mask[step - 1]
            toks = torch.where(forced, s.force_tokens[step - 1], toks)
        if gs is not None:
            nxt = grammar_advance(s.gram_table, gs, toks)
            gs = nxt if forced is None else torch.where(forced, gs, nxt)
        s.tokens[step].copy_(toks)
        last, lens = s.tokens[step], lens + 1
    s.last_tokens.copy_(last)
    s.seq_lens.copy_(lens)


def verify_body(s: BurstState, window: int, seeded: bool,
                mode: str) -> None:
    """One speculative verify step over every slot (see the module's
    docstring): verify_out takes [last token, K+1 samples, accepted], and
    each active row's seq_len and last token advance past its accepted
    drafts and the correction (or bonus) sample."""
    ids, lens, start = s.verify_ids, s.verify_lens, s.verify_start
    ids[:, 0].copy_(s.last_tokens)
    family = family_for(s.cfg)
    if s.block_tables is not None:
        logits, _, _ = family.verify_step_paged(
            s.params, s.cfg, ids, lens, start, s.block_tables, s.cache_k,
            s.cache_v, window=window, lora_idx=s.lora_idx, **_mesh_kw(s))
    else:
        logits, _, _ = family.verify_step(
            s.params, s.cfg, ids, lens, start, None, s.cache_k, s.cache_v,
            window=window, lora_idx=s.lora_idx, **_mesh_kw(s))
    count_nan_rows(s.nan_rows, logits)
    b, k1 = ids.shape
    bias = None
    if mode == "grammar":
        # column j: the cursor after drafts 1..j (a disallowed draft keeps
        # the state, so its column's sample can never equal it)
        gs = s.gram_state
        cols = [grammar_bias(s.gram_table, gs)]
        for j in range(1, k1):
            gs = grammar_advance(s.gram_table, gs, ids[:, j])
            cols.append(grammar_bias(s.gram_table, gs))
        bias = torch.stack(cols, dim=1).reshape(b * k1, -1)
    elif mode == "mask":
        bias = s.verify_mask.reshape(b * k1, -1)
    toks = sample_chunk(logits, s.generator, s.temps, s.top_ps, s.top_ks,
                        bias, s.seeds if seeded else None, start)
    # accepted: the longest prefix of drafts equal to the model's samples
    drafts = torch.arange(1, k1, device=ids.device)[None, :] < lens[:, None]
    matches = (toks[:, :-1] == ids[:, 1:]) & drafts
    accepted = torch.cumprod(matches.to(torch.int32), dim=1).sum(dim=1)
    active = s.verify_active > 0
    s.verify_out[:, 0].copy_(ids[:, 0])
    s.verify_out[:, 1:k1 + 1].copy_(toks)
    s.verify_out[:, k1 + 1].copy_(accepted)
    nxt = torch.gather(toks, 1, accepted[:, None].long())[:, 0]
    s.seq_lens.copy_(torch.where(active, start + accepted + 1, s.seq_lens))
    s.last_tokens.copy_(torch.where(active, nxt, s.last_tokens))


@dataclasses.dataclass
class CapturedBurst:
    graph: Any  # torch.cuda.CUDAGraph, or anything with replay()
    launches: dict[str, int]  # the port's kernel launches per replay
    capture_s: float  # capture and instantiation, host seconds
    pool_bytes: int  # device memory the allocator reserved for the capture
    nodes: int | None  # nodes of the captured graph (None: not counted)


class BurstGraphs:
    """Runs decode bursts: eagerly, or as replays of one graph per key."""

    def __init__(self, body: Callable[..., None],
                 capture: Callable[[Callable[[], None]], tuple] | None = None,
                 lock: Any = None, kind: str = ""):
        self._body = body
        # "verify/" for the verify keys' names
        self.kind = kind
        self._capture = capture
        self._lock = lock if lock is not None else contextlib.nullcontext()
        # (window, seeded, mode)
        self.graphs: dict[tuple, CapturedBurst] = {}
        self.replays = 0
        self.eager_bursts = 0

    def run(self, window: int, seeded: bool, mode: str) -> None:
        """One burst of key (window, seeded, mode): a replay of its graph,
        or the eager body (then captured, when there is a capture
        function)."""
        key = (window, seeded, mode)
        captured = self.graphs.get(key)
        if captured is None:
            self._body(*key)
            self.eager_bursts += 1
            if self._capture is not None:
                self.graphs[key] = self._capture_key(key)
            return
        with self._lock:
            captured.graph.replay()
        build.add_launches(captured.launches)
        self.replays += 1

    def _capture_key(self, key: tuple) -> CapturedBurst:
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        with self._lock:
            graph, pool_bytes, nodes = self._capture(lambda: self._body(*key))
        capture_s = time.perf_counter() - t0
        launches = build.launches_since(before)
        build.add_launches(launches, times=-1)  # the capture launched nothing
        return CapturedBurst(graph, launches, capture_s, pool_bytes, nodes)

    def info(self) -> dict:
        """What the graphs cost and run (EngineCore.decode_graph_info)."""
        return {
            "graphs": len(self.graphs),
            "replays": self.replays,
            "eager_bursts": self.eager_bursts,
            "capture_s": sum(c.capture_s for c in self.graphs.values()),
            "pool_bytes": sum(c.pool_bytes for c in self.graphs.values()),
            "keys": {self.kind + key_name(key): {
                "launches": dict(c.launches), "nodes": c.nodes,
                "capture_s": c.capture_s, "pool_bytes": c.pool_bytes}
                for key, c in self.graphs.items()},
        }


def key_name(key: tuple) -> str:
    """"256/unseeded", "256/seeded/grammar": a graph key as info() names
    it (a free key's name carries no mode)."""
    window, seeded, mode = key
    return "/".join([str(window), "seeded" if seeded else "unseeded"]
                    + ([] if mode == "free" else [mode]))


def cuda_capture(device: torch.device, generator: torch.Generator):
    """The capture function of `BurstGraphs` on the card: one shared memory
    pool, the engine's generator registered with each graph, capture in
    thread-local mode (another thread's CUDA calls, such as an adapter's
    upload, are not the capture's to refuse). Returns (graph, bytes the
    allocator reserved for it, node count)."""
    if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        raise RuntimeError(
            f"torch {torch.__version__} cannot register a non-default "
            "generator with a CUDA graph (CUDAGraph.register_generator_state)"
            ": the decode graphs would replay frozen noise")
    pool = torch.cuda.graph_pool_handle()

    def capture(fn: Callable[[], None]) -> tuple:
        with torch.cuda.device(device):
            # torch.cuda.graph frees the allocator's cache before capturing;
            # free it first, so the growth in reserved memory is the pool's
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            graph.register_generator_state(generator)
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                fn()
            nodes = graph_nodes(graph.raw_cuda_graph())
            graph.instantiate()
            return graph, torch.cuda.memory_reserved(device) - reserved, nodes
    return capture


def graph_nodes(raw_graph: int) -> int:
    """Nodes of a captured cudaGraph_t (libcuda's cuGraphGetNodes)."""
    get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t)]
    get_nodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    rc = get_nodes(raw_graph, None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return count.value
