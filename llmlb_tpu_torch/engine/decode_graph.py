"""The decode burst as one CUDA graph per (window bucket, seeded) key:
counterpart of the JAX engine's `_build_decode_many` and `_decode_many_for`
(`llmlb_tpu/engine/scheduler.py`), which compile a k-step decode scan, with
sampling inside, into one program per (burst, window) and dispatch it once
per burst.

`BurstState` names every device tensor a burst reads or writes: the params
(adapter pools included), the KV caches, the block tables, the per-slot
last tokens, sequence lengths, sampling parameters and adapter rows, the
NaN counter and the [k + 1, slots] token block the host fetches. Each is
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
from llmlb_tpu_torch.models import llama
from llmlb_tpu_torch.ops.sampling import sample_tokens


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


def count_nan_rows(nan_rows: torch.Tensor, logits: torch.Tensor) -> None:
    """Add the logit rows holding a NaN to the device counter, in place."""
    nan_rows.add_(torch.isnan(logits).any(dim=-1).sum())


def burst_body(s: BurstState, window: int, seeded: bool) -> None:
    """k = tokens.shape[0] - 1 decode steps over every slot. Row 0 of the
    token block takes the last tokens going in, row i the tokens of step i;
    last_tokens and seq_lens end advanced by k."""
    last, lens = s.last_tokens, s.seq_lens
    s.tokens[0].copy_(last)
    for step in range(1, s.tokens.shape[0]):
        if s.block_tables is not None:
            logits, _, _ = llama.decode_step_paged(
                s.params, s.cfg, last, lens, s.cache_k, s.cache_v,
                s.block_tables, window=window, lora_idx=s.lora_idx)
        else:
            logits, _, _ = llama.decode_step(
                s.params, s.cfg, last, lens, s.cache_k, s.cache_v,
                window=window, lora_idx=s.lora_idx)
        count_nan_rows(s.nan_rows, logits)
        # seeded rows fold in the pre-increment length, as the reference
        toks = sample_tokens(logits, s.generator, s.temps, s.top_ps, s.top_ks,
                             seeds=s.seeds if seeded else None,
                             steps=lens if seeded else None)
        s.tokens[step].copy_(toks)
        last, lens = s.tokens[step], lens + 1
    s.last_tokens.copy_(last)
    s.seq_lens.copy_(lens)


@dataclasses.dataclass
class CapturedBurst:
    graph: Any  # torch.cuda.CUDAGraph, or anything with replay()
    launches: dict[str, int]  # the port's kernel launches per replay
    capture_s: float  # capture and instantiation, host seconds
    pool_bytes: int  # device memory the allocator reserved for the capture
    nodes: int | None  # nodes of the captured graph (None: not counted)


class BurstGraphs:
    """Runs decode bursts: eagerly, or as replays of one graph per key."""

    def __init__(self, body: Callable[[int, bool], None],
                 capture: Callable[[Callable[[], None]], tuple] | None = None,
                 lock: Any = None):
        self._body = body
        self._capture = capture
        self._lock = lock if lock is not None else contextlib.nullcontext()
        self.graphs: dict[tuple[int, bool], CapturedBurst] = {}
        self.replays = 0
        self.eager_bursts = 0

    def run(self, window: int, seeded: bool) -> None:
        """One burst of key (window, seeded): a replay of its graph, or
        the eager body (then captured, when there is a capture function)."""
        key = (window, seeded)
        captured = self.graphs.get(key)
        if captured is None:
            self._body(window, seeded)
            self.eager_bursts += 1
            if self._capture is not None:
                self.graphs[key] = self._capture_key(key)
            return
        with self._lock:
            captured.graph.replay()
        build.add_launches(captured.launches)
        self.replays += 1

    def _capture_key(self, key: tuple[int, bool]) -> CapturedBurst:
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
            "keys": {f"{w}/{'seeded' if s else 'unseeded'}": {
                "launches": dict(c.launches), "nodes": c.nodes,
                "capture_s": c.capture_s, "pool_bytes": c.pool_bytes}
                for (w, s), c in self.graphs.items()},
        }


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
