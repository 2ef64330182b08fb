"""Where the port's serving dispatches spend their time on the card.

Builds a model from a preset with random weights (seed 0) and a full KV
cache, then times the dispatches the engine issues, at the engine's shapes:

- `decode`: one decode step plus sampling over 8 rows (what the burst loop
  runs k times per host sync), at a short and a long context, each launched
  eagerly; then the engine's whole burst of k = 8 such steps
  (`engine/decode_graph.py`) as one CUDA graph replay at the same two
  contexts (its first call runs the burst eagerly and captures it), with
  wall and device time also given per step (divided by k). The graph rows'
  `launches` are the device kernels the profiler saw per replay;
- `prefill`: one bucketed `prefill_into_pages` dispatch;
- `extend`: one 512-token `prefill_extend_pages` chunk at position 1024.

For each it prints the host wall time per dispatch (host clock around many
back-to-back dispatches ending in a synchronize), the device time the
profiler saw (`torch.profiler`, kernel durations summed), the device's idle
share (1 - device / wall), the launches per dispatch, and the device time
split into the port's attention kernels, its LoRA kernels, the MoE layer
(`moe`: every kernel inside models/mixtral.py's "moe" profiler range on
the device timeline, the router, top-k, dispatch and combine and the
expert products with their int8 widening; eager dispatches only, since a
graph replay records no range), matrix products (cuBLAS) and everything
else, with the top kernels by name. Beside
them, under "clocks", the card's SM clock, power draw, power limit and
temperature as `nvidia-smi --query-gpu=clocks.sm,power.draw,power.limit,
temperature.gpu` read them on a thread while the dispatch ran: a card held
below its clock by power or heat runs every kernel slower.

Run on the card from the repository root:

    python -m llmlb_tpu_torch.profile_step --preset llama-3-8b

`--preset mixtral-8x7b --quantize weights` profiles the MoE family (int8
experts: its bf16 weights do not fit the card); the weights are filled as
int8 a matrix at a time, as the engine fills them.

`--quantize all` (or `weights`, `kv`) profiles the int8 engine: the same
seed-0 weights quantized on the card one layer at a time, and int8 pools.

`--kv-layout dense` profiles the dense slot cache [L, 8, 4096, K, D]
instead of the page pool: `decode_step`, `prefill_into_slots` and
`prefill_extend_slots`.

`--lora N` adds an adapter pool of N random rank-16 adapters on all seven
projections (seed 2), as the engine's LoraManager lays it out (row 0 the
identity), and gives the dispatches mixed rows: row i uses pool row
i % (N + 1), so the base model shares the batch with the adapters.

`--only prefill,extend` (any of decode, prefill, extend) runs those
dispatches alone. `--only buckets` asks whether a row's prefill logits
depend on the bucket its chunk is padded to: a 1503-token prompt prefills
in 512-token chunks, as a cold run does, and the rows a prefix-cache hit
would prefill (from 1408, the head aligned down to 128) run again over the
same KV at bucket 128 and at the cold chunk's bucket 512. It prints their
first-token logits against the cold run's (the largest difference, its
worst ratio to the bf16 limit 2^-6 (|cold| + rms(cold)), bit for bit or
not) and the wall of the suffix dispatch at each bucket. The engine runs a
hit's suffix at the cold chunk's bucket (`EngineCore._advance_prefill`).

`--verify` runs the speculative verify step instead (`--only verify`): one
step of K+1 = 5 positions over the 8 rows, every row a full chunk (4 drafts),
at the short and the long context: the eager `verify_body`, then the
engine's verify graph key (its first call runs the step eagerly and
captures it) as one replay, the lengths reset to the context before each.

`--device cpu` rehearses the same dispatches at a small preset on the CPU
and prints no timing (there is no device to time).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import subprocess
import threading
import time

import torch

from llmlb_tpu_torch.device import resolve_device
from llmlb_tpu_torch.engine.decode_graph import (
    BurstGraphs,
    BurstState,
    burst_body,
    cuda_capture,
    verify_body,
)
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.lora.manager import LORA_A, LORA_B
from llmlb_tpu_torch.lora.store import lora_target_dims
from llmlb_tpu_torch.models import family_for
from llmlb_tpu_torch.ops import cuda_attention
from llmlb_tpu_torch.ops.attention import pool_shape
from llmlb_tpu_torch.ops.sampling import sample_tokens
from llmlb_tpu_torch.quant import parse_quant_mode

ROWS = 8  # the engine's default slots
BURST = 8  # the engine's decode burst on the card
CAPACITY = 4096  # its default slot capacity, in tokens
PAGE = 128
REPS = 20
LORA_RANK = 16  # the engine's default rank cap
VERIFY_K1 = 5  # the verify chunk at the engine's default 4 drafts
ATTENTION_KERNELS = ("paged_decode_kernel", "flash_prefill_kernel",
                     "paged_extend_kernel", "paged_decode_quant_kernel",
                     "paged_extend_quant_kernel", "flash_decode_kernel",
                     "flash_extend_kernel", "flash_prefill_tc_kernel",
                     "flash_extend_tc_kernel", "decode_combine_kernel",
                     "paged_extend_tc_kernel", "paged_extend_quant_tc_kernel")
LORA_KERNELS = ("bgmv_cluster_kernel",)  # csrc/lora_bgmv.cu
MATMUL_MARKS = ("gemm", "gemv", "cutlass", "cublas", "nvjet", "xmma")


MOE_RANGE = "moe"  # models/mixtral.py's record_function around the layer


def _category(name: str) -> str:
    low = name.lower()
    if any(k in name for k in ATTENTION_KERNELS):
        return "attention"
    if "llmlb" in name and any(k in name for k in LORA_KERNELS):
        return "lora"
    if any(m in low for m in MATMUL_MARKS):
        return "matmul"
    return "other"


SMI_QUERY = "clocks.sm,power.draw,power.limit,temperature.gpu"


def _smi_sample() -> list[float]:
    """[SM clock MHz, power draw W, power limit W, temperature C] of card
    0, as nvidia-smi reads them now."""
    line = subprocess.run(
        ["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return [float(x) for x in line.split(",")]


class _Clocks:
    """nvidia-smi samples taken on a thread while the `with` block runs:
    one at its start, then one every 0.2 s or so, and one at its end."""

    def __init__(self):
        self.samples: list[list[float]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while True:
            self.samples.append(_smi_sample())
            if self._stop.wait(0.2):
                self.samples.append(_smi_sample())
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=120)

    def summary(self) -> dict:
        sm, power, limit, temp = zip(*self.samples)
        return {"query": SMI_QUERY, "samples": len(self.samples),
                "sm_mhz_min": min(sm), "sm_mhz_max": max(sm),
                "power_w_max": max(power), "power_limit_w": limit[0],
                "temperature_c_max": max(temp)}


def _profile(fn, reps: int) -> dict:
    """Wall and device time of fn() per call, on the card, and the card's
    clocks while the wall-clock loop ran."""
    fn()
    torch.cuda.synchronize()
    with _Clocks() as clocks:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_cat: dict[str, float] = collections.defaultdict(float)
    by_name: dict[str, float] = collections.defaultdict(float)
    launches = 0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    # the MoE range shows on the device as an annotation spanning its
    # kernels: a kernel that starts inside one is "moe"
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == MOE_RANGE)
    starts = [a for a, _ in spans]
    for e in events:
        if e.name == MOE_RANGE:
            continue
        us = e.time_range.elapsed_us()
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        inside = i >= 0 and e.time_range.start < spans[i][1]
        by_cat["moe" if inside else _category(e.name)] += us
        by_name[e.name] += us
        launches += 1
    device_ms = sum(by_cat.values()) / reps / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "idle_share": (1.0 - device_ms / wall_ms) if device_ms else None,
        "launches": launches / reps,
        "device_ms_by_kind": {k: v / reps / 1e3 for k, v in sorted(by_cat.items())},
        "top_kernels_ms": [[n[:80], v / reps / 1e3] for n, v in top],
        "clocks": clocks.summary(),
    }


def _lora_pool(cfg, n: int, device) -> dict[str, torch.Tensor]:
    """Pool leaves [L, n+1, in, R] / [L, n+1, R, out] for every target of
    the family (Llama: all seven projections; MoE: the attention's):
    row 0 zero (the identity), rows 1..n random, small enough that no logit
    overflows."""
    gen = torch.Generator(device=device).manual_seed(2)
    leaves = {}
    for tgt, (in_dim, out_dim) in lora_target_dims(
            cfg, family_for(cfg).LORA_TARGETS).items():
        for suffix, shape in ((LORA_A, (in_dim, LORA_RANK)),
                              (LORA_B, (LORA_RANK, out_dim))):
            pool = torch.randn((cfg.num_layers, n + 1, *shape), generator=gen,
                               device=device, dtype=torch.float32)
            pool *= 0.01
            pool[:, 0] = 0.0
            leaves[tgt + suffix] = pool.to(cfg.dtype)
    return leaves


def _dispatches(cfg, params, ck, cv, tables, device, short_ctx, long_ctx,
                lora_idx=None):
    """name -> zero-argument callable issuing one engine dispatch. `tables`
    None selects the dense slot entry points (row i is slot i)."""
    gen = torch.Generator(device=device).manual_seed(1)
    temps = torch.zeros(ROWS, device=device)  # greedy, as chip_smoke serves
    top_p = torch.ones(ROWS, device=device)
    top_k = torch.zeros(ROWS, dtype=torch.int32, device=device)
    toks = torch.randint(0, 256, (ROWS,), generator=gen, device=device,
                         dtype=torch.int32)
    dense = tables is None
    fam = family_for(cfg)
    capacity = (ck.shape[2] if dense
                else tables.shape[1] * pool_shape(ck)[2])
    slots = torch.arange(ROWS, device=device)

    def decode(ctx):
        lens = torch.full((ROWS,), ctx, dtype=torch.int32, device=device)
        window = min(capacity, 1 << max(8, (ctx + 9 - 1).bit_length()))

        def step():
            if dense:
                logits, _, _ = fam.decode_step(params, cfg, toks, lens, ck,
                                               cv, window=window,
                                               lora_idx=lora_idx)
            else:
                logits, _, _ = fam.decode_step_paged(
                    params, cfg, toks, lens, ck, cv, tables, window=window,
                    lora_idx=lora_idx)
            sample_tokens(logits, gen, temps, top_p, top_k)
        return step

    def burst_graph(ctx):
        """One burst of BURST steps as the engine runs it on the card: a
        replay of its captured graph, the lengths reset to ctx before each
        (a fill outside the graph); eager on the CPU, which captures
        nothing."""
        state = BurstState(
            params=params, cfg=cfg, cache_k=ck, cache_v=cv,
            block_tables=tables, last_tokens=toks.clone(),
            seq_lens=torch.full((ROWS,), ctx, dtype=torch.int32,
                                device=device),
            tokens=torch.zeros((BURST + 1, ROWS), dtype=torch.int32,
                               device=device),
            temps=temps, top_ps=top_p, top_ks=top_k,
            seeds=torch.full((ROWS,), -1, dtype=torch.int64, device=device),
            lora_idx=lora_idx,
            nan_rows=torch.zeros((), dtype=torch.int64, device=device),
            generator=gen)
        window = min(capacity,
                     1 << max(8, (ctx + BURST + 1 - 1).bit_length()))
        bursts = BurstGraphs(
            lambda w, s, m: burst_body(state, w, s, m),
            cuda_capture(device, gen) if device.type == "cuda" else None)

        def run():
            state.seq_lens.fill_(ctx)
            bursts.run(window, False, "free")
        return run

    def prefill(rows, bucket):
        ids = torch.randint(0, 256, (rows, bucket), generator=gen,
                            device=device)
        lens = torch.full((rows,), bucket - 4, dtype=torch.int32,
                          device=device)
        lidx = None if lora_idx is None else lora_idx[-rows:]
        if dense:
            return lambda: fam.prefill_into_slots(
                params, cfg, ids, lens, slots[:rows], ck, cv, lora_idx=lidx)
        return lambda: fam.prefill_into_pages(params, cfg, ids, lens,
                                              tables[:rows], ck, cv,
                                              lora_idx=lidx)

    def extend(start, chunk):
        ids = torch.randint(0, 256, (1, chunk), generator=gen, device=device)
        n = torch.tensor([chunk], dtype=torch.int32, device=device)
        s = torch.tensor([start], dtype=torch.int32, device=device)
        # the chunk's row takes an adapter when there is one
        lidx = None if lora_idx is None else lora_idx[-1:]
        if dense:
            return lambda: fam.prefill_extend_slots(
                params, cfg, ids, n, s, slots[:1], ck, cv, lora_idx=lidx)
        return lambda: fam.prefill_extend_pages(params, cfg, ids, n, s,
                                                tables[:1], ck, cv,
                                                lora_idx=lidx)

    def verify(ctx, graph):
        """One verify step over every row (a K+1-token chunk each, the
        engine's verify_body): eager, or as a replay of its captured graph
        (eager on the CPU); the lengths and starts reset to ctx before
        each (fills outside the graph)."""
        k1 = VERIFY_K1
        i32 = dict(dtype=torch.int32, device=device)
        vin = torch.zeros(ROWS * (k1 + 3), **i32)
        nk = ROWS * k1
        state = BurstState(
            params=params, cfg=cfg, cache_k=ck, cache_v=cv,
            block_tables=tables, last_tokens=toks.clone(),
            seq_lens=torch.full((ROWS,), ctx, **i32),
            tokens=torch.zeros((2, ROWS), **i32),
            temps=temps, top_ps=top_p, top_ks=top_k,
            seeds=torch.full((ROWS,), -1, dtype=torch.int64, device=device),
            lora_idx=lora_idx,
            nan_rows=torch.zeros((), dtype=torch.int64, device=device),
            generator=gen, verify_ids=vin[:nk].view(ROWS, k1),
            verify_lens=vin[nk:nk + ROWS],
            verify_start=vin[nk + ROWS:nk + 2 * ROWS],
            verify_active=vin[nk + 2 * ROWS:],
            verify_out=torch.zeros((ROWS, k1 + 2), **i32))
        state.verify_ids.copy_(torch.randint(0, 256, (ROWS, k1),
                                             generator=gen, **i32))
        state.verify_lens.fill_(k1)
        state.verify_active.fill_(1)
        window = min(capacity, 1 << max(8, (ctx + k1 + 1 - 1).bit_length()))
        steps = BurstGraphs(
            lambda w, s, m: verify_body(state, w, s, m),
            cuda_capture(device, gen) if graph and device.type == "cuda"
            else None)

        def run():
            state.seq_lens.fill_(ctx)
            state.verify_start.fill_(ctx)
            if graph:
                steps.run(window, False, "free")
            else:
                verify_body(state, window, False, "free")
        return run

    bucket = min(512, capacity // 2)
    return {
        f"verify rows={ROWS} k1={VERIFY_K1} ctx={short_ctx}":
            verify(short_ctx, False),
        f"verify rows={ROWS} k1={VERIFY_K1} ctx={long_ctx}":
            verify(long_ctx, False),
        f"verify graph rows={ROWS} k1={VERIFY_K1} ctx={short_ctx}":
            verify(short_ctx, True),
        f"verify graph rows={ROWS} k1={VERIFY_K1} ctx={long_ctx}":
            verify(long_ctx, True),
        f"decode rows={ROWS} ctx={short_ctx}": decode(short_ctx),
        f"decode rows={ROWS} ctx={long_ctx}": decode(long_ctx),
        f"decode graph burst={BURST} rows={ROWS} ctx={short_ctx}":
            burst_graph(short_ctx),
        f"decode graph burst={BURST} rows={ROWS} ctx={long_ctx}":
            burst_graph(long_ctx),
        f"prefill rows=1 bucket={min(128, bucket)}": prefill(1, min(128, bucket)),
        f"prefill rows={ROWS} bucket={bucket}": prefill(ROWS, bucket),
        f"extend chunk={bucket} start={long_ctx // 2}": extend(long_ctx // 2,
                                                               bucket),
    }


def _buckets(cfg, params, ck, cv, tables, device, largest, on_card) -> dict:
    """The `--only buckets` row: a cold run's chunks, then a hit's suffix at
    two buckets over the same KV (row 0 of the pool or slot cache)."""
    capacity = (ck.shape[2] if tables is None
                else tables.shape[1] * pool_shape(ck)[2])
    n = min(3 * largest - 33, capacity - 2)  # 1503 at 512
    align = PAGE if tables is not None else 32
    hit = (n - 1) // align * align
    gen = torch.Generator(device=device).manual_seed(3)
    prompt = torch.randint(0, 256, (n,), generator=gen, device=device)
    fam = family_for(cfg)

    def chunk(start, length, bucket):
        ids = torch.zeros((1, bucket), dtype=torch.int64, device=device)
        ids[0, :length] = prompt[start:start + length]
        lens = torch.tensor([length], dtype=torch.int32, device=device)
        at = torch.tensor([start], dtype=torch.int32, device=device)
        if tables is None:
            out = fam.prefill_extend_slots(
                params, cfg, ids, lens, at,
                torch.zeros(1, dtype=torch.int64, device=device), ck, cv)
        else:
            out = fam.prefill_extend_pages(params, cfg, ids, lens, at,
                                           tables[:1], ck, cv)
        return out[0][0].float()

    starts = list(range(0, n, largest))
    for s in starts[:-1]:
        chunk(s, largest, largest)
    cold = chunk(starts[-1], n - starts[-1], largest)
    rms = cold.pow(2).mean().sqrt()
    row = {"dispatch": f"buckets prompt={n} hit_start={hit}"}
    small = max(32, 1 << (n - hit - 1).bit_length())
    for bucket in (small, largest):
        got = chunk(hit, n - hit, bucket)
        diff = (got - cold).abs()
        out = {"max_abs_diff": diff.max().item(),
               "worst_ratio_to_bf16_limit":
                   (diff / (2.0**-6 * (cold.abs() + rms))).max().item(),
               "bitwise": bool(torch.equal(got, cold))}
        if on_card:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(REPS):
                chunk(hit, n - hit, bucket)
            torch.cuda.synchronize()
            out["suffix_wall_ms"] = (time.perf_counter() - t0) / REPS * 1e3
        row[f"hit_at_bucket_{bucket}"] = out
    return row


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--preset", default=None,
                        help="default llama-3-8b on the card, debug-tiny on "
                             "the CPU")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--quantize", choices=("off", "weights", "kv", "all"),
                        default="off", help="int8 weights and/or KV pages")
    parser.add_argument("--kv-layout", choices=("paged", "dense"),
                        default="paged", help="page pool or dense slot cache")
    parser.add_argument("--lora", type=int, default=0, metavar="N",
                        help="N resident random adapters, mixed rows")
    parser.add_argument("--only", default="decode,prefill,extend",
                        help="comma-separated dispatch kinds to run")
    parser.add_argument("--verify", action="store_true",
                        help="the speculative verify step alone (eager and "
                             "as a graph replay), as --only verify")
    args = parser.parse_args(argv)
    kinds = {"verify"} if args.verify else set(args.only.split(","))
    if not kinds <= {"decode", "prefill", "extend", "buckets", "verify"}:
        parser.error(f"--only: unknown kinds {sorted(kinds)}")
    quant = parse_quant_mode(args.quantize)
    if quant.kv and args.kv_layout == "dense":
        parser.error("int8 KV needs the paged layout (--kv-layout paged)")
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cfg = get_preset(args.preset or ("llama-3-8b" if on_card else "debug-tiny"))
    capacity = CAPACITY if on_card else 256
    page = min(PAGE, capacity)
    ppn = capacity // page
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)

    fam = family_for(cfg)
    # int8 weights filled a matrix at a time (the engine's init): the same
    # codes as quantize_params of the model-dtype init
    params = fam.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                             device, quantize_weights=quant.weights)
    lora_idx = None
    if args.lora:
        # adapter leaves join after quantization, as in the engine
        params = {**params, **_lora_pool(cfg, args.lora, device)}
        lora_idx = torch.arange(ROWS, dtype=torch.int32,
                                device=device) % (args.lora + 1)
    if args.kv_layout == "dense":
        ck, cv = fam.init_kv_cache(cfg, ROWS, capacity, device)
        tables = None
    else:
        ck, cv = fam.init_kv_pages(cfg, ROWS * ppn + 1, page, device,
                                     quantized=quant.kv)
        tables = (torch.arange(ROWS * ppn, dtype=torch.int32, device=device)
                  + 1).reshape(ROWS, ppn)
    dispatches = _dispatches(cfg, params, ck, cv, tables, device,
                             short_ctx=min(160, capacity // 4),
                             long_ctx=capacity // 2, lora_idx=lora_idx)
    if "buckets" in kinds:
        row = _buckets(cfg, params, ck, cv, tables, device,
                       min(512, capacity // 2), on_card)
        print(json.dumps({**row, "preset": args.preset or "llama-3-8b",
                          "quantize": quant.mode,
                          "kv_layout": args.kv_layout, "lora": args.lora,
                          **({"card": smi} if on_card else {})}), flush=True)
    for name, fn in dispatches.items():
        if name.split()[0] not in kinds:
            continue
        if not on_card:
            fn()  # rehearsal: shapes and control flow only
            print(f"rehearsal on cpu: {name} ran (no device to time)")
            continue
        cuda_attention.reset_launch_counts()
        row = {"dispatch": name, "preset": args.preset or "llama-3-8b",
               "quantize": quant.mode, "kv_layout": args.kv_layout,
               "lora": args.lora, "card": smi, **_profile(fn, REPS),
               # the port's kernels per dispatch (_profile ran fn 2 REPS + 1
               # times)
               "port_launches": {k: v / (2 * REPS + 1) for k, v in
                                 cuda_attention.LAUNCHES.items() if v}}
        if " graph burst=" in name:
            row["per_step"] = {key: row[key] / BURST for key in
                               ("wall_ms", "device_ms", "launches")}
        print(json.dumps(row), flush=True)
        if not any(cuda_attention.LAUNCHES.values()):
            raise RuntimeError(f"{name}: no attention kernel launched")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
