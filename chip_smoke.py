#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llmlb_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

`--serve-only` runs the device, build and serve phases alone, and
`--tree DIR` imports the port from another checkout (an older commit
unpacked with `git archive`), so that two trees' serving times can be taken
in one call on one card:

    python3 chip_smoke.py --serve-only --tree chip_tree/parent

Phases, in order; any failure exits non-zero and prints no result line:

1. device  — the card's name and power limit (nvidia-smi), TF32 off.
2. build   — compile llmlb_tpu_torch/csrc/*.cu with nvcc for sm_90a.
3. kernels — hold each kernel against its plain PyTorch version on the card,
             in bf16 and fp32 at the serving shapes of Llama-3-8B and in fp32
             at debug-tiny's widths, show that the limit rejects the plain
             version with a fault a kernel could have (a page or key tile
             left out; for the int8 kernels the wrong page's scales or K's
             scales for V; for the dense kernels the next slot's row; for
             the tensor-core prefill and extend a causal diagonal shifted by
             one key and a GQA head's output taken from its neighbour; for
             lora_delta the next adapter's rows, the last rank column or
             one cluster rank's partial left out; for the split-K decodes a
             lost partial, the keys of the second split left out), hold the
             three split-K decodes (flash_decode, paged_flash_decode,
             paged_flash_decode_quant) at kv_lens on the split edges and
             bit for bit across batch (a row alone and in the batch of 8)
             and sweep (4096 and 256 keys), hold lora_delta's two modes
             (the fp32 delta; the delta added into a projection output in
             place, bit for bit y + delta.to(dtype)), time the three decode
             kernels at the serving shape too (8 rows near 160 keys, window
             256), with torch.profiler's device time beside the events,
             hold the tensor-core prefill and extend in bf16 at
             head_dim 64 with GQA groups of 7 and 8 (Qwen2.5-0.5B,
             TinyLlama) and an extend start inside a key tile, hold the
             tensor-core paged extends (bf16 and int8 pools) on their tile
             and page edges (starts inside a tile, a chunk crossing a page
             inside a query tile, 3 rows with padding query tiles, pages of
             16..128 with shuffled tables, head_dim 64 with G = 7 and 8),
             reject a tile read from the next page-table entry and a page's
             second 64-key half read from its first, and hold them bit for
             bit: a row alone and in a batch, the int8 extend against the
             bf16 extend over the dequantized pools, the paged bf16 extend
             against flash_extend over the dense row of the same keys; time
             kernel / plain / library call with CUDA events, the attention
             kernels and their SDPA calls also with the L2 cache cold.
4. unembed — the 8B vocab projection: bf16 operands, fp32 logits.
5. model   — the model's serving entry points on the card (kernels)
             against the CPU (plain path) at debug size: the paged ones with
             model-dtype, int8, adapter-pool (mixed lora_idx) and int8 +
             adapter params; the dense-slot ones with and without adapters.
6. serve   — the port's HTTP server in-process, Llama-3-8B at full width and
             depth with random bf16 weights from seed 0: concurrent chat
             requests (streaming and not), a ~1500-token prompt that takes
             the chunked path, a repeat whose text must match, then
             token-level determinism, TTFT (the 124-token prompt and the
             ~1500-token one, whose chunks run the extend kernel) and decode
             rate on the same core. The core's decode bursts are CUDA graph
             replays, one graph per (window bucket, seeded) key after one
             eager warm-up burst each: every other burst replays, and the
             capture time, the graphs' pool bytes, nodes and port kernels
             per replay are logged. Then an engine with
             decode_graphs=False on the same weights and card: greedy and
             seeded rows (with adapters, the mixed batch) give the same
             tokens as the replays, two identical unseeded requests at
             temperature 1 draw different tokens on the graph core
             whenever they do on the eager one, and its single-stream
             decode rate is logged beside the graph core's. A capture or
             replay failure fails the phase: there is no eager fallback.
             Each kernel of the path launches over this phase (a replay
             counts the launches its capture recorded); the int8
             kernels do not. Then batch_invariance (C1): on the same
             weights, the timed prompt's prefill logits alone and as row 0
             of groups of 2, 4 and 8 other prompts of its bucket, through
             the entry point the scheduler's group prefill calls, equal bit
             for bit (on a difference the first op whose row 0 differs is
             named); this runs after each serve phase below too.
7. serve int8 — the same, graphs and all, with quantize="all": the same
             seed-0 weights
             quantized on the card, int8 KV pages; flash_prefill and the two
             int8 kernels launch, the bf16 paged kernels do not, and the
             greedy tokens that agree with the bf16 run are counted.
8. serve lora — the paged bf16 engine with a temporary adapter directory
             (two adapters written by the port's save_adapter): HTTP traffic
             mixing the base model, the `lora` field and `model:adapter`
             names; the adapter-free timed prompt's greedy ids equal the
             bf16 run's, an adapter's differ, a mixed batch's rows equal
             their solo runs for 32 of 32 tokens, lora_delta and the paged
             kernels launch, adapter refcounts drain to {}; batch
             invariance with mixed adapters.
9. serve dense — the bf16 traffic with kv_layout="dense": flash_prefill,
             flash_decode and flash_extend launch, no paged kernel does, and
             the timed prompt's 64 greedy tokens equal the paged bf16 run's
             (else the first op whose row 0 differs between the two
             layouts' entry points is named); how many of the long prompt's
             16 greedy tokens agree with the paged run's is reported.

The second-to-last line is one JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): bf16 tensor cores and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Llama-3-8B serving shapes at the engine defaults.
H, KV, D = 32, 8, 128
SLOTS, CAPACITY, PAGE = 8, 4096, 128
# the decode steps of the serve phases: 8 rows near 160 keys, window 256
SERVE_LENS, SERVE_WINDOW = [156, 157, 158, 159, 160, 161, 162, 163], 256
# bf16: inputs, probabilities and outputs are rounded to bf16 (8 significant
# bits), and the kernel's online softmax rescales its sums in another order
# than the plain version's two passes. Allow two bf16 steps of the element and
# of its (query, head) row's RMS: |err| <= 2^-6 (|plain| + rms(plain row)).
# Attention outputs shrink with the context (RMS ~ sqrt(e / keys) for unit
# normal q, k, v: 0.026 at 4096 keys), so the limit follows each row's scale;
# phase_kernels shows that one dropped page or key tile fails it.
BF16_REL = 2.0**-6
FP32_ATOL = 1e-4  # fp32: the same math summed in another order
# lora_delta: an fp32 result of exact products (bf16 x bf16 fits fp32) summed
# in another order than the plain version's fp32 einsum: relative sum-order
# error ~ sqrt(IN) * 2^-24 ~ 1e-5 at IN 14336. Allow 1e-4 of the element and
# of its row's RMS; one rank column of 16 left out moves ~25% of the RMS.
LORA_REL = 1e-4
# fp32 logits of the 8B vocab projection: fp32 sums of 4096 exact bf16
# products in another order than the fp32 product's (logits ~ N(0, 1))
UNEMBED_ATOL = 1e-3
# kernel names torch.profiler reports for each split-K decode's launches
PAGED_DECODE_MARKS = ("paged_decode_kernel", "decode_combine_kernel")
QUANT_DECODE_MARKS = ("paged_decode_quant_kernel", "decode_combine_kernel")
DENSE_DECODE_MARKS = ("flash_decode_kernel", "decode_combine_kernel")
# ... and for the tensor-core paged extends (bf16)
PAGED_EXTEND_MARKS = ("paged_extend_tc_kernel",)
QUANT_EXTEND_MARKS = ("paged_extend_quant_tc_kernel",)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, after one
    warm-up call (CUDA events on the current stream)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int) -> float:
    """Mean device time of fn() with the L2 cache cold: before each call a
    128 MB buffer is read and written (outside the timed region), so fn()
    finds none of its inputs in the 50 MB L2, as a serving step whose
    other layers ran in between would. CUDA events around each call."""
    import torch

    flush = torch.zeros(32 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def profiled_ms(fn, reps: int, marks: tuple[str, ...]) -> float:
    """Device time per fn() call of the kernels whose names hold one of
    `marks`, as torch.profiler saw them (no host time between launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(m in e.name for m in marks))
    return us / reps / 1e3


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- phases


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    kind = torch.cuda.get_device_name(0)
    log(f"torch: {torch.__version__} cuda {torch.version.cuda}; device 0: {kind}; "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"smi": smi, "kind": kind, "count": torch.cuda.device_count()}


def phase_build() -> None:
    from llmlb_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        f"(nvcc {build.BUILD_INFO.get('seconds', 0.0):.2f} s, "
        f"cached={build.BUILD_INFO.get('cached')})")
    for name, report in (build.BUILD_INFO.get("ptxas") or {}).items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")


def _pool(torch, gen, pages, dtype, kv=KV, d=D, page=PAGE):
    shape = (pages, page, kv, d)
    k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return k, v


def _pairs(got, want, rows):
    """(kernel, plain) pairs over the defined rows: all rows, or the first
    rows[b] of batch row b."""
    if rows is None:
        return [(got.float(), want.float())]
    return [(got[b, :n].float(), want[b, :n].float())
            for b, n in enumerate(rows) if n > 0]


def _within(got, want, atol, rel, rows) -> tuple[float, bool]:
    """(max |got - want|, whether every element is within
    atol + rel * (|want| + rms of want's last-dim row)). NaN fails."""
    err, ok = 0.0, True
    for g, w in _pairs(got, want, rows):
        rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
        diff = (g - w).abs()
        err = max(err, diff.max().item())
        ok = ok and bool((diff <= atol + rel * (w.abs() + rms)).all())
    return err, ok


def _check(name, got, want, *, atol=0.0, rel=0.0, rows=None) -> float:
    """Max |kernel - plain| over the defined rows; raises if any element is
    outside the limit of `_within`."""
    err, ok = _within(got, want, atol, rel, rows)
    log(f"  {name}: max_abs_err {err:.3e} (atol {atol:g}, rel {rel:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max_abs_err {err:.3e})")
    return err


def _must_fail(name, mutant, want, *, rel, rows=None) -> None:
    """The bf16 limit must reject `mutant`, the plain version with part of
    the work left out, as it would reject a kernel that skipped it."""
    err, ok = _within(mutant, want, 0.0, rel, rows)
    log(f"  {name}: max_abs_err {err:.3e} -> "
        f"{'REJECTED' if not ok else 'ACCEPTED (limit too loose)'}")
    if ok:
        raise AssertionError(f"{name}: the bf16 limit accepts a mutant")


def _plain(torch, q, k_cache, v_cache, mask, drop=None):
    """masked_attention with keys [lo, hi) of batch rows `rows` hidden, or
    the unchanged mask for drop=None; q [B, T, H, D], mask [B, T, S]."""
    from llmlb_tpu_torch.ops import cuda_attention as ca

    if drop is not None:
        lo, hi, rows = drop
        cols = torch.arange(mask.shape[-1], device=mask.device)
        hide = (cols >= lo) & (cols < hi)
        sel = torch.zeros(mask.shape[0], dtype=torch.bool, device=mask.device)
        sel[list(rows)] = True
        mask = mask & ~(hide[None, None, :] & sel[:, None, None])
    return ca.masked_attention(q, k_cache, v_cache, mask)


def phase_kernels() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from llmlb_tpu_torch.ops import cuda_attention as ca
    from llmlb_tpu_torch.quant import quantize_kv

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # -- flash_prefill: a 512-token bucket, 8 ragged prompts -----------------
    b, t = SLOTS, 512
    q, k, v = randn((b, t, H, D), bf16), randn((b, t, KV, D), bf16), \
        randn((b, t, KV, D), bf16)
    plens_host = [512, 500, 384, 256, 200, 129, 64, 1]
    plens = torch.tensor(plens_host, dtype=torch.int32, device="cuda")
    got = ca.flash_prefill(q, k, v, plens)
    want = ca.flash_prefill_reference(q, k, v, plens)
    torch.cuda.synchronize()
    err = _check("flash_prefill bf16 [8,512,32,128]", got, want, rel=BF16_REL,
                 rows=plens_host)
    pos = torch.arange(t, device="cuda")
    mask = ((pos[None, :, None] >= pos[None, None, :])
            & (pos[None, None, :] < plens[:, None, None]))
    if not torch.equal(_plain(torch, q, k, v, mask), want):
        raise AssertionError("flash_prefill: the mutants' mask is not the "
                             "plain version's")
    _must_fail("flash_prefill bf16, key tile [64, 128) of row 0 dropped",
               _plain(torch, q, k, v, mask, (64, 128, [0])), want,
               rel=BF16_REL, rows=plens_host)
    _tc_mutants(torch, "flash_prefill", q, k, v,
                (pos[None, :, None] + 1 >= pos[None, None, :])
                & (pos[None, None, :] < plens[:, None, None]), want, plens_host)
    # the yardstick call takes SDPA's [B, H, T, D] layout with the KV heads
    # repeated for the group, prepared outside the timed region
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
              for x in (k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt,
                                              attn_mask=mask[:, None])

    # the function's work: the defined rows read q, k, v and write out once
    visible = sum(n * (n + 1) // 2 for n in plens_host)
    nbytes = (2 * H + 2 * KV) * D * 2 * sum(plens_host) + b * 4
    bms, by = bound_ms(nbytes, 4 * H * D * visible, PEAK_BF16_FLOPS)
    rows.append(dict(
        name="flash_prefill", route="cuda",
        source="llmlb_tpu_torch/csrc/flash_prefill.cu",
        replaces="llmlb_tpu/ops/pallas_attention.py:494",
        max_abs_err=err,
        ms=cuda_ms(lambda: ca.flash_prefill(q, k, v, plens), 20),
        ms_cold=cuda_ms_cold(lambda: ca.flash_prefill(q, k, v, plens), 20),
        plain_ms=cuda_ms(lambda: ca.flash_prefill_reference(q, k, v, plens), 3),
        bound_ms=bms, bound_by=by, library_ms=cuda_ms(sdpa, 10),
        library_ms_cold=cuda_ms_cold(sdpa, 10)))
    del q, k, v, qt, kt, vt, got, want, mask
    _tc_head_dim_64(torch, gen)

    # -- paged_flash_decode: 8 rows up to 4096 tokens through block tables ---
    ppn = CAPACITY // PAGE
    pages_total = SLOTS * ppn + 1
    kp, vp = _pool(torch, gen, pages_total, bf16)
    perm = torch.randperm(pages_total - 1, generator=gen, device="cuda") + 1
    tables = perm.reshape(SLOTS, ppn).to(torch.int32).contiguous()
    lens_host = [4096, 3000, 2048, 1500, 1024, 513, 129, 1]
    lens = torch.tensor(lens_host, dtype=torch.int32, device="cuda")
    q = randn((SLOTS, H, D), bf16)
    got = ca.paged_flash_decode(q, kp, vp, tables, lens, pages=ppn)
    want = ca.paged_flash_decode_reference(q, kp, vp, tables, lens, pages=ppn)
    torch.cuda.synchronize()
    err = _check("paged_flash_decode bf16 [8,32,128] ctx<=4096", got, want,
                 rel=BF16_REL)
    kc, vc = ca.gather_kv_pages(kp, tables), ca.gather_kv_pages(vp, tables)
    cols = torch.arange(ppn * PAGE, device="cuda")
    mask = (cols[None, :] < lens[:, None])[:, None]
    if not torch.equal(_plain(torch, q[:, None], kc, vc, mask)[:, 0], want):
        raise AssertionError("paged_flash_decode: the mutants' mask is not "
                             "the plain version's")
    sk = ca.DECODE_SPLIT_KEYS
    for what, drop in (("page 5", (5 * PAGE, 6 * PAGE, [0])),
                       ("last key tile", (4096 - 64, 4096, [0])),
                       (f"keys [{sk}, {2 * sk}) (a lost partial)",
                        (sk, 2 * sk, [0]))):
        _must_fail(f"paged_flash_decode bf16, {what} of the 4096-token row "
                   "dropped",
                   _plain(torch, q[:, None], kc, vc, mask, drop)[:, 0], want,
                   rel=BF16_REL)
    del kc, vc
    edge_host = _edge_lens(ca)
    edge = torch.tensor(edge_host, dtype=torch.int32, device="cuda")
    _check(f"paged_flash_decode bf16 kv_lens {edge_host} (split edges)",
           ca.paged_flash_decode(q, kp, vp, tables, edge, pages=ppn),
           ca.paged_flash_decode_reference(q, kp, vp, tables, edge, pages=ppn),
           rel=BF16_REL)
    _bitwise(torch, "paged_flash_decode bf16",
             lambda rows_, sweep: ca.paged_flash_decode(
                 q[rows_].contiguous(), kp, vp, tables[rows_].contiguous(),
                 edge[rows_].contiguous(), pages=sweep // PAGE), edge_host)
    kv_cells = sum(lens_host)
    table_reads = sum(-(-n // PAGE) for n in lens_host)
    nbytes = (kv_cells * KV * D * 2 * 2 + 2 * q.numel() * 2
              + table_reads * 4 + SLOTS * 4)
    bms, by = bound_ms(nbytes, 4 * H * D * kv_cells, PEAK_BF16_FLOPS)
    rows.append(dict(
        name="paged_flash_decode", route="cuda",
        source="llmlb_tpu_torch/csrc/paged_decode.cu",
        replaces="llmlb_tpu/ops/pallas_attention.py:211",
        max_abs_err=err,
        ms=cuda_ms(lambda: ca.paged_flash_decode(q, kp, vp, tables, lens,
                                                 pages=ppn), 50),
        ms_cold=cuda_ms_cold(lambda: ca.paged_flash_decode(
            q, kp, vp, tables, lens, pages=ppn), 20),
        dev_ms=profiled_ms(lambda: ca.paged_flash_decode(
            q, kp, vp, tables, lens, pages=ppn), 20, PAGED_DECODE_MARKS),
        plain_ms=cuda_ms(lambda: ca.paged_flash_decode_reference(
            q, kp, vp, tables, lens, pages=ppn), 5),
        bound_ms=bms, bound_by=by, library_ms=None))
    serve = torch.tensor(SERVE_LENS, dtype=torch.int32, device="cuda")
    serve_pages = SERVE_WINDOW // PAGE
    _check(f"paged_flash_decode bf16 kv_lens {SERVE_LENS} pages {serve_pages}",
           ca.paged_flash_decode(q, kp, vp, tables, serve, pages=serve_pages),
           ca.paged_flash_decode_reference(q, kp, vp, tables, serve,
                                           pages=serve_pages), rel=BF16_REL)
    _serve_times(torch, "paged_flash_decode", lambda: ca.paged_flash_decode(
        q, kp, vp, tables, serve, pages=serve_pages), rows[-1],
        PAGED_DECODE_MARKS)

    # -- paged_flash_extend: the last 476-token chunk of a 1500-token prompt --
    t, start_host, chunk_host = 512, 1024, 476
    q = randn((1, t, H, D), bf16)
    tab1 = tables[:1].contiguous()
    start = torch.tensor([start_host], dtype=torch.int32, device="cuda")
    chunk = torch.tensor([chunk_host], dtype=torch.int32, device="cuda")
    got = ca.paged_flash_extend(q, kp, vp, tab1, start, chunk)
    want = ca.paged_flash_extend_reference(q, kp, vp, tab1, start, chunk)
    torch.cuda.synchronize()
    err = _check("paged_flash_extend bf16 [1,512,32,128] start 1024", got,
                 want, rel=BF16_REL, rows=[chunk_host])
    kc, vc = ca.gather_kv_pages(kp, tab1), ca.gather_kv_pages(vp, tab1)
    q_pos = start_host + torch.arange(t, device="cuda")
    mask = (cols[None, None, :] <= q_pos[None, :, None])
    if not torch.equal(_plain(torch, q, kc, vc, mask), want):
        raise AssertionError("paged_flash_extend: the mutants' mask is not "
                             "the plain version's")
    _must_fail("paged_flash_extend bf16, page 5 (keys 640..767) dropped",
               _plain(torch, q, kc, vc, mask, (5 * PAGE, 6 * PAGE, [0])), want,
               rel=BF16_REL, rows=[chunk_host])
    for what, (kt, vt) in _tile_mutants(kc, vc):
        _must_fail(f"paged_flash_extend bf16, {what}",
                   _plain(torch, q, kt, vt, mask), want, rel=BF16_REL,
                   rows=[chunk_host])
    del kc, vc, mask
    # the function's work: the defined rows, and the keys they see
    keys = start_host + chunk_host
    visible = sum(start_host + i + 1 for i in range(chunk_host))
    nbytes = (keys * KV * D * 2 * 2 + 2 * chunk_host * H * D * 2
              + -(-keys // PAGE) * 4 + 8)
    bms, by = bound_ms(nbytes, 4 * H * D * visible, PEAK_BF16_FLOPS)
    rows.append(dict(
        name="paged_flash_extend", route="cuda",
        source="llmlb_tpu_torch/csrc/paged_extend.cu",
        replaces="llmlb_tpu/ops/pallas_attention.py:732",
        max_abs_err=err,
        ms=cuda_ms(lambda: ca.paged_flash_extend(q, kp, vp, tab1, start,
                                                 chunk), 20),
        ms_cold=cuda_ms_cold(lambda: ca.paged_flash_extend(
            q, kp, vp, tab1, start, chunk), 20),
        dev_ms=profiled_ms(lambda: ca.paged_flash_extend(
            q, kp, vp, tab1, start, chunk), 20, PAGED_EXTEND_MARKS),
        plain_ms=cuda_ms(lambda: ca.paged_flash_extend_reference(
            q, kp, vp, tab1, start, chunk), 3),
        bound_ms=bms, bound_by=by, library_ms=None))
    del q, got, want
    _paged_extend_cases(torch, gen, kp, vp, tables)

    # -- the int8 kernels, on the same pages quantized -----------------------
    rows += _quant_kernels(torch, gen, kp, vp, tables, lens_host, tab1,
                           start_host, chunk_host)
    del kp, vp

    # -- the dense slot cache kernels and the LoRA bgmv ----------------------
    rows += _dense_kernels(torch, gen, lens_host, start_host, chunk_host)
    rows += _lora_kernel(torch, gen)

    # -- fp32 at the serving shapes (D 128, pages of 128) --------------------
    q, k, v = randn((2, 128, H, D), f32), randn((2, 128, KV, D), f32), \
        randn((2, 128, KV, D), f32)
    pl = torch.tensor([128, 77], dtype=torch.int32, device="cuda")
    _check("flash_prefill fp32 [2,128,32,128]",
           ca.flash_prefill(q, k, v, pl),
           ca.flash_prefill_reference(q, k, v, pl), atol=FP32_ATOL,
           rows=[128, 77])
    kp, vp = _pool(torch, gen, pages_total, f32)
    q = randn((SLOTS, H, D), f32)
    _check("paged_flash_decode fp32 [8,32,128] ctx<=4096",
           ca.paged_flash_decode(q, kp, vp, tables, lens, pages=ppn),
           ca.paged_flash_decode_reference(q, kp, vp, tables, lens, pages=ppn),
           atol=FP32_ATOL)
    _check(f"paged_flash_decode fp32 kv_lens {edge_host} (split edges)",
           ca.paged_flash_decode(q, kp, vp, tables, edge, pages=ppn),
           ca.paged_flash_decode_reference(q, kp, vp, tables, edge, pages=ppn),
           atol=FP32_ATOL)
    q = randn((1, t, H, D), f32)
    _check("paged_flash_extend fp32 [1,512,32,128] start 1024",
           ca.paged_flash_extend(q, kp, vp, tab1, start, chunk),
           ca.paged_flash_extend_reference(q, kp, vp, tab1, start, chunk),
           atol=FP32_ATOL, rows=[chunk_host])
    del kp, vp, q, k, v

    # -- fp32 at debug-tiny's head_dim 16, pages of 16, the `pages` bound ----
    kp, vp = _pool(torch, gen, 13, f32, kv=4, d=16, page=16)
    tab = (torch.randperm(12, generator=gen, device="cuda") + 1).reshape(3, 4)
    tab = tab.to(torch.int32).contiguous()
    q = randn((3, 8, 16), f32)
    kl = torch.tensor([1, 16, 45], dtype=torch.int32, device="cuda")
    _check("paged_flash_decode fp32 [3,8,16] G=2 pages=3",
           ca.paged_flash_decode(q, kp, vp, tab, kl, pages=3),
           ca.paged_flash_decode_reference(q, kp, vp, tab, kl, pages=3),
           atol=FP32_ATOL)
    q = randn((3, 16, 8, 16), f32)
    st = torch.tensor([0, 13, 40], dtype=torch.int32, device="cuda")
    ch = torch.tensor([16, 9, 3], dtype=torch.int32, device="cuda")
    _check("paged_flash_extend fp32 [3,16,8,16] G=2",
           ca.paged_flash_extend(q, kp, vp, tab, st, ch),
           ca.paged_flash_extend_reference(q, kp, vp, tab, st, ch),
           atol=FP32_ATOL, rows=[16, 9, 3])
    qk, qv = quantize_kv(kp), quantize_kv(vp)
    q = randn((3, 8, 16), f32)
    _check("paged_flash_decode_quant fp32 [3,8,16] G=2 pages=3",
           ca.paged_flash_decode_quant(q, *qk, *qv, tab, kl, pages=3),
           ca.paged_flash_decode_quant_reference(q, *qk, *qv, tab, kl, pages=3),
           atol=FP32_ATOL)
    q = randn((3, 16, 8, 16), f32)
    _check("paged_flash_extend_quant fp32 [3,16,8,16] G=2",
           ca.paged_flash_extend_quant(q, *qk, *qv, tab, st, ch),
           ca.paged_flash_extend_quant_reference(q, *qk, *qv, tab, st, ch),
           atol=FP32_ATOL, rows=[16, 9, 3])
    for r in rows:
        lib = ("none" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ms warm"
               + (f", {r['library_ms_cold']:.4f} ms L2 cold"
                  if "library_ms_cold" in r else ""))
        cold = (f", {r['ms_cold']:.4f} ms L2 cold" if "ms_cold" in r else "")
        cold += (f", device {r['dev_ms']:.4f} ms" if "dev_ms" in r else "")
        serve = (f"; serve shape {r['serve_ms']:.4f} ms warm, "
                 f"{r['serve_ms_cold']:.4f} ms L2 cold, device "
                 f"{r['serve_dev_ms']:.4f} ms" if "serve_ms" in r else "")
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms warm{cold}, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}){serve}")
    return rows


def _sdpa_ms(torch, q, k, v, mask) -> tuple[float, float]:
    """The yardstick call for the dense kernels: SDPA with a boolean mask
    and the KV heads shared by their query group (enable_gqa), on the
    [B, heads, T, D] layout prepared outside the timed region. Timed only,
    warm and with the L2 cold; the port never calls it."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    m = mask[:, None]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m,
                                              enable_gqa=True)

    return cuda_ms(sdpa, 10), cuda_ms_cold(sdpa, 10)


def _tc_mutants(torch, name, q, k, v, shifted, want, rows) -> None:
    """Faults a fragment-layout error in the tensor-core body would make,
    which the bf16 limit must reject: the causal diagonal shifted by one
    (`shifted`: row t also sees key t + 1), and one head of a GQA group
    writing its neighbour's output (head 1 given head 0's rows)."""
    _must_fail(f"{name} bf16, causal diagonal shifted by one key",
               _plain(torch, q, k, v, shifted), want, rel=BF16_REL, rows=rows)
    swapped = want.clone()
    swapped[:, :, 1] = want[:, :, 0]
    _must_fail(f"{name} bf16, head 1 of the group given head 0's output",
               swapped, want, rel=BF16_REL, rows=rows)


def _tc_head_dim_64(torch, gen) -> None:
    """The tensor-core prefill and extend at head_dim 64 in bf16, with GQA
    groups that do not fill the 64 rows alike: Qwen2.5-0.5B (14 heads over
    2 KV heads, G = 7: 9 positions, 63 live rows) and TinyLlama-1.1B (32
    over 4, G = 8). Prompt lengths on the 64-key tile's edges; extend starts
    inside a tile, and one chunk whose second query tile is all padding."""
    from llmlb_tpu_torch.ops import cuda_attention as ca

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    for tag, h, kv in (("Qwen2.5-0.5B G=7", 14, 2), ("TinyLlama G=8", 32, 4)):
        lens_host = [1, 63, 64, 65, 127, 129]
        b, t, d = len(lens_host), 192, 64
        q, k, v = randn((b, t, h, d)), randn((b, t, kv, d)), randn((b, t, kv, d))
        plens = torch.tensor(lens_host, dtype=torch.int32, device="cuda")
        got = ca.flash_prefill(q, k, v, plens)
        want = ca.flash_prefill_reference(q, k, v, plens)
        torch.cuda.synchronize()
        _check(f"flash_prefill bf16 [{b},{t},{h},{d}] kv {kv} ({tag}) lens "
               f"{lens_host}", got, want, rel=BF16_REL, rows=lens_host)
        pos = torch.arange(t, device="cuda")
        shifted = ((pos[None, :, None] + 1 >= pos[None, None, :])
                   & (pos[None, None, :] < plens[:, None, None]))
        _tc_mutants(torch, f"flash_prefill ({tag})", q, k, v, shifted, want,
                    lens_host)
        s_len, t = 1024, 256
        q = randn((2, t, h, d))
        kc, vc = randn((2, s_len, kv, d)), randn((2, s_len, kv, d))
        start_host, chunk_host = [777, 37], [200, 50]
        start = torch.tensor(start_host, dtype=torch.int32, device="cuda")
        chunk = torch.tensor(chunk_host, dtype=torch.int32, device="cuda")
        got = ca.flash_extend(q, kc, vc, start, chunk)
        want = ca.flash_extend_reference(q, kc, vc, start, chunk)
        torch.cuda.synchronize()
        _check(f"flash_extend bf16 [2,{t},{h},{d}] rows [2,{s_len},{kv},{d}] "
               f"({tag}) start {start_host} chunk {chunk_host}", got, want,
               rel=BF16_REL, rows=chunk_host)


def _edge_lens(ca) -> list[int]:
    """kv_lens on the split-K decodes' split edges: one below, at and one
    above kSplitKeys, an empty row, the full 4096, one a few keys into the
    fourth split, one key, and two whole splits."""
    sk = ca.DECODE_SPLIT_KEYS
    return [sk - 1, sk, sk + 1, 0, CAPACITY, 3 * sk + 7, 1, 2 * sk]


def _bitwise(torch, name, run, lens_host) -> None:
    """A split-K decode's rows do not depend on the batch or the sweep:
    row 0 computed alone equals its row in the batch, bit for bit, and the
    rows with kv_len <= kSplitKeys (one split) give the same bits under a
    sweep of 4096 keys (split kernel + combine) as under 256 (one launch).
    `run(rows, sweep)` runs the kernel on the batch rows `rows` (a slice)
    with that sweep."""
    from llmlb_tpu_torch.ops import cuda_attention as ca

    full = run(slice(None), CAPACITY)
    alone = run(slice(0, 1), CAPACITY)
    torch.cuda.synchronize()
    if not torch.equal(alone[0], full[0]):
        raise AssertionError(f"{name}: row 0 alone differs from its row in "
                             "the batch")
    short = [i for i, n in enumerate(lens_host) if n <= ca.DECODE_SPLIT_KEYS]
    narrow = run(slice(None), SERVE_WINDOW)
    torch.cuda.synchronize()
    if not torch.equal(narrow[short], full[short]):
        raise AssertionError(f"{name}: rows {short} differ between sweeps "
                             f"{CAPACITY} and {SERVE_WINDOW}")
    log(f"  {name}: row 0 alone == its row in the batch of {len(lens_host)}, "
        f"bit for bit; rows {short} (kv_len <= {ca.DECODE_SPLIT_KEYS}) equal "
        f"under sweeps {CAPACITY} and {SERVE_WINDOW}, bit for bit")


def _serve_times(torch, name, call, row, marks) -> None:
    """Time `call` (the kernel at the serve phases' decode shape) warm, with
    the L2 cold and in device time (the kernels named by `marks`), into
    row["serve_ms"], row["serve_ms_cold"], row["serve_dev_ms"]."""
    row["serve_ms"] = cuda_ms(call, 50)
    row["serve_ms_cold"] = cuda_ms_cold(call, 20)
    row["serve_dev_ms"] = profiled_ms(call, 20, marks)
    log(f"  {name} at the serve shape (kv_lens {SERVE_LENS}, sweep "
        f"{SERVE_WINDOW}): kernel {row['serve_ms']:.4f} ms warm, "
        f"{row['serve_ms_cold']:.4f} ms L2 cold, device "
        f"{row['serve_dev_ms']:.4f} ms")


def _tile_mutants(kc, vc):
    """(name, (K, V)) for faults of a paged extend's per-tile table read, on
    gathered rows [B, N*PS, K, D] with pages of 128: the first 64-key tile
    of page entry 5 (keys 640..703) read from entry 6, and the second half
    of that page (keys 704..767) read from its first half."""
    t0 = 5 * PAGE
    for what, dst, src in (
            ("keys 640..703 read from the next page-table entry",
             (t0, t0 + 64), (t0 + PAGE, t0 + PAGE + 64)),
            ("keys 704..767 (the page's second 64-key half) read from its "
             "first half", (t0 + 64, t0 + PAGE), (t0, t0 + 64))):
        kt, vt = kc.clone(), vc.clone()
        kt[:, dst[0]:dst[1]] = kc[:, src[0]:src[1]]
        vt[:, dst[0]:dst[1]] = vc[:, src[0]:src[1]]
        yield what, (kt, vt)


def _repage(torch, gen, rows_k, rows_v, ps):
    """K and V pools of `ps`-token pages holding dense rows [B, S, K, D] in
    shuffled pages (page 0 unused, as the engine's trash page) and their
    block tables [B, S / ps]: the paged layout of the same keys."""
    b, s, kv, d = rows_k.shape
    n = s // ps
    perm = torch.randperm(b * n, generator=gen, device="cuda") + 1
    pools = []
    for rows in (rows_k, rows_v):
        pool = torch.zeros((b * n + 1, ps, kv, d), dtype=rows.dtype,
                           device="cuda")
        pool[perm] = rows.reshape(b * n, ps, kv, d)
        pools.append(pool)
    return (*pools, perm.reshape(b, n).to(torch.int32).contiguous())


def _extend_pair(torch, name, q, kp, vp, tables, start_host, chunk_host):
    """One paged extend case in bf16, both kernels: paged_flash_extend over
    the pools and paged_flash_extend_quant over them quantized, each against
    its plain version; the int8 kernel equal bit for bit to the bf16 kernel
    over the pools dequantized with dequantize_kv. Returns the bf16
    output."""
    from llmlb_tpu_torch.ops import cuda_attention as ca
    from llmlb_tpu_torch.quant import dequantize_kv, quantize_kv

    start = torch.tensor(start_host, dtype=torch.int32, device="cuda")
    chunk = torch.tensor(chunk_host, dtype=torch.int32, device="cuda")
    got = ca.paged_flash_extend(q, kp, vp, tables, start, chunk)
    _check(f"paged_flash_extend bf16 {name}", got,
           ca.paged_flash_extend_reference(q, kp, vp, tables, start, chunk),
           rel=BF16_REL, rows=chunk_host)
    (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
    got8 = ca.paged_flash_extend_quant(q, kq, ks, vq, vs, tables, start, chunk)
    _check(f"paged_flash_extend_quant bf16 {name}", got8,
           ca.paged_flash_extend_quant_reference(q, kq, ks, vq, vs, tables,
                                                 start, chunk),
           rel=BF16_REL, rows=chunk_host)
    deq = ca.paged_flash_extend(q, dequantize_kv(kq, ks, torch.bfloat16),
                                dequantize_kv(vq, vs, torch.bfloat16), tables,
                                start, chunk)
    torch.cuda.synchronize()
    if not torch.equal(got8, deq):
        raise AssertionError(f"paged_flash_extend_quant {name}: not the bf16 "
                             "extend's bits over the dequantized pools")
    return got


def _paged_extend_cases(torch, gen, kp, vp, tables) -> None:
    """The tensor-core paged extends (bf16) on the edges of their 64-key
    tiles and per-tile table reads, each case for both kernels
    (_extend_pair): the table shape (476 queries at 1024) and a start
    inside a key tile (1000), both bit for bit against flash_extend over the
    dense row that holds the same keys; a chunk that crosses a page
    boundary inside a query tile; 3 rows with other starts and chunk_lens,
    whose padding query tiles read nothing, row 0 alone equal to its row in
    the batch; pages of 16, 32, 64 and 128 with shuffled tables, each equal
    to flash_extend over the dense row; head_dim 64 with GQA groups of 7
    and 8."""
    from llmlb_tpu_torch.ops import cuda_attention as ca

    bf16 = torch.bfloat16

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    def same_as_dense(name, got, q, kc, vc, start_host, chunk_host):
        start = torch.tensor(start_host, dtype=torch.int32, device="cuda")
        chunk = torch.tensor(chunk_host, dtype=torch.int32, device="cuda")
        dense = ca.flash_extend(q, kc, vc, start, chunk)
        torch.cuda.synchronize()
        if not torch.equal(got, dense):
            raise AssertionError(f"paged_flash_extend {name}: not "
                                 "flash_extend's bits over the dense row")
        log(f"  paged_flash_extend bf16 {name}: flash_extend's bits over the "
            "dense row holding the same keys")

    tab1 = tables[:1].contiguous()
    kc, vc = ca.gather_kv_pages(kp, tab1), ca.gather_kv_pages(vp, tab1)
    for start_host in (1024, 1000):
        q = randn((1, 512, H, D))
        name = f"[1,512,{H},{D}] start {start_host} chunk 476"
        got = _extend_pair(torch, name, q, kp, vp, tab1, [start_host], [476])
        same_as_dense(name, got, q, kc, vc, [start_host], [476])
    q = randn((1, 64, H, D))
    _extend_pair(torch, f"[1,64,{H},{D}] start 100 chunk 60 (crosses the "
                 "page edge at 128 inside query tile 1)", q, kp, vp, tab1,
                 [100], [60])
    # 3 rows: row 1's query tiles 1..3 and row 2's tile 3 are all padding
    starts, chunks = [1000, 0, 517], [64, 10, 33]
    q = randn((3, 64, H, D))
    tab3 = tables[:3].contiguous()
    got = _extend_pair(torch, f"[3,64,{H},{D}] starts {starts} chunk_lens "
                       f"{chunks}", q, kp, vp, tab3, starts, chunks)
    alone = ca.paged_flash_extend(
        q[:1].contiguous(), kp, vp, tab1,
        torch.tensor(starts[:1], dtype=torch.int32, device="cuda"),
        torch.tensor(chunks[:1], dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    if not torch.equal(alone[0], got[0]):
        raise AssertionError("paged_flash_extend: row 0 alone differs from "
                             "its row in the batch of 3")
    log("  paged_flash_extend bf16: row 0 alone == its row in the batch of "
        "3, bit for bit")
    # pages of 16..128 holding slot 0's first 1536 keys, shuffled tables
    rows_k, rows_v = kc[:, :1536].contiguous(), vc[:, :1536].contiguous()
    q = randn((1, 256, H, D))
    for ps in (16, 32, 64, 128):
        pk, pv, tab = _repage(torch, gen, rows_k, rows_v, ps)
        name = f"[1,256,{H},{D}] pages of {ps} start 1000 chunk 200"
        got = _extend_pair(torch, name, q, pk, pv, tab, [1000], [200])
        same_as_dense(name, got, q, rows_k, rows_v, [1000], [200])
    del kc, vc, rows_k, rows_v
    # head_dim 64 (Qwen2.5-0.5B G = 7, TinyLlama G = 8)
    for tag, h, kv, ps in (("G=7", 14, 2, 16), ("G=8", 32, 4, 128)):
        rows_k, rows_v = randn((2, 1024, kv, 64)), randn((2, 1024, kv, 64))
        pk, pv, tab = _repage(torch, gen, rows_k, rows_v, ps)
        q = randn((2, 256, h, 64))
        name = (f"[2,256,{h},64] kv {kv} ({tag}) pages of {ps} starts "
                "[777, 37] chunks [200, 50]")
        got = _extend_pair(torch, name, q, pk, pv, tab, [777, 37], [200, 50])
        same_as_dense(name, got, q, rows_k, rows_v, [777, 37], [200, 50])


def _dense_kernels(torch, gen, lens_host, start_host, chunk_host) -> list[dict]:
    """flash_decode and flash_extend over the dense slot cache at the
    serving shapes (8 slots of 4096 cells; one 476-token chunk at 1024),
    bf16 and fp32 against their plain versions, the mutants the bf16 limit
    must reject (the last 64-key tile left out; the next slot's row read),
    fp32 at debug-tiny's head_dim with a window below S, timings."""
    from llmlb_tpu_torch.ops import cuda_attention as ca

    bf16, f32 = torch.bfloat16, torch.float32
    out = []

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # -- flash_decode: 8 slots, contexts 4096..1, the full sweep -------------
    kc, vc = randn((SLOTS, CAPACITY, KV, D), bf16), \
        randn((SLOTS, CAPACITY, KV, D), bf16)
    lens = torch.tensor(lens_host, dtype=torch.int32, device="cuda")
    q = randn((SLOTS, H, D), bf16)
    got = ca.flash_decode(q, kc, vc, lens, window=CAPACITY)
    want = ca.flash_decode_reference(q, kc, vc, lens, window=CAPACITY)
    torch.cuda.synchronize()
    err = _check("flash_decode bf16 [8,32,128] cache [8,4096,8,128]", got,
                 want, rel=BF16_REL)
    cols = torch.arange(CAPACITY, device="cuda")
    mask = (cols[None, :] < lens[:, None])[:, None]
    if not torch.equal(_plain(torch, q[:, None], kc, vc, mask)[:, 0], want):
        raise AssertionError("flash_decode: the mutants' mask is not the "
                             "plain version's")
    _must_fail("flash_decode bf16, last 64-key tile of the 4096-token row "
               "left out",
               _plain(torch, q[:, None], kc, vc, mask,
                      (CAPACITY - 64, CAPACITY, [0]))[:, 0], want,
               rel=BF16_REL)
    _must_fail("flash_decode bf16, the next slot's row read",
               _plain(torch, q[:, None], kc.roll(-1, 0), vc.roll(-1, 0),
                      mask)[:, 0], want, rel=BF16_REL)
    sk = ca.DECODE_SPLIT_KEYS
    _must_fail(f"flash_decode bf16, keys [{sk}, {2 * sk}) of the 4096-token "
               "row left out (a lost partial)",
               _plain(torch, q[:, None], kc, vc, mask,
                      (sk, 2 * sk, [0]))[:, 0], want, rel=BF16_REL)
    edge_host = _edge_lens(ca)
    edge = torch.tensor(edge_host, dtype=torch.int32, device="cuda")
    _check(f"flash_decode bf16 kv_lens {edge_host} (split edges)",
           ca.flash_decode(q, kc, vc, edge, window=CAPACITY),
           ca.flash_decode_reference(q, kc, vc, edge, window=CAPACITY),
           rel=BF16_REL)
    _bitwise(torch, "flash_decode bf16", lambda rows, sweep: ca.flash_decode(
        q[rows].contiguous(), kc[rows].contiguous(), vc[rows].contiguous(),
        edge[rows].contiguous(), window=sweep), edge_host)
    cells = sum(lens_host)
    nbytes = cells * KV * D * 2 * 2 + 2 * q.numel() * 2 + SLOTS * 4
    bms, by = bound_ms(nbytes, 4 * H * D * cells, PEAK_BF16_FLOPS)
    out.append(dict(
        name="flash_decode", route="cuda",
        source="llmlb_tpu_torch/csrc/flash_decode.cu",
        replaces="llmlb_tpu/ops/pallas_attention.py:128",
        max_abs_err=err,
        ms=cuda_ms(lambda: ca.flash_decode(q, kc, vc, lens,
                                           window=CAPACITY), 50),
        ms_cold=cuda_ms_cold(lambda: ca.flash_decode(q, kc, vc, lens,
                                                     window=CAPACITY), 20),
        dev_ms=profiled_ms(lambda: ca.flash_decode(q, kc, vc, lens,
                                                   window=CAPACITY), 20,
                           DENSE_DECODE_MARKS),
        plain_ms=cuda_ms(lambda: ca.flash_decode_reference(
            q, kc, vc, lens, window=CAPACITY), 5),
        bound_ms=bms, bound_by=by,
        **dict(zip(("library_ms", "library_ms_cold"),
                   _sdpa_ms(torch, q[:, None], kc, vc, mask)))))
    serve = torch.tensor(SERVE_LENS, dtype=torch.int32, device="cuda")
    _check(f"flash_decode bf16 kv_lens {SERVE_LENS} window {SERVE_WINDOW}",
           ca.flash_decode(q, kc, vc, serve, window=SERVE_WINDOW),
           ca.flash_decode_reference(q, kc, vc, serve, window=SERVE_WINDOW),
           rel=BF16_REL)
    _serve_times(torch, "flash_decode", lambda: ca.flash_decode(
        q, kc, vc, serve, window=SERVE_WINDOW), out[-1], DENSE_DECODE_MARKS)
    qf = randn((SLOTS, H, D), f32)
    kf, vf = kc.float(), vc.float()
    _check("flash_decode fp32 [8,32,128] cache [8,4096,8,128]",
           ca.flash_decode(qf, kf, vf, lens, window=CAPACITY),
           ca.flash_decode_reference(qf, kf, vf, lens, window=CAPACITY),
           atol=FP32_ATOL)
    _check(f"flash_decode fp32 kv_lens {edge_host} (split edges)",
           ca.flash_decode(qf, kf, vf, edge, window=CAPACITY),
           ca.flash_decode_reference(qf, kf, vf, edge, window=CAPACITY),
           atol=FP32_ATOL)
    del kf, vf, qf

    # -- flash_extend: the 476-token chunk at 1024 of slot 0's row -----------
    t = 512
    q = randn((1, t, H, D), bf16)
    rows_k, rows_v = kc[:1].contiguous(), vc[:1].contiguous()
    start = torch.tensor([start_host], dtype=torch.int32, device="cuda")
    chunk = torch.tensor([chunk_host], dtype=torch.int32, device="cuda")
    got = ca.flash_extend(q, rows_k, rows_v, start, chunk)
    want = ca.flash_extend_reference(q, rows_k, rows_v, start, chunk)
    torch.cuda.synchronize()
    err = _check("flash_extend bf16 [1,512,32,128] rows [1,4096,8,128] "
                 "start 1024", got, want, rel=BF16_REL, rows=[chunk_host])
    keys = start_host + chunk_host
    q_pos = start_host + torch.arange(t, device="cuda")
    mask = cols[None, None, :] <= q_pos[None, :, None]
    if not torch.equal(_plain(torch, q, rows_k, rows_v, mask), want):
        raise AssertionError("flash_extend: the mutants' mask is not the "
                             "plain version's")
    last = (keys - 1) // 64 * 64
    _must_fail(f"flash_extend bf16, last 64-key tile [{last}, {keys}) left out",
               _plain(torch, q, rows_k, rows_v, mask, (last, keys, [0])), want,
               rel=BF16_REL, rows=[chunk_host])
    _must_fail("flash_extend bf16, the next slot's row read",
               _plain(torch, q, kc[1:2], vc[1:2], mask), want, rel=BF16_REL,
               rows=[chunk_host])
    _tc_mutants(torch, "flash_extend", q, rows_k, rows_v,
                cols[None, None, :] <= q_pos[None, :, None] + 1, want,
                [chunk_host])
    visible = sum(start_host + i + 1 for i in range(chunk_host))
    nbytes = keys * KV * D * 2 * 2 + 2 * chunk_host * H * D * 2 + 8
    bms, by = bound_ms(nbytes, 4 * H * D * visible, PEAK_BF16_FLOPS)
    out.append(dict(
        name="flash_extend", route="cuda",
        source="llmlb_tpu_torch/csrc/flash_extend.cu",
        replaces="llmlb_tpu/ops/pallas_attention.py:642",
        max_abs_err=err,
        ms=cuda_ms(lambda: ca.flash_extend(q, rows_k, rows_v, start, chunk),
                   20),
        ms_cold=cuda_ms_cold(lambda: ca.flash_extend(q, rows_k, rows_v, start,
                                                     chunk), 20),
        plain_ms=cuda_ms(lambda: ca.flash_extend_reference(
            q, rows_k, rows_v, start, chunk), 3),
        bound_ms=bms, bound_by=by,
        **dict(zip(("library_ms", "library_ms_cold"),
                   _sdpa_ms(torch, q, rows_k, rows_v, mask)))))
    # the same chunk starting inside a key tile (1000 = 15 * 64 + 40)
    st = torch.tensor([1000], dtype=torch.int32, device="cuda")
    _check("flash_extend bf16 [1,512,32,128] rows [1,4096,8,128] start 1000",
           ca.flash_extend(q, rows_k, rows_v, st, chunk),
           ca.flash_extend_reference(q, rows_k, rows_v, st, chunk),
           rel=BF16_REL, rows=[chunk_host])
    qf = randn((1, t, H, D), f32)
    kf, vf = rows_k.float(), rows_v.float()
    _check("flash_extend fp32 [1,512,32,128] rows [1,4096,8,128] start 1024",
           ca.flash_extend(qf, kf, vf, start, chunk),
           ca.flash_extend_reference(qf, kf, vf, start, chunk),
           atol=FP32_ATOL, rows=[chunk_host])
    del kc, vc, rows_k, rows_v, kf, vf, q, qf

    # -- fp32 at debug-tiny's head_dim 16, G=2, a window below S -------------
    kc, vc = randn((3, 320, 4, 16), f32), randn((3, 320, 4, 16), f32)
    q = randn((3, 8, 16), f32)
    kl = torch.tensor([1, 137, 256], dtype=torch.int32, device="cuda")
    _check("flash_decode fp32 [3,8,16] cache [3,320,4,16] window 256",
           ca.flash_decode(q, kc, vc, kl, window=256),
           ca.flash_decode_reference(q, kc, vc, kl, window=256),
           atol=FP32_ATOL)
    q = randn((3, 16, 8, 16), f32)
    st = torch.tensor([0, 13, 300], dtype=torch.int32, device="cuda")
    ch = torch.tensor([16, 9, 3], dtype=torch.int32, device="cuda")
    _check("flash_extend fp32 [3,16,8,16] rows [3,320,4,16]",
           ca.flash_extend(q, kc, vc, st, ch),
           ca.flash_extend_reference(q, kc, vc, st, ch), atol=FP32_ATOL,
           rows=[16, 9, 3])
    return out


def _lora_kernel(torch, gen) -> list[dict]:
    """lora_delta at Llama-3-8B's four projection shapes, 9 pool rows (8
    adapters and the identity) at rank 16, decode (8, 1) and prefill (8, 128)
    rows, and (8, 512) timed: mode (a), the fp32 delta, against the plain
    version; mode (b), the delta added into a projection output y in place,
    bit for bit against y + mode (a) rounded (and within the bf16 limit of
    y + the plain delta rounded); the mutants the limit must reject (the
    next adapter's rows, the last rank column, one cluster rank's partial
    left out); an all-identity batch (+0.0 in mode a, y + 0.0 in mode b);
    fp32 at the same and at debug-tiny widths; timings of both modes."""
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.lora import lora_target_dims
    from llmlb_tpu_torch.ops import lora

    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_preset("llama-3-8b")
    rank, n_rows = 16, 9
    idx_host = [0, 3, 1, 0, 8, 2, 2, 5]
    idx = torch.tensor(idx_host, dtype=torch.int32, device="cuda")
    marks = ("bgmv_cluster_kernel",)

    def pools(in_dim, out_dim, dtype, rank=rank, n_rows=n_rows):
        a = torch.randn((n_rows, in_dim, rank), generator=gen,
                        device="cuda") * in_dim**-0.5
        b = torch.randn((n_rows, rank, out_dim), generator=gen,
                        device="cuda") * rank**-0.5
        a[0] = 0.0  # the identity adapter
        b[0] = 0.0
        return a.to(dtype).contiguous(), b.to(dtype).contiguous()

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def both_modes(tag, x, a, b, ix, y, rel):
        """Mode (a) against the plain version, mode (b) bit for bit against
        y + mode (a) rounded; returns (mode a's max error, the delta)."""
        got = lora.lora_delta(x, a, b, ix)
        want = lora.lora_delta_reference(x, a, b, ix)
        fused = lora.lora_delta_add(y.clone(), x, a, b, ix)
        torch.cuda.synchronize()
        if got.dtype != torch.float32:
            raise AssertionError(f"{tag}: output is {got.dtype}")
        err = _check(f"{tag} mode (a)", got, want, rel=rel)
        if not torch.equal(fused, y + got.to(y.dtype)):
            raise AssertionError(f"{tag}: mode (b) is not y + delta.to(dtype) "
                                 "bit for bit")
        plain = y + want.to(y.dtype)
        differ = int((fused != plain).sum())
        _check(f"{tag} mode (b) against y + plain delta ({differ} of "
               f"{plain.numel()} elements differ from it by a rounding)",
               fused, plain, rel=BF16_REL if y.dtype == bf16 else rel)
        log(f"  {tag} mode (b): bit for bit y + mode (a).to({y.dtype})")
        return err, got

    row = None
    dims = lora_target_dims(cfg, ("wq", "wk", "wg", "wd"))
    for tgt, (in_dim, out_dim) in dims.items():
        a, b = pools(in_dim, out_dim, bf16)
        for t in (1, 128, 512):
            x = randn((SLOTS, t, in_dim), bf16)
            y = randn((SLOTS, t, out_dim), bf16)
            tag = f"lora_delta bf16 {tgt} x [8,{t},{in_dim}] -> {out_dim}"
            err, got = both_modes(tag, x, a, b, idx, y, LORA_REL)
            want = lora.lora_delta_reference(x, a, b, idx)
            if tgt == "wg" and t in (1, 128):
                plan = lora.lora_plan(t, in_dim, out_dim)
                lo, hi = plan["in"][3]
                x_cut = x.clone()
                x_cut[..., lo:hi] = 0
                _must_fail(f"{tag}, cluster rank 3's partial (IN [{lo}, {hi})"
                           f" of {plan['cluster']} slices) left out",
                           lora.lora_delta_reference(x_cut, a, b, idx), want,
                           rel=LORA_REL)
                _must_fail(f"{tag}, row i reading adapter idx_i + 1",
                           lora.lora_delta_reference(x, a, b, (idx + 1) % n_rows),
                           want, rel=LORA_REL)
                a_cut = a.clone()
                a_cut[..., -1] = 0
                _must_fail(f"{tag}, the last rank column dropped",
                           lora.lora_delta_reference(x, a_cut, b, idx), want,
                           rel=LORA_REL)
                zeros = torch.zeros_like(idx)
                zero = lora.lora_delta(x, a, b, zeros)
                if not (torch.equal(zero, torch.zeros_like(zero))
                        and not torch.signbit(zero).any()):
                    raise AssertionError("lora_delta: the identity row's delta "
                                         "is not exactly +0.0")
                y0 = y.clone()
                y0[..., :4] = -0.0
                if not torch.equal(lora.lora_delta_add(y0.clone(), x, a, b,
                                                       zeros), y0 + 0.0):
                    raise AssertionError("lora_delta_add: the identity rows "
                                         "are not y + 0.0")
                log(f"  {tag}, idx all 0: delta exactly +0.0, mode (b) y + 0.0")
            ms_a = cuda_ms(lambda: lora.lora_delta(x, a, b, idx), 50)
            ms_b = cuda_ms(lambda: lora.lora_delta_add(y, x, a, b, idx), 50)
            # back to back, a call this short is bound by the host's launch
            # path; the profiler gives the kernel's own time
            dev_a = profiled_ms(lambda: lora.lora_delta(x, a, b, idx), 20,
                                marks)
            dev_b = profiled_ms(lambda: lora.lora_delta_add(y, x, a, b, idx),
                                20, marks)
            log(f"  {tag}: mode (a) {ms_a:.4f} ms warm, device {dev_a:.4f} ms; "
                f"mode (b) {ms_b:.4f} ms warm, device {dev_b:.4f} ms")
            if t == 1 and tgt == "wg":
                # the main path's call: mode (b). Its least work: x once, the
                # 7 distinct rows the batch selects once, y read and written
                # once; two products per (row, position)
                distinct = len(set(idx_host))
                nbytes = (x.numel() * 2 + distinct * rank * (in_dim + out_dim)
                          * 2 + 2 * y.numel() * 2 + SLOTS * 4)
                bms, by = bound_ms(nbytes, 2 * SLOTS * t * rank
                                   * (in_dim + out_dim), PEAK_BF16_FLOPS)
                nbytes_a = nbytes - 2 * y.numel() * 2 + SLOTS * t * out_dim * 4
                row = dict(
                    name="lora_delta", route="cuda",
                    source="llmlb_tpu_torch/csrc/lora_bgmv.cu",
                    replaces="llmlb_tpu/ops/lora.py:87", max_abs_err=err,
                    ms=ms_b, dev_ms=dev_b,
                    ms_cold=cuda_ms_cold(
                        lambda: lora.lora_delta_add(y, x, a, b, idx), 20),
                    mode_a_ms=ms_a, mode_a_dev_ms=dev_a,
                    mode_a_bound_ms=bound_ms(nbytes_a, 0, PEAK_BF16_FLOPS)[0],
                    plain_ms=cuda_ms(lambda: y + lora.lora_delta_reference(
                        x, a, b, idx).to(bf16), 5),
                    bound_ms=bms, bound_by=by, library_ms=None)
                log(f"  lora_delta at the decode shape (wg, mode b): bound "
                    f"{bms:.5f} ms ({by}); mode (a) bound "
                    f"{row['mode_a_bound_ms']:.5f} ms")
            del x, y, got, want
        af, bf = a.float(), b.float()
        xf = randn((SLOTS, 1, in_dim), f32)
        both_modes(f"lora_delta fp32 {tgt} x [8,1,{in_dim}] -> {out_dim}",
                   xf, af, bf, idx, randn((SLOTS, 1, out_dim), f32), LORA_REL)
        del a, b, af, bf, xf
    # fp32 at debug-tiny's widths (hidden 128, KV 64, ffn 256), rank 8
    tiny = get_preset("debug-tiny")
    for tgt, (in_dim, out_dim) in lora_target_dims(
            tiny, ("wq", "wk", "wg", "wd")).items():
        a, b = pools(in_dim, out_dim, f32, rank=8, n_rows=3)
        x = randn((5, 7, in_dim), f32)
        ix = torch.tensor([0, 1, 2, 1, 0], dtype=torch.int32, device="cuda")
        both_modes(f"lora_delta fp32 debug-tiny {tgt} x [5,7,{in_dim}] -> "
                   f"{out_dim}", x, a, b, ix, randn((5, 7, out_dim), f32),
                   LORA_REL)
    return [row]


def _dequant(codes, scales, tables, dtype, scale_tables=None):
    """The plain versions' dequantized rows [B, N*PS, K, D]: codes gathered
    through `tables`, scales through `scale_tables` (default the same)."""
    from llmlb_tpu_torch.quant import dequantize_kv

    idx = tables.long()
    sidx = idx if scale_tables is None else scale_tables.long()
    b, n = idx.shape
    _, ps, kv, d = codes.shape
    return dequantize_kv(codes[idx].reshape(b, n * ps, kv, d),
                         scales[sidx].reshape(b, n * ps, kv), dtype)


def _quant_kernels(torch, gen, kp, vp, tables, lens_host, tab1, start_host,
                   chunk_host) -> list[dict]:
    """paged_flash_decode_quant and paged_flash_extend_quant at the shapes of
    the bf16 checks above, on those pools quantized: bf16 and fp32 against
    the plain versions, four mutants the bf16 limit must reject, timings."""
    from llmlb_tpu_torch.ops import cuda_attention as ca
    from llmlb_tpu_torch.quant import quantize_kv

    bf16, f32 = torch.bfloat16, torch.float32
    (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
    ppn = tables.shape[1]
    lens = torch.tensor(lens_host, dtype=torch.int32, device="cuda")
    cols = torch.arange(ppn * PAGE, device="cuda")
    out = []

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def mutants(q, mask, tab, decode):
        """(name, plain version with the fault) for faults a kernel reading
        int8 pages could have."""
        kc, vc = (_dequant(kq, ks, tab, q.dtype), _dequant(vq, vs, tab, q.dtype))
        yield "page 5 of row 0 left out", _plain(torch, q, kc, vc, mask,
                                                   (5 * PAGE, 6 * PAGE, [0]))
        if decode:  # the 4096-token row's last key tile, a lost partial
            yield "last 64-key tile of row 0 left out", _plain(
                torch, q, kc, vc, mask, (4096 - 64, 4096, [0]))
            sk = ca.DECODE_SPLIT_KEYS
            yield (f"keys [{sk}, {2 * sk}) of row 0 left out (a lost "
                   "partial)", _plain(torch, q, kc, vc, mask,
                                      (sk, 2 * sk, [0])))
        # an off-by-one in the scale index: K scales of the next page
        wrong = _dequant(kq, ks, tab, q.dtype, torch.roll(tab, -1, dims=1))
        yield "K scales read from the next page", _plain(torch, q, wrong, vc,
                                                         mask)
        yield "K's scales used for V", _plain(
            torch, q, kc, _dequant(vq, ks, tab, q.dtype), mask)

    # -- decode: 8 rows, contexts 4096..1 -------------------------------------
    q = randn((SLOTS, H, D), bf16)
    got = ca.paged_flash_decode_quant(q, kq, ks, vq, vs, tables, lens, pages=ppn)
    want = ca.paged_flash_decode_quant_reference(q, kq, ks, vq, vs, tables,
                                                 lens, pages=ppn)
    torch.cuda.synchronize()
    err = _check("paged_flash_decode_quant bf16 [8,32,128] ctx<=4096", got,
                 want, rel=BF16_REL)
    mask = (cols[None, :] < lens[:, None])[:, None]
    kc, vc = _dequant(kq, ks, tables, bf16), _dequant(vq, vs, tables, bf16)
    if not torch.equal(_plain(torch, q[:, None], kc, vc, mask)[:, 0], want):
        raise AssertionError("paged_flash_decode_quant: the mutants' plain "
                             "version is not the plain version")
    del kc, vc
    for what, mutant in mutants(q[:, None], mask, tables, True):
        _must_fail(f"paged_flash_decode_quant bf16, {what}", mutant[:, 0],
                   want, rel=BF16_REL)
    kv_cells = sum(lens_host)
    table_reads = sum(-(-n // PAGE) for n in lens_host)
    # codes and a float32 scale per (position, KV head), for K and V
    nbytes = (kv_cells * KV * (D + 4) * 2 + 2 * q.numel() * 2
              + table_reads * 4 + SLOTS * 4)
    bms, by = bound_ms(nbytes, 4 * H * D * kv_cells, PEAK_BF16_FLOPS)
    out.append(dict(
        name="paged_flash_decode_quant", route="cuda",
        source="llmlb_tpu_torch/csrc/paged_decode_quant.cu",
        replaces="llmlb_tpu/ops/pallas_attention.py:346",
        max_abs_err=err,
        ms=cuda_ms(lambda: ca.paged_flash_decode_quant(
            q, kq, ks, vq, vs, tables, lens, pages=ppn), 50),
        ms_cold=cuda_ms_cold(lambda: ca.paged_flash_decode_quant(
            q, kq, ks, vq, vs, tables, lens, pages=ppn), 20),
        dev_ms=profiled_ms(lambda: ca.paged_flash_decode_quant(
            q, kq, ks, vq, vs, tables, lens, pages=ppn), 20,
            QUANT_DECODE_MARKS),
        plain_ms=cuda_ms(lambda: ca.paged_flash_decode_quant_reference(
            q, kq, ks, vq, vs, tables, lens, pages=ppn), 5),
        bound_ms=bms, bound_by=by, library_ms=None))
    edge_host = _edge_lens(ca)
    edge = torch.tensor(edge_host, dtype=torch.int32, device="cuda")
    _check(f"paged_flash_decode_quant bf16 kv_lens {edge_host} (split edges)",
           ca.paged_flash_decode_quant(q, kq, ks, vq, vs, tables, edge,
                                       pages=ppn),
           ca.paged_flash_decode_quant_reference(q, kq, ks, vq, vs, tables,
                                                 edge, pages=ppn),
           rel=BF16_REL)
    _bitwise(torch, "paged_flash_decode_quant bf16",
             lambda rows, sweep: ca.paged_flash_decode_quant(
                 q[rows].contiguous(), kq, ks, vq, vs,
                 tables[rows].contiguous(), edge[rows].contiguous(),
                 pages=sweep // PAGE), edge_host)
    serve = torch.tensor(SERVE_LENS, dtype=torch.int32, device="cuda")
    serve_pages = SERVE_WINDOW // PAGE
    _check(f"paged_flash_decode_quant bf16 kv_lens {SERVE_LENS} pages "
           f"{serve_pages}",
           ca.paged_flash_decode_quant(q, kq, ks, vq, vs, tables, serve,
                                       pages=serve_pages),
           ca.paged_flash_decode_quant_reference(q, kq, ks, vq, vs, tables,
                                                 serve, pages=serve_pages),
           rel=BF16_REL)
    _serve_times(torch, "paged_flash_decode_quant",
                 lambda: ca.paged_flash_decode_quant(
                     q, kq, ks, vq, vs, tables, serve, pages=serve_pages),
                 out[-1], QUANT_DECODE_MARKS)
    qf = randn((SLOTS, H, D), f32)
    _check("paged_flash_decode_quant fp32 [8,32,128] ctx<=4096",
           ca.paged_flash_decode_quant(qf, kq, ks, vq, vs, tables, lens,
                                       pages=ppn),
           ca.paged_flash_decode_quant_reference(qf, kq, ks, vq, vs, tables,
                                                 lens, pages=ppn),
           atol=FP32_ATOL)
    _check(f"paged_flash_decode_quant fp32 kv_lens {edge_host} (split edges)",
           ca.paged_flash_decode_quant(qf, kq, ks, vq, vs, tables, edge,
                                       pages=ppn),
           ca.paged_flash_decode_quant_reference(qf, kq, ks, vq, vs, tables,
                                                 edge, pages=ppn),
           atol=FP32_ATOL)

    # -- extend: one 476-token chunk at position 1024 ------------------------
    t = 512
    q = randn((1, t, H, D), bf16)
    start = torch.tensor([start_host], dtype=torch.int32, device="cuda")
    chunk = torch.tensor([chunk_host], dtype=torch.int32, device="cuda")
    got = ca.paged_flash_extend_quant(q, kq, ks, vq, vs, tab1, start, chunk)
    want = ca.paged_flash_extend_quant_reference(q, kq, ks, vq, vs, tab1,
                                                 start, chunk)
    torch.cuda.synchronize()
    err = _check("paged_flash_extend_quant bf16 [1,512,32,128] start 1024",
                 got, want, rel=BF16_REL, rows=[chunk_host])
    q_pos = start_host + torch.arange(t, device="cuda")
    mask = cols[None, None, :] <= q_pos[None, :, None]
    for what, mutant in mutants(q, mask, tab1, False):
        _must_fail(f"paged_flash_extend_quant bf16, {what}", mutant, want,
                   rel=BF16_REL, rows=[chunk_host])
    kc, vc = _dequant(kq, ks, tab1, bf16), _dequant(vq, vs, tab1, bf16)
    for what, (kt, vt) in _tile_mutants(kc, vc):
        _must_fail(f"paged_flash_extend_quant bf16, {what}",
                   _plain(torch, q, kt, vt, mask), want, rel=BF16_REL,
                   rows=[chunk_host])
    del kc, vc
    keys = start_host + chunk_host
    visible = sum(start_host + i + 1 for i in range(chunk_host))
    nbytes = (keys * KV * (D + 4) * 2 + 2 * chunk_host * H * D * 2
              + -(-keys // PAGE) * 4 + 8)
    bms, by = bound_ms(nbytes, 4 * H * D * visible, PEAK_BF16_FLOPS)
    out.append(dict(
        name="paged_flash_extend_quant", route="cuda",
        source="llmlb_tpu_torch/csrc/paged_extend_quant.cu",
        replaces="llmlb_tpu/ops/pallas_attention.py:885",
        max_abs_err=err,
        ms=cuda_ms(lambda: ca.paged_flash_extend_quant(
            q, kq, ks, vq, vs, tab1, start, chunk), 20),
        ms_cold=cuda_ms_cold(lambda: ca.paged_flash_extend_quant(
            q, kq, ks, vq, vs, tab1, start, chunk), 20),
        dev_ms=profiled_ms(lambda: ca.paged_flash_extend_quant(
            q, kq, ks, vq, vs, tab1, start, chunk), 20, QUANT_EXTEND_MARKS),
        plain_ms=cuda_ms(lambda: ca.paged_flash_extend_quant_reference(
            q, kq, ks, vq, vs, tab1, start, chunk), 3),
        bound_ms=bms, bound_by=by, library_ms=None))
    qf = randn((1, t, H, D), f32)
    _check("paged_flash_extend_quant fp32 [1,512,32,128] start 1024",
           ca.paged_flash_extend_quant(qf, kq, ks, vq, vs, tab1, start, chunk),
           ca.paged_flash_extend_quant_reference(qf, kq, ks, vq, vs, tab1,
                                                 start, chunk),
           atol=FP32_ATOL, rows=[chunk_host])
    return out


def phase_unembed() -> None:
    """The Llama-3-8B vocab projection on the card, untied and tied (the
    head a transposed view): bf16 operands, fp32 logits held against the
    fp32 product of the same bf16 values, and the same argmax per row."""
    import dataclasses

    import torch

    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.models import llama
    from llmlb_tpu_torch.ops.norms import rms_norm

    cfg = get_preset("llama-3-8b")
    e, vocab = cfg.hidden_size, cfg.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((SLOTS, e), generator=gen, device="cuda").to(cfg.dtype)
    head = (torch.randn((e, vocab), generator=gen, device="cuda")
            * e**-0.5).to(cfg.dtype)
    ln = torch.ones(e, dtype=cfg.dtype, device="cuda")
    want = rms_norm(x, ln, cfg.rms_eps).float() @ head.float()
    rounded = (want.to(cfg.dtype).float() - want).abs().max().item()
    for name, c, params in (
            ("untied", cfg, {"ln_final": ln, "lm_head": head}),
            ("tied", dataclasses.replace(cfg, tie_word_embeddings=True),
             {"ln_final": ln, "embed": head.T.contiguous()})):
        got = llama._unembed(c, params, x)
        err = (got - want).abs().max().item()
        same = bool((got.argmax(-1) == want.argmax(-1)).all())
        log(f"  unembed llama-3-8b {name} [8,4096]x[4096,128256] "
            f"{got.dtype}: max_abs_err {err:.3e} (atol {UNEMBED_ATOL:g}; "
            f"logits rounded to bf16 would be off by {rounded:.3e}); "
            f"argmax {'equal' if same else 'DIFFERS'}")
        if got.dtype != torch.float32 or not err <= UNEMBED_ATOL or not same:
            raise AssertionError(f"unembed {name}: fp32 logits disagree")
        del got, params
    del x, head, want


def phase_model_entry_points() -> None:
    """The serving entry points at debug size: card (kernels) against CPU
    (plain path), fp32 logits within FP32_ATOL * 10 (two layers). The three
    paged ones with model-dtype pools and weights, with int8 pools and
    weights, with an adapter pool and mixed `lora_idx`, and with int8
    weights and adapters; the three dense-slot ones, with and without
    adapters."""
    import tempfile

    import torch

    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.lora import LoraManager, save_adapter
    from llmlb_tpu_torch.models import llama
    from llmlb_tpu_torch.quant import quantize_params

    cfg = get_preset("debug-tiny")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tables = torch.tensor([[3, 7, 1, 10], [5, 2, 9, 11]], dtype=torch.int32)
    rng = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 512, (2, 32), generator=rng)
    lens = torch.tensor([5, 21], dtype=torch.int32)
    chunk = torch.randint(0, 512, (2, 16), generator=rng)
    chunk_lens = torch.tensor([16, 3], dtype=torch.int32)
    toks = torch.randint(0, 512, (2,), generator=rng)
    slots = torch.tensor([2, 0], dtype=torch.int64)

    # an adapter pool with two adapters in rows 1 and 2 (row 0 identity)
    with tempfile.TemporaryDirectory() as lora_dir:
        save_adapter(lora_dir, "acme", cfg, rank=4)
        save_adapter(lora_dir, "beta", cfg, rank=8,
                     targets=("wq", "wk", "wv", "wo", "wg", "wu", "wd"))
        mgr = LoraManager(cfg, lora_dir=lora_dir, max_adapters=2, rank_cap=8)
        pool = mgr.init_pool_leaves(cfg.dtype, "cpu")
        mgr.attach(pool)
        for i, name in enumerate(("acme", "beta")):
            mgr.acquire(name, f"r{i}")
    lora_idx = torch.tensor([2, 1], dtype=torch.int32)

    def paged(dev, p, quantized, lidx):
        tb = tables.to(dev)
        li = None if lidx is None else lidx.to(dev)
        ck, cv = llama.init_kv_pages(cfg, 12, 16, dev, quantized=quantized)
        out = [llama.prefill_into_pages(p, cfg, ids.to(dev), lens.to(dev), tb,
                                        ck, cv, lora_idx=li)[0]]
        out.append(llama.prefill_extend_pages(
            p, cfg, chunk.to(dev), chunk_lens.to(dev), lens.to(dev), tb,
            ck, cv, lora_idx=li)[0])
        seq = (lens + chunk_lens).to(dev)
        for _ in range(2):
            out.append(llama.decode_step_paged(p, cfg, toks.to(dev), seq, ck,
                                               cv, tb, window=64,
                                               lora_idx=li)[0])
            seq = seq + 1
        return [o.cpu() for o in out]

    def dense(dev, p, _quantized, lidx):
        # 3 slots of 320 cells: the prompts land in slots 2 and 0; decode
        # runs over all 3 rows (row 1 idle) with a 256-cell window
        li = None if lidx is None else lidx.to(dev)
        ck, cv = llama.init_kv_cache(cfg, 3, 320, dev)
        out = [llama.prefill_into_slots(p, cfg, ids.to(dev), lens.to(dev),
                                        slots.to(dev), ck, cv,
                                        lora_idx=li)[0]]
        out.append(llama.prefill_extend_slots(
            p, cfg, chunk.to(dev), chunk_lens.to(dev), lens.to(dev),
            slots.to(dev), ck, cv, lora_idx=li)[0])
        seq = torch.zeros(3, dtype=torch.int32)
        seq[slots] = lens + chunk_lens
        rows_li = None
        if li is not None:
            rows_li = torch.zeros(3, dtype=torch.int32)
            rows_li[slots] = lidx
            rows_li = rows_li.to(dev)
        last = torch.zeros(3, dtype=torch.int64)
        last[slots] = toks
        seq = seq.to(dev)
        for _ in range(2):
            logits = llama.decode_step(p, cfg, last.to(dev), seq, ck, cv,
                                       window=256, lora_idx=rows_li)[0]
            out.append(logits[slots.to(dev)])
            seq = seq + 1
        return [o.cpu() for o in out]

    cases = (("paged", paged, False, None, cfg.dtype),
             ("paged", paged, True, None, "int8 pools and weights"),
             ("paged", paged, False, lora_idx, "adapters, lora_idx [2, 1]"),
             ("paged", paged, "weights", lora_idx,
              "int8 weights + adapters"),
             ("dense", dense, False, None, cfg.dtype),
             ("dense", dense, False, lora_idx, "adapters, lora_idx [2, 1]"))
    for layout, fn, quantized, lidx, tag in cases:
        p = quantize_params(params) if quantized else params
        if lidx is not None:
            p = {**p, **pool}
        gp = {k: v.cuda() for k, v in p.items()}
        names = ((f"prefill_into_{'pages' if layout == 'paged' else 'slots'}",
                  f"prefill_extend_{'pages' if layout == 'paged' else 'slots'}")
                 + (("decode_step_paged#1", "decode_step_paged#2")
                    if layout == "paged" else ("decode_step#1",
                                               "decode_step#2")))
        pools_int8 = quantized is True
        for name, g, c in zip(names, fn("cuda", gp, pools_int8, lidx),
                              fn("cpu", p, pools_int8, lidx)):
            err = (g - c).abs().max().item()
            log(f"  model {name} debug-tiny ({tag}) fp32 logits card vs cpu: "
                f"max_abs_err {err:.3e}")
            if not (err <= FP32_ATOL * 10 and torch.isfinite(g).all()):
                raise AssertionError(f"{name}: card logits disagree with the "
                                     f"plain path (max_abs_err {err:.3e})")


def _post(url: str, body: dict, timeout: float = 600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _chat(base: str, content: str, max_tokens: int, stream: bool,
          model: str = "llama-3-8b", lora: str | None = None) -> dict:
    """One greedy chat request; returns {text, usage, finish, model} after
    checking the response shape."""
    body = {"model": model, "temperature": 0, "max_tokens": max_tokens,
            "stream": stream,
            "messages": [{"role": "user", "content": content}]}
    if lora is not None:
        body["lora"] = lora
    with _post(base + "/v1/chat/completions", body) as resp:
        if not stream:
            out = json.loads(resp.read())
            assert out["object"] == "chat.completion", out
            choice = out["choices"][0]
            return {"text": choice["message"]["content"], "usage": out["usage"],
                    "finish": choice["finish_reason"], "model": out["model"]}
        lines = [ln.decode().strip() for ln in resp if ln.strip()]
    assert lines[-1] == "data: [DONE]", lines[-3:]
    chunks = [json.loads(ln[len("data: "):]) for ln in lines[:-1]]
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    usage = chunks[-1]["usage"]
    finish = chunks[-2]["choices"][0]["finish_reason"]
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks[:-1] if c["choices"])
    return {"text": text, "usage": usage, "finish": finish,
            "model": chunks[0]["model"]}


def _timed_core_request(core, prompt: list[int], max_tokens: int,
                        lora: str | None = None, **sampling):
    """Submit straight to the serving core (greedy unless `sampling` says
    otherwise); returns (ids, ttft_s, decode tokens/s of this request)."""
    from llmlb_tpu_torch.engine.scheduler import Request, SamplingParams

    sampling.setdefault("temperature", 0.0)
    req = core.submit(Request(prompt_ids=list(prompt), sampling=SamplingParams(
        max_tokens=max_tokens, lora=lora, **sampling)))
    ids, stamps = [], []
    while True:
        kind, value = req.events.get(timeout=600)
        if kind == "token":
            ids.append(int(value))
            stamps.append(time.monotonic())
        elif kind == "done":
            break
        else:
            raise RuntimeError(f"engine error: {value}")
    ttft = stamps[0] - req.submitted_at
    rate = (len(ids) - 1) / (stamps[-1] - stamps[0]) if len(ids) > 1 else 0.0
    return ids, ttft, rate


def _concurrent(fns: list) -> list:
    """Run the zero-argument callables on threads at once; their results in
    order, or the first error raised."""
    results: dict[int, object] = {}
    errors: list[BaseException] = []

    def worker(i: int) -> None:
        try:
            results[i] = fns[i]()
        except BaseException as e:  # collected and re-raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(fns))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    if errors or len(results) != len(fns):
        raise RuntimeError(f"concurrent requests failed: {errors!r}")
    return [results[i] for i in range(len(fns))]


def _shared(a: list[int], b: list[int]) -> int:
    """Length of the common prefix of two token lists."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


# The kernels each serving path must launch, and those it must not.
BF16_PATH = ("flash_prefill", "paged_flash_decode", "paged_flash_extend")
INT8_PATH = ("flash_prefill", "paged_flash_decode_quant",
             "paged_flash_extend_quant")
LORA_PATH = BF16_PATH + ("lora_delta",)
DENSE_PATH = ("flash_prefill", "flash_decode", "flash_extend")
# Adapters of the LoRA phase: (name, rank, targets). Their factors are
# drawn at scale 0.03: the delta of a projection is then ~0.1-0.3 of the
# base output at Llama-3-8B's widths (0.25, the default, is sized for
# debug-tiny and would swamp the base model).
ADAPTERS = (("acme", 8, ("wq", "wk", "wv", "wo")),
            ("beta", 16, ("wq", "wk", "wv", "wo", "wg", "wu", "wd")))
ADAPTER_SCALE = 0.03
# greedy tokens of the long prompt's timed requests
LONG_TOKENS = 16


# Ops of the model whose row-0 outputs _first_difference compares, and the
# label each gets (the projections are labelled by their weight's name).
TRACED_OPS = {"rms_norm": "norm", "_proj": None, "apply_rope": "rope",
              "gqa_attention_prefill": "attention",
              "gqa_attention_decode": "attention",
              "paged_attention_decode": "attention", "_unembed": "unembed"}
# the prefill group sizes the batch_invariance phase holds row 0 across
GROUPS = (1, 2, 4, 8)


def _traced(run) -> list[tuple[str, object]]:
    """Run `run()` with the model's ops in TRACED_OPS wrapped to record
    (where, a copy of batch row 0 of the op's output), in call order.
    `where` names the entry-point call (counted by its unembed), the layer
    (counted by its two norms, ln_attn and ln_mlp) and the op."""
    from llmlb_tpu_torch.models import llama

    records = []
    state = {"call": 0, "norms": 0, "unembed": False}
    saved = {name: getattr(llama, name) for name in TRACED_OPS}

    def wrap(name, fn):
        def inner(*args, **kwargs):
            if name == "_unembed":
                state["unembed"] = True
            try:
                out = fn(*args, **kwargs)
            finally:
                state["unembed"] = False
            tag = args[1] if name == "_proj" else TRACED_OPS[name]
            if name == "rms_norm" and not state["unembed"]:
                state["norms"] += 1
                tag = ("ln_attn", "ln_mlp")[(state["norms"] - 1) % 2]
            elif name == "rms_norm":
                tag = "ln_final"
            where = (f"entry-point call {state['call']}, layer "
                     f"{(state['norms'] - 1) // 2}, {tag}")
            if name in ("_unembed", "rms_norm") and tag in ("unembed",
                                                             "ln_final"):
                where = f"entry-point call {state['call']}, {tag}"
            records.append((where, out[0].detach().clone()))
            if name == "_unembed":
                state["call"] += 1
                state["norms"] = 0
            return out
        return inner

    try:
        for name, fn in saved.items():
            setattr(llama, name, wrap(name, fn))
        run()
    finally:
        for name, fn in saved.items():
            setattr(llama, name, fn)
    return records


def _first_difference(run_a, run_b) -> str:
    """The first op (in call order) whose row-0 output differs bit for bit
    between two runs of the model's entry points, as _traced records them."""
    import torch

    a, b = _traced(run_a), _traced(run_b)
    for (wa, xa), (wb, xb) in zip(a, b):
        if wa != wb:
            return f"the runs call different ops: {wa} / {wb}"
        if xa.shape != xb.shape:
            return f"{wa}: shapes {tuple(xa.shape)} / {tuple(xb.shape)}"
        if not torch.equal(xa, xb):
            diff = (xa.float() - xb.float()).abs().max().item()
            return (f"{wa}: row 0 first differs here (max |diff| {diff:.3e}, "
                    f"{int((xa != xb).sum())} of {xa.numel()} elements)")
    if len(a) != len(b):
        return f"the runs call {len(a)} and {len(b)} traced ops"
    return "no traced op differs in row 0 (the difference is elsewhere)"


def phase_batch_invariance(core, prompts: list[list[int]], label: str,
                           lora_rows: list[int] | None) -> None:
    """C1: row 0's prefill logits do not depend on the group it is prefilled
    with. The serve phases' timed prompt (124 tokens, bucket 128) goes
    (prompts[0]) goes through the entry point `_prefill_group` calls
    (prefill_into_pages, or prefill_into_slots for the dense layout) alone
    and as row 0 of groups of 2, 4 and 8 whose other rows are other prompts
    of the same bucket (prompts[1:]);
    its last-position logits must be equal bit for bit. The KV lands in the
    trash page (paged) or the idle slots (dense): the engine is idle. With
    `lora_rows`, row i takes adapter pool row lora_rows[i]. On a difference
    the first op whose row 0 differs is reported."""
    import numpy as np
    import torch

    from llmlb_tpu_torch.models import llama

    bucket = 128
    ids_all = np.zeros((max(GROUPS), bucket), np.int64)
    lens_all = np.zeros((max(GROUPS),), np.int32)
    for i, p in enumerate(prompts[:max(GROUPS)]):
        if not 64 < len(p) <= bucket:
            raise AssertionError(f"prompt {i} has {len(p)} tokens, not in the "
                                 f"{bucket} bucket")
        ids_all[i, :len(p)] = p
        lens_all[i] = len(p)

    def run(g):
        ids = torch.from_numpy(ids_all[:g]).cuda()
        lens = torch.from_numpy(lens_all[:g]).cuda()
        lidx = (None if lora_rows is None else
                torch.tensor(lora_rows[:g], dtype=torch.int32, device="cuda"))
        if core.page_pool is not None:
            tables = torch.zeros((g, core._block_tables.shape[1]),
                                 dtype=torch.int32, device="cuda")
            return llama.prefill_into_pages(core.params, core.cfg, ids, lens,
                                            tables, core.cache_k, core.cache_v,
                                            lora_idx=lidx)[0]
        slots = torch.arange(g, device="cuda")
        return llama.prefill_into_slots(core.params, core.cfg, ids, lens,
                                        slots, core.cache_k, core.cache_v,
                                        lora_idx=lidx)[0]

    solo = run(1)
    for g in GROUPS[1:]:
        grouped = run(g)
        torch.cuda.synchronize()
        if not torch.equal(grouped[0], solo[0]):
            where = _first_difference(lambda: run(1), lambda: run(g))
            raise AssertionError(
                f"batch_invariance {label}: row 0's logits alone and in a "
                f"group of {g} differ (max |diff| "
                f"{(grouped[0] - solo[0]).abs().max().item():.3e}); {where}")
    log(f"batch_invariance {label}: row 0's prefill logits bit-identical "
        f"alone and in groups of {list(GROUPS[1:])}"
        + ("" if lora_rows is None else
           f" (adapter pool rows {lora_rows[:max(GROUPS)]})"))


def _dense_paged_report(core, prompt: list[int]) -> str:
    """Why the dense engine's greedy stream parts from the paged one's: the
    timed prompt's prefill and first decode step through the dense entry
    points (the dense engine's idle slot 0) and through the paged ones (a
    temporary 3-page pool: the trash page and the row's two), with the same
    weights, traced op by op on row 0."""
    import torch

    from llmlb_tpu_torch.models import llama

    cfg, params = core.cfg, core.params
    n = len(prompt)
    ids = torch.zeros((1, 128), dtype=torch.int64, device="cuda")
    ids[0, :n] = torch.tensor(prompt, device="cuda")
    lens = torch.tensor([n], dtype=torch.int32, device="cuda")
    ck, cv = llama.init_kv_pages(cfg, 3, PAGE, "cuda")
    tables = torch.zeros((SLOTS, 2), dtype=torch.int32, device="cuda")
    tables[0] = torch.tensor([1, 2])
    seq = torch.zeros(SLOTS, dtype=torch.int32, device="cuda")
    seq[0] = n

    def paged():
        logits = llama.prefill_into_pages(params, cfg, ids, lens, tables[:1],
                                          ck, cv)[0]
        toks = torch.zeros(SLOTS, dtype=torch.int64, device="cuda")
        toks[0] = logits[0].argmax()
        llama.decode_step_paged(params, cfg, toks, seq, ck, cv, tables,
                                window=SERVE_WINDOW)

    def dense():
        logits = llama.prefill_into_slots(
            params, cfg, ids, lens, torch.zeros(1, dtype=torch.int64,
                                                device="cuda"),
            core.cache_k, core.cache_v)[0]
        toks = torch.zeros(SLOTS, dtype=torch.int64, device="cuda")
        toks[0] = logits[0].argmax()
        llama.decode_step(params, cfg, toks, seq, core.cache_k, core.cache_v,
                          window=SERVE_WINDOW)

    return _first_difference(paged, dense)


# The graph = eager workload: (sampling, adapter) of each of its rows, run
# together; the adapters apply in the LoRA phase (its mixed batch).
GRAPH_ROWS = ((dict(), None), (dict(), "acme"),
              (dict(temperature=0.8, top_p=0.95, seed=1234), "beta"),
              (dict(temperature=1.0, top_k=40, seed=77), "acme"))
GRAPH_TOKENS = 48


def _graph_counters(core, label: str, dev: dict) -> dict:
    """The decode graphs of the serving core: every burst after a key's
    first is one replay. Logs what the graphs cost: capture seconds, the
    pool's bytes, and per key the port's kernels and the graph's nodes per
    replay."""
    st = core.stats()
    info = core.decode_graph_info()
    if not info["enabled"]:
        raise AssertionError(f"serve {label}: decode graphs are off on the "
                             "card")
    if st.decode_graph_replays < 1 or st.decode_graphs < 1:
        raise AssertionError(f"serve {label}: no decode burst replayed a "
                             f"graph ({st})")
    if st.decode_eager_bursts > st.decode_graphs:
        raise AssertionError(
            f"serve {label}: {st.decode_eager_bursts} eager bursts for "
            f"{st.decode_graphs} captured keys")
    if st.decode_graph_replays + st.decode_eager_bursts != core.decode_bursts:
        raise AssertionError(f"serve {label}: bursts do not add up ({st}, "
                             f"{core.decode_bursts} bursts)")
    log(f"serve {label} [{dev['smi']}]: decode graphs: "
        f"{st.decode_graph_replays} replays, {st.decode_eager_bursts} eager "
        f"bursts (one warm-up a key), {st.decode_graphs} keys captured in "
        f"{info['capture_s']:.3f} s, pool {info['pool_bytes'] / 2**20:.1f} "
        f"MiB (reserved memory after minus before each capture); per key "
        + "; ".join(f"{k}: nodes {v['nodes']}, port kernels {v['launches']}, "
                    f"capture {v['capture_s']:.3f} s, pool "
                    f"{v['pool_bytes'] / 2**20:.1f} MiB"
                    for k, v in info["keys"].items()))
    return info


def _graph_vs_eager(core, prompt: list[int], label: str, lora: bool,
                    dev: dict, core_kwargs: dict) -> dict:
    """On the same card and the same weights, an engine with
    decode_graphs=False: the GRAPH_ROWS workload (greedy and seeded rows;
    with adapters the mixed batch) gives the same tokens as on the serving
    core, whose bursts replay graphs; two identical unseeded requests at
    temperature 1 draw different tokens on the serving core whenever they
    do on the eager one; and the eager engine's single-stream decode rate."""
    import gc

    import torch

    from llmlb_tpu_torch.engine.scheduler import EngineCore

    eager = EngineCore(core.cfg, core.params, device="cuda", seed=0,
                       num_slots=SLOTS, slot_capacity=CAPACITY, eos_id=-1,
                       decode_graphs=False, **core_kwargs)
    eager.start()
    try:
        def workload(c):
            return _concurrent([
                lambda i=i, sp=sp, name=name: _timed_core_request(
                    c, prompt[:-1] + [200 + i], GRAPH_TOKENS,
                    name if lora else None, **sp)[0]
                for i, (sp, name) in enumerate(GRAPH_ROWS)])

        def unseeded_twice(c):
            return [_timed_core_request(c, prompt, 32, temperature=1.0)[0]
                    for _ in range(2)]

        replays = core.stats().decode_graph_replays
        graph_ids, eager_ids = workload(core), workload(eager)
        replayed = core.stats().decode_graph_replays - replays
        same = [_shared(a, b) for a, b in zip(graph_ids, eager_ids)]
        log(f"serve {label}: graph = eager: rows (greedy, greedy, seeded, "
            f"seeded){' with adapters [None, acme, beta, acme]' if lora else ''}"
            f" share {same} of {GRAPH_TOKENS} tokens; the graph core "
            f"replayed {replayed} bursts for them, the eager core "
            f"{eager.stats().decode_graph_replays}")
        if graph_ids != eager_ids:
            raise AssertionError(f"serve {label}: graph and eager bursts give "
                                 f"different tokens (shared {same})")
        if replayed < 1 or eager.stats().decode_graph_replays:
            raise AssertionError(f"serve {label}: the comparison did not set "
                                 "replays against eager bursts")
        g1, g2 = unseeded_twice(core)
        e1, e2 = unseeded_twice(eager)
        log(f"serve {label}: unseeded temperature-1 twice: the graph core's "
            f"draws share {_shared(g1, g2)} of 32 tokens, the eager core's "
            f"{_shared(e1, e2)}")
        if e1 != e2 and g1 == g2:
            raise AssertionError(f"serve {label}: replays repeat their "
                                 "unseeded noise")
        rates = [_timed_core_request(eager, prompt, 64)[2] for _ in range(2)]
        log(f"serve {label} [{dev['smi']}]: eager bursts (decode_graphs="
            f"False): decode {max(rates):.1f} tok/s")
        return {"decode_tok_s_1_eager": max(rates)}
    finally:
        eager.stop()
        del eager
        gc.collect()
        torch.cuda.empty_cache()


def phase_serve(dev: dict, label: str, path: tuple[str, ...],
                bf16_ids: list[int] | None = None,
                bf16_long_ids: list[int] | None = None, **core_kwargs) -> dict:
    """Serve Llama-3-8B at full width and depth, random weights from seed 0,
    through the HTTP server, then time requests on its core. `core_kwargs`
    pick the path (quantize="all", kv_layout="dense", lora_dir=...).
    Returns the metrics, the greedy ids of the timed prompts (124 and ~1500
    tokens) and the kernel launches of this run."""
    import gc

    import torch

    from llmlb_tpu_torch.engine.server import start_server
    from llmlb_tpu_torch.engine.service import Engine
    from llmlb_tpu_torch.ops import cuda_attention as ca

    lora = "lora_dir" in core_kwargs
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = Engine.from_preset("llama-3-8b", device="cuda", seed=0,
                                num_slots=SLOTS, slot_capacity=CAPACITY,
                                eos_id=-1, **core_kwargs)
    core = engine.core
    torch.cuda.synchronize()
    kv_info = core.kv_cache_info()
    log(f"serve {label}: llama-3-8b random weights (seed 0) on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"(params {core.param_bytes / 2**30:.2f} GiB, KV "
        f"{kv_info['hbm_bytes'] / 2**30:.2f} GiB {kv_info['layout']} "
        f"{kv_info['kv_dtype']}); decode burst {core.decode_burst}")
    if core_kwargs.get("quantize") == "all" and kv_info["kv_dtype"] != "int8":
        raise AssertionError(f"quantize=all serves a {kv_info['kv_dtype']} "
                             "KV pool")
    if kv_info["layout"] != core_kwargs.get("kv_layout", "paged"):
        raise AssertionError(f"the engine serves the {kv_info['layout']} "
                             "layout")
    server, thread = start_server(engine)
    base = "http://%s:%d" % server.server_address[:2]
    stats = {}
    try:
        ca.reset_launch_counts()
        # the main path, over HTTP; with adapters, a mix of the base model,
        # the `lora` field and the `model:adapter` suffix
        first = _chat(base, "Tell me about paged attention.", 32, True)

        def request(i: int) -> dict:
            content = f"Request {i}: write a haiku about GPUs and TPUs."
            if lora and i % 3 == 1:
                return _chat(base, content, 32, i % 2 == 0, lora="acme")
            if lora and i % 3 == 2:
                return _chat(base, content, 32, i % 2 == 0,
                             model="llama-3-8b:beta")
            return _chat(base, content, 32, stream=i % 2 == 0)

        results = _concurrent([lambda i=i: request(i) for i in range(4)])
        long_text = " ".join(f"w{i % 97}" for i in range(380))  # ~1500 tokens
        long = _chat(base, long_text, 32, False,
                     lora="beta" if lora else None)
        again = _chat(base, "Tell me about paged attention.", 32, True)
        for r in [first, again, long, *results]:
            assert r["usage"]["completion_tokens"] == 32, r["usage"]
            assert r["finish"] == "length", r["finish"]
        assert long["usage"]["prompt_tokens"] > 1024, long["usage"]
        assert again["text"] == first["text"], (first, again)
        if lora:
            assert results[2]["model"] == "llama-3-8b", results[2]["model"]
            with urllib.request.urlopen(base + "/v1/models",
                                        timeout=60) as resp:
                ids = [m["id"] for m in json.loads(resp.read())["data"]]
            assert {"llama-3-8b:acme", "llama-3-8b:beta"} <= set(ids), ids
        log(f"serve {label}: 4 concurrent chats"
            + (" (base, lora field, model:adapter suffix)" if lora else "")
            + f" + {long['usage']['prompt_tokens']}-token prompt"
            + (" with adapter beta" if lora else "")
            + " + repeat over HTTP ok; repeat text identical")

        # token-level determinism and timing on the same core
        prompt = engine.encode_chat([{"role": "user",
                                      "content": "x" * 100}])
        ids1, ttft1, rate1 = _timed_core_request(core, prompt, 64)
        ids2, ttft2, rate2 = _timed_core_request(core, prompt, 64)
        assert ids1 == ids2, "greedy token ids differ between identical runs"
        t_batch = time.monotonic()
        _concurrent([lambda i=i: _timed_core_request(
            core, prompt[:-1] + [i], 64) for i in range(SLOTS)])
        agg = SLOTS * 64 / (time.monotonic() - t_batch)
        # the long prompt's TTFT: its chunks run the extend kernel
        long_prompt = engine.encode_chat([{"role": "user",
                                           "content": long_text}])
        long_runs = [_timed_core_request(core, long_prompt, LONG_TOKENS,
                                         "beta" if lora else None)
                     for _ in range(2)]
        if long_runs[0][0] != long_runs[1][0]:
            raise AssertionError("the long prompt's greedy ids differ between "
                                 "identical runs")
        stats = {"ttft_s": min(ttft1, ttft2), "decode_tok_s_1": max(rate1, rate2),
                 "tok_s_8": agg, "ids": ids1,
                 "ttft_long_s": min(r[1] for r in long_runs),
                 "long_ids": long_runs[0][0]}
        log(f"serve {label} [{dev['smi']}]: single-request TTFT "
            f"{stats['ttft_s'] * 1e3:.1f} ms ({len(prompt)}-token prompt), "
            f"{stats['ttft_long_s'] * 1e3:.1f} ms ({len(long_prompt)}-token "
            f"prompt{', adapter beta' if lora else ''}), decode "
            f"{stats['decode_tok_s_1']:.1f} tok/s; 8 concurrent x 64 "
            f"tokens: {agg:.1f} tok/s incl. prefill")
        if bf16_long_ids is not None:
            log(f"serve {label}: the first "
                f"{_shared(stats['long_ids'], bf16_long_ids)} of {LONG_TOKENS} "
                f"greedy tokens of the {len(long_prompt)}-token prompt agree "
                "with the bf16 paged run")
        if bf16_ids is not None:
            agree = _shared(ids1, bf16_ids)
            log(f"serve {label}: the first {agree} of {len(ids1)} greedy "
                "tokens of the timed prompt agree with the bf16 paged run")
            if lora and ids1 != bf16_ids:
                raise AssertionError("an adapter-free request differs from the "
                                     "LoRA-free engine's: the identity row "
                                     "must add exactly 0.0")
            if core_kwargs.get("kv_layout") == "dense" and ids1 != bf16_ids:
                raise AssertionError(
                    f"the dense stream parts from the paged bf16 one after "
                    f"{agree} of {len(ids1)} greedy tokens; "
                    f"{_dense_paged_report(core, prompt)}")
        if lora:
            acme, _, _ = _timed_core_request(core, prompt, 64, lora="acme")
            if acme == ids1:
                raise AssertionError("adapter acme changed no greedy token")
            # a mixed batch against each row's solo run: every row's tokens
            # are its solo run's (a row's prefill and decode do not depend
            # on the rows it shares a dispatch with)
            mix = [None, "acme", "beta", "acme"]
            solo = [_timed_core_request(core, prompt[:-1] + [i], 32, name)[0]
                    for i, name in enumerate(mix)]
            batch = _concurrent([lambda i=i, name=name: _timed_core_request(
                core, prompt[:-1] + [i], 32, name)[0]
                for i, name in enumerate(mix)])
            shared = [_shared(a, b) for a, b in zip(batch, solo)]
            log(f"serve {label}: acme's greedy ids share the first "
                f"{_shared(acme, ids1)} of 64 with the base model's; mixed "
                f"batch {mix} rows share {shared} of 32 tokens with their "
                "solo runs")
            if shared != [32] * len(mix):
                raise AssertionError(f"mixed batch {mix}: rows share {shared} "
                                     "of 32 tokens with their solo runs")
            info = core.lora_info()
            if info["active"] != {}:
                raise AssertionError(f"adapter refcounts left: {info['active']}")
            log(f"serve {label}: resident {info['resident']}, loads "
                f"{info['loads_total']}, refcounts drained to {{}}")
        nan_rows = core.nan_logit_rows()
        launches = dict(ca.LAUNCHES)
        stats["launches"] = launches
        log(f"serve {label}: launches over the main path {launches}; NaN "
            f"logit rows {nan_rows}")
        if nan_rows:
            raise AssertionError(f"{nan_rows} logit rows had NaN")
        missing = [k for k in path if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main path: "
                                 f"{missing}")
        stray = [k for k, n in launches.items() if k not in path and n]
        if stray:
            raise AssertionError(f"kernels of another path launched: {stray}")
        if hasattr(core, "decode_graph_info"):  # not in trees before graphs
            _graph_counters(core, label, dev)
            stats.update(_graph_vs_eager(core, prompt, label, lora, dev,
                                         core_kwargs))
            stats["graphs"] = _graph_counters(core, label, dev)
        # C1, on this configuration's weights, with the engine idle
        prompts = [prompt] + [engine.encode_chat(
            [{"role": "user", "content": f"Prompt {i}: " + "y" * (70 + 3 * i)}])
            for i in range(1, max(GROUPS))]
        lora_rows = None
        if lora:
            lora_rows = [core.lora.slot_of(n) for n in
                         ("beta", "acme", None, "beta", "acme", None, "beta",
                          "acme")]
        phase_batch_invariance(core, prompts, label, lora_rows)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        engine.shutdown()
        del engine, core
        gc.collect()
        torch.cuda.empty_cache()
    return stats


def phase_serve_lora(dev: dict, bf16_ids: list[int]) -> dict:
    """The LoRA path: a temporary adapter directory with the two ADAPTERS,
    written by the port's save_adapter, served by the paged bf16 engine."""
    import tempfile

    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.kernels import build
    from llmlb_tpu_torch.lora import save_adapter

    cfg = get_preset("llama-3-8b")
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as lora_dir:
        t0 = time.perf_counter()
        for name, rank, targets in ADAPTERS:
            save_adapter(lora_dir, name, cfg, rank=rank, targets=targets,
                         scale=ADAPTER_SCALE)
        log(f"serve lora: adapters {[a[0] for a in ADAPTERS]} written in "
            f"{time.perf_counter() - t0:.1f} s")
        return phase_serve(dev, "lora", LORA_PATH, bf16_ids=bf16_ids,
                           lora_dir=lora_dir)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=None,
                        help="checkout to import llmlb_tpu_torch from (another "
                             "commit, to time two trees in one call)")
    parser.add_argument("--serve-only", action="store_true",
                        help="run the device, build and serve phases only")
    args = parser.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve() if args.tree else REPO
    sys.path.insert(0, str(tree))
    try:
        import llmlb_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port package is not here ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2
    if Path(llmlb_tpu_torch.__file__).resolve().parents[1] != tree:
        print(f"chip_smoke: imported {llmlb_tpu_torch.__file__}, not from "
              f"{tree}", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    phase = "device"
    kernels = []
    try:
        dev = phase_device()
        phase = "build"
        phase_build()
        if not args.serve_only:
            phase = "kernels"
            kernels = phase_kernels()
            phase = "unembed"
            phase_unembed()
            phase = "model entry points"
            phase_model_entry_points()
        phase = "serve"
        stats = phase_serve(dev, "bf16", BF16_PATH)
        phase = "serve int8"
        stats_int8 = phase_serve(dev, "quantize=all", INT8_PATH,
                                 bf16_ids=stats["ids"], quantize="all")
        phase = "serve lora"
        stats_lora = phase_serve_lora(dev, stats["ids"])
        phase = "serve dense"
        stats_dense = phase_serve(dev, "dense", DENSE_PATH,
                                  bf16_ids=stats["ids"],
                                  bf16_long_ids=stats["long_ids"],
                                  kv_layout="dense")
    except BaseException:
        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' FAILED", file=sys.stderr)
        return 1
    serves = {"bf16": stats, "quantize=all": stats_int8, "lora": stats_lora,
              "dense": stats_dense}
    log(json.dumps({"serve": {
        label: {k: st[k] for k in ("ttft_s", "ttft_long_s", "decode_tok_s_1",
                                   "tok_s_8", "decode_tok_s_1_eager")
                if k in st}
        for label, st in serves.items()}, "tree": str(tree),
        "card": dev["smi"]}))
    own_path = {"lora_delta": stats_lora, "flash_decode": stats_dense,
                "flash_extend": stats_dense,
                **{n: stats_int8 for n in INT8_PATH if n != "flash_prefill"}}
    for k in kernels:  # each kernel's count from the path it belongs to
        k["launches"] = own_path.get(k["name"], stats)["launches"][k["name"]]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{key: k[key] for key in order}
                                for k in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": dev["kind"],
                                           "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
