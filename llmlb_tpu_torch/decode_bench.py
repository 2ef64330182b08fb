"""Time the attention kernels on the card: the one-token decodes, or with
`--extend` the prefill and extend kernels.

Three kernels, each at two shapes of Llama-3-8B (32 heads over 8 KV heads,
head_dim 128, bf16, pages of 128 tokens, the engine's 8 slots of 4096):

- `table`: contexts 4096, 3000, 2048, 1500, 1024, 513, 129, 1, swept to
  4096 (the shape of PERF.md's kernel table);
- `serve`: contexts 156..163 under a 256-key window (2 pages), the decode
  steps of the serving phases.

`flash_decode` (dense slot cache), `paged_flash_decode` and
`paged_flash_decode_quant` (int8 pools) are each checked against their plain
version (bf16 limit 2^-6 of |plain| + row RMS) and timed with CUDA events,
warm (back to back) and with the L2 cache cold (a 128 MB buffer written
before each call), and their kernels' device time per call is read from
torch.profiler (back to back, a call this short may be bound by the host's
launch path instead); at the table shape SDPA on the dense cache is timed
beside them as the yardstick. Every line printed after the card's name and
power limit is one JSON object.

    python -m llmlb_tpu_torch.decode_bench
    python llmlb_tpu_torch/decode_bench.py --tree DIR   # another checkout
    python -m llmlb_tpu_torch.decode_bench --extend --compare FILE

`--lora` also times the LoRA kernel at Llama-3-8B's projection shapes (8
rows, rank 16, 9 pool rows; T 1, 128 and 512): `lora_delta` (the fp32
delta, held against its plain version) and the delta added into a
projection output, `lora_delta_add` where the tree has it, else the unfused
`y + lora_delta(...).to(y.dtype)`; device time is every kernel the call
launches.

`--lora-variants 16x8x4,8x8x4` rebuilds the LoRA kernel once per
(kTileT, cluster size, kExpandPositions) triple, as `--split-keys` does for
the decode kernels, and times it at T 128 and 512 with every cluster of that
size.

`--extend` times the four chunk kernels instead, at the shapes of
PERF.md's kernel table: `flash_prefill` (8 prompts of 512..1 tokens in a
512 bucket), `flash_extend` (476 queries at 1024 over a 4096-cell row),
`paged_flash_extend` and `paged_flash_extend_quant` (the same chunk over the
same keys in shuffled 128-token pages, bf16 and int8), each against its
plain version and timed as above. `--save-out FILE` writes their outputs;
`--compare FILE` holds this tree's against such a file, and fails unless
`flash_prefill` and `flash_extend` give the same bits (the paged extends'
largest difference is reported): run the parent tree with `--save-out`,
then this one with `--compare`, in one call on one card.

`--tree DIR` imports `llmlb_tpu_torch` from the checkout at DIR (an older
commit, to compare two trees in one run on one card). `--split-keys
256,512` times the split-K kernels once per split size: for a size other
than the header's, the kernel sources are copied under the build directory
with `kSplitKeys` changed and built from there, and the wrappers' split
count follows. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROWS, H, KV, D, PAGE, CAPACITY = 8, 32, 8, 128, 128, 4096
TABLE_LENS = [4096, 3000, 2048, 1500, 1024, 513, 129, 1]
SERVE_LENS = [156, 157, 158, 159, 160, 161, 162, 163]
SERVE_WINDOW = 256
BF16_REL = 2.0**-6
LORA_REL = 1e-4  # fp32 sums of exact products in another order
LORA_RANK, LORA_POOL_ROWS = 16, 9
LORA_IDX = [0, 3, 1, 0, 8, 2, 2, 5]
LORA_SHAPES = {"wq": (4096, 4096), "wk": (4096, 1024), "wg": (4096, 14336),
               "wd": (14336, 4096)}


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, after one
    warm-up call."""
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


def cuda_ms_cold(torch, fn, reps: int) -> float:
    """Mean device time of fn() with a 128 MB buffer written before each
    call (outside the timed region), so no input is left in the L2."""
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


def device_ms(torch, fn, reps: int) -> dict[str, float]:
    """Device time per fn() call of each kernel it launches, as
    torch.profiler saw them (no host time between launches)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            found = re.search(r"\w+_kernel", e.name)
            name = found.group(0) if found else e.name[:60]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    return {k: v / reps / 1e3 for k, v in by_name.items()}


def max_err(got, want, rel=BF16_REL) -> tuple[float, bool]:
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    diff = (g - w).abs()
    return diff.max().item(), bool((diff <= rel * (w.abs() + rms)).all())


def extend_bench(torch, base: dict, save: str | None,
                 compare: str | None) -> None:
    """The chunk kernels at the table shapes, one JSON line each (see the
    module docstring); their outputs saved to `save` or held bit for bit
    against those in `compare`."""
    from llmlb_tpu_torch.ops import cuda_attention as ca
    from llmlb_tpu_torch.quant import quantize_kv

    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    plens_host = [512, 500, 384, 256, 200, 129, 64, 1]
    plens = torch.tensor(plens_host, dtype=torch.int32, device="cuda")
    pq, pk, pv = randn((ROWS, 512, H, D)), randn((ROWS, 512, KV, D)), \
        randn((ROWS, 512, KV, D))
    start_host, chunk_host = 1024, 476
    start = torch.tensor([start_host], dtype=torch.int32, device="cuda")
    chunk = torch.tensor([chunk_host], dtype=torch.int32, device="cuda")
    q = randn((1, 512, H, D))
    kc, vc = randn((1, CAPACITY, KV, D)), randn((1, CAPACITY, KV, D))
    # the row's keys in shuffled pages of 128 (page 0 unused)
    ppn = CAPACITY // PAGE
    perm = torch.randperm(ppn, generator=gen, device="cuda") + 1
    kp = torch.zeros((ppn + 1, PAGE, KV, D), dtype=torch.bfloat16, device="cuda")
    vp = torch.zeros_like(kp)
    kp[perm], vp[perm] = kc.reshape(ppn, PAGE, KV, D), vc.reshape(ppn, PAGE, KV, D)
    tables = perm[None].to(torch.int32).contiguous()
    (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
    cases = {
        "flash_prefill": (
            lambda: ca.flash_prefill(pq, pk, pv, plens),
            lambda: ca.flash_prefill_reference(pq, pk, pv, plens), plens_host),
        "flash_extend": (
            lambda: ca.flash_extend(q, kc, vc, start, chunk),
            lambda: ca.flash_extend_reference(q, kc, vc, start, chunk),
            [chunk_host]),
        "paged_flash_extend": (
            lambda: ca.paged_flash_extend(q, kp, vp, tables, start, chunk),
            lambda: ca.paged_flash_extend_reference(q, kp, vp, tables, start,
                                                    chunk), [chunk_host]),
        "paged_flash_extend_quant": (
            lambda: ca.paged_flash_extend_quant(q, kq, ks, vq, vs, tables,
                                                start, chunk),
            lambda: ca.paged_flash_extend_quant_reference(
                q, kq, ks, vq, vs, tables, start, chunk), [chunk_host]),
    }
    outs = {}
    for kernel, (fn, plain, rows) in cases.items():
        got, want = fn(), plain()
        torch.cuda.synchronize()
        errs = [max_err(got[b, :n], want[b, :n]) for b, n in enumerate(rows)]
        err, ok = max(e for e, _ in errs), all(o for _, o in errs)
        outs[kernel] = got.cpu()
        print(json.dumps({**base, "shape": "table", "kernel": kernel,
                          "max_abs_err": err, "within": ok,
                          "ms": cuda_ms(torch, fn, 20),
                          "ms_cold": cuda_ms_cold(torch, fn, 20),
                          "device_ms": device_ms(torch, fn, 20)}), flush=True)
        if not ok:
            raise AssertionError(f"{kernel}: disagrees with its plain version "
                                 f"({err:.3e})")
    if save:
        torch.save(outs, save)
    if compare:
        theirs = torch.load(compare)
        for kernel, got in outs.items():
            same = torch.equal(got, theirs[kernel])
            diff = (got.float() - theirs[kernel].float()).abs().max().item()
            print(json.dumps({**base, "kernel": kernel, "compared_with": compare,
                              "bits_equal": same, "max_abs_diff": diff}),
                  flush=True)
            if kernel in ("flash_prefill", "flash_extend") and not same:
                raise AssertionError(f"{kernel}: other bits than {compare}")


def lora_bench(torch, base: dict, lengths=(1, 128, 512)) -> None:
    """The LoRA kernel's two forms at the projection shapes and T in
    `lengths`, one JSON line each (see the module docstring)."""
    from llmlb_tpu_torch.ops import lora

    fused = getattr(lora, "lora_delta_add", None)
    gen = torch.Generator(device="cuda").manual_seed(3)
    idx = torch.tensor(LORA_IDX, dtype=torch.int32, device="cuda")
    bf16 = torch.bfloat16
    for tgt, (in_dim, out_dim) in LORA_SHAPES.items():
        a = (torch.randn((LORA_POOL_ROWS, in_dim, LORA_RANK), generator=gen,
                         device="cuda") * in_dim**-0.5).to(bf16)
        b = (torch.randn((LORA_POOL_ROWS, LORA_RANK, out_dim), generator=gen,
                         device="cuda") * LORA_RANK**-0.5).to(bf16)
        a[0] = 0
        b[0] = 0
        for t in lengths:
            x = torch.randn((ROWS, t, in_dim), generator=gen,
                            device="cuda").to(bf16)
            y = torch.randn((ROWS, t, out_dim), generator=gen,
                            device="cuda").to(bf16)
            err, ok = max_err(lora.lora_delta(x, a, b, idx),
                              lora.lora_delta_reference(x, a, b, idx),
                              LORA_REL)
            if not ok:
                raise AssertionError(f"lora_delta {tgt} T {t}: disagrees with "
                                     f"its plain version ({err:.3e})")
            if fused is not None:
                add, form = (lambda: fused(y, x, a, b, idx)), "b (fused)"
            else:
                add = lambda: y + lora.lora_delta(x, a, b, idx).to(bf16)  # noqa: E731
                form = "b (unfused: delta, cast, add)"
            for mode, fn in (("a", lambda: lora.lora_delta(x, a, b, idx)),
                             (form, add)):
                dev = device_ms(torch, fn, 20)
                print(json.dumps({**base, "kernel": "lora_delta", "mode": mode,
                                  "target": tgt, "shape": [ROWS, t, in_dim,
                                                           out_dim],
                                  "max_abs_err": err,
                                  "ms": cuda_ms(torch, fn, 50),
                                  "device_ms": dev,
                                  "device_ms_total": sum(dev.values())}),
                      flush=True)
            del x, y


def source_variant(build, source: str, values: dict[str, int]) -> None:
    """Point the build at a copy of the sources whose `source` defines the
    constants `values` (`constexpr int NAME = V;`), or at the sources
    themselves when they already do."""
    src = build.PKG_DIR / "csrc"
    text = (src / source).read_text()
    new = text
    for name, value in values.items():
        new = re.sub(rf"constexpr int {name} = (\d+);",
                     f"constexpr int {name} = {value};", new)
    build._lib = None
    if new == text:
        build.CSRC_DIR = src
        return
    tag = "_".join(f"{k}{v}" for k, v in values.items())
    dst = build.BUILD_DIR / f"csrc_{tag}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    (dst / source).write_text(new)
    build.CSRC_DIR = dst


def split_variant(build, ca, split_keys: int) -> None:
    """Build the decode kernels with kSplitKeys = `split_keys`."""
    source_variant(build, "attention_decode.cuh", {"kSplitKeys": split_keys})
    ca.DECODE_SPLIT_KEYS = split_keys


def lora_variant(build, lora, tile: int, cluster: int, expand: int) -> None:
    """Build the LoRA kernel with kTileT = tile, every long-T cluster of
    `cluster` blocks (kClusterMin = kClusterMax = cluster: also at T = 128
    and 1) and kExpandPositions = expand; the wrapper's plan follows."""
    source_variant(build, "lora_bgmv.cu", {"kTileT": tile,
                                           "kClusterMin": cluster,
                                           "kClusterMax": cluster,
                                           "kExpandPositions": expand})
    lora._TILE_T = tile
    lora._CLUSTER_MIN = lora._CLUSTER_MAX = cluster


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=None,
                        help="checkout to import llmlb_tpu_torch from")
    parser.add_argument("--split-keys", default="",
                        help="comma-separated kSplitKeys values to time")
    parser.add_argument("--tag", default="", help="label on every line")
    parser.add_argument("--lora", action="store_true",
                        help="also time the LoRA kernel")
    parser.add_argument("--extend", action="store_true",
                        help="time the prefill and extend kernels instead")
    parser.add_argument("--save-out", default=None,
                        help="(--extend) file to save the outputs to")
    parser.add_argument("--compare", default=None,
                        help="(--extend) outputs to hold these against")
    parser.add_argument("--lora-variants", default="",
                        help="comma-separated TILExCLUSTERxEXPAND builds of "
                             "the LoRA kernel (kTileT, one cluster size, "
                             "kExpandPositions) to time at T 128 and 512")
    args = parser.parse_args(argv)
    tree = Path(args.tree or Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(tree))

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("decode_bench: no CUDA device", file=sys.stderr)
        return 2
    from llmlb_tpu_torch.kernels import build
    from llmlb_tpu_torch.ops import cuda_attention as ca
    from llmlb_tpu_torch.quant import quantize_kv

    if Path(ca.__file__).resolve().parents[2] != tree:
        raise RuntimeError(f"imported {ca.__file__}, not from {tree}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.extend:
        build.load()
        extend_bench(torch, {"tag": args.tag, "tree": str(tree), "card": smi},
                     args.save_out, args.compare)
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    ppn = CAPACITY // PAGE
    kc, vc = randn((ROWS, CAPACITY, KV, D)), randn((ROWS, CAPACITY, KV, D))
    kp, vp = randn((ROWS * ppn + 1, PAGE, KV, D)), randn((ROWS * ppn + 1, PAGE, KV, D))
    (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
    perm = torch.randperm(ROWS * ppn, generator=gen, device="cuda") + 1
    tables = perm.reshape(ROWS, ppn).to(torch.int32).contiguous()
    q = randn((ROWS, H, D))

    def cases(lens, window):
        pages = -(-window // PAGE)
        return {
            "flash_decode": (
                lambda: ca.flash_decode(q, kc, vc, lens, window=window),
                lambda: ca.flash_decode_reference(q, kc, vc, lens, window=window)),
            "paged_flash_decode": (
                lambda: ca.paged_flash_decode(q, kp, vp, tables, lens, pages=pages),
                lambda: ca.paged_flash_decode_reference(q, kp, vp, tables, lens,
                                                        pages=pages)),
            "paged_flash_decode_quant": (
                lambda: ca.paged_flash_decode_quant(q, kq, ks, vq, vs, tables, lens,
                                                    pages=pages),
                lambda: ca.paged_flash_decode_quant_reference(
                    q, kq, ks, vq, vs, tables, lens, pages=pages)),
        }

    shapes = {"table": (TABLE_LENS, CAPACITY), "serve": (SERVE_LENS, SERVE_WINDOW)}
    variants = [int(v) for v in args.split_keys.split(",") if v] or [None]
    base = {"tag": args.tag, "tree": str(tree), "card": smi}
    for variant in variants:
        if variant is not None:
            split_variant(build, ca, variant)
        build.load()
        for name, report in (build.BUILD_INFO.get("ptxas") or {}).items():
            if name in ("flash_decode.cu", "paged_decode.cu",
                        "paged_decode_quant.cu", "lora_bgmv.cu"):
                for line in report.splitlines():
                    if "registers" in line or "spill" in line:
                        print(f"ptxas {name} (split {variant}): {line.strip()}",
                              flush=True)
        for shape, (lens_host, window) in shapes.items():
            lens = torch.tensor(lens_host, dtype=torch.int32, device="cuda")
            for kernel, (fn, plain) in cases(lens, window).items():
                got, want = fn(), plain()
                torch.cuda.synchronize()
                err, ok = max_err(got, want)
                row = {**base, "split_keys": variant, "shape": shape,
                       "kernel": kernel, "max_abs_err": err, "within": ok,
                       "ms": cuda_ms(torch, fn, 50),
                       "ms_cold": cuda_ms_cold(torch, fn, 20),
                       "device_ms": device_ms(torch, fn, 20)}
                print(json.dumps(row), flush=True)
                if not ok:
                    raise AssertionError(f"{kernel} {shape}: disagrees with its "
                                         f"plain version ({err:.3e})")
    # SDPA on the dense cache at the table shape: the yardstick call
    lens = torch.tensor(TABLE_LENS, dtype=torch.int32, device="cuda")
    cols = torch.arange(CAPACITY, device="cuda")
    mask = (cols[None, :] < lens[:, None])[:, None, None]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q[:, None], kc, vc))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    print(json.dumps({**base, "shape": "table", "kernel": "sdpa",
                      "ms": cuda_ms(torch, sdpa, 50),
                      "ms_cold": cuda_ms_cold(torch, sdpa, 20),
                      "device_ms": device_ms(torch, sdpa, 20)}), flush=True)
    if args.lora:
        lora_bench(torch, base)
    for variant in filter(None, args.lora_variants.split(",")):
        from llmlb_tpu_torch.ops import lora

        tile, cluster, expand = (int(v) for v in variant.split("x"))
        lora_variant(build, lora, tile, cluster, expand)
        build.load()
        lora_bench(torch, {**base, "lora_variant": variant}, (128, 512))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
