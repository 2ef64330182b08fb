"""Time the one-token decode attention kernels on the card.

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


def max_err(got, want) -> tuple[float, bool]:
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    diff = (g - w).abs()
    return diff.max().item(), bool((diff <= BF16_REL * (w.abs() + rms)).all())


def split_variant(build, ca, split_keys: int) -> None:
    """Point the build at a copy of the sources whose kSplitKeys is
    `split_keys` (the sources themselves for the header's value)."""
    src = build.PKG_DIR / "csrc"
    text = (src / "attention_decode.cuh").read_text()
    pattern = r"constexpr int kSplitKeys = (\d+);"
    current = int(re.search(pattern, text).group(1))
    build._lib = None
    if split_keys == current:
        build.CSRC_DIR = src
    else:
        dst = build.BUILD_DIR / f"csrc_split{split_keys}"
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst)
        (dst / "attention_decode.cuh").write_text(
            re.sub(pattern, f"constexpr int kSplitKeys = {split_keys};", text))
        build.CSRC_DIR = dst
    ca.DECODE_SPLIT_KEYS = split_keys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=None,
                        help="checkout to import llmlb_tpu_torch from")
    parser.add_argument("--split-keys", default="",
                        help="comma-separated kSplitKeys values to time")
    parser.add_argument("--tag", default="", help="label on every line")
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
            if name in ("flash_decode.cu", "paged_decode_quant.cu"):
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
