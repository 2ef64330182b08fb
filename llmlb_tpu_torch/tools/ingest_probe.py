"""Model-ingestion probe: validate a checkpoint before serving it.

The port's counterpart of `llmlb_tpu/tools/ingest_probe.py`. The probe:

  1. walks every safetensors shard through `engine/safetensors_io.py`:
     header integrity, dtype support, NaN/Inf in a bounded sample of each
     float tensor, duplicate names, tensors per shard;
  2. checks that every tensor the shard index names exists;
  3. reads config.json with the port's `load_config` and holds the shards
     against it: the layer count, and the shape of every tensor the
     family's loader would read (`models.family_for` and the loader's HF
     name map) against the shape the config implies.

The reference's `--stablehlo` (lowering the prefill step to StableHLO)
has no counterpart here: the port runs no XLA program, and the flag is
refused with a message.

Usage: python -m llmlb_tpu_torch.tools.ingest_probe CHECKPOINT_DIR
Exit code 0 = servable; 1 = validation findings; 2 = unreadable (or a
refused flag).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

import numpy as np

from llmlb_tpu_torch.engine.safetensors_io import (
    INDEX_NAME,
    SafetensorsFile,
    read_header,
)


@dataclasses.dataclass
class ProbeReport:
    checkpoint: str
    shards: list[dict] = dataclasses.field(default_factory=list)
    tensor_count: int = 0
    total_bytes: int = 0
    dtypes: dict = dataclasses.field(default_factory=dict)
    findings: list[str] = dataclasses.field(default_factory=list)
    config: dict | None = None

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        return {**dataclasses.asdict(self), "ok": self.ok}


_SUPPORTED_DTYPES = {"F32", "F16", "BF16", "I32", "I64", "U8", "I8"}
_FLOAT_DTYPES = {"F32", "F16", "BF16"}  # the ones safetensors_io reads
_SAMPLE = 8192  # values read per tensor for the NaN/Inf check


def _walk_shard(report: ProbeReport, path: str, seen: dict,
                sample_values: bool) -> None:
    shard = os.path.basename(path)
    info = {"file": shard, "bytes": os.path.getsize(path), "tensors": 0}
    try:
        header, _ = read_header(path)
        reader = SafetensorsFile(path) if sample_values and any(
            e.get("dtype") in _FLOAT_DTYPES for e in header.values()) else None
        for name, entry in header.items():
            dtype = str(entry.get("dtype", "?"))
            info["tensors"] += 1
            report.tensor_count += 1
            report.dtypes[dtype] = report.dtypes.get(dtype, 0) + 1
            if name in seen:
                report.findings.append(
                    f"duplicate tensor {name!r} (also in {seen[name][0]})")
            seen[name] = (shard, tuple(entry.get("shape", ())))
            if dtype.upper() not in _SUPPORTED_DTYPES:
                report.findings.append(f"{name}: unsupported dtype {dtype}")
            elif reader is not None and dtype in _FLOAT_DTYPES:
                flat = reader.get_tensor(name).reshape(-1)
                sample = flat[:: max(1, flat.size // 4096)][:_SAMPLE]
                if sample.size and not np.isfinite(sample).all():
                    report.findings.append(
                        f"{name}: non-finite values (NaN/Inf) in shard {shard}")
    except (OSError, ValueError, KeyError, TypeError) as e:
        report.findings.append(f"{shard}: unreadable ({e})")
    report.total_bytes += info["bytes"]
    report.shards.append(info)


def _expected_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """{HF tensor name: shape} of every tensor the loader reads for cfg."""
    from llmlb_tpu_torch.engine.weights import _cells, _param_builders
    from llmlb_tpu_torch.models import family_for

    shapes = family_for(cfg).param_shapes(cfg)
    out = {}
    for leaf, (fmt, stacked, transpose) in _param_builders(cfg).items():
        full = tuple(shapes[leaf][0])
        for hf_name, at in _cells(cfg, fmt, stacked):
            shape = full[len(at):]
            out[hf_name] = shape[::-1] if transpose else shape
    return out


def _check_config(report: ProbeReport, model_dir: str, seen: dict) -> None:
    from llmlb_tpu_torch.engine.weights import load_config

    try:
        cfg = load_config(model_dir)
        report.config = {
            "num_layers": cfg.num_layers,
            "hidden_size": cfg.hidden_size,
            "num_heads": cfg.num_heads,
            "num_kv_heads": cfg.num_kv_heads,
            "vocab_size": cfg.vocab_size,
            "max_position_embeddings": cfg.max_position_embeddings,
        }
        found_layers = len({name.split(".")[2] for name in seen
                            if name.startswith("model.layers.")})
        if found_layers and found_layers != cfg.num_layers:
            report.findings.append(
                f"config says {cfg.num_layers} layers but shards carry "
                f"{found_layers}")
        for name, want in _expected_shapes(cfg).items():
            if name in seen and seen[name][1] != want:
                report.findings.append(
                    f"{name}: shape {list(seen[name][1])}, the config "
                    f"implies {list(want)}")
    except (OSError, ValueError, KeyError, TypeError) as e:
        report.findings.append(f"config/arch check failed: {e}")


def probe_checkpoint(model_dir: str, *,
                     sample_values: bool = True) -> ProbeReport:
    report = ProbeReport(checkpoint=os.path.abspath(model_dir))
    shards = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not shards:
        report.findings.append("no .safetensors shards found")
        return report
    seen: dict[str, tuple] = {}  # name -> (shard, shape)
    for path in shards:
        _walk_shard(report, path, seen, sample_values)

    index_path = os.path.join(model_dir, INDEX_NAME)
    if os.path.isfile(index_path):
        try:
            with open(index_path) as f:
                weight_map = json.load(f).get("weight_map", {})
            missing = [t for t in weight_map if t not in seen]
            if missing:
                report.findings.append(
                    f"{len(missing)} tensors in the index are missing from "
                    f"shards (first: {missing[0]})")
        except (OSError, ValueError) as e:
            report.findings.append(f"unreadable shard index: {e}")

    if os.path.isfile(os.path.join(model_dir, "config.json")):
        _check_config(report, model_dir, seen)
    else:
        report.findings.append("no config.json (cannot cross-check arch)")
    return report


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m llmlb_tpu_torch.tools.ingest_probe",
        description="Validate a checkpoint before serving it.")
    parser.add_argument("checkpoint_dir")
    parser.add_argument(
        "--stablehlo", metavar="OUT",
        help="refused: the reference lowers its prefill step to StableHLO; "
             "the port runs no XLA program, so there is nothing to lower")
    args = parser.parse_args(argv)
    if args.stablehlo is not None:
        parser.error("--stablehlo has no counterpart in the PyTorch/CUDA "
                     "port (it runs no XLA program to lower); run the "
                     "reference's probe, python -m llmlb_tpu.tools."
                     "ingest_probe, for a StableHLO proof")
    if not os.path.isdir(args.checkpoint_dir):
        print(json.dumps({"error": f"not a directory: {args.checkpoint_dir}"}))
        return 2
    report = probe_checkpoint(args.checkpoint_dir)
    print(json.dumps(report.to_json(), indent=2))
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
