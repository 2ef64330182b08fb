"""The port's ingestion probe (llmlb_tpu_torch/tools/ingest_probe.py),
held to the cases of tests/test_ingest_probe.py: a clean checkpoint, NaN
values and a missing index entry, an empty directory, the CLI. The
reference's `--stablehlo` lowering has no counterpart in the port: the
flag is refused with a message. The port also holds each tensor the
loader reads against the shape the config implies, through the family's
param_shapes, and reads a whole checkpoint the port itself writes."""

import json
import struct

import numpy as np
import pytest

from llmlb_tpu.tools import ingest_probe as jprobe
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.safetensors_io import save_sharded
from llmlb_tpu_torch.engine.weights import hf_config, hf_tensors
from llmlb_tpu_torch.models import llama
from llmlb_tpu_torch.tools.ingest_probe import main, probe_checkpoint

import torch


def _write_safetensors(path, tensors: dict):
    header, blobs, offset = {}, [], 0
    for name, arr in tensors.items():
        data = arr.tobytes()
        dtype = {"float32": "F32", "float16": "F16", "int32": "I32",
                 "float64": "F64"}[str(arr.dtype)]
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)


CONFIG = {"vocab_size": 16, "hidden_size": 8, "intermediate_size": 16,
          "num_hidden_layers": 2, "num_attention_heads": 2,
          "num_key_value_heads": 2, "max_position_embeddings": 64,
          "rms_norm_eps": 1e-6, "rope_theta": 10000.0}


@pytest.fixture
def good_ckpt(tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    _write_safetensors(str(d / "model.safetensors"), {
        "model.embed_tokens.weight": np.ones((16, 8), np.float32),
        "lm_head.weight": np.ones((16, 8), np.float32),
    })
    (d / "config.json").write_text(json.dumps(CONFIG))
    return d


def test_probe_reports_clean_checkpoint(good_ckpt):
    report = probe_checkpoint(str(good_ckpt))
    want = jprobe.probe_checkpoint(str(good_ckpt))
    assert report.tensor_count == want.tensor_count == 2
    assert report.total_bytes == want.total_bytes > 0
    assert report.config == want.config
    assert report.config["num_layers"] == 2
    assert report.ok, report.findings


def test_probe_flags_nan_and_missing_index(tmp_path):
    d = tmp_path / "bad"
    d.mkdir()
    arr = np.ones((8, 8), np.float32)
    arr[3, 3] = np.nan
    _write_safetensors(str(d / "model.safetensors"), {"w": arr})
    (d / "model.safetensors.index.json").write_text(json.dumps({
        "weight_map": {"w": "model.safetensors",
                       "missing.weight": "model-00002.safetensors"}}))
    report = probe_checkpoint(str(d))
    joined = " ".join(report.findings)
    assert "non-finite" in joined
    assert "missing from" in joined
    assert "no config.json" in joined
    assert not report.ok


def test_probe_empty_dir(tmp_path):
    report = probe_checkpoint(str(tmp_path))
    assert not report.ok
    assert "no .safetensors" in report.findings[0]


def test_probe_cli(good_ckpt, capsys):
    rc = main([str(good_ckpt)])
    printed = json.loads(capsys.readouterr().out)
    assert rc == 0, printed
    assert printed["ok"] is True and printed["tensor_count"] == 2


def test_probe_cli_refuses_stablehlo(good_ckpt, tmp_path, capsys):
    out = tmp_path / "prefill.stablehlo"
    with pytest.raises(SystemExit) as e:
        main([str(good_ckpt), "--stablehlo", str(out)])
    assert e.value.code == 2
    assert "--stablehlo has no counterpart" in capsys.readouterr().err
    assert not out.exists()


def test_probe_flags_dtypes_shapes_and_layers(tmp_path):
    d = tmp_path / "shapes"
    d.mkdir()
    _write_safetensors(str(d / "model.safetensors"), {
        "model.embed_tokens.weight": np.ones((16, 8), np.float32),
        "lm_head.weight": np.ones((8, 16), np.float32),  # not transposed
        "model.layers.0.input_layernorm.weight": np.ones((8,), np.float16),
        "counts": np.arange(4, dtype=np.int32),
        "wide": np.ones((2,), np.float64),
    })
    (d / "config.json").write_text(json.dumps(CONFIG))
    report = probe_checkpoint(str(d))
    assert report.dtypes == {"F32": 2, "F16": 1, "I32": 1, "F64": 1}
    findings = " | ".join(report.findings)
    assert "lm_head.weight: shape [8, 16], the config implies [16, 8]" in \
        findings
    assert "wide: unsupported dtype F64" in findings
    assert "config says 2 layers but shards carry 1" in findings
    assert len(report.findings) == 3


def test_probe_passes_a_checkpoint_the_port_writes(tmp_path):
    cfg = get_preset("debug-tiny")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    save_sharded(hf_tensors(params, cfg), str(tmp_path), 2)
    (tmp_path / "config.json").write_text(json.dumps(hf_config(cfg)))
    report = probe_checkpoint(str(tmp_path))
    assert report.ok, report.findings
    assert len(report.shards) == 2
    assert report.config["num_layers"] == cfg.num_layers
