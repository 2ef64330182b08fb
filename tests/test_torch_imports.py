"""Import hygiene and device rules of the PyTorch port.

The port (and chip_smoke.py, which drives it on the card) must import
neither JAX nor anything of the JAX package `llmlb_tpu`. Note the port's own
name starts with "llmlb_tpu": the check matches the module `llmlb_tpu` and
the prefix `llmlb_tpu.` only.
"""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import llmlb_tpu_torch
from llmlb_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parent.parent


def _is_forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "llmlb_tpu" or name.startswith("llmlb_tpu."))


def _port_modules() -> list[str]:
    return ["llmlb_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(llmlb_tpu_torch.__path__,
                                              "llmlb_tpu_torch.")
    ]


def test_forbidden_name_check():
    assert _is_forbidden("jax") and _is_forbidden("llmlb_tpu.ops")
    assert _is_forbidden("llmlb_tpu")
    assert not _is_forbidden("llmlb_tpu_torch")
    assert not _is_forbidden("llmlb_tpu_torch.ops.attention")
    assert not _is_forbidden("jaxlib_like")


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = _port_modules()
    assert "llmlb_tpu_torch.engine.server" in modules
    assert "llmlb_tpu_torch.ops.cuda_attention" in modules
    assert "llmlb_tpu_torch.quant.core" in modules
    assert "llmlb_tpu_torch.ops._threefry" in modules
    for name in ("lora", "lora.api", "lora.store", "lora.manager", "ops.lora",
                 "engine.safetensors_io", "kernels.build"):
        assert f"llmlb_tpu_torch.{name}" in modules
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if _is_forbidden(m)] == []


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert any(n.startswith("llmlb_tpu_torch") for n in names)
    assert [n for n in names if _is_forbidden(n)] == []


def test_default_device_is_the_card(monkeypatch):
    """No device argument means CUDA; on a host without it, construction
    raises instead of running on the CPU. The CPU only on request."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.engine.scheduler import EngineCore

    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineCore(get_preset("debug-tiny"))
    assert resolve_device("cpu") == torch.device("cpu")
