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
                 "engine.safetensors_io", "kernels.build", "ops.grammar",
                 "structured.constraint", "structured.regex_dfa",
                 "structured.json_schema", "structured.openai_api",
                 "engine.stepstats", "engine.flightrec", "engine.metrics",
                 "engine.telemetry", "engine.profiling", "engine.cuda_probe",
                 "engine.dispatch_check", "ops.moe", "models.mixtral",
                 "models", "disagg", "disagg.wire", "disagg.split",
                 "models.whisper", "models.tts", "models.diffusion",
                 "models._common",
                 "engine.asr", "engine.tts", "engine.image",
                 "tools.ingest_probe", "parallel", "parallel.mesh",
                 "parallel.sharding", "parallel.distributed",
                 "engine.multihost", "ops.ring_attention",
                 "disagg.gateway", "lora.gateway", "gateway",
                 "gateway.http", "gateway.types", "gateway.config",
                 "gateway.db", "gateway.auth", "gateway.registry",
                 "gateway.model_names", "gateway.detection",
                 "gateway.model_sync", "gateway.engine_metadata",
                 "gateway.health", "gateway.balancer",
                 "gateway.faults", "gateway.resilience", "gateway.sanitize",
                 "gateway.token_accounting", "gateway.tracing",
                 "gateway.metrics", "gateway.replay", "gateway.gate",
                 "gateway.ratelimit", "gateway.api_openai",
                 "gateway.api_admin", "gateway.app_state", "gateway.app",
                 "gateway.server", "gateway.api_anthropic",
                 "gateway.api_media", "gateway.api_cloud",
                 "gateway.api_models", "gateway.audit",
                 "gateway.system_info", "gateway.events",
                 "gateway.api_dashboard", "gateway.api_benchmarks",
                 "gateway.logging_setup", "gateway.worker",
                 "gateway.gossip", "gateway.rebalance", "native",
                 "gateway.update", "gateway.update_source", "gateway.lock",
                 "gateway.tray", "gateway.assistant"):
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


def test_gateway_serves_without_aiohttp_argon2_jax_or_torch(tmp_path):
    """`python -m llmlb_tpu_torch.gateway.server serve` with aiohttp,
    argon2, jax and llmlb_tpu made unimportable (as on the card's machine)
    starts, answers /health, logs in and verifies its audit chain (the
    audit middleware recorded both requests), serves the dashboard and
    tails its own log file under LLMLB_LOG_DIR, stops on SIGTERM, and never
    loads torch or tiktoken (whose first use fetches a BPE file over the
    network)."""
    import os
    import signal
    import urllib.request

    code = (
        "import atexit, json, runpy, sys\n"
        "for n in ('aiohttp', 'argon2', 'jax', 'llmlb_tpu'):\n"
        "    sys.modules[n] = None\n"
        "watch = ('torch', 'tiktoken', 'aiohttp', 'argon2', 'jax',\n"
        "         'llmlb_tpu')\n"
        "atexit.register(lambda: print(json.dumps(sorted(\n"
        "    m for m, v in sys.modules.items()\n"
        "    if v is not None and m.split('.')[0] in watch)), flush=True))\n"
        "sys.argv = ['server', 'serve', '--host', '127.0.0.1', '--port', '0']\n"
        "runpy.run_module('llmlb_tpu_torch.gateway.server',\n"
        "                 run_name='__main__')\n"
    )
    env = {**os.environ, "LLMLB_DATA_DIR": str(tmp_path),
           "LLMLB_ADMIN_PASSWORD": "adminpass1",
           "LLMLB_LOG_DIR": str(tmp_path / "logs")}
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        port = None
        for _ in range(200):
            line = proc.stderr.readline()
            if not line:
                break
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert port, proc.stderr.read() if proc.poll() is not None else ""
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}

        def post(path, body, headers=None):
            req = urllib.request.Request(
                base + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json",
                         **(headers or {})})
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())

        token = post("/api/auth/login", {"username": "admin",
                                         "password": "adminpass1"})["token"]
        admin = {"Authorization": f"Bearer {token}"}
        assert post("/api/audit-log/verify", {}, admin) == {
            "ok": True, "error": None}
        req = urllib.request.Request(base + "/api/audit-log", headers=admin)
        with urllib.request.urlopen(req, timeout=30) as r:
            paths = [e["path"] for e in json.loads(r.read())["entries"]]
        # newest first; verify flushed the two before it
        assert paths[-2:] == ["/api/auth/login", "/health"]
        with urllib.request.urlopen(base + "/dashboard", timeout=30) as r:
            assert r.read() == (REPO / "llmlb_tpu_torch" / "gateway" /
                                "dashboard_static" / "index.html").read_bytes()
        req = urllib.request.Request(base + "/api/dashboard/logs/lb",
                                     headers=admin)
        with urllib.request.urlopen(req, timeout=30) as r:
            tail = json.loads(r.read())
        assert tail["path"] == str(tmp_path / "logs" / "llmlb.log")
        assert any("w0 llmlb_tpu_torch.gateway.server: llmlb_tpu_torch "
                   "gateway listening on" in ln for ln in tail["lines"])
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert json.loads(out.strip().splitlines()[-1]) == []
    assert (tmp_path / "llmlb.db").exists()


def test_gateway_has_every_module_of_the_reference():
    """The port's gateway has a counterpart of each of the reference
    gateway's files; its only file of its own is http.py (the aiohttp
    subset on the standard library)."""
    def files(pkg):
        return {p.name for p in (REPO / pkg / "gateway").iterdir()
                if p.suffix == ".py" or p.name == "dashboard_static"}

    ours, ref = files("llmlb_tpu_torch"), files("llmlb_tpu")
    assert ref - ours == set()
    assert ours - ref == {"http.py"}


def test_gateway_workers_import_no_torch():
    """Every module of the gateway, the multi-worker supervisor
    (gateway/worker.py) and the gossip bus (gateway/gossip.py) among them,
    imports with torch, jax and llmlb_tpu unimportable: a worker the
    supervisor forks never holds a CUDA context it could not use.
    tests/test_torch_gateway_multiworker.py serves `--workers 2` so."""
    gateway = [m for m in _port_modules()
               if m.startswith("llmlb_tpu_torch.gateway")]
    assert {"llmlb_tpu_torch.gateway.worker",
            "llmlb_tpu_torch.gateway.gossip"} <= set(gateway)
    code = (
        "import importlib, json, sys\n"
        "for n in ('torch', 'jax', 'llmlb_tpu', 'aiohttp', 'argon2'):\n"
        "    sys.modules[n] = None\n"
        f"for m in {gateway!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m, v in sys.modules.items()\n"
        "                        if v is not None)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if m.split(".")[0] in (
        "torch", "jax", "llmlb_tpu", "aiohttp", "argon2", "tiktoken")] == []


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
