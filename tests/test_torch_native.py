"""The port's native core (llmlb_tpu_torch/native/) held against its Python
twins and against the JAX package's native core.

- The build: the library is compiled from the port's own sources into
  llmlb_tpu_torch/_build/, and nothing under the repository's root
  `native/` is opened, compiled or loaded; three processes building into
  one empty directory at once compile it once and all load it.
- The router core: the port's LoadManager on its native core against its
  Python core and against the JAX package's native LoadManager, on the
  reference's randomized, tie-break, round-robin, rejected-sample and
  seed/snapshot traces (tests/gateway/test_native_router.py), and on
  tests/test_torch_gateway_units.py's seeded scripts with prompt heads.
- The SSE scanner against the Python accumulator and the JAX package's
  scanner, on the reference's cases and its chunk-boundary fuzz.
- `native_chain_hash` against hashlib, `native_ct_equal` against
  `hmac.compare_digest`, and an audit chain written by either package
  (each on its native hash) verifies in the other.

These tests build the library here and FAIL when it cannot be built: the
Python twins must not pass for it.
"""

import hashlib
import hmac
import json
import random
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from llmlb_tpu import native as ref_native
from llmlb_tpu.gateway import audit as ref_audit
from llmlb_tpu.gateway import balancer as ref_balancer
from llmlb_tpu.gateway import config as ref_config
from llmlb_tpu.gateway import types as ref_types
from llmlb_tpu.gateway.db import Database as RefDatabase
from llmlb_tpu_torch import native
from llmlb_tpu_torch.gateway import audit, balancer, config, types
from llmlb_tpu_torch.gateway.db import Database
from llmlb_tpu_torch.gateway.token_accounting import StreamingTokenAccumulator
from tests.test_torch_gateway_audit import _entries
from tests.test_torch_gateway_units import load_manager_script

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.ensure_native_built(), (
        f"the port's native library did not build: {native.BUILD_INFO}")
    assert native.load_native() is not None
    assert ref_native.ensure_native_built() and \
        ref_native.load_native() is not None, \
        "the JAX package's native library did not build"


# ------------------------------------------------------------------ build


BUILD_PROBE = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    events = []
    def hook(name, args):
        if name == "open" and isinstance(args[0], (str, bytes)):
            events.append(["open", str(args[0])])
        elif name == "subprocess.Popen":
            events.append(["exec", [str(a) for a in args[1]]])
        elif name == "ctypes.dlopen":
            events.append(["dlopen", str(args[0])])
    sys.addaudithook(hook)
    from llmlb_tpu_torch import native
    native.BUILD_DIR = Path(sys.argv[1])
    ok = native.ensure_native_built()
    lib = native.load_native()
    print(json.dumps({"ok": ok, "loaded": lib is not None,
                      "info": native.BUILD_INFO, "events": events}))
""")


def _probe_builds(build_dir: Path, n: int) -> list[dict]:
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_PROBE,
                               str(build_dir)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(n)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


def test_builds_from_the_ports_sources_only(tmp_path):
    """Three processes build into one empty directory at once: one
    compiles, the others wait on the lock and load the same library; the
    compiler is given the port's three sources and nothing else, and no
    process opens or loads anything under the root native/."""
    outs = _probe_builds(tmp_path, 3)
    root_native = str(REPO / "native")
    port_dir = REPO / "llmlb_tpu_torch" / "native"
    assert all(o["ok"] and o["loaded"] for o in outs)
    assert sorted(o["info"]["cached"] for o in outs) == [False, True, True]
    lib = Path(outs[0]["info"]["path"])
    assert lib.parent == tmp_path and lib.name.startswith("libllmlb_native_")
    assert [p.name for p in tmp_path.iterdir() if p.suffix == ".so"] == \
        [lib.name]  # no temporary left behind
    compiles = [e[1] for o in outs for e in o["events"] if e[0] == "exec"]
    assert len(compiles) == 1
    sources = [Path(a) for a in compiles[0] if a.endswith(".cpp")]
    assert sources == [port_dir / s for s in native.SOURCES]
    for flag in ("-O2", "-std=c++17", "-fPIC", "-shared"):
        assert flag in compiles[0]
    for o in outs:
        loads = [e[1] for e in o["events"]
                 if e[0] == "dlopen" and "llmlb_native" in e[1]]
        assert loads == [str(lib)]
        touched = [e[1] for e in o["events"] if e[0] in ("open", "dlopen")]
        assert not [t for t in touched if t.startswith(root_native + "/")]
    # the library the gateway loads lives in the package's build directory
    assert native.lib_path().parent == REPO / "llmlb_tpu_torch" / "_build"
    assert native.lib_path().is_file()


def test_a_changed_source_names_another_library(monkeypatch, tmp_path):
    """The library's name is a hash of the sources and flags: an edited
    source (here a copy with one more line) builds anew."""
    before = native.lib_path().name
    for name in native.SOURCES:
        (tmp_path / name).write_bytes((native.NATIVE_DIR / name).read_bytes())
    with open(tmp_path / "sse_scan.cpp", "a") as f:
        f.write("\n// edited\n")
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)
    assert native.lib_path().name != before


# ------------------------------------------------------------ router core


def _endpoint(mod, i: int, pressure: float | None = None,
              queue_depth: int = 0):
    ep = mod.Endpoint(
        name=f"e{i}", base_url=f"http://e{i}:1", id=f"ep{i}",
        endpoint_type=mod.EndpointType.OPENAI_COMPATIBLE,
        status=mod.EndpointStatus.ONLINE,
    )
    if pressure is not None or queue_depth:
        ep.accelerator = mod.AcceleratorInfo(
            hbm_used_bytes=int((pressure or 0.0) * 1_000_000),
            hbm_total_bytes=1_000_000, queue_depth=queue_depth,
            sampled_at=time.time())
    return ep


class _Side:
    """One LoadManager and the endpoints of its package."""

    def __init__(self, bal, cfg, mod, native_core: bool):
        self.lm = bal.LoadManager(cfg.QueueConfig(max_active_per_endpoint=3),
                                  use_native=native_core)
        assert (self.lm._rc is not None) == native_core
        self.mod = mod
        self.chat = mod.TpsApiKind.CHAT


def _sides() -> dict:
    return {"port-native": _Side(balancer, config, types, True),
            "port-python": _Side(balancer, config, types, False),
            "jax-native": _Side(ref_balancer, ref_config, ref_types, True)}


def _tps(v: float | None):
    """An EMA to 12 significant digits (the reference's rel=1e-12)."""
    return None if v is None else float(f"{v:.12g}")


def _trace_randomized(sides):
    rng = random.Random(7)
    eps = {k: [_endpoint(s.mod, i) for i in range(4)]
           for k, s in sides.items()}
    leases = {k: [] for k in sides}
    seen = []
    for step in range(400):
        op = rng.random()
        if op < 0.35:
            eid, model = f"ep{rng.randrange(4)}", rng.choice(["m0", "m1"])
            tokens, dur = rng.randrange(1, 500), rng.uniform(0.01, 3.0)
            for s in sides.values():
                s.lm.update_tps(eid, model, s.chat, tokens, dur)
        elif op < 0.7:
            model = rng.choice(["m0", "m1"])
            got = {k: s.lm.try_admit(eps[k], model, s.chat)
                   for k, s in sides.items()}
            seen.append((step, {k: g and g[0].id for k, g in got.items()}))
            for k, g in got.items():
                if g is not None:
                    leases[k].append(g[1])
        elif op < 0.9:
            if leases["port-native"]:
                i = rng.randrange(len(leases["port-native"]))
                for k in sides:
                    leases[k].pop(i).complete()
        else:
            eid = f"ep{rng.randrange(4)}"
            for s in sides.values():
                s.lm.clear_tps_for_endpoint(eid)
        seen.append((step, {
            k: ([s.lm.active_count(f"ep{i}") for i in range(4)],
                [_tps(s.lm.get_tps(f"ep{i}", m, s.chat)) for i in range(4)
                 for m in ("m0", "m1")])
            for k, s in sides.items()}))
    return seen


def _trace_tiebreak(sides):
    out = []
    for k, s in sides.items():
        eps = [_endpoint(s.mod, 0, pressure=0.99),
               _endpoint(s.mod, 1, pressure=0.2)]
        out.append([s.lm.select_endpoint(eps, "m", s.chat).id
                    for _ in range(4)])
    assert out[0] == ["ep1"] * 4
    return out


def _trace_round_robin(sides):
    out = []
    for s in sides.values():
        eps = [_endpoint(s.mod, i) for i in range(3)]
        out.append([s.lm.select_endpoint(eps, "m", s.chat).id
                    for _ in range(7)])
    assert len(set(out[0][:3])) == 3  # a genuine rotation
    return out


def _trace_rejected_samples(sides):
    out = []
    for s in sides.values():
        s.lm.update_tps("ep0", "m", s.chat, 0, 1.0)
        s.lm.update_tps("ep0", "m", s.chat, 10, 0.0)
        out.append((s.lm.stats()["tracked_tps_keys"], s.lm.tps_snapshot()))
    assert out[0] == (0, {})
    return out


def _trace_seed_snapshot(sides):
    out = []
    for s in sides.values():
        s.lm.seed_tps("ep0", "m", s.chat, 123.456, samples=5)
        s.lm.update_tps("ep0", "m", s.chat, 100, 1.0)
        snap = s.lm.tps_snapshot()["ep0:m:chat"]
        out.append((round(snap["ema_tps"], 9), snap["samples"]))
    return out


def _same(values: list, name: str) -> None:
    for v in values[1:]:
        assert v == values[0], name


@pytest.mark.parametrize("trace", ["randomized", "tiebreak", "round_robin",
                                   "rejected_samples", "seed_snapshot"])
def test_router_core_traces(trace):
    sides = _sides()
    seen = globals()[f"_trace_{trace}"](sides)
    if trace == "randomized":
        for step, by_side in seen:
            _same(list(by_side.values()), f"step {step}")
        stats = [s.lm.stats() for s in sides.values()]
        for key in ("total_requests", "active_requests", "tracked_tps_keys"):
            _same([st[key] for st in stats], key)
        assert [st.get("native_router") for st in stats] == [True, None,
                                                             True]
    else:
        _same(seen, trace)


@pytest.mark.parametrize("seed,mode", [(s, m) for s in range(4)
                                       for m in ("lru", "ring")])
def test_native_load_managers_match_on_scripts(seed, mode, monkeypatch):
    """tests/test_torch_gateway_units.py's scripts (admissions with prompt
    heads in both affinity modes, failures, clears) through both packages'
    native cores."""
    load_manager_script(seed, mode, monkeypatch, native=True)


def test_hrw_owner_and_ct_equal_match():
    ids = [f"endpoint-{i}" for i in range(9)]
    for k in range(200):
        key = hashlib.sha256(str(k).encode()).hexdigest()
        idx = native.native_hrw_select(key, ids)
        assert ids[idx] == balancer.hrw_owner(key, ids)
        assert idx == ref_native.native_hrw_select(key, ids)
    assert native.native_hrw_select("k", []) == -1
    cases = [
        (b"", b""), (b"a", b"a"), (b"a", b"b"), (b"a", b""),
        (b"sk_" + b"x" * 43, b"sk_" + b"x" * 43),
        (b"sk_" + b"x" * 43, b"sk_" + b"x" * 42 + b"y"),
        (b"\x00\x01\x02", b"\x00\x01\x02"), (b"\x00\x01\x02", b"\x00\x01\x03"),
        (b"abc", b"abcd"), (b"abcd", b"abc"),
    ]
    for a, b in cases:
        assert native.native_ct_equal(a, b) is hmac.compare_digest(a, b)
        assert native.native_ct_equal(a, b) == ref_native.native_ct_equal(a, b)


# ------------------------------------------------------------- SSE scanner


def _sse_frames(payloads):
    return b"".join(
        b"data: " + json.dumps(p).encode() + b"\n\n" for p in payloads
    ) + b"data: [DONE]\n\n"


def test_sse_scanner_cases():
    stream = _sse_frames([
        {"choices": [{"delta": {"content": "hel"}}]},
        {"choices": [{"delta": {"content": "lo"}}]},
        {"choices": [], "usage": {"prompt_tokens": 11,
                                  "completion_tokens": 2}},
    ])
    scanner = native.NativeSseScanner()
    for i in range(0, len(stream), 7):
        scanner.feed(stream[i:i + 7])
    assert (scanner.frames, scanner.usage()) == (3, (11, 2))
    acc = StreamingTokenAccumulator()
    assert acc._native is not None  # the gateway's accumulator runs native
    for i in range(0, len(stream), 7):
        acc.feed(stream[i:i + 7])
    assert acc.finalize() == (11, 2, True)
    responses = native.NativeSseScanner()
    responses.feed(_sse_frames([
        {"type": "response.output_text.delta", "delta": "x"},
        {"type": "response.completed", "response": {},
         "usage": {"input_tokens": 4, "output_tokens": 9}}]))
    assert responses.usage() == (4, 9)
    # no usage: the native accumulator estimates from the retained bytes,
    # as the Python one does
    raw = _sse_frames([{"choices": [{"delta": {"content": "x" * 40}}]}])
    empty = native.NativeSseScanner()
    empty.feed(raw)
    assert empty.usage() is None
    fast, slow = StreamingTokenAccumulator(), StreamingTokenAccumulator()
    slow._native = None
    for a in (fast, slow):
        a.feed(raw)
    assert fast.finalize("p" * 20) == slow.finalize("p" * 20) == (5, 10,
                                                                   False)


def _random_stream(rng) -> bytes:
    frames = []
    for i in range(rng.randrange(1, 12)):
        roll = rng.random()
        if roll < 0.5:
            frames.append({"choices": [{"delta": {
                "content": f"tok{i}" * rng.randrange(1, 4)}}]})
        elif roll < 0.65:
            frames.append({"choices": [], "usage": {
                "prompt_tokens": rng.randrange(0, 500),
                "completion_tokens": rng.randrange(0, 500)}})
        elif roll < 0.75:
            frames.append({"type": "response.output_text.delta",
                           "delta": "x" * rng.randrange(1, 30)})
        elif roll < 0.85:
            frames.append({"choices": [{"delta": {}}], "usage": {
                "input_tokens": rng.randrange(0, 99),
                "output_tokens": rng.randrange(0, 99)}})
        else:
            frames.append({"choices": [{"delta": {
                "content": 'q"u\\o✓te'}}]})
    raw = b""
    for f in frames:
        raw += (rng.choice([b"data: ", b"data:", b"data:  "])
                + json.dumps(f).encode()
                + rng.choice([b"\n\n", b"\r\n\r\n", b"\n"]))
        if rng.random() < 0.2:
            raw += rng.choice([b": keepalive\n", b"event: ping\n", b"\n",
                               b"data:\n"])
    if rng.random() < 0.8:
        raw += b"data: [DONE]\n\n"
    return raw


def test_sse_scanner_chunk_boundary_fuzz():
    """The reference's parity fuzz: identical streams split at random
    boundaries through the port's scanner, the JAX package's scanner and
    the port's Python splitter: the same frame counts and usage."""
    rng = random.Random(0xC0FFEE)
    for case in range(50):
        stream = _random_stream(rng)
        chunks, pos = [], 0
        while pos < len(stream):
            step = rng.randrange(1, 24)
            chunks.append(stream[pos:pos + step])
            pos += step
        ours, ref = native.NativeSseScanner(), ref_native.NativeSseScanner()
        acc = StreamingTokenAccumulator()
        acc._native = None  # the pure-Python splitter
        acc._raw = None
        for c in chunks:
            ours.feed(c)
            ref.feed(c)
            acc._feed_python(c)
        assert ours.frames == ref.frames == acc._chunks_seen, case
        assert ours.usage() == ref.usage(), case
        if acc._usage is not None and acc._usage != (0, 0):
            assert ours.usage() == acc._usage, case


# --------------------------------------------------------------- the chain


def test_chain_hash_matches_hashlib():
    prev = "0" * 64
    for entries in ([b'["a",1]', b'["b",2]', "unicode-é".encode()], [],
                    [b"x" * 100_000, b"y"]):
        want = hashlib.sha256(prev.encode() + b"".join(entries)).hexdigest()
        assert native.native_chain_hash(prev, entries) == want
        assert ref_native.native_chain_hash(prev, entries) == want


def test_audit_chain_written_natively_verifies_in_both(tmp_path, monkeypatch):
    """Batches appended in turn by both packages' AuditLogs to one file,
    each hashing through its native library: both verify the chain."""
    calls = {"port": 0, "jax": 0}

    def counting(mod, who):
        real = mod.native_chain_hash

        def wrapped(prev, entries):
            calls[who] += 1
            return real(prev, entries)
        return wrapped

    monkeypatch.setattr(native, "native_chain_hash",
                        counting(native, "port"))
    monkeypatch.setattr(ref_native, "native_chain_hash",
                        counting(ref_native, "jax"))
    path = str(tmp_path / "llmlb.db")
    ref_db, port_db = RefDatabase(path), Database(path)
    logs = [(ref_audit.AuditLog(ref_db), ref_audit.AuditEntry),
            (audit.AuditLog(port_db), audit.AuditEntry)]
    for i in range(4):
        log, cls = logs[i % 2]
        for e in _entries(20 + i, 2 + i, cls):
            log.record(e)
        assert log.flush() == i + 1
    assert [log.verify() for log, _ in logs] == [(True, None)] * 2
    assert calls["port"] >= 2 and calls["jax"] >= 2
    ref_db.close()
    port_db.close()
