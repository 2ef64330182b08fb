"""The port's assistant CLI (llmlb_tpu_torch/gateway/assistant.py) against
the JAX package's (llmlb_tpu/gateway/assistant.py).

- `parse_curl`, `_validate_url` and `mask_sensitive` give the same results,
  or the same rejection, on a grid of commands taken from
  `tests/gateway/test_assistant.py` and widened around each rule (the
  forbidden patterns and options, the host whitelist, the options parsed);
- `openapi_summary()` lists the same paths and `GUIDES` has the same keys;
  the guides name the port's own engine module;
- `run_curl` against each package's gateway in-process (auto-auth from
  LLMLB_API_KEY or LLMLB_TOKEN, no redirect followed, an unreachable host)
  answers the same;
- `python -m llmlb_tpu_torch.gateway.server assistant ...` runs with
  aiohttp, torch and jax unimportable and prints what the reference's
  `main` prints.
"""

import asyncio
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from llmlb_tpu.gateway import assistant as ref
from llmlb_tpu_torch.gateway import assistant
from tests.support import ADMIN_PASSWORD

REPO = Path(__file__).resolve().parent.parent
ROUTER = "http://localhost:32768"


@pytest.fixture(autouse=True)
def _no_tiktoken(monkeypatch):
    """The reference gateway's tiktoken path would fetch a BPE file over the
    network (ROADMAP C15)."""
    monkeypatch.setitem(sys.modules, "tiktoken", None)


def _outcome(mod, fn, *args):
    try:
        return ("ok", getattr(mod, fn)(*args))
    except mod.CurlRejected as e:
        return ("rejected", str(e))


_URL = "http://localhost:32768/v1/models"
COMMANDS = [
    # shell metacharacters and redirection
    f"curl {_URL}; rm -rf /", f"curl {_URL} | sh", f"curl {_URL} && id",
    "curl $(evil) http://localhost:32768/", "curl ${HOME} /x",
    "curl http://localhost:32768/ > /etc/passwd",
    "curl http://localhost:32768/ >> out", "curl /x < ~/secret",
    "curl `id` http://localhost:32768/",
    # forbidden options, alone and with '='
    *(f"curl {opt} {_URL}" for opt in (
        "-o /tmp/x", "--output /tmp/x", "--output=/tmp/x", "-O", "-K cfg",
        "--config=cfg", "-q", "--netrc", "--netrc-file f", "-u user:pass",
        "--user=u:p", "--trace log", "--trace-ascii x", "--libcurl x",
        "--proto =http", "-F a=@/etc/passwd", "--form a=b",
        "-T /etc/passwd", "--upload-file=x", "--delegation always")),
    "curl -d @/etc/passwd http://localhost:32768/x",
    "curl --data-binary @body.json /x",
    # the host whitelist and bare paths
    f"curl {_URL}", "curl http://127.0.0.1:32768/v1/models",
    "curl http://[::1]:32768/v1/models", "curl /v1/models",
    "curl http://evil.example/v1/models", "curl http://localhost:9999/x",
    "curl ftp://localhost:32768/x", "curl https://localhost:32768/x",
    "curl http://localhost/x", "curl file:///etc/passwd",
    # methods, headers, bodies, timeouts, no-ops
    'curl -X PUT -H "X-Thing: 1" -d \'{"a":1}\' /api/endpoints/xyz',
    "curl -d '{}' /x", "curl --request delete /api/endpoints/e1",
    'curl --json \'{"b": 2}\' /v1/chat/completions',
    'curl -H "content-type: text/plain" --json \'{"b": 2}\' /x',
    "curl --data-raw hello --data-ascii again /x",
    'curl -H "Authorization: Bearer sk_abc" -H "x-api-key: k" /x',
    "curl -m 5 /x", "curl --max-time 0.2 /x", "curl -m 9999 /x",
    "curl -m soon /x", "curl -s -S -i -L -k -v --compressed -g /x",
    "curl --silent --show-error --include --location --insecure "
    "--verbose --globoff /x",
    # malformed
    "curl", "curl -X", "curl -H", "curl /a /b", "wget /x", "", "   ",
    "curl 'unclosed /x", "curl --frobnicate /x", "curl -Z /x",
]


@pytest.mark.parametrize("router", [ROUTER, "http://127.0.0.1:8080",
                                    "https://gw.example", "http://gw:80"])
def test_parse_curl_matches_the_jax_package(router):
    got = [_outcome(assistant, "parse_curl", c, router) for c in COMMANDS]
    want = [_outcome(ref, "parse_curl", c, router) for c in COMMANDS]
    assert got == want
    if router == ROUTER:
        assert sum(o == "ok" for o, _ in got) == 17
        assert sum(o == "rejected" for o, _ in got) == 47


URLS = ["/v1/models", "v1/models", "http://localhost:32768/x",
        "http://127.0.0.1:32768/x", "http://[::1]:32768/x",
        "http://LOCALHOST:32768/x", "http://gw.example/x",
        "https://gw.example/x", "https://gw.example:443/x",
        "http://gw.example:80/x", "http://gw.example:8080/x",
        "javascript:alert(1)", "http:///x", "//gw.example/x"]


@pytest.mark.parametrize("router", [ROUTER, "https://gw.example",
                                    "http://gw.example", "http://[::1]:9"])
def test_validate_url_matches_the_jax_package(router):
    assert [_outcome(assistant, "_validate_url", u, router) for u in URLS] \
        == [_outcome(ref, "_validate_url", u, router) for u in URLS]


def test_mask_sensitive_matches_the_jax_package():
    texts = [
        'curl -H "Authorization: Bearer sk_abc123" -H "x-api-key: sk_zzz" /x',
        "Bearer eyJhbGci.eyJzdWIi.sig-nat_ure", "X-API-Key:   secret /y",
        "key sk_live0099 and sk_ and sk_x", "nothing secret here",
        "bearer lowercase", "Authorization: Bearer\tsk_tab",
        json.dumps({"api_key": "sk_inbody1", "note": "Bearer abc.def"}),
    ]
    got = [assistant.mask_sensitive(t) for t in texts]
    assert got == [ref.mask_sensitive(t) for t in texts]
    assert "sk_abc123" not in got[0] and "Bearer ***" in got[0]


def test_openapi_and_guides_match_the_jax_package():
    assert assistant.openapi_summary() == ref.openapi_summary()
    assert set(assistant.GUIDES) == set(ref.GUIDES)
    text = "\n".join(assistant.GUIDES.values())
    assert "python -m llmlb_tpu_torch.engine.server" in text
    assert "llmlb_tpu.engine" not in text
    assert "TPU engine" not in text and "chip/HBM" not in text
    # every route and variable the reference's guides name stays
    import re

    for key, body in ref.GUIDES.items():
        for token in re.findall(r"(?:/(?:api|v1)/[\w{}/.-]+|LLMLB_\w+)",
                                body):
            assert token in assistant.GUIDES[key], (key, token)


class _Redirector:
    """A server on 127.0.0.1 that answers every GET with a 302 to another
    host and records the Authorization headers it saw."""

    def __init__(self):
        seen = self.seen = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                seen.append(self.headers.get("Authorization"))
                self.send_response(302)
                self.send_header("Location", "http://evil.example/steal")
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = "http://127.0.0.1:%d" % self.srv.server_address[1]
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


async def _curl_session(mod, base: str, key: str, token: str,
                        monkeypatch) -> list:
    """run_curl on a thread (the gateway serves on this loop)."""
    loop = asyncio.get_running_loop()

    async def run(cmd, **kw):
        out = await loop.run_in_executor(
            None, lambda: mod.run_curl(cmd, router_url=base, **kw))
        out["executed_command"] = out["executed_command"].replace(base,
                                                                  "BASE")
        if out.get("body"):
            body = json.loads(out["body"])
            if isinstance(body, dict):
                body.pop("request_id", None)
            out["body"] = body
        return out

    rows = [await run(f"curl {base}/v1/models", api_key=key)]
    monkeypatch.setenv("LLMLB_API_KEY", key)
    rows.append(await run(f"curl -H 'X-Trace: 1' {base}/v1/models"))
    rows.append(await run("curl /api/endpoints"))  # a key is not admin
    monkeypatch.delenv("LLMLB_API_KEY")
    monkeypatch.setenv("LLMLB_TOKEN", token)
    rows.append(await run("curl /api/endpoints"))
    rows.append(await run("curl -X POST /api/system/update/check"))
    rows.append(await run(f'curl -H "Authorization: Bearer {key}" '
                          "/v1/models"))
    monkeypatch.delenv("LLMLB_TOKEN")
    rows.append(await run("curl /v1/models"))
    for row in rows:
        assert key not in row["executed_command"]
        assert token not in row["executed_command"]
    return rows


async def test_run_curl_against_both_gateways_answers_the_same(monkeypatch):
    from tests.test_torch_gateway_e2e import _jax_gateway, _PortGateway
    from llmlb_tpu_torch.gateway import http as gh

    monkeypatch.delenv("LLMLB_API_KEY", raising=False)
    monkeypatch.delenv("LLMLB_TOKEN", raising=False)
    monkeypatch.setenv("LLMLB_ADMIN_PASSWORD", ADMIN_PASSWORD)
    jgw, jbase = await _jax_gateway()
    pgw = await _PortGateway.create()
    got = {}
    try:
        for name, mod, base in (("jax", ref, jbase),
                                ("port", assistant, pgw.url)):
            async with gh.ClientSession() as s:
                r = await s.post(base + "/api/auth/login", json={
                    "username": "admin", "password": ADMIN_PASSWORD})
                token = (await r.json())["token"]
                r = await s.post(base + "/api/api-keys", json={
                    "name": "a", "permissions": ["openai.inference",
                                                 "openai.models.read"]},
                    headers={"Authorization": f"Bearer {token}"})
                key = (await r.json())["api_key"]
            got[name] = await _curl_session(mod, base, key, token,
                                            monkeypatch)
    finally:
        await jgw.close()
        await pgw.close()
    assert got["port"] == got["jax"]
    assert [r["status"] for r in got["port"]] == [200, 200, 403, 200, 501,
                                                  200, 401]

    redirector = _Redirector()
    try:
        rows = [m.run_curl("curl /x", router_url=redirector.url,
                           api_key="sk_secret") for m in (ref, assistant)]
    finally:
        redirector.close()
    assert rows[0] == rows[1]
    assert rows[1]["status"] == 302
    assert redirector.seen == ["Bearer sk_secret"] * 2  # never forwarded
    down = [m.run_curl("curl /x", router_url="http://127.0.0.1:1")
            for m in (ref, assistant)]
    assert down[0] == down[1] and down[1]["status"] is None


CLI_ARGS = [[], ["openapi"], ["guide"], ["guide", "update"],
            ["guide", "nonsense"], ["curl"], ["curl", "curl", "/x;", "id"],
            ["bogus"]]

# One process for every case: `server.main(["assistant", ...])` with
# aiohttp, torch and jax unimportable, each case's exit code and output.
_CLI = textwrap.dedent("""
    import contextlib, io, json, sys
    for n in ("torch", "aiohttp", "argon2", "jax", "llmlb_tpu"):
        sys.modules[n] = None
    from llmlb_tpu_torch.gateway import server
    rows = []
    for argv in json.loads(sys.argv[1]):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                server.main(["assistant", *argv])
                code = None
            except SystemExit as e:
                code = e.code
        rows.append([code, out.getvalue(), err.getvalue()])
    loaded = sorted(m for m, v in sys.modules.items() if v is not None
                    and m.split(".")[0] in ("torch", "aiohttp", "jax"))
    print(json.dumps({"rows": rows, "loaded": loaded}))
""")


@pytest.fixture(scope="module")
def cli_rows(tmp_path_factory):
    env = {**os.environ,
           "LLMLB_DATA_DIR": str(tmp_path_factory.mktemp("assistant"))}
    out = subprocess.run([sys.executable, "-c", _CLI, json.dumps(CLI_ARGS)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    return dict(zip(map(tuple, CLI_ARGS), got["rows"]))


def _ref_main(argv: list[str]) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = ref.main(argv)
    return code, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", CLI_ARGS,
                         ids=lambda a: "-".join(a) or "none")
def test_cli_prints_what_the_jax_package_prints(argv, cli_rows):
    code, stdout, stderr = _ref_main(argv)
    got = cli_rows[tuple(argv)]
    if argv[:1] != ["guide"] or argv[1:] == ["nonsense"]:
        assert got == [code, stdout, stderr]
    else:
        topic = argv[1] if len(argv) > 1 else "quickstart"
        assert got[0] == code == 0
        assert got[1] == assistant.GUIDES[topic] + "\n"
