"""Assistant CLI: `python -m llmlb_tpu_torch.gateway.server assistant
curl|openapi|guide`.

The port's copy of llmlb_tpu/gateway/assistant.py. Parity with reference
cli/assistant.rs (~1.5k LoC): a safe way for operators (and LLM agents
driving a shell) to poke the gateway API —
- `curl`: executes a curl-like command with injection prevention (shell
  metacharacters and file/credential-touching curl options rejected), a host
  whitelist pinned to the router URL (:442-450), automatic auth-header
  injection from the environment, and secret masking in everything echoed
  back (:635-649). The request itself is made with urllib — no shell, no
  curl binary — so the forbidden-pattern screen is defense in depth, not the
  only wall.
- `openapi`: a machine-readable summary of the API surface.
- `guide`: built-in usage guides per topic.
"""

from __future__ import annotations

import json
import os
import re
import shlex
import sys
import urllib.error
import urllib.parse
import urllib.request

DEFAULT_ROUTER_URL = "http://localhost:32768"
DEFAULT_TIMEOUT_S = 30.0
MAX_TIMEOUT_S = 300.0
LOCALHOST_HOSTNAMES = ("localhost", "127.0.0.1", "::1")

# Shell metacharacters and redirections have no business in a curl line we
# were handed as data (parity: FORBIDDEN_PATTERNS, assistant.rs:53-63).
_FORBIDDEN_PATTERNS = [
    re.compile(r"[;&|`]"),
    re.compile(r"\$\("),
    re.compile(r"\$\{"),
    re.compile(r">>|>\s*[/~]|<\s*[/~]"),
]

# curl options that write files, read local config, or leak credentials
# (parity: FORBIDDEN_OPTIONS, assistant.rs:28-51).
_FORBIDDEN_OPTIONS = {
    "-o", "--output", "-O", "--remote-name", "-K", "--config", "-q",
    "--disable", "-u", "--user", "--netrc", "--netrc-file",
    "--netrc-optional", "--delegation", "--libcurl", "--trace",
    "--trace-ascii", "--trace-time", "--proto", "--proto-default",
    "--proto-redir", "-T", "--upload-file", "-F", "--form",
}

_BEARER_RE = re.compile(r"(Bearer\s+)[A-Za-z0-9._\-]+")
_XAPIKEY_RE = re.compile(r"((?:x-api-key|X-API-Key)\s*:\s*)\S+")
_SK_RE = re.compile(r"sk_[A-Za-z0-9]+")


def mask_sensitive(text: str) -> str:
    """Secrets never round-trip through echoed output (assistant.rs:635-649)."""
    text = _BEARER_RE.sub(r"\1***", text)
    text = _XAPIKEY_RE.sub(r"\1***", text)
    return _SK_RE.sub("sk_***", text)


class CurlRejected(ValueError):
    pass


def parse_curl(command: str, router_url: str) -> dict:
    """Parse a restricted curl grammar into a request spec, rejecting
    anything that could touch the shell, the filesystem, or foreign hosts."""
    for pat in _FORBIDDEN_PATTERNS:
        if pat.search(command):
            raise CurlRejected(
                "command contains shell metacharacters or redirection"
            )
    try:
        tokens = shlex.split(command)
    except ValueError as e:
        raise CurlRejected(f"unparseable command: {e}")
    if not tokens or tokens[0] != "curl":
        raise CurlRejected("command must start with 'curl'")

    spec = {"method": None, "headers": {}, "data": None, "url": None,
            "timeout": DEFAULT_TIMEOUT_S}

    def arg_after(idx: int, opt: str) -> str:
        if idx + 1 >= len(tokens):
            raise CurlRejected(f"curl option {opt!r} is missing its argument")
        return tokens[idx + 1]

    i = 1
    while i < len(tokens):
        tok = tokens[i]
        if tok in _FORBIDDEN_OPTIONS or tok.split("=", 1)[0] in _FORBIDDEN_OPTIONS:
            raise CurlRejected(f"curl option {tok!r} is not allowed")
        if tok in ("-X", "--request"):
            spec["method"] = arg_after(i, tok).upper()
            i += 2
        elif tok in ("-H", "--header"):
            name, _, value = arg_after(i, tok).partition(":")
            spec["headers"][name.strip()] = value.strip()
            i += 2
        elif tok in ("-d", "--data", "--data-raw", "--data-binary",
                     "--data-ascii", "--json"):
            body = arg_after(i, tok)
            if body.startswith("@"):
                raise CurlRejected("reading request bodies from files ('@') "
                                   "is not allowed")
            spec["data"] = body
            if tok == "--json" and not any(
                h.lower() == "content-type" for h in spec["headers"]
            ):
                spec["headers"]["Content-Type"] = "application/json"
            i += 2
        elif tok in ("-m", "--max-time"):
            raw = arg_after(i, tok)
            try:
                spec["timeout"] = min(MAX_TIMEOUT_S, max(1.0, float(raw)))
            except ValueError:
                raise CurlRejected(f"invalid --max-time value {raw!r}")
            i += 2
        elif tok in ("-s", "--silent", "-S", "--show-error", "-i",
                     "--include", "-L", "--location", "-k", "--insecure",
                     "-v", "--verbose", "--compressed", "-g", "--globoff"):
            i += 1  # tolerated no-ops
        elif tok.startswith("-"):
            raise CurlRejected(f"unsupported curl option {tok!r}")
        else:
            if spec["url"] is not None:
                raise CurlRejected("multiple URLs in one command")
            spec["url"] = tok
            i += 1

    if not spec["url"]:
        raise CurlRejected("no URL in command")
    spec["url"] = _validate_url(spec["url"], router_url)
    if spec["method"] is None:
        spec["method"] = "POST" if spec["data"] is not None else "GET"
    return spec


def _validate_url(url: str, router_url: str) -> str:
    """Host whitelist: the router's own host (+ localhost aliases when the
    router is local) — the assistant never talks to foreign hosts
    (assistant.rs:442-450). Bare paths are resolved against the router."""
    if url.startswith("/"):
        return router_url.rstrip("/") + url
    parsed = urllib.parse.urlparse(url)
    if parsed.scheme not in ("http", "https"):
        raise CurlRejected(f"scheme {parsed.scheme!r} is not allowed")
    router = urllib.parse.urlparse(router_url)
    allowed = {router.hostname}
    if router.hostname in LOCALHOST_HOSTNAMES:
        allowed.update(LOCALHOST_HOSTNAMES)
    if parsed.hostname not in allowed:
        raise CurlRejected(
            f"host {parsed.hostname!r} is not the router "
            f"({router.hostname!r}); refusing"
        )
    port = parsed.port or (443 if parsed.scheme == "https" else 80)
    router_port = router.port or (443 if router.scheme == "https" else 80)
    if port != router_port:
        raise CurlRejected(
            f"port {port} is not the router port ({router_port}); refusing"
        )
    return url


def run_curl(command: str, router_url: str | None = None,
             api_key: str | None = None) -> dict:
    """Execute the sanitized request (urllib — no shell, no curl binary).
    Returns {status, body, executed_command} with secrets masked."""
    router_url = router_url or os.environ.get(
        "LLMLB_ROUTER_URL", DEFAULT_ROUTER_URL
    )
    spec = parse_curl(command, router_url)

    # auto-auth: inject the operator's key when the command carries none
    if api_key is None:
        api_key = os.environ.get("LLMLB_API_KEY") or os.environ.get(
            "LLMLB_TOKEN"
        )
    has_auth = any(h.lower() in ("authorization", "x-api-key")
                   for h in spec["headers"])
    if api_key and not has_auth:
        spec["headers"]["Authorization"] = f"Bearer {api_key}"

    data = spec["data"].encode() if spec["data"] is not None else None
    # case-insensitive: urllib canonicalizes header names, so a check on the
    # exact spelling would clobber a user-supplied 'content-type: …'
    if data is not None and not any(
        h.lower() == "content-type" for h in spec["headers"]
    ):
        spec["headers"]["Content-Type"] = "application/json"
    req = urllib.request.Request(
        spec["url"], data=data, method=spec["method"],
        headers=spec["headers"],
    )

    class _NoRedirect(urllib.request.HTTPRedirectHandler):
        # urllib would forward the injected Authorization header to whatever
        # host a 3xx points at — a credential exfil channel past the host
        # whitelist. Surface the redirect instead of following it.
        def redirect_request(self, *a, **k):
            return None

    opener = urllib.request.build_opener(_NoRedirect)
    try:
        with opener.open(req, timeout=spec["timeout"]) as resp:
            body = resp.read().decode("utf-8", "replace")
            status = resp.status
    except urllib.error.HTTPError as e:
        body = e.read().decode("utf-8", "replace")
        status = e.code
    except (urllib.error.URLError, OSError) as e:
        return {
            "status": None,
            "error": str(getattr(e, "reason", e)),
            "executed_command": mask_sensitive(command),
        }
    return {
        "status": status,
        "body": body[:65536],
        "executed_command": mask_sensitive(command),
    }


# --------------------------------------------------------------------- openapi

def openapi_summary() -> dict:
    """Machine-readable sketch of the API surface (enough for an agent to
    orient; the dashboard and guides carry the human detail)."""
    return {
        "openapi": "3.0.0",
        "info": {"title": "llmlb-tpu gateway", "version": "1"},
        "paths": {
            "/v1/chat/completions": {"post": {
                "summary": "OpenAI-compatible chat (SSE when stream=true)"}},
            "/v1/completions": {"post": {"summary": "legacy completions"}},
            "/v1/responses": {"post": {"summary": "responses API"}},
            "/v1/embeddings": {"post": {"summary": "embeddings"}},
            "/v1/models": {"get": {"summary": "models served by any online endpoint"}},
            "/v1/messages": {"post": {"summary": "Anthropic Messages adapter"}},
            "/v1/audio/transcriptions": {"post": {"summary": "ASR (multipart)"}},
            "/v1/audio/speech": {"post": {"summary": "TTS"}},
            "/v1/images/generations": {"post": {"summary": "image generation"}},
            "/api/auth/login": {"post": {"summary": "JWT + cookie session"}},
            "/api/endpoints": {"get": {"summary": "list endpoints"},
                               "post": {"summary": "register endpoint"}},
            "/api/api-keys": {"post": {"summary": "create scoped API key"}},
            "/api/audit-log": {"get": {"summary": "FTS audit search"}},
            "/api/dashboard/overview": {"get": {"summary": "serving overview"}},
            "/api/benchmarks/tps": {"post": {"summary": "TPS benchmark run"}},
            "/api/system/update/check": {"post": {"summary": "release check"}},
        },
    }


# ---------------------------------------------------------------------- guides

GUIDES = {
    "quickstart": """\
llmlb-tpu quickstart
  1. serve the gateway:   llmlb serve --port 32768
  2. serve an engine:     python -m llmlb_tpu_torch.engine.server --preset llama-3-8b
  3. register it:         llmlb assistant curl "curl -X POST /api/endpoints \
-d '{\\"base_url\\": \\"http://127.0.0.1:8100\\"}'"
  4. chat through it:     llmlb assistant curl "curl /v1/models"
Set LLMLB_API_KEY (an sk_... key) or LLMLB_TOKEN (a JWT) for auto-auth.
(llmlb here is python -m llmlb_tpu_torch.gateway.server.)""",
    "auth": """\
auth guide
  - POST /api/auth/login {username,password} -> {token} + session cookies
  - API keys: POST /api/api-keys {name, permissions:[...]} (admin)
    scopes: openai.inference, openai.models.read, endpoints.read,
            endpoints.manage, users.manage, invitations.manage,
            logs.read, metrics.read, registry.read
  - /v1/* accepts ONLY header auth (Bearer sk_... or JWT); browser cookies
    work on /api/* behind CSRF (x-csrf-token header = llmlb_csrf cookie).""",
    "endpoints": """\
endpoints guide
  - register:  POST /api/endpoints {base_url, endpoint_type?, api_key?}
    types auto-detected in priority order: tpu, xllm, ollama, vllm,
    lm_studio, llama_cpp, openai_compatible (the port's engines detect
    as tpu)
  - test:      POST /api/endpoints/{id}/test
  - sync:      POST /api/endpoints/{id}/sync (pull /v1/models)
  - health:    checked every 30s; 2 strikes -> offline; the port's engines
    report device memory + queue telemetry that demotes pressured
    endpoints.""",
    "serving": """\
serving guide (the port's engine, one CUDA card)
  - python -m llmlb_tpu_torch.engine.server --preset llama-3-8b --checkpoint DIR
  - continuous batching over paged KV (--kv-layout dense: slot cache);
    chunked prefill beyond the largest bucket; --slot-capacity 4096
    default (see scheduler.kv_cache_bytes)
  - multi-host: LLMLB_COORDINATOR/LLMLB_NUM_HOSTS/LLMLB_HOST_ID (leader
    serves HTTP, followers run the lockstep loop)
  - metrics: GET /metrics (Prometheus), GET /api/health (JSON).""",
    "update": """\
self-update guide
  - env: LLMLB_UPDATE_REPO=owner/name, LLMLB_UPDATE_ARTIFACT=/path/to/app
  - POST /api/system/update/check -> {available, version}
  - POST /api/system/update/apply {force?} -> drain (503 on /v1/*) -> swap
    with .bak -> exit for supervisor restart -> 30s health watch; unhealthy
    rolls back from .bak and blocklists the release.""",
}


def main(argv: list[str]) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: llmlb assistant {curl,openapi,guide} ...\n"
              f"guides: {', '.join(sorted(GUIDES))}")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "curl":
        if not rest:
            print("usage: llmlb assistant curl \"curl ... URL\"",
                  file=sys.stderr)
            return 2
        try:
            result = run_curl(" ".join(rest))
        except CurlRejected as e:
            print(json.dumps({"rejected": str(e)}), file=sys.stderr)
            return 2
        print(json.dumps(result, indent=2))
        return 0 if result.get("status") and result["status"] < 400 else 1
    if cmd == "openapi":
        print(json.dumps(openapi_summary(), indent=2))
        return 0
    if cmd == "guide":
        topic = rest[0] if rest else "quickstart"
        if topic not in GUIDES:
            print(f"unknown guide {topic!r}; available: "
                  f"{', '.join(sorted(GUIDES))}", file=sys.stderr)
            return 2
        print(GUIDES[topic])
        return 0
    print(f"unknown assistant command {cmd!r}", file=sys.stderr)
    return 2
