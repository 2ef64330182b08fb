"""OpenAI-compatible HTTP server of the port's engine, on the standard
library (`http.server.ThreadingHTTPServer`, one thread per connection).

Counterpart of the serving subset of `llmlb_tpu/engine/server.py`:

- `GET /v1/models`
- `POST /v1/chat/completions`, streaming (SSE, written and flushed chunk by
  chunk, ending with a usage chunk and `data: [DONE]`) and non-streaming,
  with the reference's chunk and usage shapes;
- `GET /api/health`;
- `GET /api/system`, carrying `"tpu_engine": true` — the field the
  gateway's endpoint detection keys on to treat this as an in-tree engine —
  and `"backend": "cuda"`.

Request fields are honoured or refused, never ignored: `priority`,
`speculative` and the `X-Request-Deadline-Ms` header are validated by the
reference's rules (a malformed value is a 400 with the reference's message)
and carried on the request's SamplingParams; a `response_format` other
than text and a forced `tool_choice` are 400s naming the field, since the
port has no constrained decoding.

Multi-LoRA (`--lora-dir`): a request names an adapter with the `lora` field
or a `model:adapter` suffix (the suffix only on a LoRA-enabled engine);
unknown, unservable or conflicting adapters are 400s naming `lora`.
`/v1/models` gives the base entry the `lora` capability and one
`base:adapter` entry per resident adapter; `/api/health` and `/api/system`
carry a `lora` block.

Run: `python -m llmlb_tpu_torch.engine.server --preset llama-3-8b` (on the
card; `--device cpu` for the plain PyTorch path; `--quantize all` for int8
weights and KV pages; `--kv-layout dense` for the slot cache; `--lora-dir
DIR` for adapters).
"""

from __future__ import annotations

import argparse
import json
import logging
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from llmlb_tpu_torch import __version__
from llmlb_tpu_torch.engine.scheduler import SamplingParams
from llmlb_tpu_torch.engine.service import Engine, EngineError
from llmlb_tpu_torch.lora import adapter_from_body

log = logging.getLogger("llmlb_tpu_torch.engine.server")

SYSTEM_FINGERPRINT = f"fp_llmlb_tpu_torch_{__version__}"
MAX_BODY_BYTES = 20 * 1024 * 1024
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9_.:\-]{1,128}$")


def _sampling_from(body: dict, default_max: int = 256,
                   deadline_ms: float | None = None) -> SamplingParams:
    def pick(*names, default):
        for n in names:
            if body.get(n) is not None:
                return body[n]
        return default

    temperature = float(pick("temperature", default=1.0))
    top_p = float(pick("top_p", default=1.0))
    top_k = int(pick("top_k", default=0))
    max_tokens = int(pick("max_tokens", "max_completion_tokens",
                          default=default_max))
    if temperature < 0:
        raise ValueError("'temperature' must be >= 0")
    if not 0 < top_p <= 1:
        raise ValueError("'top_p' must be in (0, 1]")
    if top_k < 0:
        raise ValueError("'top_k' must be >= 0")
    if max_tokens < 1:
        raise ValueError("'max_tokens' must be >= 1")
    seed = body.get("seed")
    if seed is not None and (isinstance(seed, bool) or not isinstance(seed, int)):
        raise ValueError("'seed' must be an integer")
    _refuse_structured(body)
    return SamplingParams(temperature=temperature, top_p=top_p, top_k=top_k,
                          max_tokens=max_tokens, seed=seed,
                          priority=_priority_from(body),
                          speculative=_speculative_from(body),
                          deadline_ms=deadline_ms)


_PRIORITY_NAMES = {"high": 0, "normal": 1, "low": 2}


def _priority_from(body: dict) -> int:
    """Per-request priority class, "high"/"normal"/"low" or 0/1/2 (lower is
    more important; default "normal"), as the reference validates it."""
    p = body.get("priority")
    if p is None:
        return 1
    if isinstance(p, str):
        if p not in _PRIORITY_NAMES:
            raise ValueError(
                "'priority' must be one of high, normal, low (or 0..2)")
        return _PRIORITY_NAMES[p]
    if isinstance(p, bool) or not isinstance(p, int) or not 0 <= p <= 2:
        raise ValueError(
            "'priority' must be one of high, normal, low (or 0..2)")
    return p


def _deadline_from(headers) -> float | None:
    """The request's remaining deadline in milliseconds, from the
    X-Request-Deadline-Ms header (set by the gateway or a direct client),
    as the reference validates it."""
    raw = headers.get("X-Request-Deadline-Ms")
    if not raw:
        return None
    try:
        ms = float(raw)
    except ValueError:
        raise ValueError("X-Request-Deadline-Ms must be a number") from None
    if ms <= 0:
        raise ValueError("X-Request-Deadline-Ms must be positive")
    return ms


def _speculative_from(body: dict) -> dict | None:
    """Per-request speculative-decoding knobs, `speculative: {enabled,
    max_draft_tokens}`, as the reference validates them, so a malformed
    knob is a 400 instead of being silently ignored."""
    spec = body.get("speculative")
    if spec is None:
        return None
    if not isinstance(spec, dict):
        raise ValueError("'speculative' must be an object")
    out: dict = {}
    if "enabled" in spec:
        if not isinstance(spec["enabled"], bool):
            raise ValueError("'speculative.enabled' must be a boolean")
        out["enabled"] = spec["enabled"]
    if spec.get("max_draft_tokens") is not None:
        k = spec["max_draft_tokens"]
        if not isinstance(k, int) or isinstance(k, bool) or k < 1:
            raise ValueError(
                "'speculative.max_draft_tokens' must be a positive integer")
        out["max_draft_tokens"] = k
    return out or None


def _refuse_structured(body: dict) -> None:
    """The port has no constrained decoding: a `response_format` other than
    text, or a `tool_choice` that forces a call ("required" or a function
    object), is refused naming the field rather than answered with free
    text. "auto" and "none" leave the model free, so they pass."""
    rf = body.get("response_format")
    if rf is not None:
        if not isinstance(rf, dict):
            raise ValueError("response_format must be an object")
        if rf.get("type") not in (None, "text"):
            raise ValueError(
                f"response_format type {rf.get('type')!r} is not supported "
                "by this engine (no constrained decoding; only 'text')")
    choice = body.get("tool_choice")
    if choice is None or choice in ("auto", "none"):
        return
    if choice == "required" or isinstance(choice, dict):
        raise ValueError("tool_choice that forces a tool call is not "
                         "supported by this engine (no constrained "
                         "decoding; only 'auto' or 'none')")
    raise ValueError("tool_choice must be 'auto', 'none', 'required', "
                     "or a {type: 'function'} object")


def _stops_from(body: dict) -> list[str]:
    stop = body.get("stop") or []
    if isinstance(stop, str):
        return [stop]
    return [s for s in stop if isinstance(s, str)]


def _usage(prompt_tokens: int, completion_tokens: int) -> dict:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


class EngineHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, address: tuple[str, int], engine: Engine):
        self.engine = engine
        super().__init__(address, _Handler)


class _Handler(BaseHTTPRequestHandler):
    server: EngineHTTPServer
    server_version = f"llmlb_tpu_torch/{__version__}"

    def log_message(self, fmt, *args):  # route access logs through logging
        log.debug("%s - " + fmt, self.address_string(), *args)

    # ---------------------------------------------------------------- helpers

    def _json(self, status: int, body: dict, headers: dict | None = None):
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _error(self, status: int, message: str,
               err_type: str = "invalid_request_error"):
        self._json(status, {"error": {"message": message, "type": err_type,
                                      "code": None}})

    def _sse(self, payload: dict | str) -> None:
        data = payload if isinstance(payload, str) else json.dumps(
            payload, separators=(",", ":"))
        self.wfile.write(f"data: {data}\n\n".encode())
        self.wfile.flush()

    def _request_id(self) -> str | None:
        rid = self.headers.get("X-Request-Id")
        return rid if rid and _REQUEST_ID_RE.match(rid) else None

    # ----------------------------------------------------------------- routes

    def do_GET(self):
        engine = self.server.engine
        path = self.path.split("?", 1)[0]
        if path == "/v1/models":
            self._json(200, {"object": "list", "data": _models(engine)})
        elif path == "/api/health":
            self._json(200, engine.health())
        elif path == "/api/system":
            self._json(200, {
                "name": "llmlb_tpu_torch-engine",
                "version": __version__,
                "tpu_engine": True,
                "backend": "cuda",
                "device": str(engine.core.device),
                "model": engine.model_id,
                "kv_cache": engine.core.kv_cache_info(),
                "prefix_cache": engine.core.prefix_cache_info(),
                "quant": engine.core.quant_info(),
                "lora": engine.core.lora_info(),
            })
        else:
            self._error(404, f"no route for GET {path}")

    def do_POST(self):
        path = self.path.split("?", 1)[0]
        if path != "/v1/chat/completions":
            self._error(404, f"no route for POST {path}")
            return
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY_BYTES:
            self._error(413, "request body too large")
            return
        try:
            body = json.loads(self.rfile.read(length) or b"null")
        except ValueError:
            self._error(400, "invalid JSON body")
            return
        if not isinstance(body, dict):
            self._error(400, "body must be a JSON object")
            return
        self._chat(body)

    def _chat(self, body: dict) -> None:
        engine = self.server.engine
        messages = body.get("messages")
        try:
            if not isinstance(messages, list) or not messages:
                raise ValueError("'messages' must be a non-empty array")
            if int(body.get("n") or 1) != 1:
                raise ValueError("only n=1 is supported")
            prompt_ids = engine.encode_chat(messages)
            sampling = _sampling_from(
                body, deadline_ms=_deadline_from(self.headers))
            stops = _stops_from(body)
            model = body.get("model") or engine.model_id
            adapter, base = _parse_lora(engine, body)
            if adapter is not None:
                sampling.lora = adapter
                model = base or model
            deltas = engine.stream(prompt_ids, sampling, stops,
                                   request_id=self._request_id())
        except (ValueError, TypeError) as e:
            self._error(400, str(e))
            return
        completion_id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        if body.get("stream"):
            include_usage = bool(
                (body.get("stream_options") or {}).get("include_usage", True))
            self._stream_chat(deltas, completion_id, created, model,
                              len(prompt_ids), include_usage)
            return
        text, final = [], None
        try:
            for delta in deltas:
                text.append(delta.text)
                if delta.finish_reason is not None:
                    final = delta
        except EngineError as e:
            self._error(500, str(e), "server_error")
            return
        self._json(200, {
            "id": completion_id,
            "object": "chat.completion",
            "created": created,
            "model": model,
            "system_fingerprint": SYSTEM_FINGERPRINT,
            "choices": [{"index": 0,
                         "message": {"role": "assistant",
                                     "content": "".join(text)},
                         "finish_reason": final.finish_reason}],
            "usage": _usage(final.prompt_tokens, final.completion_tokens),
        })

    def _stream_chat(self, deltas, completion_id: str, created: int,
                     model: str, prompt_tokens: int,
                     include_usage: bool) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()

        def chunk(delta: dict, finish: str | None = None) -> dict:
            return {
                "id": completion_id,
                "object": "chat.completion.chunk",
                "created": created,
                "model": model,
                "system_fingerprint": SYSTEM_FINGERPRINT,
                "choices": [{"index": 0, "delta": delta,
                             "finish_reason": finish}],
            }

        usage = _usage(prompt_tokens, 0)
        finish = "stop"
        try:
            self._sse(chunk({"role": "assistant", "content": ""}))
            for delta in deltas:
                if delta.text:
                    self._sse(chunk({"content": delta.text}))
                if delta.finish_reason is not None:
                    finish = delta.finish_reason
                    usage = _usage(delta.prompt_tokens,
                                   delta.completion_tokens)
            self._sse(chunk({}, finish))
            if include_usage:
                final = chunk({}, None)
                final["choices"] = []
                final["usage"] = usage
                self._sse(final)
            self._sse("[DONE]")
        except EngineError as e:
            self._sse({"error": {"message": str(e)}})
            self._sse("[DONE]")
        except OSError:
            deltas.close()  # client gone: cancel the request, free the slot


def _models(engine: Engine) -> list[dict]:
    """The /v1/models entries: the base model, with the `lora` capability
    when adapters are on ("this endpoint can load any adapter of its
    store"), then one `base:adapter` entry per RESIDENT adapter, so the
    gateway routes adapter traffic where it is already loaded."""
    caps = ["chat_completion"]
    lora = engine.core.lora
    if lora is not None:
        caps.append("lora")

    def entry(model_id: str) -> dict:
        return {"id": model_id, "object": "model", "created": 0,
                "owned_by": "llmlb_tpu_torch", "capabilities": list(caps)}

    data = [entry(engine.model_id)]
    if lora is not None:
        for name in lora.resident_names():
            data.append({**entry(f"{engine.model_id}:{name}"), "lora": name})
    return data


def _parse_lora(engine: Engine, body: dict) -> tuple[str | None, str | None]:
    """(adapter, base model) of a body, validated against the engine's
    adapter store; ValueError naming the `lora` field otherwise. A `:suffix`
    counts only on a LoRA-enabled engine."""
    lora = engine.core.lora
    if body.get("lora") is None and lora is None:
        return None, None
    if lora is None:
        raise ValueError("'lora' adapters are not enabled on this engine "
                         "(start it with --lora-dir)")
    base, adapter = adapter_from_body(body)
    if adapter is None:
        return None, None
    lora.validate(adapter)
    return adapter, base


def start_server(engine: Engine, host: str = "127.0.0.1",
                 port: int = 0) -> tuple[EngineHTTPServer, threading.Thread]:
    """Serve `engine` from a background thread; port 0 picks a free port
    (read it from `server.server_address`). Stop with server.shutdown()."""
    server = EngineHTTPServer((host, port), engine)
    thread = threading.Thread(target=server.serve_forever,
                              name="engine-http", daemon=True)
    thread.start()
    return server, thread


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="llmlb_tpu_torch inference engine (PyTorch/CUDA)")
    parser.add_argument("--preset", default="debug-tiny")
    parser.add_argument("--model-id", default=None)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8100)
    parser.add_argument("--num-slots", type=int, default=8)
    parser.add_argument("--slot-capacity", type=int, default=4096)
    parser.add_argument(
        "--prefill-buckets", default=None,
        help="comma-separated one-shot prefill lengths (default 32..512); "
             "prompts beyond the largest run through chunked prefill")
    parser.add_argument("--kv-page-size", type=int, default=None,
                        help="tokens per KV page (default 128)")
    parser.add_argument("--kv-pages", type=int, default=None,
                        help="total pages in the pool (default: every slot's "
                             "full capacity plus the trash page)")
    parser.add_argument("--decode-burst", type=int, default=None,
                        help="decode+sample steps per host sync (default 8 on "
                             "the card, 1 on the CPU)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights and the sampler")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument(
        "--quantize", choices=("off", "weights", "kv", "all"), default=None,
        help="int8 quantization (default off; also via LLMLB_QUANTIZE): "
             "'weights' = per-output-channel int8 projection weights, 'kv' "
             "= int8 KV pages with per-vector scales, 'all' = both")
    parser.add_argument(
        "--kv-layout", choices=("paged", "dense"), default=None,
        help="KV cache layout (default paged; also via LLMLB_KV_LAYOUT): "
             "'dense' keeps one contiguous row of --slot-capacity positions "
             "per slot")
    parser.add_argument(
        "--lora-dir", default=None,
        help="directory of LoRA adapters in the HF/PEFT layout, one "
             "subdirectory each (also via LLMLB_LORA_DIR); enables the "
             "'lora' request field and 'model:adapter' names")
    parser.add_argument("--lora-max-adapters", type=int, default=None,
                        help="resident adapter rows of the pool (default 8; "
                             "LLMLB_LORA_MAX_ADAPTERS)")
    parser.add_argument("--lora-rank-cap", type=int, default=None,
                        help="largest adapter rank served, the pool's rank "
                             "(default 16; LLMLB_LORA_RANK_CAP)")
    parser.add_argument(
        "--prefix-cache", choices=("on", "off"), default=None,
        help="radix-tree prefix KV reuse across requests (default on; also "
             "via LLMLB_PREFIX_CACHE=0)")
    parser.add_argument(
        "--prefix-cache-slots", type=int, default=None,
        help="most prefix donors held at once (default num_slots // 2, "
             "always leaving one serving slot)")
    return parser


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    core_kwargs = dict(num_slots=args.num_slots,
                       slot_capacity=args.slot_capacity, seed=args.seed,
                       kv_page_size=args.kv_page_size, kv_pages=args.kv_pages,
                       decode_burst=args.decode_burst,
                       quantize=args.quantize, kv_layout=args.kv_layout,
                       lora_dir=args.lora_dir,
                       lora_max_adapters=args.lora_max_adapters,
                       lora_rank_cap=args.lora_rank_cap)
    if args.prefix_cache is not None:
        core_kwargs["prefix_cache"] = args.prefix_cache == "on"
    if args.prefix_cache_slots is not None:
        core_kwargs["prefix_cache_slots"] = max(0, args.prefix_cache_slots)
    if args.prefill_buckets:
        core_kwargs["prefill_buckets"] = tuple(
            int(b) for b in args.prefill_buckets.split(","))
    engine = Engine.from_preset(args.preset, model_id=args.model_id,
                                device=args.device, **core_kwargs)
    server = EngineHTTPServer((args.host, args.port), engine)
    log.info("serving %s on http://%s:%d (%s)", engine.model_id,
             *server.server_address[:2], engine.core.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.shutdown()


if __name__ == "__main__":
    main()
