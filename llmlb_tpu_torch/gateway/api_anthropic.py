"""Anthropic Messages API adapter: /v1/messages backed by OpenAI endpoints.

Parity with reference api/anthropic.rs: `anthropic:`-prefixed models pass
through to the cloud natively (:137); local models are served by converting the
Anthropic request to OpenAI chat (:1048, tools/tool_choice :1218-1321),
proxying through the normal TPS selection path, then converting back — either
as a full message response (:1435, stop_reason mapping :1526) or as a stateful
SSE re-encoding of OpenAI chunks into the Anthropic event stream
(message_start/content_block_*/message_delta/message_stop incl. tool_use,
:728-1046).

The port's copy of llmlb_tpu/gateway/api_anthropic.py: the same selection,
admission, rate-limit, failover and mid-stream resume machinery as the
port's chat path (gateway/api_openai.py, gateway/replay.py).
"""

from __future__ import annotations

import asyncio
import json
import os
import time
import uuid

from llmlb_tpu_torch.gateway import http
from llmlb_tpu_torch.gateway.http import web

from llmlb_tpu_torch.gateway.api_openai import (
    HandoffOrchestrationError,
    QueueTimeout,
    StreamWriteTimeout,
    _acquire_resume,
    _chat_prompt_text,
    _handoff_upstream,
    _record,
    affinity_text_from_body,
    deadline_at_of,
    priority_label,
    ratelimit_verdict,
    select_endpoint_with_queue,
    stream_write_guard,
    tenant_of,
)
from llmlb_tpu_torch.gateway.replay import (
    REPLAY_OBJECT,
    RESUMABLE_ENDPOINT_TYPES,
    ChunkSplicer,
    ReplayState,
)
from llmlb_tpu_torch.gateway.balancer import prefix_affinity_hash
from llmlb_tpu_torch.gateway.resilience import (
    RETRYABLE_EXCEPTIONS,
    FailoverController,
    PreStreamFailure,
    book_stream_outcome,
    retry_after_seconds,
    upstream_post,
)
from llmlb_tpu_torch.gateway.model_names import to_canonical
from llmlb_tpu_torch.gateway.token_accounting import estimate_tokens
from llmlb_tpu_torch.gateway.tracing import (
    REQUEST_ID_HEADER,
    TokenTimeline,
    observe_first_token,
)
from llmlb_tpu_torch.gateway.types import Capability, TpsApiKind
from llmlb_tpu_torch.structured import inspect_request as inspect_structured

ANTHROPIC_BASE = os.environ.get(
    "LLMLB_ANTHROPIC_BASE_URL", "https://api.anthropic.com"
)

STOP_REASON_MAP = {
    "stop": "end_turn",
    "length": "max_tokens",
    "tool_calls": "tool_use",
    "content_filter": "end_turn",
}


def _anthropic_error(status: int, message: str,
                     err_type: str = "invalid_request_error",
                     headers: dict | None = None) -> web.Response:
    return web.json_response(
        {"type": "error", "error": {"type": err_type, "message": message}},
        status=status,
        headers=headers,
    )


def anthropic_error_event(message: str,
                          err_type: str = "api_error") -> bytes:
    """Anthropic's native SSE error event (the real API emits exactly this
    shape mid-stream), written before closing a cut stream so clients can
    tell truncation from completion."""
    payload = {"type": "error", "error": {"type": err_type,
                                          "message": message}}
    return (
        f"event: error\ndata: {json.dumps(payload, separators=(',', ':'))}\n\n"
    ).encode()


# ------------------------------------------------- request/response convert


def anthropic_request_to_openai(body: dict) -> dict:
    """Anthropic /v1/messages body → OpenAI chat body (anthropic.rs:1048)."""
    messages: list[dict] = []
    system = body.get("system")
    if system:
        if isinstance(system, list):  # content-block system prompts
            system = "".join(
                b.get("text", "") for b in system if isinstance(b, dict)
            )
        messages.append({"role": "system", "content": system})

    for m in body.get("messages") or []:
        role = m.get("role")
        content = m.get("content")
        if isinstance(content, str):
            messages.append({"role": role, "content": content})
            continue
        # content-block array: text, tool_use (assistant), tool_result (user)
        text_parts: list[str] = []
        tool_calls: list[dict] = []
        for block in content or []:
            if not isinstance(block, dict):
                continue
            btype = block.get("type")
            if btype == "text":
                text_parts.append(block.get("text", ""))
            elif btype == "tool_use":
                tool_calls.append({
                    "id": block.get("id") or f"call_{uuid.uuid4().hex[:12]}",
                    "type": "function",
                    "function": {
                        "name": block.get("name", ""),
                        "arguments": json.dumps(block.get("input") or {}),
                    },
                })
            elif btype == "tool_result":
                tool_content = block.get("content")
                if isinstance(tool_content, list):
                    tool_content = "".join(
                        b.get("text", "") for b in tool_content
                        if isinstance(b, dict)
                    )
                messages.append({
                    "role": "tool",
                    "tool_call_id": block.get("tool_use_id", ""),
                    "content": tool_content or "",
                })
        if text_parts or tool_calls:
            msg: dict = {"role": role, "content": "".join(text_parts) or None}
            if tool_calls:
                msg["tool_calls"] = tool_calls
            messages.append(msg)

    out: dict = {
        "model": body.get("model"),
        "messages": messages,
        "max_tokens": body.get("max_tokens", 1024),
    }
    for src, dst in (("temperature", "temperature"), ("top_p", "top_p"),
                     ("stream", "stream"),
                     # speculative-decoding knobs ({enabled,
                     # max_draft_tokens}) ride both dialects verbatim — the
                     # engine validates and clamps them
                     ("speculative", "speculative"),
                     # priority class (docs/scheduling.md): high/normal/low
                     # or 0..2, carried verbatim — the engine validates
                     ("priority", "priority"),
                     # LoRA adapter name (docs/lora.md): carried verbatim —
                     # the shared validator (llmlb_tpu/lora/api.py) runs at
                     # the gateway's inspect step and again at the engine
                     ("lora", "lora")):
        if body.get(src) is not None:
            out[dst] = body[src]
    if body.get("stop_sequences"):
        out["stop"] = body["stop_sequences"]
    if body.get("tools"):
        out["tools"] = [
            {
                "type": "function",
                "function": {
                    "name": t.get("name"),
                    "description": t.get("description", ""),
                    "parameters": t.get("input_schema") or {},
                },
            }
            for t in body["tools"]
            if isinstance(t, dict)
        ]
    choice = body.get("tool_choice")
    if isinstance(choice, dict):
        ctype = choice.get("type")
        if ctype == "auto":
            out["tool_choice"] = "auto"
        elif ctype == "any":
            out["tool_choice"] = "required"
        elif ctype == "tool":
            out["tool_choice"] = {
                "type": "function",
                "function": {"name": choice.get("name", "")},
            }
    return out


def openai_response_to_anthropic(resp: dict, model: str) -> dict:
    """OpenAI chat response → Anthropic message response (anthropic.rs:1435)."""
    content: list[dict] = []
    finish = "stop"
    choices = resp.get("choices") or []
    if choices:
        choice = choices[0]
        finish = choice.get("finish_reason") or "stop"
        msg = choice.get("message") or {}
        if isinstance(msg.get("content"), str) and msg["content"]:
            content.append({"type": "text", "text": msg["content"]})
        for tc in msg.get("tool_calls") or []:
            fn = tc.get("function") or {}
            try:
                args = json.loads(fn.get("arguments") or "{}")
            except ValueError:
                args = {}
            content.append({
                "type": "tool_use",
                "id": tc.get("id") or f"toolu_{uuid.uuid4().hex[:12]}",
                "name": fn.get("name", ""),
                "input": args,
            })
    usage = resp.get("usage") or {}
    return {
        "id": f"msg_{uuid.uuid4().hex[:24]}",
        "type": "message",
        "role": "assistant",
        "model": model,
        "content": content,
        "stop_reason": STOP_REASON_MAP.get(finish, "end_turn"),
        "stop_sequence": None,
        "usage": {
            "input_tokens": usage.get("prompt_tokens", 0),
            "output_tokens": usage.get("completion_tokens", 0),
        },
    }


class AnthropicStreamEncoder:
    """Re-encodes OpenAI chat chunks as Anthropic SSE events (anthropic.rs:728).

    Stateful: text deltas stream through an open text block; tool-call deltas
    are buffered per OpenAI tool index (OpenAI may interleave fragments of
    parallel tool calls, which cannot map onto Anthropic's sequential block
    stream) and emitted as complete tool_use blocks at finish. message_start
    carries an input-token estimate (the upstream only reports usage at stream
    end); message_delta carries the reported figures.
    """

    def __init__(self, model: str, input_token_estimate: int = 0):
        self.model = model
        self.message_id = f"msg_{uuid.uuid4().hex[:24]}"
        self.started = False
        self.block_index = -1
        self.block_type: str | None = None  # "text" (tool_use emitted at end)
        self.finish_reason: str | None = None
        self.input_token_estimate = input_token_estimate
        self.usage = {"input_tokens": 0, "output_tokens": 0}
        self._usage_reported = False
        # OpenAI tool index -> {"id", "name", "args": [fragments]}
        self._tools: dict[int, dict] = {}

    @staticmethod
    def _event(name: str, payload: dict) -> bytes:
        return (
            f"event: {name}\ndata: "
            f"{json.dumps(payload, separators=(',', ':'))}\n\n"
        ).encode()

    def start(self) -> bytes:
        self.started = True
        return self._event("message_start", {
            "type": "message_start",
            "message": {
                "id": self.message_id, "type": "message", "role": "assistant",
                "model": self.model, "content": [],
                "stop_reason": None, "stop_sequence": None,
                "usage": {"input_tokens": self.input_token_estimate,
                          "output_tokens": 0},
            },
        })

    def _close_block(self) -> list[bytes]:
        if self.block_type is None:
            return []
        out = [self._event("content_block_stop", {
            "type": "content_block_stop", "index": self.block_index,
        })]
        self.block_type = None
        return out

    def _open_block(self, btype: str, header: dict) -> list[bytes]:
        out = self._close_block()
        self.block_index += 1
        self.block_type = btype
        out.append(self._event("content_block_start", {
            "type": "content_block_start", "index": self.block_index,
            "content_block": header,
        }))
        return out

    def feed(self, chunk: dict) -> list[bytes]:
        """Consume one OpenAI chunk dict; returns encoded Anthropic events."""
        out: list[bytes] = []
        if not self.started:
            out.append(self.start())
        usage = chunk.get("usage")
        if isinstance(usage, dict):
            self.usage = {
                "input_tokens": usage.get("prompt_tokens", 0),
                "output_tokens": usage.get("completion_tokens", 0),
            }
            self._usage_reported = True
        for choice in chunk.get("choices") or []:
            if not isinstance(choice, dict):
                continue
            if choice.get("finish_reason"):
                self.finish_reason = choice["finish_reason"]
            delta = choice.get("delta") or {}
            content = delta.get("content")
            if isinstance(content, str) and content:
                if self.block_type != "text":
                    out.extend(self._open_block(
                        "text", {"type": "text", "text": ""}
                    ))
                out.append(self._event("content_block_delta", {
                    "type": "content_block_delta", "index": self.block_index,
                    "delta": {"type": "text_delta", "text": content},
                }))
            for tc in delta.get("tool_calls") or []:
                idx = tc.get("index", 0)
                fn = tc.get("function") or {}
                tool = self._tools.setdefault(
                    idx, {"id": None, "name": "", "args": []}
                )
                if tc.get("id"):
                    tool["id"] = tc["id"]
                if fn.get("name"):
                    tool["name"] = fn["name"]
                if fn.get("arguments"):
                    tool["args"].append(fn["arguments"])
        return out

    def finish(self) -> list[bytes]:
        out = self._close_block()
        for idx in sorted(self._tools):
            tool = self._tools[idx]
            self.block_index += 1
            out.append(self._event("content_block_start", {
                "type": "content_block_start", "index": self.block_index,
                "content_block": {
                    "type": "tool_use",
                    "id": tool["id"] or f"toolu_{uuid.uuid4().hex[:12]}",
                    "name": tool["name"], "input": {},
                },
            }))
            args = "".join(tool["args"])
            if args:
                out.append(self._event("content_block_delta", {
                    "type": "content_block_delta", "index": self.block_index,
                    "delta": {"type": "input_json_delta", "partial_json": args},
                }))
            out.append(self._event("content_block_stop", {
                "type": "content_block_stop", "index": self.block_index,
            }))
        usage = {"output_tokens": self.usage["output_tokens"]}
        if self._usage_reported:
            usage["input_tokens"] = self.usage["input_tokens"]
        out.append(self._event("message_delta", {
            "type": "message_delta",
            "delta": {
                "stop_reason": STOP_REASON_MAP.get(
                    self.finish_reason or "stop", "end_turn"
                ),
                "stop_sequence": None,
            },
            "usage": usage,
        }))
        out.append(self._event("message_stop", {"type": "message_stop"}))
        return out


# ------------------------------------------------------------------ handler


async def messages(request: web.Request) -> web.StreamResponse:
    state = request.app["state"]
    started = time.monotonic()
    trace = request.get("trace")
    if trace is not None:
        trace.end("auth")
    try:
        body = await request.json()
    except Exception:
        return _anthropic_error(400, "invalid JSON body")
    model = body.get("model")
    if not model or not isinstance(model, str):
        return _anthropic_error(400, "'model' is required")
    if not body.get("messages"):
        return _anthropic_error(400, "'messages' is required")
    if body.get("max_tokens") is None:
        return _anthropic_error(400, "'max_tokens' is required")

    if model.startswith("anthropic:"):
        return await _cloud_passthrough(request, state, body,
                                        model[len("anthropic:"):])

    canonical = to_canonical(model)
    if trace is not None:
        trace.model = canonical
    openai_body = anthropic_request_to_openai(body)
    # Forced tool_choice ({type: "tool"} → forced function call after the
    # OpenAI conversion above) is grammar-constrained exactly like the
    # OpenAI dialect: validate it here (400 in the Anthropic error shape,
    # unsupported schema feature named) and steer to structured-capable
    # endpoints when the model has any.
    capability = Capability.CHAT_COMPLETION
    try:
        structured = inspect_structured(openai_body)
    except ValueError as e:
        state.metrics.record_structured_rejected()
        return _anthropic_error(400, str(e))
    if structured is not None:
        state.metrics.record_structured_request(structured.kind)
        if state.registry.find_by_model(
            canonical, Capability.STRUCTURED_OUTPUTS
        ):
            capability = Capability.STRUCTURED_OUTPUTS
    # Multi-LoRA routing (docs/lora.md) — same resolution and 400 shape
    # contract as proxy_openai_post, refusals in the Anthropic error shape.
    from llmlb_tpu_torch.lora.gateway import lora_route_for

    try:
        lora_route = lora_route_for(state, openai_body)
    except ValueError as e:
        state.metrics.record_lora_route("rejected")
        return _anthropic_error(400, str(e))
    if lora_route is not None:
        canonical = lora_route.canonical
        state.metrics.record_lora_route(lora_route.kind)
        if lora_route.capability is not None:
            capability = lora_route.capability
    prefix_hash = prefix_affinity_hash(
        lora_route.base_canonical if lora_route is not None else canonical,
        affinity_text_from_body(body),
        lora=lora_route.adapter if lora_route is not None else None,
    )
    is_stream = bool(body.get("stream"))
    if is_stream:
        openai_body["stream"] = True
        openai_body["stream_options"] = {"include_usage": True}

    # Overload protection (docs/scheduling.md): same pipeline as
    # proxy_openai_post — per-key token buckets, request deadline, WFQ
    # tenant — with refusals in the Anthropic error shape.
    try:
        deadline_at = deadline_at_of(request, state, started)
    except ValueError as e:
        return _anthropic_error(400, str(e))
    tenant, tenant_name = tenant_of(request)
    refused = ratelimit_verdict(
        state, request, estimate_tokens(_chat_prompt_text(openai_body))
    )
    if refused is not None:
        reason, retry_after = refused
        return _anthropic_error(
            429,
            f"rate limit exceeded ({reason}); retry after {retry_after}s",
            "rate_limit_error",
            headers={"Retry-After": str(retry_after)},
        )
    wfq_weight = state.admission.weight_for(tenant_name)
    prio = priority_label(body)

    # Disaggregation role steering — same policy as proxy_openai_post
    # (docs/disaggregation.md): long cold-prefix prompts prefer
    # prefill-capable endpoints, everything else avoids prefill-only ones.
    from llmlb_tpu_torch.disagg.gateway import endpoint_role, is_prefill_heavy

    prefill_heavy = is_prefill_heavy(
        state, canonical,
        estimate_tokens(_chat_prompt_text(openai_body)), prefix_hash,
    )

    # Same failover loop as proxy_openai_post: re-select excluding failed
    # endpoints, retry under the attempt cap + global budget; streams fail
    # over only before the first Anthropic event reaches the client.
    fo = FailoverController(
        state, canonical, trace=trace,
        candidates_fn=lambda: [
            ep for ep, _ in state.registry.find_by_model(canonical, capability)
        ],
    )
    while True:
        queue_timeout = (fo.config.failover_queue_timeout_s
                         if fo.failed_ids else None)
        if deadline_at is not None:
            remaining = deadline_at - time.monotonic()
            if remaining <= 0:
                state.metrics.record_deadline_shed(canonical)
                return _anthropic_error(
                    504, "request deadline exceeded before an endpoint was "
                    "available", "timeout_error",
                )
            cap = (queue_timeout if queue_timeout is not None
                   else state.load_manager.queue_config.queue_timeout_s)
            queue_timeout = min(cap, remaining)
        try:
            selection = await select_endpoint_with_queue(
                state, canonical, capability, TpsApiKind.CHAT,
                trace=trace, prefix_hash=prefix_hash, exclude=fo.failed_ids,
                queue_timeout_s=queue_timeout,
                tenant=tenant, weight=wfq_weight,
                prefill_heavy=prefill_heavy,
            )
        except QueueTimeout:
            if deadline_at is not None and time.monotonic() >= deadline_at:
                state.metrics.record_deadline_shed(canonical)
                return _anthropic_error(
                    504, "request deadline exceeded while queued",
                    "timeout_error",
                )
            return _anthropic_error(
                503, "all endpoints busy", "overloaded_error",
                headers={"Retry-After": str(retry_after_seconds(
                    state, canonical, capability
                ))},
            )
        if selection is None:
            return _anthropic_error(
                404, f"model {model!r} is not available", "not_found_error"
            )
        endpoint, engine_model, lease, chosen_model = selection
        openai_body["model"] = engine_model
        if lora_route is not None:
            from llmlb_tpu_torch.lora.gateway import forward_model_name

            openai_body["model"] = forward_model_name(
                lora_route, engine_model, lora_route.base_canonical
            )
            openai_body["lora"] = lora_route.adapter

        # Durable streams (gateway/replay.py): arm tpu:// engine streams so
        # a mid-stream engine death resumes token-identically elsewhere and
        # splices into the SAME Anthropic event stream (no second
        # message_start, exactly one message_stop).
        arm_replay = (
            is_stream
            and state.config.stream_resume
            and state.config.stream_resume_attempts > 0
            and endpoint.endpoint_type.value in RESUMABLE_ENDPOINT_TYPES
        )
        if arm_replay:
            openai_body["llmlb_replay"] = True
        else:
            openai_body.pop("llmlb_replay", None)

        headers = {"Content-Type": "application/json"}
        if endpoint.api_key:
            headers["Authorization"] = f"Bearer {endpoint.api_key}"
        rid = request.get("request_id")
        if rid:
            headers[REQUEST_ID_HEADER] = rid
        if deadline_at is not None:
            remaining_ms = (deadline_at - time.monotonic()) * 1000.0
            if remaining_ms <= 0:
                lease.fail()
                state.metrics.record_deadline_shed(canonical)
                return _anthropic_error(
                    504, "request deadline exceeded before forwarding",
                    "timeout_error",
                )
            headers["X-Request-Deadline-Ms"] = str(max(1, int(remaining_ms)))
        if trace is not None:
            trace.begin("proxy")
        try:
            if endpoint_role(endpoint, chosen_model) == "prefill":
                # two-phase disaggregated handoff: prefill here, adopt on a
                # decode-capable endpoint; the returned upstream is a normal
                # chat-completions response/SSE, so the Anthropic transform
                # below consumes it unchanged (docs/disaggregation.md)
                upstream, endpoint, lease, _adopt_model = (
                    await _handoff_upstream(
                        state, fo, endpoint, lease, canonical, capability,
                        TpsApiKind.CHAT, openai_body, headers, deadline_at,
                        is_stream, engine_model,
                    )
                )
            else:
                upstream = await upstream_post(
                    state, endpoint, "/v1/chat/completions",
                    json=openai_body,
                    headers=headers,
                    timeout=http.ClientTimeout(
                        total=state.config.inference_timeout_s
                    ),
                )
        except HandoffOrchestrationError as e:
            fo.record_failure(e.endpoint, e.lease, e.reason)
            if trace is not None:
                trace.end("proxy")
            if await fo.should_retry(e.reason):
                continue
            return _anthropic_error(
                502, f"handoff adoption failed: {e.reason}", "api_error"
            )
        except RETRYABLE_EXCEPTIONS as e:
            reason = ("timeout" if isinstance(e, asyncio.TimeoutError)
                      else "connect_error")
            fo.record_failure(endpoint, lease, reason)
            if trace is not None:
                trace.end("proxy")
            if await fo.should_retry(reason):
                continue
            return _anthropic_error(
                502, f"upstream unreachable: {type(e).__name__}", "api_error"
            )

        if upstream.status != 200:
            status_code = upstream.status
            try:
                detail = (await upstream.read())[:1024].decode(errors="replace")
            except RETRYABLE_EXCEPTIONS:
                detail = "<error body unreadable>"
            upstream.release()
            if trace is not None:
                trace.end("proxy")
            if status_code in fo.config.retryable_statuses:
                reason = f"http_{status_code}"
                fo.record_failure(endpoint, lease, reason)
                if await fo.should_retry(reason):
                    continue
            else:
                # non-retryable 4xx: not endpoint sickness, but liveness
                # evidence — resolves a half-open probe
                lease.fail()
                fo.record_alive(endpoint)
            _record(state, endpoint=endpoint, model=canonical,
                    api_kind=TpsApiKind.CHAT, path="/v1/messages", status=502,
                    started=started, client_ip=request.remote,
                    auth=request.get("auth"), error=detail)
            return _anthropic_error(
                502, f"upstream returned {status_code}: {detail}", "api_error"
            )

        if is_stream:
            replay = None
            if arm_replay:
                replay = ReplayState(
                    openai_body, capability=capability,
                    api_kind=TpsApiKind.CHAT, tenant=tenant,
                    weight=wfq_weight, deadline_at=deadline_at, rid=rid,
                    prefix_hash=prefix_hash,
                    max_attempts=state.config.stream_resume_attempts,
                )
            result = await _stream_transform(
                request, state, upstream, endpoint, canonical, started, lease,
                body, openai_body, trace=trace, failover=fo, priority=prio,
                replay=replay,
            )
            if isinstance(result, PreStreamFailure):
                fo.record_failure(endpoint, lease, "stream_pre_byte")
                if trace is not None:
                    trace.end("proxy")
                if await fo.should_retry("stream_pre_byte"):
                    continue
                return _anthropic_error(
                    502,
                    f"upstream stream failed before first byte: "
                    f"{result.error}",
                    "api_error",
                )
            return result

        observe_first_token(state, trace, canonical, endpoint.name, started)
        try:
            raw = await upstream.read()
        except RETRYABLE_EXCEPTIONS as e:
            # endpoint died mid-body: invisible to the client, fails over
            upstream.release()
            fo.record_failure(endpoint, lease, "read_error")
            if trace is not None:
                trace.end("proxy")
            if await fo.should_retry("read_error"):
                continue
            return _anthropic_error(
                502, f"upstream response read failed: {type(e).__name__}",
                "api_error",
            )
        upstream.release()
        if trace is not None:
            trace.end("proxy")
        try:
            openai_resp = json.loads(raw)
        except ValueError:
            # the endpoint answered (malformed): alive, but not a success
            lease.fail()
            fo.record_alive(endpoint)
            return _anthropic_error(
                502, "invalid upstream response", "api_error"
            )
        anthropic_resp = openai_response_to_anthropic(openai_resp, model)
        usage = anthropic_resp["usage"]
        lease.complete_with_tokens(usage["input_tokens"],
                                   usage["output_tokens"])
        fo.record_success(endpoint)
        # non-streaming goodput: only the TTFT target applies
        state.metrics.record_slo(canonical, time.monotonic() - started, None,
                                 priority=prio)
        _record(state, endpoint=endpoint, model=canonical,
                api_kind=TpsApiKind.CHAT, path="/v1/messages", status=200,
                started=started,
                prompt_tokens=usage["input_tokens"],
                completion_tokens=usage["output_tokens"],
                client_ip=request.remote, auth=request.get("auth"))
        return web.json_response(anthropic_resp)


async def _stream_transform(
    request, state, upstream, endpoint, model, started, lease,
    original_body, openai_body, trace=None, failover=None,
    priority: str = "normal", replay: ReplayState | None = None,
) -> "web.StreamResponse | PreStreamFailure":
    # First upstream chunk is pulled BEFORE the client response is prepared:
    # a failure there is invisible to the client and fails over.
    iterator = upstream.content.iter_any()
    first_chunk = None
    try:
        first_chunk = await iterator.__anext__()
    except StopAsyncIteration:
        first_chunk = None
    except (http.ClientError, asyncio.TimeoutError, OSError,
            ConnectionResetError) as e:
        upstream.release()
        return PreStreamFailure(f"{type(e).__name__}: {e}")

    headers = {"Content-Type": "text/event-stream"}
    rid = request.get("request_id")
    if rid:
        headers[REQUEST_ID_HEADER] = rid
    resp = web.StreamResponse(status=200, headers=headers)
    await resp.prepare(request)
    lease.complete()
    # Estimate from the flattened OpenAI conversion: it folds system prompts
    # and content-block (tool) messages into plain strings, which the raw
    # Anthropic body does not.
    prompt_text = "\n".join(
        m.get("content") for m in openai_body.get("messages", [])
        if isinstance(m, dict) and isinstance(m.get("content"), str)
    )
    encoder = AnthropicStreamEncoder(
        original_body.get("model", model),
        input_token_estimate=estimate_tokens(prompt_text),
    )
    buffer = b""
    status = 200
    error = None
    upstream_failed = False
    # durable streams: a cut booked in-line (victim charged at the moment of
    # the cut) must not be booked again by the finally block
    outcome_booked = False
    splicer: ChunkSplicer | None = None  # active after the first resume
    # set when the upstream's [DONE] has been consumed: a transport reset
    # arriving AFTER a complete stream is not a cut (same guard as the
    # OpenAI armed pump's terminal_sent)
    upstream_done = False
    # Sampled token timeline + SLO inputs, same contract as the OpenAI
    # passthrough (_forward_stream): one mark per upstream data chunk that
    # produced client-visible events.
    timeline = (TokenTimeline()
                if trace is not None and state.traces.sample_timeline()
                else None)
    ttft_s: float | None = None

    # Hot loop locals: the dialect transform must JSON-parse each frame (it
    # rewrites OpenAI chunks into Anthropic events, unlike the byte-for-byte
    # OpenAI passthrough), but the line splitter and writer should not pay
    # attribute walks per line on top of that.
    loads = json.loads
    encoder_feed = encoder.feed

    # Slow-loris protection: the shared per-stream watchdog guard
    # (api_openai.StreamWriteGuard) — a non-draining client aborts the
    # pump instead of pinning the slot; no per-chunk wait_for.
    guard = stream_write_guard(state, resp, endpoint, "/v1/messages")
    resp_write = guard.write if guard.active() else resp.write

    async def pump(raw_chunk: bytes) -> None:
        nonlocal buffer, upstream_done
        buffer += raw_chunk
        wrote = False
        while b"\n" in buffer:
            line, buffer = buffer.split(b"\n", 1)
            line = line.strip()
            if not line.startswith(b"data:"):
                continue
            data = line[len(b"data:"):].strip()
            if not data:
                continue
            if data == b"[DONE]":
                upstream_done = True
                continue
            try:
                chunk = loads(data)
            except ValueError:
                continue
            if replay is not None:
                if splicer is None:
                    # primary segment: account committed ids + chars fed to
                    # the encoder; gateway-internal replay frames never feed
                    if not replay.note_openai_chunk(chunk):
                        continue
                else:
                    # resumed segment: the adopter re-emits the full text —
                    # splice off what the encoder already consumed
                    if chunk.get("object") == REPLAY_OBJECT:
                        replay.note_openai_chunk(chunk)
                        continue
                    chunk = splicer.splice(chunk)
                    if chunk is None:
                        continue
            for event in encoder_feed(chunk):
                await resp_write(event)
                wrote = True
        if wrote and timeline is not None:
            timeline.mark()

    try:
        if first_chunk is not None:
            observe_first_token(state, trace, model, endpoint.name,
                                started, streaming=True)
            ttft_s = time.monotonic() - started
            await pump(first_chunk)
            next_chunk = iterator.__anext__
            while True:
                try:
                    raw_chunk = await next_chunk()
                except StopAsyncIteration:
                    break
                except (http.ClientError, asyncio.TimeoutError,
                        OSError) as e:
                    if upstream_done:
                        break  # the stream already completed cleanly
                    if replay is not None and failover is not None:
                        # book the victim exactly once (breaker + one
                        # stream_interruption; also excludes it from the
                        # re-selection) and splice a token-identical
                        # continuation into THIS event stream — the open
                        # encoder keeps its state, so there is no second
                        # message_start and exactly one message_stop
                        failover.record_failure(
                            endpoint, None, "stream_interrupted",
                            stream_interrupted=True,
                        )
                        resumed = await _acquire_resume(
                            state, failover, replay, model, trace=trace,
                        )
                        if resumed is not None:
                            upstream.release()
                            upstream, endpoint, iterator, raw_chunk = resumed
                            next_chunk = iterator.__anext__
                            buffer = b""  # drop the dead stream's partials
                            splicer = ChunkSplicer(replay)
                            replay.mark_ledger_stale()
                            await pump(raw_chunk)
                            continue
                        outcome_booked = True  # victim booked above
                        status = 502
                        error = f"stream interrupted: {type(e).__name__}"
                        await resp_write(anthropic_error_event(error))
                        break
                    # mid-stream upstream cut: native Anthropic error event,
                    # then count it against the endpoint
                    status = 502
                    error = f"stream interrupted: {type(e).__name__}"
                    upstream_failed = True
                    # guarded: a stalled client must not pin the handler on
                    # the farewell frame either
                    await resp_write(anthropic_error_event(error))
                    break
                await pump(raw_chunk)
        if status == 200:
            for event in encoder.finish():
                await resp_write(event)
    except asyncio.CancelledError:
        # watchdog cancel landing at a non-write await (post-race): only a
        # fired guard converts, anything else propagates
        if not guard.fired:
            raise
        status = 502
        error = f"stream write timeout: {guard.timeout_error()}"
        state.metrics.record_stream_write_timeout(model)
    except StreamWriteTimeout as e:
        # the client stopped draining (slow-loris): abort so the engine
        # slot frees; counted, not blamed on the endpoint
        status = 502
        error = f"stream write timeout: {e}"
        state.metrics.record_stream_write_timeout(model)
    except (http.ClientError, asyncio.TimeoutError, OSError,
            ConnectionResetError) as e:
        # client went away mid-write: not endpoint sickness
        status = 502
        error = error or f"client disconnected: {type(e).__name__}"
    finally:
        guard.close()
        upstream.release()
        if trace is not None:
            trace.end("decode")
            trace.end("proxy")
        if not outcome_booked:
            book_stream_outcome(state, failover, endpoint, model,
                                upstream_failed=upstream_failed,
                                completed=status == 200)
        ct = encoder.usage["output_tokens"]
        duration_s = time.monotonic() - started
        if trace is not None and timeline is not None:
            trace.attach_timeline(timeline)
        if status == 200 and ttft_s is not None:
            itl_mean = (max(0.0, duration_s - ttft_s) / (ct - 1)
                        if ct and ct > 1 else None)
            state.metrics.record_slo(model, ttft_s, itl_mean,
                                     priority=priority)
        if ct:
            state.load_manager.update_tps(
                endpoint.id, model, TpsApiKind.CHAT, ct, duration_s
            )
        _record(state, endpoint=endpoint, model=model, api_kind=TpsApiKind.CHAT,
                path="/v1/messages", status=status, started=started,
                prompt_tokens=encoder.usage["input_tokens"],
                completion_tokens=ct, client_ip=request.remote,
                auth=request.get("auth"), error=error, stream=True)
    return resp


async def _cloud_passthrough(request, state, body, model) -> web.StreamResponse:
    from llmlb_tpu_torch.gateway.api_cloud import cloud_post

    key = os.environ.get("ANTHROPIC_API_KEY")
    if not key:
        return _anthropic_error(
            401, "ANTHROPIC_API_KEY not configured", "authentication_error"
        )
    payload = dict(body)
    payload["model"] = model
    upstream = await cloud_post(
        state, "anthropic", ANTHROPIC_BASE + "/v1/messages",
        json=payload,
        headers={
            "x-api-key": key,
            "anthropic-version": request.headers.get(
                "anthropic-version", "2023-06-01"
            ),
        },
        timeout=http.ClientTimeout(total=state.config.inference_timeout_s),
    )
    if payload.get("stream"):
        resp = web.StreamResponse(
            status=upstream.status,
            headers={"Content-Type": "text/event-stream"},
        )
        await resp.prepare(request)
        try:
            async for chunk in upstream.content.iter_any():
                await resp.write(chunk)
        finally:
            upstream.release()
        return resp
    raw = await upstream.read()
    upstream.release()
    return web.Response(body=raw, status=upstream.status,
                        content_type="application/json")
