"""Token accounting for proxied traffic.

Parity with reference token/mod.rs: a streaming accumulator that line-splits
SSE as bytes pass through untouched and captures `usage` when the upstream
provides it (our engines always do; so do OpenAI-compatible servers with
stream_options.include_usage), otherwise accumulates content text and
estimates. The port's copy of llmlb_tpu/gateway/token_accounting.py: a C++
twin of the hot SSE line-splitter lives in llmlb_tpu_torch/native/
(sse_scan.cpp, used when built). One difference: the reference estimates
with tiktoken's cl100k_base, whose BPE file tiktoken downloads on first
use; the port never fetches anything, so it estimates at ~4 characters a
token, the reference's own fallback (ROADMAP C15).
"""

from __future__ import annotations

import json


def estimate_tokens(text: str) -> int:
    """~4 characters a token (the reference's fallback estimate)."""
    if not text:
        return 0
    return max(1, len(text) // 4)


def extract_usage_from_response(body: dict) -> tuple[int, int] | None:
    usage = body.get("usage")
    if not isinstance(usage, dict):
        return None
    pt = usage.get("prompt_tokens", usage.get("input_tokens"))
    ct = usage.get("completion_tokens", usage.get("output_tokens"))
    if pt is None and ct is None:
        return None
    return int(pt or 0), int(ct or 0)


class StreamingTokenAccumulator:
    """Feed raw SSE bytes; get usage (reported or estimated) at stream end.

    When the C++ scanner (native/sse_scan.cpp) is available, the hot path is
    one native call per chunk; raw bytes are retained so the content-text
    estimation fallback can run in Python at finalize time only if the
    upstream never reported usage.
    """

    def __init__(self):
        self._buffer = b""
        self._content_parts: list[str] = []
        self._usage: tuple[int, int] | None = None
        self._chunks_seen = 0
        self._native = None
        self._raw: list[bytes] | None = None
        try:
            from llmlb_tpu_torch.native import NativeSseScanner

            self._native = NativeSseScanner()
            self._raw = []
        except Exception:
            self._native = None

    def feed(self, chunk: bytes) -> None:
        if self._native is not None:
            self._native.feed(chunk)
            # retain raw bytes only until a usage object shows up — once the
            # upstream has reported, the estimation fallback can never run
            if self._raw is not None:
                if self._native.usage() is not None:
                    self._raw = None
                else:
                    self._raw.append(chunk)
            return
        self._feed_python(chunk)

    def _feed_python(self, chunk: bytes) -> None:
        self._buffer += chunk
        while b"\n" in self._buffer:
            line, self._buffer = self._buffer.split(b"\n", 1)
            self._feed_line(line.strip())

    def _feed_line(self, line: bytes) -> None:
        if not line.startswith(b"data:"):
            return
        data = line[len(b"data:"):].strip()
        if not data or data == b"[DONE]":
            return
        try:
            payload = json.loads(data)
        except (ValueError, UnicodeDecodeError):
            return
        if not isinstance(payload, dict):
            return
        self._chunks_seen += 1
        usage = extract_usage_from_response(payload)
        if usage is not None and usage != (0, 0):
            self._usage = usage
        for choice in payload.get("choices") or []:
            if not isinstance(choice, dict):
                continue
            delta = choice.get("delta") or {}
            content = delta.get("content")
            if isinstance(content, str):
                self._content_parts.append(content)
            text = choice.get("text")
            if isinstance(text, str):
                self._content_parts.append(text)
        # Responses-API streams: output_text deltas
        if payload.get("type") == "response.output_text.delta":
            delta = payload.get("delta")
            if isinstance(delta, str):
                self._content_parts.append(delta)

    def finalize(self, prompt_text: str = "") -> tuple[int, int, bool]:
        """Returns (prompt_tokens, completion_tokens, was_reported)."""
        if self._native is not None:
            usage = self._native.usage()
            if usage is not None:
                return usage[0], usage[1], True
            # no reported usage: replay retained bytes through the Python
            # parser (off the hot path) to estimate from content text
            raw, self._raw = self._raw or [], []
            self._native = None
            for chunk in raw:
                self._feed_python(chunk)
        if self._usage is not None:
            return self._usage[0], self._usage[1], True
        return (
            estimate_tokens(prompt_text),
            estimate_tokens("".join(self._content_parts)),
            False,
        )

    @property
    def chunks_seen(self) -> int:
        if self._native is not None:
            return self._native.frames
        return self._chunks_seen
