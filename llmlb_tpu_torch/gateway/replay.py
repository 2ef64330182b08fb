"""Durable streams: per-stream replay state + continuation splicing.

Failover alone stops at "mid-stream failures are not retried — bytes
already left". This module moves that line: while an SSE stream flows through the
gateway, a `ReplayState` accumulates the token ids the engine has committed
(shipped as interleaved ``data: {"object": "llmlb.replay", "tokens": [...]}``
frames when the gateway arms a stream with ``llmlb_replay: true``) plus the
exact completion text already forwarded to the client. When the engine dies
mid-stream, the proxy re-runs endpoint selection and POSTs the ORIGINAL chat
body + the committed ids to the new engine's ``/v1/resume`` — the engine's
adopt/replay path, so the continuation is token-identical for greedy and
seeded streams — then SPLICES the resumed stream into the same client
response with `ChunkSplicer`: the duplicated prefix (the adopter re-emits the
full text) is dropped, the second role delta is stripped, and the client sees
one uninterrupted stream with exactly one terminal frame.

Why token ids and not text: replaying re-tokenized text would not land KV at
the same absolute positions; replaying the committed ids does (chunk-prefill
of prompt+committed — engine/scheduler.ParkedState semantics), which is what
makes the continuation bit-identical. The ids the gateway missed between the
last replay frame and the cut are simply regenerated: generation is
deterministic given the committed prefix for greedy/seeded sampling, and for
unseeded stochastic streams the engine ships each frame's ids BEFORE the text
they produced, so the replayed ids always cover every character the client
has seen.
"""

from __future__ import annotations

import json

REPLAY_OBJECT = "llmlb.replay"

# Endpoint types whose engines speak /v1/resume (the in-tree engines).
# Everything else streams through the historical byte-for-byte path and a
# mid-stream cut stays terminal, exactly as before this module existed.
RESUMABLE_ENDPOINT_TYPES = ("tpu",)


class FrameSplitter:
    """Split an SSE byte stream into complete frames at ``\\n\\n`` boundaries.

    The armed pump forwards whole frames only: a cut that lands mid-frame
    must not leak a partial event to the client (the resumed stream re-emits
    that frame's text, and the splice counts only forwarded characters)."""

    __slots__ = ("_buf",)

    def __init__(self):
        self._buf = b""

    def push(self, chunk: bytes) -> list[bytes]:
        """Complete frames (terminator included) arrived so far."""
        self._buf += chunk
        frames: list[bytes] = []
        while True:
            idx = self._buf.find(b"\n\n")
            if idx < 0:
                return frames
            frames.append(self._buf[: idx + 2])
            self._buf = self._buf[idx + 2:]


def is_done_frame(frame: bytes) -> bool:
    """Exact terminal-frame test: a ``data:`` line whose payload is the
    literal ``[DONE]`` — a substring test would false-positive on completion
    CONTENT that happens to contain the text \"[DONE]\"."""
    for line in frame.split(b"\n"):
        line = line.strip()
        if (line.startswith(b"data:")
                and line[len(b"data:"):].strip() == b"[DONE]"):
            return True
    return False


def parse_data_frame(frame: bytes) -> dict | None:
    """The JSON payload of one SSE frame's ``data:`` line, or None for
    non-data frames, ``[DONE]``, and unparseable payloads."""
    for line in frame.split(b"\n"):
        line = line.strip()
        if not line.startswith(b"data:"):
            continue
        data = line[len(b"data:"):].strip()
        if not data or data == b"[DONE]":
            return None
        try:
            payload = json.loads(data)
        except (ValueError, UnicodeDecodeError):
            return None
        return payload if isinstance(payload, dict) else None
    return None


class ReplayState:
    """Everything one armed stream needs to continue on another engine:
    the engine-bound request body, the committed token ids, and the exact
    client-visible characters already forwarded (content and tool-call
    arguments tracked separately — they are distinct delta channels)."""

    def __init__(self, payload: dict, *, capability=None, api_kind=None,
                 tenant: str | None = None, weight: float = 1.0,
                 deadline_at: float | None = None, rid: str | None = None,
                 prefix_hash: str | None = None, max_attempts: int = 2):
        # the body as forwarded to the FIRST engine; `model` is rewritten to
        # each resume target's engine-local name at acquire time
        self.payload = dict(payload)
        self.payload.pop("committed_ids", None)
        self.capability = capability
        self.api_kind = api_kind
        self.tenant = tenant
        self.weight = weight
        self.deadline_at = deadline_at
        self.rid = rid
        self.prefix_hash = prefix_hash
        self.max_attempts = max(0, int(max_attempts))
        self.attempts = 0
        self.committed: list[int] = []
        # set at each resume: the NEXT replay frame replaces the ledger
        # instead of extending it (see mark_ledger_stale)
        self._ledger_stale = False
        self.sent_content = 0
        self.sent_args = 0
        self.tool_open_sent = False
        self.resumes = 0  # successful splices on this stream
        # identity of the stream as the client first saw it: continuation
        # chunks are re-stamped with these so the splice is seamless
        self.completion_id: str | None = None
        self.created: int | None = None
        # the endpoint currently serving this stream: a resume first asks
        # it (POST /v1/kv/export) for the parked stream's serialized KV
        # pages so the adopter can land bytes instead of replaying — a
        # dead origin just fails the fetch fast and replay proceeds
        self.origin = None

    # ------------------------------------------------------------- accounting

    def note_openai_chunk(self, obj: dict) -> bool:
        """Account one upstream data-frame payload. Returns False for
        replay frames (gateway-internal — never forwarded to the client),
        True for client-relevant chunks."""
        if obj.get("object") == REPLAY_OBJECT:
            toks = obj.get("tokens")
            if isinstance(toks, list):
                if self._ledger_stale:
                    # first frame from an adopter: it re-reports the FULL
                    # committed sequence, superseding the pre-resume ledger
                    self.committed = []
                    self._ledger_stale = False
                self.committed.extend(int(t) for t in toks)
            return False
        if self.completion_id is None and isinstance(obj.get("id"), str):
            self.completion_id = obj["id"]
            created = obj.get("created")
            if isinstance(created, int):
                self.created = created
        for choice in obj.get("choices") or []:
            if not isinstance(choice, dict):
                continue
            delta = choice.get("delta") or {}
            content = delta.get("content")
            if isinstance(content, str):
                self.sent_content += len(content)
            for tc in delta.get("tool_calls") or []:
                if not isinstance(tc, dict):
                    continue
                if tc.get("id") or (tc.get("function") or {}).get("name"):
                    self.tool_open_sent = True
                args = (tc.get("function") or {}).get("arguments")
                if isinstance(args, str):
                    self.sent_args += len(args)
        return True

    def mark_ledger_stale(self) -> None:
        """Called at each resume: the adopter's replay frames re-report the
        full committed sequence (replayed ids first, continuation after), so
        a SECOND cut replays from the fresh ledger. The swap is LAZY — it
        happens at the adopter's first replay frame, not here — so a cut
        landing before any frame arrives still resumes from the previous
        ledger, which by the ships-tokens-before-text contract covers every
        character the client has seen."""
        self._ledger_stale = True

    def resume_body(self, engine_model: str | None,
                    kv_pages: dict | None = None) -> dict:
        body = dict(self.payload)
        if engine_model:
            body["model"] = engine_model
        body["committed_ids"] = list(self.committed)
        body["stream"] = True
        body["llmlb_replay"] = True
        if kv_pages is not None:
            # serialized KV pages fetched from the draining origin's
            # /v1/kv/export: the adopter lands them instead of replaying
            # the prefill (engine/kv_transfer.py); incompatible payloads
            # fall back engine-side, never here
            body["kv_pages"] = kv_pages
        return body


def _drop_prefix(text: str, skip: int) -> tuple[str, int]:
    if skip <= 0:
        return text, 0
    if skip >= len(text):
        return "", skip - len(text)
    return text[skip:], 0


class ChunkSplicer:
    """Rewrites a resumed upstream's chunks so the client stream continues
    seamlessly: the second role delta is stripped, the re-emitted completion
    prefix (content and tool-call arguments the client already has) is
    dropped, a duplicate forced-tool-call opening (id+name) is suppressed,
    and every chunk is re-stamped with the original stream's id/created.
    Forwarded characters are counted back into the ReplayState so a second
    cut splices against the up-to-date offsets."""

    def __init__(self, replay: ReplayState):
        self.replay = replay
        self.skip_content = replay.sent_content
        self.skip_args = replay.sent_args
        self.suppress_tool_open = replay.tool_open_sent

    def splice(self, obj: dict) -> dict | None:
        """Spliced chunk dict to forward, or None when nothing in this chunk
        is new to the client (pure duplicate / role-only chunk)."""
        out = dict(obj)
        if self.replay.completion_id is not None:
            out["id"] = self.replay.completion_id
        if self.replay.created is not None:
            out["created"] = self.replay.created
        meaningful = isinstance(out.get("usage"), dict)
        choices_out = []
        for choice in out.get("choices") or []:
            if not isinstance(choice, dict):
                choices_out.append(choice)
                continue
            choice = dict(choice)
            delta = dict(choice.get("delta") or {})
            delta.pop("role", None)  # exactly one role delta per stream
            content = delta.get("content")
            if isinstance(content, str) and content:
                keep, self.skip_content = _drop_prefix(content,
                                                       self.skip_content)
                delta["content"] = keep
                self.replay.sent_content += len(keep)
                if keep:
                    meaningful = True
            tool_calls = delta.get("tool_calls")
            if isinstance(tool_calls, list) and tool_calls:
                spliced_tcs = []
                for tc in tool_calls:
                    if not isinstance(tc, dict):
                        continue
                    tc = dict(tc)
                    fn = dict(tc.get("function") or {})
                    if self.suppress_tool_open:
                        # the client already holds the opening tool delta
                        # from the first engine (its call id is canonical)
                        tc.pop("id", None)
                        tc.pop("type", None)
                        fn.pop("name", None)
                    elif tc.get("id") or fn.get("name"):
                        self.replay.tool_open_sent = True
                        self.suppress_tool_open = True
                        meaningful = True
                    args = fn.get("arguments")
                    if isinstance(args, str) and args:
                        keep, self.skip_args = _drop_prefix(args,
                                                            self.skip_args)
                        fn["arguments"] = keep
                        self.replay.sent_args += len(keep)
                        if keep:
                            meaningful = True
                    tc["function"] = fn
                    if tc.get("id") or fn.get("name") or fn.get("arguments"):
                        spliced_tcs.append(tc)
                if spliced_tcs:
                    delta["tool_calls"] = spliced_tcs
                else:
                    delta.pop("tool_calls", None)
            if choice.get("finish_reason"):
                meaningful = True
            choice["delta"] = delta
            choices_out.append(choice)
        out["choices"] = choices_out
        return out if meaningful else None


def encode_chunk_frame(obj: dict) -> bytes:
    """One spliced chunk back onto the wire as an SSE data frame."""
    return b"data: " + json.dumps(obj, separators=(",", ":")).encode() + b"\n\n"
