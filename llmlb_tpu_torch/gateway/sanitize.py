"""Request-body sanitization for stored history records.

The reference SPECS this contract (tests/contract/
openai_request_sanitization_spec.rs: inline base64 media must never land in
request_history) but ships the test ignored ("TDD RED: request history
sanitization not implemented"). Here it is implemented: `data:` URLs
(image_url), `input_audio.data` / `b64_json` payloads, and any long
base64-looking string under a media key are replaced with a size-preserving
redaction marker before the record is stored, and oversized bodies are
wrapped with a truncation envelope so the stored column stays valid JSON.
"""

from __future__ import annotations

import json
import re
from typing import Any

# Keys whose long base64 string values are inline media payloads. file_data
# carries Responses-API inline files; image_url appears both as an object
# ({"url": ...}) and as a bare string in the Responses API.
_MEDIA_KEYS = frozenset({"data", "b64_json", "audio", "image", "file_data"})
_REDACT_MIN_LEN = 256  # short values (format tags, tiny fixtures) pass through
_BASE64ISH = re.compile(r"^[A-Za-z0-9+/=_\-\s]+$")

MAX_STORED_BODY_BYTES = 32 * 1024


def _redact_data_url(value: str) -> str:
    """Keep only the media-type head of a data: URL. A malformed one with no
    comma must not leak through (base64 never contains commas, so the head
    is safe to keep only when a comma terminates it)."""
    if "," in value:
        head = value.split(",", 1)[0]
        return f"{head},<redacted {len(value)} bytes>"
    return f"data:<redacted {len(value)} bytes>"


def _walk(obj: Any) -> Any:
    if isinstance(obj, dict):
        out = {}
        for key, value in obj.items():
            if isinstance(value, str) and len(value) >= _REDACT_MIN_LEN:
                if value.startswith("data:"):
                    # inline data URL under ANY key (url, image_url string
                    # form, file_data, ...)
                    out[key] = _redact_data_url(value)
                    continue
                if key in _MEDIA_KEYS and _BASE64ISH.fullmatch(value):
                    # media keys redact only base64-looking payloads; a long
                    # plain-text value under a generic "data" key survives
                    # for the dashboard detail view
                    out[key] = f"<redacted {len(value)} bytes>"
                    continue
            out[key] = _walk(value)
        return out
    if isinstance(obj, list):
        return [_walk(item) for item in obj]
    return obj


def sanitize_request_body(body: Any) -> str | None:
    """JSON text safe to persist in request_history.request_body: inline
    media redacted, size bounded in BYTES, always valid JSON (or None when
    the body isn't JSON-serializable)."""
    try:
        text = json.dumps(_walk(body), ensure_ascii=False)
    except (TypeError, ValueError):
        return None
    encoded = text.encode("utf-8")
    if len(encoded) > MAX_STORED_BODY_BYTES:
        prefix = encoded[:MAX_STORED_BODY_BYTES // 2].decode("utf-8", "ignore")
        return json.dumps({
            "_truncated": True,
            "_original_bytes": len(encoded),
            "prefix": prefix,
        }, ensure_ascii=False)
    return text
