"""Tokenizers for the port's engine: its own copy of
`llmlb_tpu/engine/tokenizer.py`.

A checkpoint is served with the HF tokenizer saved beside its weights
(`HFTokenizer`, which imports `transformers` only when built). Random-weight
mode (benches, tests, the card smoke run) uses a byte-level tokenizer so the
full serving path (template -> encode -> decode -> stream) runs without
model artifacts.
"""

from __future__ import annotations

from typing import Protocol, Sequence


class Tokenizer(Protocol):
    eos_id: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    def apply_chat_template(self, messages: list[dict]) -> str: ...


def default_chat_template(messages: list[dict]) -> str:
    """Minimal ChatML-style rendering used when no HF template is available."""
    parts = []
    for m in messages:
        content = m.get("content") or ""
        if isinstance(content, list):  # OpenAI content-part arrays
            content = "".join(
                p.get("text", "") for p in content if isinstance(p, dict)
            )
        parts.append(f"<|{m.get('role', 'user')}|>\n{content}\n")
    parts.append("<|assistant|>\n")
    return "".join(parts)


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: ids 0..255 are bytes, 256 is EOS/pad."""

    def __init__(self, vocab_size: int = 512):
        if vocab_size < 258:
            raise ValueError("ByteTokenizer needs vocab_size >= 258")
        self.eos_id = 256
        self.bos_id = 257
        self.vocab_size = vocab_size

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: list[dict]) -> str:
        return default_chat_template(messages)


class HFTokenizer:
    """Wraps a transformers tokenizer loaded from a checkpoint directory:
    encode adds the special tokens (BOS), decode skips them, and chat
    messages render through the tokenizer's chat template, or through
    `default_chat_template` when it has none."""

    def __init__(self, model_dir: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(model_dir)
        self.eos_id = self._tok.eos_token_id

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=True)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: list[dict]) -> str:
        if getattr(self._tok, "chat_template", None):
            return self._tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
        return default_chat_template(messages)


class IncrementalDetokenizer:
    """Streams text out of a growing id sequence without re-emitting prefixes.

    Decodes the full sequence each call and diffs against what was already
    emitted — robust to multi-byte/multi-token characters (a naive per-token
    decode emits U+FFFD for split UTF-8 sequences).
    """

    def __init__(self, tokenizer: Tokenizer):
        self._tok = tokenizer
        self._ids: list[int] = []
        self._emitted = 0

    def push(self, token_id: int) -> str:
        self._ids.append(token_id)
        text = self._tok.decode(self._ids)
        # Hold back a trailing replacement char: likely a split multi-byte seq.
        safe_end = len(text)
        if text.endswith("�"):
            safe_end = len(text) - 1
        delta = text[self._emitted : safe_end]
        self._emitted = safe_end
        return delta

    def flush(self) -> str:
        text = self._tok.decode(self._ids)
        delta = text[self._emitted :]
        self._emitted = len(text)
        return delta
