"""Prompt-lookup drafting: the port's own copy of `llmlb_tpu/spec/drafter.py`
(pure Python; the port imports nothing of the JAX package). A suffix-match
n-gram index over one request.

The proposal model of classic prompt-lookup decoding: if the last n tokens
of the sequence also occurred earlier (in the prompt or in already-generated
text), the tokens that followed that earlier occurrence are a strong guess
for what comes next. Deterministic, free of a second model, and strongest
exactly where this engine's traffic is predictable — shared-prefix chat
(answers quote the prompt) and JSON-mode output (keys and punctuation
repeat).

Index shape: for each n in [min_ngram, max_ngram] a dict mapping the n-gram
tuple to the position *after* its most recent occurrence. Updates are O(1)
per appended token (one dict write per n); proposals are O(max_ngram) dict
lookups plus a list slice. Indexing is deliberately one token *behind* the
live tail: when token t is appended, the n-grams ending at the PREVIOUS
position are indexed, so a lookup of the current tail can never match
itself — it finds the most recent strictly-earlier occurrence.

Determinism matters beyond reproducibility: in the reference's multihost
lockstep every host drafts from the same mirrored token history, so
identical proposals (and verify dispatches) fall out for free, and so in the
port's (engine/multihost.py): a follower drafts from its mirrored history.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Engine-level speculative-decoding defaults (per-request `speculative`
    knobs override `enabled`/`max_draft_tokens` within these bounds)."""

    enabled: bool = False
    max_draft_tokens: int = 4
    max_ngram: int = 3
    min_ngram: int = 1

    def __post_init__(self):
        if self.max_draft_tokens < 1:
            raise ValueError("max_draft_tokens must be >= 1")
        if not 1 <= self.min_ngram <= self.max_ngram:
            raise ValueError(
                "need 1 <= min_ngram <= max_ngram, got "
                f"[{self.min_ngram}, {self.max_ngram}]"
            )


class PromptLookupDrafter:
    """Per-request n-gram index over prompt + generated tokens.

    Owned by the scheduler step loop (one per speculating slot); not
    thread-safe by design. `append` is called for every emitted token,
    `propose` once per decode step that considers speculating.
    """

    __slots__ = ("max_ngram", "min_ngram", "tokens", "_index")

    def __init__(self, prompt_ids, *, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.tokens: list[int] = []
        # n -> {ngram tuple -> position AFTER its latest occurrence}; only
        # n-grams ending strictly before the current tail are present.
        self._index: dict[int, dict[tuple, int]] = {
            n: {} for n in range(min_ngram, max_ngram + 1)
        }
        for t in prompt_ids:
            self.append(int(t))

    def __len__(self) -> int:
        return len(self.tokens)

    def append(self, token: int) -> None:
        """Extend the sequence by one token, indexing the n-grams that end
        at the previous tail (they now have a known follower: `token`)."""
        tokens = self.tokens
        prev_len = len(tokens)
        tokens.append(token)
        for n in range(self.min_ngram, self.max_ngram + 1):
            if prev_len >= n:
                self._index[n][tuple(tokens[prev_len - n:prev_len])] = prev_len

    def propose(self, k: int) -> list[int]:
        """Up to `k` draft tokens continuing the current tail, from the most
        recent earlier occurrence of the longest matching tail n-gram.
        Empty list when nothing matches (the step falls back to plain
        decode — proposing from no evidence would just burn verify FLOPs)."""
        if k <= 0:
            return []
        tokens = self.tokens
        length = len(tokens)
        for n in range(min(self.max_ngram, length), self.min_ngram - 1, -1):
            follow = self._index[n].get(tuple(tokens[length - n:]))
            if follow is not None:
                return tokens[follow:follow + k]
        return []
