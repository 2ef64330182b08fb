"""The port's own copy of `llmlb_tpu/structured/constraint.py`.

Token-level constraints: char-DFA × tokenizer vocabulary → mask tables.

The back of the pipeline. A `TokenConstraint` is a compiled artifact bound to
one (grammar, tokenizer) pair: per-DFA-state boolean rows over the vocabulary
(`allowed[s, v]` — sampling token v from state s keeps the match alive), built
by walking every token's decoded text through the character DFA via a trie so
shared token prefixes are walked once. EOS is allowed exactly in accepting
states, which is how terminal acceptance becomes `finish_reason="stop"`: once
the grammar is complete and nothing else may follow, the mask leaves only EOS
and the engine's normal EOS path fires.

`ConstraintState` is the per-request cursor the scheduler advances on each
sampled token (re-walking the token's text — a handful of dict lookups — so
no [S, V] next-state table is stored). `ConstraintCompiler` caches compiled
artifacts LRU per schema hash; repeat schemas skip both regex→DFA and the
vocabulary scan, which is the expensive part (O(states × trie nodes) — see
docs/structured-outputs.md for sizing).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import OrderedDict

import numpy as np

from llmlb_tpu_torch.structured.json_schema import (
    UnsupportedSchemaError,
    any_object_regex,
    schema_to_regex,
)
from llmlb_tpu_torch.structured.regex_dfa import CharDfa, compile_regex

# Additive logit bias for disallowed tokens. Large negative finite instead of
# -inf: adding -inf to an already -inf logit (top-k padding) would be fine,
# but finite keeps softmax/top-p free of inf-inf NaN edge cases everywhere.
MASK_NEG = np.float32(-1e30)


def spec_regex(spec: dict) -> str:
    """Constraint spec (the wire form riding SamplingParams) → regex.

    Specs:  {"type": "json_object"}
            {"type": "json_schema", "schema": {...}}
            {"type": "regex", "pattern": "..."}
            {"type": "tool_call", "name": "...", "schema": {...}}  (arguments
            object of a forced function call — constrained like json_schema;
            `name` is metadata for response shaping, not the grammar)
    """
    if not isinstance(spec, dict):
        raise ValueError("constraint spec must be an object")
    kind = spec.get("type")
    if kind == "json_object":
        return any_object_regex()
    if kind in ("json_schema", "tool_call"):
        schema = spec.get("schema")
        if schema is None:
            raise ValueError(f"constraint spec {kind!r} requires 'schema'")
        return schema_to_regex(schema)
    if kind == "regex":
        pattern = spec.get("pattern")
        if not isinstance(pattern, str) or not pattern:
            raise ValueError("constraint spec 'regex' requires 'pattern'")
        return pattern
    raise ValueError(f"unknown constraint spec type {kind!r}")


def spec_hash(spec: dict) -> str:
    return hashlib.sha256(
        json.dumps(spec, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()


def _token_trie(token_texts: list[str | None]) -> dict:
    """Trie over token texts; node = {char: child} plus "ids" at nodes where
    one or more tokens end. Tokens decoding to nothing are excluded — they
    would advance the grammar zero characters and let the model stall the
    constraint forever."""
    root: dict = {}
    for tid, text in enumerate(token_texts):
        if not text:
            continue
        node = root
        for ch in text:
            node = node.setdefault(ch, {})
        node.setdefault("ids", []).append(tid)
    return root


class TokenConstraint:
    """One grammar compiled against one vocabulary."""

    def __init__(self, dfa: CharDfa, token_texts: list[str | None],
                 eos_id: int):
        self.dfa = dfa
        self.eos_id = eos_id
        vocab = len(token_texts)
        states = dfa.num_states
        self.allowed = np.zeros((states, vocab), dtype=bool)
        trie = _token_trie(token_texts)
        # DFS per start state; the trie shares prefix walks across tokens.
        for s0 in range(states):
            stack = [(trie, s0)]
            row = self.allowed[s0]
            while stack:
                node, st = stack.pop()
                for ch, child in node.items():
                    if ch == "ids":
                        row[child] = True
                        continue
                    nxt = dfa.step(st, ch)
                    if nxt is not None:
                        stack.append((child, nxt))
            if dfa.is_accepting(s0):
                row[eos_id] = True
        self._texts = token_texts
        # Precomputed -inf-style bias rows are built lazily per state and
        # memoized: most requests only ever visit a fraction of the states.
        self._bias_rows: dict[int, np.ndarray] = {}
        self._bias_lock = threading.Lock()
        # Dense next-state table for the device grammar path (ops/grammar).
        # Built on first request and cached: fused decode registers each
        # compiled schema once, not per step.
        self._transition: np.ndarray | None = None

    def transition_table(self) -> np.ndarray:
        """Dense int32 ``[states, V]`` next-state table: ``table[s, v]`` is
        the DFA state after sampling token v from state s, or -1 when v is
        disallowed. Invariant: ``table[s, v] >= 0  <=>  allowed[s, v]``, so
        a bias derived on-device from this table (0 where >= 0, MASK_NEG
        where -1) is bit-identical to ``bias_row``. The EOS column maps an
        accepting state to itself (EOS ends the request; the self-loop keeps
        lockstep device cursors valid past it). Dead-end rows mirror the
        bias_row fail-open: everything -1 except EOS self-looping."""
        with self._bias_lock:
            table = self._transition
            if table is not None:
                return table
        states, vocab = self.allowed.shape
        table = np.full((states, vocab), -1, dtype=np.int32)
        trie = _token_trie(self._texts)
        for s0 in range(states):
            stack = [(trie, s0)]
            row = table[s0]
            while stack:
                node, st = stack.pop()
                for ch, child in node.items():
                    if ch == "ids":
                        row[child] = st
                        continue
                    nxt = self.dfa.step(st, ch)
                    if nxt is not None:
                        stack.append((child, nxt))
            if self.dfa.is_accepting(s0):
                row[self.eos_id] = s0
            if not self.allowed[s0].any():
                # dead-end fail-open: only EOS survives, self-looping
                row[:] = -1
                row[self.eos_id] = s0
        with self._bias_lock:
            if self._transition is None:
                self._transition = table
            return self._transition

    @property
    def num_states(self) -> int:
        return self.allowed.shape[0]

    @property
    def nbytes(self) -> int:
        return int(self.allowed.nbytes)

    def bias_row(self, state: int) -> np.ndarray:
        """Additive float32 [V] row: 0 where allowed, MASK_NEG where not."""
        with self._bias_lock:
            row = self._bias_rows.get(state)
            if row is None:
                if not self.allowed[state].any():
                    # Dead-end state (vocabulary gap): fail open to EOS so
                    # the request terminates instead of sampling an
                    # arbitrary all-blocked token. One shared fallback for
                    # the live cursor AND speculative lookahead masks —
                    # callers that need to count the violation check
                    # allowed[state].any() themselves (ConstraintState).
                    row = np.full((self.allowed.shape[1],), MASK_NEG,
                                  dtype=np.float32)
                    row[self.eos_id] = np.float32(0.0)
                else:
                    row = np.where(self.allowed[state], np.float32(0.0),
                                   MASK_NEG)
                self._bias_rows[state] = row
        return row

    def advance(self, state: int, token_id: int) -> int | None:
        """Next DFA state after sampling `token_id`, None if it kills the
        match (cannot happen when the mask was applied, but callers treat
        None as a violation rather than trusting that)."""
        text = self._texts[token_id] if 0 <= token_id < len(self._texts) else None
        if not text:
            return None
        return self.dfa.walk(state, text)


class ConstraintState:
    """Per-request cursor over a TokenConstraint. Not thread-safe; owned by
    the scheduler step loop."""

    __slots__ = ("tc", "state", "violated")

    def __init__(self, tc: TokenConstraint):
        self.tc = tc
        self.state: int = tc.dfa.start
        self.violated = False

    @property
    def is_accepting(self) -> bool:
        return self.tc.dfa.is_accepting(self.state)

    def bias_row(self) -> np.ndarray:
        if not self.tc.allowed[self.state].any():
            # No token can advance the grammar from here (vocabulary gap —
            # e.g. a tokenizer with no token for a required character).
            # tc.bias_row fails open to EOS so the slot frees; the live
            # cursor additionally marks the violation for accounting.
            self.violated = True
        return self.tc.bias_row(self.state)

    def advance(self, token_id: int) -> bool:
        """Advance on a sampled token. False (and `violated`) if the token
        was not actually allowed — the state is left unchanged."""
        if token_id == self.tc.eos_id:
            if not self.is_accepting:
                self.violated = True
                return False
            return True
        nxt = self.tc.advance(self.state, token_id)
        if nxt is None:
            self.violated = True
            return False
        self.state = nxt
        return True


class ConstraintCompiler:
    """schema/spec → TokenConstraint, LRU-cached per (spec hash, tokenizer).

    One compiler is bound to one tokenizer (vocab texts are snapshotted at
    construction); the cache key is the spec hash alone. `metrics` is any
    object with the EngineMetrics structured hooks (duck-typed; None is
    fine), fed compile timings and cache hit/miss/eviction events.
    """

    def __init__(self, tokenizer, vocab_size: int, *, max_entries: int = 32,
                 metrics=None):
        self.eos_id = int(tokenizer.eos_id)
        self.vocab_size = int(vocab_size)
        self.metrics = metrics
        self.max_entries = max(1, int(max_entries))
        self._cache: OrderedDict[str, TokenConstraint] = OrderedDict()
        self._lock = threading.Lock()
        self.compile_cache_hits = 0
        self.compile_cache_misses = 0
        self.evictions = 0
        self._token_texts: list[str | None] | None = None
        self._tokenizer = tokenizer

    def _texts(self) -> list[str | None]:
        if self._token_texts is None:
            texts: list[str | None] = []
            for i in range(self.vocab_size):
                if i == self.eos_id:
                    texts.append(None)
                    continue
                try:
                    text = self._tokenizer.decode([i])
                except Exception:
                    text = ""
                texts.append(text or None)
            self._token_texts = texts
        return self._token_texts

    def compile_spec(self, spec: dict) -> TokenConstraint:
        key = spec_hash(spec)
        with self._lock:
            tc = self._cache.get(key)
            if tc is not None:
                self._cache.move_to_end(key)
                self.compile_cache_hits += 1
                if self.metrics is not None:
                    self.metrics.record_mask_cache_hit()
                return tc
        # Compile outside the lock: a slow first compile must not block
        # cache hits for other schemas. A racing duplicate compile of the
        # same spec is wasted work, not a correctness problem.
        started = time.monotonic()
        regex = spec_regex(spec)  # raises for malformed/unsupported specs
        dfa = compile_regex(regex)
        tc = TokenConstraint(dfa, self._texts(), self.eos_id)
        elapsed = time.monotonic() - started
        with self._lock:
            won = key not in self._cache
            if won:
                self.compile_cache_misses += 1
                self._cache[key] = tc
                while len(self._cache) > self.max_entries:
                    self._cache.popitem(last=False)
                    self.evictions += 1
                    if self.metrics is not None:
                        self.metrics.record_mask_cache_eviction()
            else:
                # lost a duplicate-compile race: the winner already counted
                # the miss — counting another would diverge the /metrics
                # counters from this cache's own hit-rate figures
                self.compile_cache_hits += 1
            tc = self._cache[key]
        if self.metrics is not None:
            if won:
                self.metrics.record_mask_cache_miss()
                self.metrics.record_schema_compile(elapsed)
            else:
                self.metrics.record_mask_cache_hit()
        return tc

    def info(self) -> dict:
        """JSON block for /api/system, /api/health, and /metrics gauges."""
        with self._lock:
            entries = len(self._cache)
            nbytes = sum(tc.nbytes for tc in self._cache.values())
            hits, misses = self.compile_cache_hits, self.compile_cache_misses
        total = hits + misses
        return {
            "enabled": True,
            "mask_cache_entries": entries,
            "mask_cache_max_entries": self.max_entries,
            "mask_cache_bytes": nbytes,
            "compile_cache_hits": hits,
            "compile_cache_misses": misses,
            "compile_cache_hit_rate": round(hits / total, 4) if total else None,
            "evictions": self.evictions,
            "vocab_size": self.vocab_size,
        }


__all__ = [
    "MASK_NEG",
    "ConstraintCompiler",
    "ConstraintState",
    "TokenConstraint",
    "UnsupportedSchemaError",
    "spec_hash",
    "spec_regex",
]
