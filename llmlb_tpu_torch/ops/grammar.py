"""Device-resident grammar tables: counterpart of `llmlb_tpu/ops/grammar.py`.

Each compiled schema's `TokenConstraint.transition_table()` (int32
`[states, V]` -> next state, -1 disallowed) goes into ONE device table
shared by every resident schema, at a per-schema row offset. A slot's
grammar cursor is then one int32 (an absolute row), and the mask and the
cursor advance are gathers inside the decode burst:

    bias[b, v]  = 0.0 where table[state[b], v] >= 0 else MASK_NEG
    state'[b]   = table[state[b], token[b]]   (kept at state[b] where the
                                               entry is -1)

Row 0 is the FREE row: all zeros, "every token allowed, next state 0".
Unconstrained slots carry cursor 0, get an all-zero bias (`logits + 0.0`
keeps their bits) and self-loop, so one burst serves mixed batches.

Two departures from the reference, for the card, with its decisions kept:

- The table is one buffer of `budget_bytes // (V * 4)` rows, allocated
  once (at the first registration) and written in place: a captured decode
  graph holds its address, so uploading a new tensor per schema, as the
  reference's `device()` does, would leave every captured grammar graph
  reading freed memory.
- The budget check reads the schema's state count before its table is
  built: the same accept or refuse as the reference, without building a
  `[states, V]` host array only to refuse it (890 MB for `json_object` at
  Llama-3's vocabulary).

`LLMLB_GRAMMAR_TABLE_MB` (64 by default, the reference's) caps the table;
a schema past it returns None and the scheduler takes the host-mask path
for it (correctness is never budget-gated). These are gathers and a
`where`, not a Pallas kernel, so plain PyTorch is the port.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from llmlb_tpu_torch.structured.constraint import MASK_NEG, TokenConstraint

# The reference's default: 64 MiB of int32 rows across resident schemas.
_DEFAULT_BUDGET_MB = 64


def _env_budget_bytes() -> int:
    raw = os.environ.get("LLMLB_GRAMMAR_TABLE_MB", "")
    try:
        mb = float(raw) if raw else float(_DEFAULT_BUDGET_MB)
    except ValueError:
        mb = float(_DEFAULT_BUDGET_MB)
    return max(1, int(mb * (1 << 20)))


class GrammarTables:
    """One device table of next-state rows for every schema seen.

    Grow-only, as the reference's: freeing rows would invalidate live
    cursors. `register` is idempotent per TokenConstraint instance and
    returns the absolute row of the schema's DFA state 0 (add a local state
    to get a cursor), or None when the schema does not fit the budget. A
    strong reference to each registered constraint keeps its `id()` from
    being recycled onto another schema. Registration runs on the step loop,
    between bursts; the lock guards the counters against scrape threads."""

    def __init__(self, vocab_size: int, *, budget_bytes: int | None = None,
                 device: str | torch.device = "cpu"):
        self.vocab_size = int(vocab_size)
        self.budget_bytes = (int(budget_bytes) if budget_bytes is not None
                             else _env_budget_bytes())
        self.device = torch.device(device)
        # the rows the budget allows: any accepted set of schemas fits
        self.capacity_rows = max(1, self.budget_bytes // (self.vocab_size * 4))
        self._lock = threading.Lock()
        self._rows = 1  # row 0 = the free row
        self._offsets: dict[int, int] = {}  # id(tc) -> absolute row offset
        self._owners: list[TokenConstraint] = []  # keep ids stable
        self._table: torch.Tensor | None = None
        self.schemas_registered = 0
        self.schemas_rejected = 0

    def register(self, tc: TokenConstraint) -> int | None:
        """Absolute row offset of `tc`'s DFA state 0, or None when adding
        the schema would exceed the table budget."""
        with self._lock:
            off = self._offsets.get(id(tc))
            if off is not None:
                return off
            states, vocab = tc.allowed.shape
            if vocab != self.vocab_size:
                raise ValueError(f"vocab mismatch: table {vocab} vs grammar "
                                 f"tables {self.vocab_size}")
            if (self._rows + states) * self.vocab_size * 4 > self.budget_bytes:
                self.schemas_rejected += 1
                return None
            off = self._rows
            table = tc.transition_table()
            # next-state entries become absolute rows; -1 stays -1
            shifted = np.where(table >= 0, table + off, table).astype(np.int32)
            self.table()[off:off + states].copy_(torch.from_numpy(shifted))
            self._rows += states
            self._offsets[id(tc)] = off
            self._owners.append(tc)
            self.schemas_registered += 1
            return off

    def table(self) -> torch.Tensor:
        """The device table [capacity_rows, V] int32: allocated (zeros)
        once, written in place by registrations. Rows past `rows` are
        unused zeros."""
        if self._table is None:
            self._table = torch.zeros((self.capacity_rows, self.vocab_size),
                                      dtype=torch.int32, device=self.device)
        return self._table

    @property
    def rows(self) -> int:
        with self._lock:
            return self._rows

    @property
    def nbytes(self) -> int:
        """Bytes of the rows in use (the reference's host table's)."""
        with self._lock:
            return self._rows * self.vocab_size * 4

    def info(self) -> dict:
        with self._lock:
            return {
                "rows": self._rows,
                "bytes": self._rows * self.vocab_size * 4,
                "budget_bytes": self.budget_bytes,
                "schemas": self.schemas_registered,
                "rejected": self.schemas_rejected,
                # the one buffer on the device (0 before the first schema)
                "allocated_bytes": (0 if self._table is None else
                                    self._table.numel() * 4),
            }


def grammar_bias(table: torch.Tensor, states: torch.Tensor) -> torch.Tensor:
    """Additive float32 [B, V] sampling bias for the cursors `states` [B]: 0
    where the token keeps the match alive, MASK_NEG where it kills it. Row 0
    cursors (free slots) give all zeros. No host sync: safe in a graph."""
    rows = table.index_select(0, states.long())  # [B, V] int32 gather
    return torch.where(rows >= 0, 0.0, float(MASK_NEG))


def grammar_advance(table: torch.Tensor, states: torch.Tensor,
                    tokens: torch.Tensor) -> torch.Tensor:
    """Next cursors after sampling `tokens` [B] from `states` [B] (int32).
    A -1 entry (a token the mask never let through) keeps the current
    state, so the cursor stays in the table."""
    nxt = table[states.long(), tokens.long()]
    return torch.where(nxt >= 0, nxt, states.to(nxt.dtype))


__all__ = ["GrammarTables", "grammar_advance", "grammar_bias"]
