"""Tiered host-RAM KV offload: cold pages spill to the host, warm returns
skip prefill. The port's own copy of `KVOffloadTier`
(`llmlb_tpu/engine/kv_offload.py`).

Device pages are the scarcest resource the scheduler manages; host RAM is
far larger and sits idle. When the prefix cache evicts a cold entry under
page pressure, or a parked row gives up its pages, the page payload
(kv_transfer) lands here instead of vanishing: a bounded LRU over host
bytes with its own budget (LLMLB_KV_OFFLOAD_BYTES, default 0 = off). A
returning prompt restores into freshly allocated pages and prefills only
its suffix; a parked request resumes without re-prefilling what it already
computed.

Two keyspaces share one budget and one LRU clock:

- **prefix** entries, keyed ``(ns, tokens)`` like the live radix cache's
  namespaces: spilled by ``_evict_one_prefix``, restored at admission just
  before the live-cache match so the ordinary zero-copy hit path takes
  over;
- **parked** entries, keyed by engine request id: spilled by
  ``_park_slot``, popped when the parked request re-activates and landed
  through the same page-restore path the wire payloads use.

The tier is storage only: all policy (when to spill, whether a restore is
worth pages, counting) lives in the scheduler, all format knowledge in
kv_transfer. Its counters let `/api/health` report occupancy and hit/miss
traffic.
"""

from __future__ import annotations

import collections
import threading

from llmlb_tpu_torch.engine.kv_transfer import KVPages


class KVOffloadTier:
    """Bounded-LRU host-RAM store of parsed KV page payloads."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = max(0, int(budget_bytes))
        # key -> KVPages; key is ("prefix", ns, tokens) or ("parked", rid).
        # OrderedDict move_to_end gives the LRU clock.
        self._entries: collections.OrderedDict[tuple, KVPages] = (
            collections.OrderedDict()
        )
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.spills = 0
        self.evictions = 0
        self.spilled_bytes = 0
        self.restored_bytes = 0

    # -- capacity -----------------------------------------------------------

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def would_admit(self, nbytes: int) -> bool:
        """Cheap pre-check so callers can skip the D2H gather entirely for
        payloads the budget could never hold."""
        return 0 < nbytes <= self.budget_bytes

    def _admit(self, key: tuple, kvp: KVPages) -> bool:
        if not self.would_admit(kvp.nbytes):
            return False
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes -= old.nbytes
        while self._bytes + kvp.nbytes > self.budget_bytes and self._entries:
            _, victim = self._entries.popitem(last=False)
            self._bytes -= victim.nbytes
            self.evictions += 1
        self._entries[key] = kvp
        self._bytes += kvp.nbytes
        self.spills += 1
        self.spilled_bytes += kvp.nbytes
        return True

    # -- prefix keyspace ----------------------------------------------------

    def put_prefix(self, ns, tokens: tuple, kvp: KVPages) -> bool:
        with self._lock:
            return self._admit(("prefix", ns, tuple(tokens)), kvp)

    def match_prefix(self, ns, tokens, max_len: int):
        """Best stored entry sharing a head with ``tokens[:max_len]`` in
        namespace ``ns`` -> (stored_tokens, KVPages), consumed from the
        tier (the caller lands it back into HBM; a later eviction
        re-spills it). An entry LONGER than max_len still matches on its
        usable head — the returning-user case is the exact same prompt,
        whose full-length spilled entry must not be unreachable just
        because one suffix token has to prefill; the caller slices pages
        (they are position-independent) down to what it can use. Linear
        over stored prefix entries — the byte budget keeps the entry count
        small, and this only runs on admission after the live radix cache
        missed."""
        with self._lock:
            best_key = None
            best_len = 0
            for key in self._entries:
                if key[0] != "prefix" or key[1] != ns:
                    continue
                stored = key[2]
                eff = min(len(stored), max_len)
                if eff <= best_len:
                    continue
                if tuple(tokens[:eff]) == stored[:eff]:
                    best_key, best_len = key, eff
            if best_key is None:
                self.misses += 1
                return None
            kvp = self._entries.pop(best_key)
            self._bytes -= kvp.nbytes
            self.hits += 1
            self.restored_bytes += kvp.nbytes
            return best_key[2], kvp

    # -- parked keyspace ----------------------------------------------------

    def put_parked(self, request_id: str, kvp: KVPages) -> bool:
        with self._lock:
            return self._admit(("parked", request_id), kvp)

    def pop_parked(self, request_id: str) -> KVPages | None:
        with self._lock:
            kvp = self._entries.pop(("parked", request_id), None)
            if kvp is None:
                self.misses += 1
                return None
            self._bytes -= kvp.nbytes
            self.hits += 1
            self.restored_bytes += kvp.nbytes
            return kvp

    def drop_parked(self, request_id: str) -> None:
        """Forget a parked spill whose request terminated (cancel/shed) —
        dead bytes must not squat in the budget until LRU reaps them."""
        with self._lock:
            kvp = self._entries.pop(("parked", request_id), None)
            if kvp is not None:
                self._bytes -= kvp.nbytes

    # -- introspection ------------------------------------------------------

    def info(self) -> dict:
        with self._lock:
            prefix = sum(1 for k in self._entries if k[0] == "prefix")
            return {
                "enabled": True,
                "budget_bytes": self.budget_bytes,
                "bytes": self._bytes,
                "entries": len(self._entries),
                "prefix_entries": prefix,
                "parked_entries": len(self._entries) - prefix,
                "hits": self.hits,
                "misses": self.misses,
                "spills": self.spills,
                "evictions": self.evictions,
                "spilled_bytes": self.spilled_bytes,
                "restored_bytes": self.restored_bytes,
            }
