"""Refcounted radix-tree prefix KV cache: the port's own copy of
`llmlb_tpu/engine/prefix_cache.py` (pure Python; the port imports nothing
of the JAX package), with the same semantics, alignment and LRU order.

Chat traffic is dominated by long shared prefixes (system prompts,
few-shot templates, multi-turn history); prefilling them again is the
largest avoidable prefill cost. This module is the host-side index for
reusing that work: a path-compressed radix tree keyed on prompt token ids
whose entries pin completed prefix KV, either rows of retained "donor"
slots of the dense slot cache [L, slots, cap, K, D] or pages of the paged
pool.

Division of labor:
- This module owns the pure bookkeeping: insert/match/refcount/evict over
  token sequences and pinned slot ids or page ids. No torch, no device
  state, no locks (every call happens on the scheduler's step-loop thread).
- The scheduler (scheduler.py) owns the device side: a hit shares the
  donor's pages through the block table (paged) or copies the donor slot's
  rows on the device (dense), then prefills only the uncached suffix; it
  also decides WHEN to insert (request completion) and evict (pinned
  budget, page or slot pressure).

Correctness hinges on one property of causal attention: the KV rows for
positions [0, m) depend only on tokens [0, m), so any stored prefix can
donate any of its own prefixes. Entries therefore store the full token
sequence they cover, and a match may use a partial head of an entry (the
longest common prefix with the query), never just exact node boundaries.

Refcounts guard in-flight readers: a hit acquires the entry for the duration
of its suffix prefill (released on activation, cancellation, or engine
failure) and acquired entries are never evicted. Eviction is LRU over a
logical clock bumped on every match/insert/touch.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PrefixEntry:
    """One cached prefix. Dense layout: `tokens` are resident as KV rows
    [0, len(tokens)) of pinned slot `slot` in the engine's slot cache.
    Paged layout: `pages` names the pool pages holding those rows in order
    (`slot` is -1; the donor slot itself was freed at donation time — a hit
    copies the page ids into the reader's block table with a refcount bump,
    never the KV bytes)."""

    tokens: tuple[int, ...]
    slot: int
    refcount: int = 0
    last_used: int = 0
    pages: tuple[int, ...] | None = None
    node: "_Node | None" = dataclasses.field(default=None, repr=False)
    # key in the cache's entry dict (the slot for dense entries, a unique
    # negative id for paged ones — freed slots recycle their ids, pages don't)
    key: int = dataclasses.field(default=0, repr=False)
    # namespace the entry was inserted under (LoRA adapter or None)
    ns: object = dataclasses.field(default=None, repr=False)

    @property
    def length(self) -> int:
        return len(self.tokens)


class _Node:
    """Path-compressed radix node: `edge` is the token run from the parent."""

    __slots__ = ("edge", "children", "entry", "parent")

    def __init__(self, edge: tuple[int, ...], parent: "_Node | None" = None):
        self.edge = edge
        self.children: dict[int, _Node] = {}
        self.entry: PrefixEntry | None = None
        self.parent = parent


def _common_len(a, b) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class PrefixCache:
    """Radix-tree index of pinned prefix slots. Not threadsafe by design —
    see module docstring (step-loop-thread only)."""

    def __init__(self, *, max_entries: int, min_len: int, align: int):
        if max_entries < 0:
            raise ValueError("max_entries must be >= 0")
        if align < 1 or min_len < 1:
            raise ValueError("align and min_len must be >= 1")
        self.max_entries = max_entries
        self.min_len = min_len
        self.align = align
        # One radix tree per namespace (`ns`): under multi-LoRA serving the
        # prompt KV depends on the adapter's wq/wk/wv deltas, so two
        # adapters sharing a prompt must NEVER share cached KV — an
        # adapter-blind hit would be silent corruption. The default
        # ns=None tree is the adapter-free cache; budget and LRU stay
        # GLOBAL across namespaces (one donor pool, shared fairly by
        # eviction pressure).
        self._roots: dict[object, _Node] = {None: _Node(())}
        # keyed by entry.key: the donor slot id for dense entries, a unique
        # negative id for paged (page-backed) entries
        self._by_slot: dict[int, PrefixEntry] = {}
        self._cached_tokens = 0
        self._clock = 0
        self._next_paged_key = -2  # -1 is the scheduler's "no slot" marker

    def _root_for(self, ns) -> "_Node":
        root = self._roots.get(ns)
        if root is None:
            root = self._roots[ns] = _Node(())
        return root

    # ------------------------------------------------------------- inspection
    #
    # __len__ and cached_tokens read single ints / dict size — safe to call
    # from scrape threads (/metrics, /api/health) while the step loop
    # mutates. Everything else, including pinned_slots/entries (they iterate
    # the dict), is step-loop-thread only.

    def __len__(self) -> int:
        return len(self._by_slot)

    def pinned_slots(self) -> frozenset[int]:
        """Donor SLOTS held out of the serving pool — dense entries only
        (page-backed donors pin pages, their slots were freed at donation)."""
        return frozenset(
            e.slot for e in self._by_slot.values() if e.pages is None
        )

    def cached_tokens(self) -> int:
        return self._cached_tokens

    def entries(self) -> list[PrefixEntry]:
        return list(self._by_slot.values())

    # ------------------------------------------------------------------ clock

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------------------------------------------ match

    def _walk(self, tokens, ns=None) -> tuple[int, _Node]:
        """Follow `tokens` as far as they match within namespace `ns`.
        Returns (matched_len, last_node_entered). The last node may be only
        partially matched (mismatch mid-edge); every entry in its subtree
        still shares the first `matched_len` tokens with the query."""
        node = self._root_for(ns)
        matched = 0
        while matched < len(tokens):
            child = node.children.get(tokens[matched])
            if child is None:
                break
            lcp = _common_len(child.edge, tokens[matched:])
            matched += lcp
            node = child
            if lcp < len(child.edge):
                break  # diverged mid-edge; subtree still shares `matched`
        return matched, node

    @staticmethod
    def _any_entry(node: _Node) -> PrefixEntry | None:
        """Any entry at or below `node` (DFS). Every one stores a superset
        of the matched path, so any can donate the matched head."""
        stack = [node]
        while stack:
            n = stack.pop()
            if n.entry is not None:
                return n.entry
            stack.extend(n.children.values())
        return None

    def match(self, tokens, *, max_len: int,
              ns=None) -> tuple[PrefixEntry, int] | None:
        """Longest reusable cached prefix of `tokens`: returns (entry,
        use_len) where entry's slot holds valid KV for rows [0, use_len) and
        use_len is capped at `max_len` (the caller must leave at least one
        suffix token to prefill, so it passes len(tokens) - 1) and aligned
        down to the prefill-bucket quantum. None when nothing aligned and
        >= min_len is cached. Bumps the winning entry's LRU clock."""
        if max_len < self.min_len or not self._by_slot:
            return None
        matched, node = self._walk(tokens, ns)
        if not matched:
            return None
        # pruning keeps every non-empty subtree holding >= 1 entry, so a
        # positive walk always finds a donor covering the matched head
        entry = self._any_entry(node)
        if entry is None:
            return None
        usable = min(matched, max_len)
        usable = (usable // self.align) * self.align
        if usable < self.min_len:
            return None
        entry.last_used = self._tick()
        return entry, usable

    def covers(self, tokens, ns=None) -> bool:
        """True if some entry already holds ALL of `tokens` as its head —
        inserting them again would pin a second slot for no new coverage."""
        matched, node = self._walk(tokens, ns)
        return matched == len(tokens) and self._any_entry(node) is not None

    def touch(self, tokens, ns=None) -> None:
        """Refresh the LRU clock of the entry covering `tokens` (a completed
        request whose prefix was already cached is a use of that entry)."""
        matched, node = self._walk(tokens, ns)
        if matched == len(tokens):
            entry = self._any_entry(node)
            if entry is not None:
                entry.last_used = self._tick()

    # --------------------------------------------------------------- refcount

    def acquire(self, entry: PrefixEntry) -> None:
        entry.refcount += 1

    def release(self, entry: PrefixEntry) -> None:
        if entry.refcount > 0:
            entry.refcount -= 1

    # ----------------------------------------------------------------- insert

    def insert(self, tokens, slot: int,
               pages: tuple[int, ...] | None = None,
               ns=None) -> PrefixEntry | None:
        """Pin a donor for prefix `tokens` in namespace `ns`: slot `slot`
        (dense) or the pool pages `pages` (paged; pass slot=-1). Returns
        the new entry, or None when rejected (budget full, duplicate
        coverage, or a slot already pinned). The caller aligns/filters
        lengths, evicts to make room first, and owns the page refcounts."""
        tokens = tuple(tokens)
        if (not tokens
                or (pages is None and slot in self._by_slot)
                or len(self._by_slot) >= self.max_entries
                or self.covers(tokens, ns)):
            return None
        node = self._root_for(ns)
        pos = 0
        while pos < len(tokens):
            child = node.children.get(tokens[pos])
            if child is None:
                leaf = _Node(tokens[pos:], node)
                node.children[tokens[pos]] = leaf
                node = leaf
                pos = len(tokens)
                break
            lcp = _common_len(child.edge, tokens[pos:])
            if lcp < len(child.edge):
                # split the edge at the divergence point
                mid = _Node(child.edge[:lcp], node)
                node.children[tokens[pos]] = mid
                child.edge = child.edge[lcp:]
                child.parent = mid
                mid.children[child.edge[0]] = child
                node = mid
            else:
                node = child
            pos += lcp
        if pages is None:
            key = slot
        else:
            key = self._next_paged_key
            self._next_paged_key -= 1
        entry = PrefixEntry(tokens=tokens, slot=slot, pages=pages,
                            last_used=self._tick(), node=node, key=key,
                            ns=ns)
        node.entry = entry
        self._by_slot[key] = entry
        self._cached_tokens += entry.length
        return entry

    # ------------------------------------------------------------------ evict

    def evict_subsumed_entries(self, tokens, ns=None) -> list["PrefixEntry"]:
        """Remove entries whose tokens are a STRICT prefix of `tokens` (and
        have no in-flight readers), returning them so the caller can release
        their donor slots / page references. Called before inserting
        `tokens`: any query matching a shorter ancestor also matches through
        the longer entry's subtree, so the ancestor is dead weight — without
        this, each turn of a growing conversation would pin a fresh donor
        until the budget was exhausted."""
        tokens = tuple(tokens)
        victims: list[PrefixEntry] = []
        node = self._root_for(ns)
        pos = 0
        while pos < len(tokens):
            child = node.children.get(tokens[pos])
            if child is None:
                break
            lcp = _common_len(child.edge, tokens[pos:])
            if lcp < len(child.edge):
                break  # diverged mid-edge: nothing deeper is a strict prefix
            node = child
            pos += lcp
            if (node.entry is not None and pos < len(tokens)
                    and node.entry.refcount == 0):
                victims.append(node.entry)
        for entry in victims:
            self._remove(entry)
        return victims

    def evict_lru_entry(self) -> PrefixEntry | None:
        """Remove the least-recently-used entry with no in-flight readers
        and return it (the scheduler frees its donor slot or releases its
        page references), or None when every entry is acquired."""
        victim: PrefixEntry | None = None
        for entry in self._by_slot.values():
            if entry.refcount:
                continue
            if victim is None or entry.last_used < victim.last_used:
                victim = entry
        if victim is None:
            return None
        self._remove(victim)
        return victim

    def _remove(self, entry: PrefixEntry) -> None:
        del self._by_slot[entry.key]
        self._cached_tokens -= entry.length
        node = entry.node
        entry.node = None
        if node is None:
            return
        node.entry = None
        # prune now-useless nodes: drop empty leaves, merge single-child
        # pass-through nodes back into their child's edge
        while node is not None and node.parent is not None:
            parent = node.parent
            if node.entry is None and not node.children:
                del parent.children[node.edge[0]]
            elif node.entry is None and len(node.children) == 1:
                (child,) = node.children.values()
                child.edge = node.edge + child.edge
                child.parent = parent
                parent.children[child.edge[0]] = child
            else:
                break
            node = parent

    def clear(self) -> None:
        """Drop everything — the device KV the entries pointed at is gone
        (engine failure path rebuilds the slot cache)."""
        self._roots = {None: _Node(())}
        self._by_slot.clear()
        self._cached_tokens = 0
