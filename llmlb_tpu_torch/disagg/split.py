"""In-process disaggregated prefill/decode: two step loops, one page pool.
The port's copy of `llmlb_tpu/disagg/split.py`.

`--role split` partitions an engine's slots into a PREFILL pool and a DECODE
pool and runs one step-loop thread per pool:

- The prefill loop owns admission (`_try_insert`) and chunked prefill
  (`_advance_prefill`), and runs the work other threads hand the engine
  (`call_in_loop`, and `encode`'s forwards). When a slot's prompt KV has landed, the slot is STAGED
  (`stage_group`): its final logits row is held on the device instead of
  sampled, and its device seq_len is parked at capacity - 1.
- The handoff pump (`pump_handoffs`) adopts staged requests into free
  decode slots (`_adopt`). The transfer is a page-id exchange: the
  block-table row moves from the prefill slot to the decode slot and no KV
  byte is copied (ownership moves with the row; no refcount changes). The
  activation then runs in the decode slot, where it attaches the grammar
  cursor and the drafter and samples the first token from the held logits,
  as a `--role both` activation does; a parked request that resumed through
  the prefill pool is fed its committed tokens by the decode pool's bursts
  (the exact resume). So adopted streams are token-identical to `--role
  both` for greedy and seeded sampling.
- The decode loop runs `_decode_active` over the decode pool only. ZERO
  prefill dispatches run on it, by construction, counted by the scheduler's
  `prefill_dispatch_by_loop` ledger.

Both loops take one lock for everything they do, so every device access of
either thread is serialized: dispatches and graph replays, the host-to-device
scatters of admission and activation, timing events and their reads, block
table copies, graph capture (which synchronizes the device and must see no
other thread's work on the stream) and the engine's one generator. Both run
on the default stream of the engine's device, so the pages the prefill
thread writes are ordered before the decode thread's next replay reads them.
The split removes scheduling contention, not compute. A decode-first
turnstile bounds a decoder's wait to the one prefill step in flight. Under
decode pressure the pump may preempt: a staged request of a more important
class parks the least important decoding row (`_acquire_decode_slot`),
which later resumes through the prefill pool and hands off again.

As in the reference, the split loops do not serve the drain's parks and
flush or a migration's park request.

On a mesh of one host's ranks (engine/multihost.py), every rank must run
the same lock sections in the same order, which the leader's two threads
set by timing. So the leader's split runs as above, and each lock section
it enters ("admit": the calls, the pump and admission; "advance": one
prefill chunk; "decode": a burst and the pump) is named in the tick plan
it broadcasts on entering (`_section`); a follower runs one thread that
takes each plan and runs the section it names, under that loop's tag, so
the dispatch ledgers read alike on every rank. The pump adopts staged
rows in staging order (`handoff_seq`), never by a clock.
"""

from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np
import torch

log = logging.getLogger("llmlb_tpu_torch.disagg")


class SplitRuntime:
    """The split-mode runtime of one EngineCore."""

    def __init__(self, core, prefill_slots: int | None = None):
        self.core = core
        n = core.num_slots
        if n < 2:
            raise ValueError(
                "--role split needs at least 2 slots (1 prefill + 1 decode)")
        if prefill_slots is None:
            env = os.environ.get("LLMLB_DISAGG_PREFILL_SLOTS")
            if env:
                try:
                    prefill_slots = int(env)
                except ValueError:
                    log.warning("LLMLB_DISAGG_PREFILL_SLOTS=%r is not an "
                                "integer; using the default split", env)
        if prefill_slots is None:
            # prefill is bursty, decode the steady state: a 1:3 split keeps
            # most of the capacity serving tokens
            prefill_slots = max(1, n // 4)
        p = min(max(1, int(prefill_slots)), n - 1)
        self.prefill_pool: tuple[int, ...] = tuple(range(p))
        self.decode_pool: tuple[int, ...] = tuple(range(p, n))
        self.lock = threading.Lock()
        # the lock sections by name: (loop tag, body)
        self._sections = {"admit": ("prefill", self._admit),
                          "advance": ("prefill", self._advance),
                          "decode": ("decode", self._decode)}
        self._staged = 0  # rows staged so far: the pump's order
        # the decode loop raises this before taking the lock, and the
        # prefill loop backs off while it is up
        self._decode_wants = threading.Event()
        self.threads: list[threading.Thread] = []
        log.info("split mode: %d prefill slot(s) %s, %d decode slot(s) %s",
                 len(self.prefill_pool), list(self.prefill_pool),
                 len(self.decode_pool), list(self.decode_pool))

    # ------------------------------------------------------------------ loops

    def start(self) -> None:
        coordinator = self.core.coordinator
        if coordinator is not None and not coordinator.is_leader:
            self.threads = [threading.Thread(target=self._follower_loop,
                                             name="engine-split-follower",
                                             daemon=True)]
        else:
            self.threads = [
                threading.Thread(target=self._prefill_loop,
                                 name="engine-prefill-pool", daemon=True),
                threading.Thread(target=self._decode_loop,
                                 name="engine-decode-pool", daemon=True),
            ]
        for t in self.threads:
            t.start()

    def join(self, timeout: float | None = None) -> None:
        for t in self.threads:
            t.join(timeout=timeout)

    def _enter(self, tag: str) -> None:
        """Tag the thread for the dispatch ledgers and put it on the
        engine's device, as the combined loop does."""
        self.core._tls.tag = tag
        if self.core.device.type == "cuda":
            torch.cuda.set_device(self.core.device)

    def _yield_to_decode(self) -> None:
        while self._decode_wants.is_set() and self.core._running:
            time.sleep(0.0002)

    def _fail_reset(self) -> None:
        core = self.core
        log.exception("split step failed; resetting engine state")
        with self.lock:
            core._fail_all("engine step error")
            core._reset_caches()

    def _section(self, name: str, entered=None) -> bool:
        """Run one lock section; on a mesh the leader names it in a tick
        plan first, so every rank runs the sections in this order.
        `entered` runs once the lock is held (the turnstile's flag)."""
        core = self.core
        with self.lock:
            if entered is not None:
                entered()
            if core.coordinator is not None:
                if not core._running:
                    return False  # the other thread's plan carried the stop
                core._lockstep_tick(section=name)
                if not core._running:
                    return False
            return self._sections[name][1]()

    def _admit(self) -> bool:
        core = self.core
        if core.coordinator is None:
            core._take_calls()
        did = core._run_calls()
        did |= core._run_plan_calls()
        did |= self.pump_handoffs()
        did |= core._try_insert()
        return did

    def _advance(self) -> bool:
        return self.core._advance_prefill()

    def _decode(self) -> bool:
        did = self.core._decode_active()
        # a finished or parked row frees a decode slot: adopt the oldest
        # staged request before the next burst
        did |= self.pump_handoffs()
        return did

    def _prefill_loop(self) -> None:
        core = self.core
        self._enter("prefill")
        while core._running:
            did = False
            try:
                self._yield_to_decode()
                did |= self._section("admit")
                self._yield_to_decode()
                did |= self._section("advance")
            except Exception:  # boundary: fail the requests, keep serving
                self._fail_reset()
            if not did:
                time.sleep(0.001)

    def _decode_loop(self) -> None:
        core = self.core
        self._enter("decode")
        while core._running:
            did = False
            try:
                self._decode_wants.set()
                try:
                    did |= self._section("decode",
                                         entered=self._decode_wants.clear)
                finally:
                    self._decode_wants.clear()
            except Exception:  # boundary: fail the requests, keep serving
                self._fail_reset()
            if not did:
                time.sleep(0.001)

    def _follower_loop(self) -> None:
        """A follower rank: each tick plan names the section the leader
        runs; run it here, under its loop's tag."""
        core = self.core
        self._enter("prefill")
        while core._running:
            try:
                with self.lock:
                    name = core._lockstep_tick()
                    if not core._running:
                        break
                    tag, body = self._sections[name]
                    core._tls.tag = tag
                    body()
            except Exception:  # boundary: fail the requests, keep serving
                self._fail_reset()

    # -------------------------------------------------------------- admission

    def free_prefill_slots(self) -> list[int]:
        return [i for i in self.prefill_pool
                if self.core.slots[i].request is None]

    def backlog(self) -> int:
        """Staged requests waiting for a decode slot."""
        return sum(1 for i in self.prefill_pool
                   if self.core.slots[i].handoff_ready)

    # --------------------------------------------------------------- handoff

    def stage_group(self, group, logits: torch.Tensor) -> None:
        """A prefill-loop activation lands here instead: the prompt's KV
        stays in the prefill slot's pages, its final logits row is held
        (the first token samples from it at adoption), and the device
        seq_len is parked at capacity - 1, the garbage contract of a
        prefilling row: the decode pool's bursts write this row's cell
        there, never read, until the pages move."""
        core = self.core
        now = time.monotonic()
        rows = []
        for row, (slot_id, request, n) in enumerate(group):
            slot = core.slots[slot_id]
            slot.prefilling = True
            slot.prefill_pos = n
            slot.handoff_ready = True
            slot.handoff_logits = logits[row:row + 1]
            slot.handoff_ready_at = now
            slot.handoff_seq = self._staged
            self._staged += 1
            core._seq_lens[slot_id] = 0
            rows.append(slot_id)
            core._fr_emit(request, "staged", tokens=n, slot=slot_id)
        core._d_seq_lens[core._to_device(np.asarray(rows, np.int64))] = (
            core.slot_capacity - 1)
        core.metrics.set_handoff_backlog(self.backlog())

    def _acquire_decode_slot(self, prio: int) -> int | None:
        """A free decode slot, or one freed by parking a less important
        decoding row: split mode's preemption point (admission-time
        preemption cannot free a prefill slot)."""
        core = self.core
        for j in self.decode_pool:
            if core.slots[j].request is None:
                return j
        cands = [c for c in core._preempt_candidates(prio)
                 if c in self.decode_pool]
        if cands:
            core._park_slot(cands[0])
            return cands[0]
        return None

    def _adopt(self, i: int, j: int) -> None:
        """Move one staged request from prefill slot `i` to decode slot `j`:
        the block-table row (no KV copy) and the prefix-cache entry move;
        then the activation runs in slot `j`, where it attaches the grammar
        cursor and the drafter (a parked request's, as they were parked)."""
        core = self.core
        slot_i, slot_j = core.slots[i], core.slots[j]
        request = slot_i.request
        n = slot_i.prefill_pos
        logits = slot_i.handoff_logits
        latency = time.monotonic() - slot_i.handoff_ready_at
        assert slot_j.request is None, "adoption into an occupied decode slot"
        core._slot_pages[j] = core._slot_pages[i]
        core._slot_pages[i] = []
        core._block_tables[j, :] = core._block_tables[i, :]
        core._block_tables[i, :] = 0
        core._tables_dirty = True
        slot_j.cache_entry = slot_i.cache_entry
        slot_i.clear()
        core._seq_lens[i] = 0
        prev = core._loop_tag()
        core._tls.tag = "handoff"
        try:
            core._activate_group([(j, request, n)], np.asarray([j], np.int64),
                                 np.asarray([n], np.int32), logits)
        finally:
            core._tls.tag = prev
        core.metrics.record_handoff("in_process", latency)
        core._fr_emit(request, "adopted", in_process=True,
                      staged_s=round(latency, 6))

    def pump_handoffs(self) -> bool:
        """Adopt staged requests into decode slots, the most important
        class first, then in staging order, then by slot id. Strictly ordered:
        a blocked head blocks everything behind it, so a later request
        cannot take the slot an earlier one is owed."""
        core = self.core
        ready = [i for i in self.prefill_pool if core.slots[i].handoff_ready]
        if not ready:
            core.metrics.set_handoff_backlog(0)
            return False
        ready.sort(key=lambda i: (core._priority_of(core.slots[i].request),
                                  core.slots[i].handoff_seq, i))
        progress = False
        for i in ready:
            request = core.slots[i].request
            if core._is_cancelled(request):
                core._finish_slot(i, "cancelled")
                progress = True
                continue
            j = self._acquire_decode_slot(core._priority_of(request))
            if j is None:
                break
            self._adopt(i, j)
            progress = True
        core.metrics.set_handoff_backlog(self.backlog())
        return progress
