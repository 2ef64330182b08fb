"""Tamper-evident audit log: capture middleware + batched writer + hash chain.

Parity with reference audit/ (middleware.rs:51-130 outermost capture,
writer.rs:48-63 batched async writer, hash_chain.rs:33-91 SHA-256 chain over
batches, verified at startup and periodically per bootstrap.rs:211-265).
Each flushed batch's hash covers its entries plus the previous batch hash, so
any retro-edit of a persisted entry breaks verification from that batch on.

The port's copy of llmlb_tpu/gateway/audit.py. `batch_hash` tries the
native chain hash (llmlb_tpu_torch/native/hash_chain.cpp) first and falls
back to hashlib, the same digest either way, so a chain either gateway
wrote verifies in the other.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import logging
import time

from llmlb_tpu_torch.gateway.db import Database

log = logging.getLogger("llmlb_tpu_torch.gateway.audit")

GENESIS_HASH = "0" * 64
FLUSH_INTERVAL_S = 1.0
FLUSH_MAX_ENTRIES = 64


def fts_quote(q: str) -> str:
    """Quote each whitespace-separated term so user input is matched as plain
    terms (AND semantics), never parsed as FTS5 syntax (NEAR, *, ^, etc.).
    Each term is a prefix query ("tok"*) so partial identifiers keep working
    the way the LIKE fallback's substring match mostly did."""
    terms = [t.replace('"', '""') for t in q.split()]
    return " ".join(f'"{t}"*' for t in terms if t)


@dataclasses.dataclass
class AuditEntry:
    ts: float
    method: str
    path: str
    status: int
    duration_ms: float
    actor: str | None = None
    actor_type: str | None = None  # "jwt" | "api_key" | "anonymous"
    ip: str | None = None
    detail: str | None = None

    def canonical(self) -> str:
        return json.dumps(
            [
                round(self.ts, 6), self.method, self.path, self.status,
                round(self.duration_ms, 3), self.actor or "", self.actor_type or "",
                self.ip or "", self.detail or "",
            ],
            separators=(",", ":"),
        )


def batch_hash(prev_hash: str, entries: list[AuditEntry]) -> str:
    canon = [e.canonical().encode() for e in entries]
    try:
        from llmlb_tpu_torch.native import native_chain_hash

        digest = native_chain_hash(prev_hash, canon)
        if digest is not None:
            return digest
    except Exception:  # allow-silent: native lib unavailable/broken —
        pass               # the identical Python path below serves
    h = hashlib.sha256()
    h.update(prev_hash.encode())
    for c in canon:
        h.update(c)
    return h.hexdigest()


class AuditLog:
    """Batched writer with a SHA-256 hash chain over flushed batches."""

    def __init__(self, db: Database):
        self.db = db
        self._pending: list[AuditEntry] = []
        self._task: asyncio.Task | None = None
        self._closed = False

    # ------------------------------------------------------------- ingestion

    def record(self, entry: AuditEntry) -> None:
        if self._closed:
            return
        self._pending.append(entry)
        if len(self._pending) >= FLUSH_MAX_ENTRIES:
            self.flush()

    def start(self) -> None:
        self._task = asyncio.create_task(self._flush_loop(), name="audit-writer")

    async def stop(self) -> None:
        self._closed = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        self.flush()

    async def _flush_loop(self) -> None:
        while True:
            await asyncio.sleep(FLUSH_INTERVAL_S)
            try:
                self.flush()
            except Exception:
                log.exception("audit flush failed")

    # ----------------------------------------------------------------- chain

    def _last_hash(self) -> str:
        row = self.db.query_one(
            "SELECT batch_hash FROM audit_batches ORDER BY id DESC LIMIT 1"
        )
        return row["batch_hash"] if row else GENESIS_HASH

    def flush(self) -> int | None:
        """Write pending entries as one chained batch; returns batch id.

        The prev-hash read and the batch insert run in one BEGIN IMMEDIATE
        transaction: with N gateway workers appending to one WAL file, two
        concurrent flushes would otherwise both read the same chain head and
        fork the hash chain (verify() would flag the second batch forever).
        """
        if not self._pending:
            return None
        entries, self._pending = self._pending, []
        with self.db.transaction():
            prev = self._last_hash()
            digest = batch_hash(prev, entries)
            cur = self.db.execute(
                """INSERT INTO audit_batches (batch_hash, prev_hash, entry_count,
                   created_at) VALUES (?,?,?,?)""",
                (digest, prev, len(entries), time.time()),
            )
            batch_id = cur.lastrowid
            self.db.executemany(
                """INSERT INTO audit_log (ts, method, path, status, duration_ms,
                   actor, actor_type, ip, detail, batch_id)
                   VALUES (?,?,?,?,?,?,?,?,?,?)""",
                [
                    (e.ts, e.method, e.path, e.status, e.duration_ms, e.actor,
                     e.actor_type, e.ip, e.detail, batch_id)
                    for e in entries
                ],
            )
        return batch_id

    # ----------------------------------------------------------------- query

    def search(
        self,
        q: str | None = None,
        actor: str | None = None,
        path_prefix: str | None = None,
        since: float | None = None,
        until: float | None = None,
        limit: int = 100,
        offset: int = 0,
    ) -> list[dict]:
        """Free-text `q` uses the FTS5 index over (path, actor, detail)
        (parity: db/audit_log.rs:82-98); LIKE fallback when sqlite lacks
        fts5. User text is quoted per-term so FTS operators can't inject."""
        clauses, params = [], []
        if q and q.strip():
            if getattr(self.db, "fts_enabled", False):
                clauses.append(
                    "id IN (SELECT rowid FROM audit_log_fts "
                    "WHERE audit_log_fts MATCH ?)"
                )
                params.append(fts_quote(q))
            else:
                clauses.append("(path LIKE ? OR detail LIKE ? OR actor LIKE ?)")
                like = f"%{q}%"
                params += [like, like, like]
        if actor:
            clauses.append("actor=?")
            params.append(actor)
        if path_prefix:
            clauses.append("path LIKE ?")
            params.append(path_prefix + "%")
        if since is not None:
            clauses.append("ts>=?")
            params.append(since)
        if until is not None:
            clauses.append("ts<=?")
            params.append(until)
        where = ("WHERE " + " AND ".join(clauses)) if clauses else ""
        rows = self.db.query(
            f"SELECT * FROM audit_log {where} ORDER BY ts DESC LIMIT ? OFFSET ?",
            tuple(params) + (limit, offset),
        )
        return [dict(r) for r in rows]

    def archive_older_than(self, cutoff_ts: float, archive_path: str) -> int:
        """Move old entries to a separate SQLite file (90-day archive parity,
        bootstrap.rs:267-318). Chain verification applies to live data only
        after archival, matching the reference's archive semantics."""
        import sqlite3

        rows = self.db.query(
            "SELECT * FROM audit_log WHERE ts < ? ORDER BY id", (cutoff_ts,)
        )
        if not rows:
            return 0
        archive = sqlite3.connect(archive_path)
        archive.execute(
            """CREATE TABLE IF NOT EXISTS audit_log (
                id INTEGER, ts REAL, method TEXT, path TEXT, status INTEGER,
                duration_ms REAL, actor TEXT, actor_type TEXT, ip TEXT,
                detail TEXT, batch_id INTEGER)"""
        )
        archive.executemany(
            "INSERT INTO audit_log VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            [tuple(r) for r in rows],
        )
        archive.commit()
        archive.close()
        batch_ids = {r["batch_id"] for r in rows}
        self.db.execute("DELETE FROM audit_log WHERE ts < ?", (cutoff_ts,))
        # drop fully-archived batches from the chain head; re-anchor genesis
        for bid in sorted(b for b in batch_ids if b is not None):
            remaining = self.db.query_one(
                "SELECT COUNT(*) AS n FROM audit_log WHERE batch_id=?", (bid,)
            )
            if remaining and remaining["n"] == 0:
                self.db.execute("DELETE FROM audit_batches WHERE id=?", (bid,))
        self._reanchor()
        return len(rows)

    def _reanchor(self) -> None:
        """After archival the first remaining batch must link to genesis."""
        first = self.db.query_one(
            "SELECT id, prev_hash FROM audit_batches ORDER BY id LIMIT 1"
        )
        if first and first["prev_hash"] != GENESIS_HASH:
            # chain now starts mid-history; mark the anchor so verify() can
            # start from the stored prev_hash instead of genesis
            self.db.set_setting("audit.anchor_hash", first["prev_hash"])

    def verify(self) -> tuple[bool, str | None]:
        """Chain verification honoring a re-anchored head after archival."""
        anchor = self.db.get_setting("audit.anchor_hash") or GENESIS_HASH
        prev = anchor
        for batch in self.db.query("SELECT * FROM audit_batches ORDER BY id"):
            rows = self.db.query(
                "SELECT * FROM audit_log WHERE batch_id=? ORDER BY id",
                (batch["id"],),
            )
            entries = [
                AuditEntry(
                    ts=r["ts"], method=r["method"], path=r["path"],
                    status=r["status"], duration_ms=r["duration_ms"],
                    actor=r["actor"], actor_type=r["actor_type"], ip=r["ip"],
                    detail=r["detail"],
                )
                for r in rows
            ]
            if batch["prev_hash"] != prev:
                return False, f"batch {batch['id']}: broken chain link"
            if len(entries) != batch["entry_count"]:
                return False, f"batch {batch['id']}: entry count mismatch"
            digest = batch_hash(prev, entries)
            if digest != batch["batch_hash"]:
                return False, f"batch {batch['id']}: hash mismatch"
            prev = digest
        return True, None
