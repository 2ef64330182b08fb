"""SQLite persistence layer: the port's counterpart of
llmlb_tpu/gateway/db.py.

The reference's schema, column for column and index for index, so either
gateway opens the other's database: users, API keys, endpoints and their
models, health checks, request history, daily stats, settings, registered
models, invitations, the audit log and its batches, download tasks, and the
audit log's FTS5 index (kept out of the schema, as in the reference, so a
sqlite build without fts5 still opens it). Single connection in WAL mode
guarded by a lock.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
import uuid
from typing import Iterable

from llmlb_tpu_torch.gateway.types import (
    AcceleratorInfo,
    Capability,
    Endpoint,
    EndpointModel,
    EndpointStatus,
    EndpointType,
)

SCHEMA = """
PRAGMA journal_mode=WAL;

CREATE TABLE IF NOT EXISTS users (
    id TEXT PRIMARY KEY,
    username TEXT NOT NULL UNIQUE,
    password_hash TEXT NOT NULL,
    role TEXT NOT NULL DEFAULT 'viewer',
    must_change_password INTEGER NOT NULL DEFAULT 0,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS api_keys (
    id TEXT PRIMARY KEY,
    user_id TEXT NOT NULL REFERENCES users(id) ON DELETE CASCADE,
    name TEXT NOT NULL,
    key_hash TEXT NOT NULL UNIQUE,
    key_prefix TEXT NOT NULL,
    permissions TEXT NOT NULL DEFAULT '[]',
    created_at REAL NOT NULL,
    last_used_at REAL,
    expires_at REAL,
    revoked INTEGER NOT NULL DEFAULT 0
);

CREATE TABLE IF NOT EXISTS endpoints (
    id TEXT PRIMARY KEY,
    name TEXT NOT NULL,
    base_url TEXT NOT NULL UNIQUE,
    api_key TEXT,
    endpoint_type TEXT NOT NULL,
    status TEXT NOT NULL,
    latency_ms REAL,
    consecutive_failures INTEGER NOT NULL DEFAULT 0,
    accelerator TEXT,
    chip_count INTEGER NOT NULL DEFAULT 0,
    hbm_used_bytes INTEGER NOT NULL DEFAULT 0,
    hbm_total_bytes INTEGER NOT NULL DEFAULT 0,
    utilization REAL,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    last_checked_at REAL
);

CREATE TABLE IF NOT EXISTS endpoint_models (
    id TEXT PRIMARY KEY,
    endpoint_id TEXT NOT NULL REFERENCES endpoints(id) ON DELETE CASCADE,
    model_id TEXT NOT NULL,
    canonical_name TEXT NOT NULL,
    capabilities TEXT NOT NULL DEFAULT '[]',
    context_length INTEGER,
    created_at REAL NOT NULL,
    UNIQUE(endpoint_id, model_id)
);
CREATE INDEX IF NOT EXISTS idx_endpoint_models_canonical
    ON endpoint_models(canonical_name);

CREATE TABLE IF NOT EXISTS endpoint_health_checks (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    endpoint_id TEXT NOT NULL,
    ok INTEGER NOT NULL,
    latency_ms REAL,
    error TEXT,
    checked_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_health_checks_endpoint
    ON endpoint_health_checks(endpoint_id, checked_at);

CREATE TABLE IF NOT EXISTS registered_models (
    id TEXT PRIMARY KEY,
    name TEXT NOT NULL UNIQUE,
    source_repo TEXT,
    format TEXT,
    capabilities TEXT NOT NULL DEFAULT '[]',
    manifest TEXT,
    created_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS request_history (
    id TEXT PRIMARY KEY,
    ts REAL NOT NULL,
    endpoint_id TEXT,
    endpoint_name TEXT,
    model TEXT,
    api_kind TEXT,
    path TEXT,
    status_code INTEGER,
    duration_ms REAL,
    prompt_tokens INTEGER NOT NULL DEFAULT 0,
    completion_tokens INTEGER NOT NULL DEFAULT 0,
    client_ip TEXT,
    api_key_id TEXT,
    user_id TEXT,
    stream INTEGER NOT NULL DEFAULT 0,
    error TEXT,
    request_body TEXT,
    response_body TEXT
);
CREATE INDEX IF NOT EXISTS idx_request_history_ts ON request_history(ts);
CREATE INDEX IF NOT EXISTS idx_request_history_ip ON request_history(client_ip, ts);

CREATE TABLE IF NOT EXISTS endpoint_daily_stats (
    endpoint_id TEXT NOT NULL,
    date TEXT NOT NULL,
    model TEXT NOT NULL,
    api_kind TEXT NOT NULL,
    request_count INTEGER NOT NULL DEFAULT 0,
    error_count INTEGER NOT NULL DEFAULT 0,
    prompt_tokens INTEGER NOT NULL DEFAULT 0,
    completion_tokens INTEGER NOT NULL DEFAULT 0,
    total_duration_ms REAL NOT NULL DEFAULT 0,
    PRIMARY KEY (endpoint_id, date, model, api_kind)
);

CREATE TABLE IF NOT EXISTS settings (
    key TEXT PRIMARY KEY,
    value TEXT NOT NULL,
    updated_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS invitations (
    id TEXT PRIMARY KEY,
    code TEXT NOT NULL UNIQUE,
    role TEXT NOT NULL DEFAULT 'viewer',
    created_by TEXT,
    created_at REAL NOT NULL,
    expires_at REAL,
    used_by TEXT,
    used_at REAL
);

CREATE TABLE IF NOT EXISTS audit_log (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    ts REAL NOT NULL,
    method TEXT NOT NULL,
    path TEXT NOT NULL,
    status INTEGER NOT NULL,
    duration_ms REAL NOT NULL,
    actor TEXT,
    actor_type TEXT,
    ip TEXT,
    detail TEXT,
    batch_id INTEGER
);
CREATE INDEX IF NOT EXISTS idx_audit_log_ts ON audit_log(ts);
CREATE INDEX IF NOT EXISTS idx_audit_log_batch ON audit_log(batch_id);

CREATE TABLE IF NOT EXISTS audit_batches (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    batch_hash TEXT NOT NULL,
    prev_hash TEXT NOT NULL,
    entry_count INTEGER NOT NULL,
    created_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS download_tasks (
    id TEXT PRIMARY KEY,
    endpoint_id TEXT NOT NULL,
    model TEXT NOT NULL,
    status TEXT NOT NULL DEFAULT 'pending',
    progress REAL NOT NULL DEFAULT 0,
    error TEXT,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
"""


# Full-text audit search (parity: db/audit_log.rs:82-98 FTS5 table+triggers).
# Kept out of SCHEMA so a sqlite build without the fts5 module still boots
# (AuditLog.search falls back to LIKE when Database.fts_enabled is False).
# External-content table: rows live in audit_log; triggers keep FTS in sync,
# including deletes from the 90-day archiver.
FTS_SCHEMA = """
CREATE VIRTUAL TABLE IF NOT EXISTS audit_log_fts USING fts5(
    path, actor, detail,
    content='audit_log', content_rowid='id'
);
CREATE TRIGGER IF NOT EXISTS audit_log_fts_ai AFTER INSERT ON audit_log BEGIN
    INSERT INTO audit_log_fts(rowid, path, actor, detail)
    VALUES (new.id, new.path, new.actor, new.detail);
END;
CREATE TRIGGER IF NOT EXISTS audit_log_fts_ad AFTER DELETE ON audit_log BEGIN
    INSERT INTO audit_log_fts(audit_log_fts, rowid, path, actor, detail)
    VALUES ('delete', old.id, old.path, old.actor, old.detail);
END;
"""


def _caps_to_json(caps: Iterable[Capability]) -> str:
    return json.dumps([c.value for c in caps])


def _caps_from_json(raw: str | None) -> list[Capability]:
    if not raw:
        return []
    out = []
    for v in json.loads(raw):
        try:
            out.append(Capability(v))
        except ValueError:
            continue
    return out


class _Transaction:
    """BEGIN IMMEDIATE transaction holding the connection lock for its whole
    extent (re-entrant: accessors called inside still acquire it)."""

    def __init__(self, db: "Database"):
        self.db = db

    def __enter__(self) -> "Database":
        self.db._lock.acquire()
        try:
            self.db._conn.execute("BEGIN IMMEDIATE")
        except BaseException:
            # BEGIN can itself time out on a sibling process's write lock;
            # __exit__ will never run, so release here or the RLock leaks
            # and every later caller deadlocks
            self.db._lock.release()
            raise
        return self.db

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc_type is None:
                self.db._conn.execute("COMMIT")
            else:
                self.db._conn.execute("ROLLBACK")
        finally:
            self.db._lock.release()


class Database:
    """Thread-safe SQLite wrapper with typed accessors."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._conn = sqlite3.connect(
            path, check_same_thread=False, isolation_level=None
        )
        self._conn.row_factory = sqlite3.Row
        self._conn.execute("PRAGMA foreign_keys=ON")
        # Multi-worker serving (gateway/worker.py) gives each process its
        # own connection to one WAL file; writers queue on the file lock
        # instead of throwing SQLITE_BUSY at the first collision.
        self._conn.execute("PRAGMA busy_timeout=5000")
        # WAL + synchronous=NORMAL is the documented SQLite pairing: commits
        # skip the per-transaction fsync (the WAL is still fsynced at
        # checkpoint), which is the difference between request-path writes
        # costing ~µs and costing a disk flush each. Durability window on
        # power loss is the last checkpoint — request history/stats, not
        # ledger data.
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._lock = threading.RLock()
        with self._lock:
            # N forked workers initialize the same file concurrently at
            # boot; executescript's implicit transaction handling can
            # surface SQLITE_BUSY despite busy_timeout (the WAL-mode switch
            # needs a moment of exclusivity), so schema init retries
            # briefly instead of killing the worker.
            for attempt in range(50):
                try:
                    self._conn.executescript(SCHEMA)
                    break
                except sqlite3.OperationalError as e:
                    if "locked" not in str(e) or attempt == 49:
                        raise
                    time.sleep(0.1)
            try:
                # Backfill on upgrade: a DB that predates the FTS table has
                # unindexed rows — searches would miss them and the delete
                # trigger would corrupt the external-content index when the
                # archiver removes a never-indexed rowid. (count(*) can't
                # detect this: on external-content tables it reads the
                # content table, so test table existence instead.)
                fts_is_new = not self._conn.execute(
                    "SELECT 1 FROM sqlite_master WHERE name='audit_log_fts'"
                ).fetchone()
                self._conn.executescript(FTS_SCHEMA)
                self.fts_enabled = True
                has_rows = self._conn.execute(
                    "SELECT 1 FROM audit_log LIMIT 1"
                ).fetchone()
                if fts_is_new and has_rows:
                    self._conn.execute(
                        "INSERT INTO audit_log_fts(audit_log_fts) "
                        "VALUES('rebuild')"
                    )
            except sqlite3.OperationalError:
                self.fts_enabled = False

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    def execute(self, sql: str, params: tuple = ()) -> sqlite3.Cursor:
        with self._lock:
            return self._conn.execute(sql, params)

    def transaction(self):
        """Context manager: BEGIN IMMEDIATE ... COMMIT under the connection
        lock, so a read-then-write sequence (the audit chain's prev-hash
        read + batch insert) is atomic against sibling worker processes,
        not just sibling threads."""
        return _Transaction(self)

    def executemany(self, sql: str, rows: list[tuple]) -> None:
        with self._lock:
            self._conn.executemany(sql, rows)

    def query(self, sql: str, params: tuple = ()) -> list[sqlite3.Row]:
        with self._lock:
            return self._conn.execute(sql, params).fetchall()

    def query_one(self, sql: str, params: tuple = ()) -> sqlite3.Row | None:
        with self._lock:
            return self._conn.execute(sql, params).fetchone()

    # ------------------------------------------------------------- endpoints

    def upsert_endpoint(self, ep: Endpoint) -> None:
        self.execute(
            """INSERT INTO endpoints (id, name, base_url, api_key, endpoint_type,
                   status, latency_ms, consecutive_failures, accelerator,
                   chip_count, hbm_used_bytes, hbm_total_bytes, utilization,
                   created_at, updated_at, last_checked_at)
               VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)
               ON CONFLICT(id) DO UPDATE SET
                   name=excluded.name, base_url=excluded.base_url,
                   api_key=excluded.api_key,
                   endpoint_type=excluded.endpoint_type, status=excluded.status,
                   latency_ms=excluded.latency_ms,
                   consecutive_failures=excluded.consecutive_failures,
                   accelerator=excluded.accelerator,
                   chip_count=excluded.chip_count,
                   hbm_used_bytes=excluded.hbm_used_bytes,
                   hbm_total_bytes=excluded.hbm_total_bytes,
                   utilization=excluded.utilization,
                   updated_at=excluded.updated_at,
                   last_checked_at=excluded.last_checked_at""",
            (
                ep.id, ep.name, ep.base_url, ep.api_key, ep.endpoint_type.value,
                ep.status.value, ep.latency_ms, ep.consecutive_failures,
                ep.accelerator.accelerator, ep.accelerator.chip_count,
                ep.accelerator.hbm_used_bytes, ep.accelerator.hbm_total_bytes,
                ep.accelerator.utilization, ep.created_at, ep.updated_at,
                ep.last_checked_at,
            ),
        )

    def delete_endpoint(self, endpoint_id: str) -> None:
        self.execute("DELETE FROM endpoints WHERE id=?", (endpoint_id,))

    def list_endpoints(self) -> list[Endpoint]:
        return [self._row_to_endpoint(r) for r in self.query("SELECT * FROM endpoints")]

    @staticmethod
    def _row_to_endpoint(r: sqlite3.Row) -> Endpoint:
        return Endpoint(
            id=r["id"], name=r["name"], base_url=r["base_url"],
            api_key=r["api_key"],
            endpoint_type=EndpointType(r["endpoint_type"]),
            status=EndpointStatus(r["status"]),
            latency_ms=r["latency_ms"],
            consecutive_failures=r["consecutive_failures"],
            accelerator=AcceleratorInfo(
                accelerator=r["accelerator"], chip_count=r["chip_count"],
                hbm_used_bytes=r["hbm_used_bytes"],
                hbm_total_bytes=r["hbm_total_bytes"],
                utilization=r["utilization"],
            ),
            created_at=r["created_at"], updated_at=r["updated_at"],
            last_checked_at=r["last_checked_at"],
        )

    # -------------------------------------------------------- endpoint models

    def replace_endpoint_models(
        self, endpoint_id: str, models: list[EndpointModel]
    ) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM endpoint_models WHERE endpoint_id=?", (endpoint_id,)
            )
            self._conn.executemany(
                """INSERT INTO endpoint_models
                   (id, endpoint_id, model_id, canonical_name, capabilities,
                    context_length, created_at)
                   VALUES (?,?,?,?,?,?,?)""",
                [
                    (
                        uuid.uuid4().hex, m.endpoint_id, m.model_id,
                        m.canonical_name, _caps_to_json(m.capabilities),
                        m.context_length, m.created_at,
                    )
                    for m in models
                ],
            )

    def list_endpoint_models(self, endpoint_id: str | None = None) -> list[EndpointModel]:
        if endpoint_id is None:
            rows = self.query("SELECT * FROM endpoint_models")
        else:
            rows = self.query(
                "SELECT * FROM endpoint_models WHERE endpoint_id=?", (endpoint_id,)
            )
        return [
            EndpointModel(
                endpoint_id=r["endpoint_id"], model_id=r["model_id"],
                canonical_name=r["canonical_name"],
                capabilities=_caps_from_json(r["capabilities"]),
                context_length=r["context_length"], created_at=r["created_at"],
            )
            for r in rows
        ]

    # ---------------------------------------------------------- health checks

    def record_health_check(
        self, endpoint_id: str, ok: bool, latency_ms: float | None,
        error: str | None, checked_at: float,
    ) -> None:
        self.execute(
            """INSERT INTO endpoint_health_checks
               (endpoint_id, ok, latency_ms, error, checked_at)
               VALUES (?,?,?,?,?)""",
            (endpoint_id, int(ok), latency_ms, error, checked_at),
        )

    def list_health_checks(
        self, endpoint_id: str, limit: int = 100
    ) -> list[sqlite3.Row]:
        return self.query(
            """SELECT * FROM endpoint_health_checks WHERE endpoint_id=?
               ORDER BY checked_at DESC LIMIT ?""",
            (endpoint_id, limit),
        )

    # --------------------------------------------------------------- settings

    def get_setting(self, key: str) -> str | None:
        row = self.query_one("SELECT value FROM settings WHERE key=?", (key,))
        return row["value"] if row else None

    def set_setting(self, key: str, value: str) -> None:
        self.execute(
            """INSERT INTO settings (key, value, updated_at) VALUES (?,?,?)
               ON CONFLICT(key) DO UPDATE SET value=excluded.value,
               updated_at=excluded.updated_at""",
            (key, value, time.time()),
        )

    def list_settings(self) -> dict[str, str]:
        return {r["key"]: r["value"] for r in self.query("SELECT * FROM settings")}

    # ------------------------------------------------- registered models
    # Parity: reference db/models.rs — metadata+manifest only, no weights
    # (api/models.rs:1021 register, :1167 manifest serving).

    def register_model(self, name: str, source_repo: str | None,
                       format_: str | None, capabilities: list[str],
                       manifest: dict) -> str:
        model_id = uuid.uuid4().hex
        self.execute(
            """INSERT INTO registered_models
               (id, name, source_repo, format, capabilities, manifest, created_at)
               VALUES (?,?,?,?,?,?,?)
               ON CONFLICT(name) DO UPDATE SET source_repo=excluded.source_repo,
               format=excluded.format, capabilities=excluded.capabilities,
               manifest=excluded.manifest""",
            (model_id, name, source_repo, format_, json.dumps(capabilities),
             json.dumps(manifest), time.time()),
        )
        # On re-registration the UPDATE path keeps the existing row's id, so
        # return the id actually stored rather than the freshly generated one.
        row = self.query_one(
            "SELECT id FROM registered_models WHERE name=?", (name,))
        return row["id"] if row else model_id

    def list_registered_models(self) -> list[dict]:
        return [
            {
                "id": r["id"], "name": r["name"],
                "source_repo": r["source_repo"], "format": r["format"],
                "capabilities": json.loads(r["capabilities"] or "[]"),
                "created_at": r["created_at"],
            }
            for r in self.query(
                "SELECT * FROM registered_models ORDER BY created_at DESC"
            )
        ]

    def get_registered_model(self, name: str) -> dict | None:
        r = self.query_one(
            "SELECT * FROM registered_models WHERE name=?", (name,)
        )
        if r is None:
            return None
        return {
            "id": r["id"], "name": r["name"], "source_repo": r["source_repo"],
            "format": r["format"],
            "capabilities": json.loads(r["capabilities"] or "[]"),
            "manifest": json.loads(r["manifest"] or "null"),
            "created_at": r["created_at"],
        }

    def delete_registered_model(self, name: str) -> bool:
        cur = self.execute(
            "DELETE FROM registered_models WHERE name=?", (name,)
        )
        return cur.rowcount > 0
