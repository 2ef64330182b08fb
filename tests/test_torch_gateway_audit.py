"""The port's audit log (llmlb_tpu_torch/gateway/audit.py) held against the
JAX gateway's.

- One SQLite file, two packages: a hash chain the JAX `AuditLog` wrote
  verifies in the port's, and the other way round, batch after batch;
  a tampered or a deleted entry is found by both.
- `batch_hash` and `fts_quote` give the JAX package's values on seeded
  inputs.
- Twins of tests/gateway/test_audit.py on the port: tampering, a deleted
  entry, search filters, the archive's re-anchored chain, FTS search with
  hostile queries, the FTS index kept in step with deletes, the LIKE
  fallback without fts5, and the backfill of a database from before FTS.
"""

import sqlite3
import time

import numpy as np
import pytest

from llmlb_tpu.gateway import audit as ref_audit
from llmlb_tpu.gateway.db import Database as RefDatabase
from llmlb_tpu_torch.gateway.audit import (
    AuditEntry,
    AuditLog,
    batch_hash,
    fts_quote,
)
from llmlb_tpu_torch.gateway.db import Database

PATHS = ["/v1/chat/completions", "/v1/messages", "/api/endpoints",
         "/api/users", "/api/audit-log", "/health", "/v1/audio/speech"]
ACTORS = [None, "admin", "key:smoke", "alice"]


def _entries(seed: int, n: int, cls=AuditEntry) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        actor = ACTORS[int(rng.integers(len(ACTORS)))]
        out.append(cls(
            ts=1.7e9 + float(rng.uniform(0, 1e6)),
            method=["GET", "POST", "PUT", "DELETE"][int(rng.integers(4))],
            path=PATHS[int(rng.integers(len(PATHS)))],
            status=int(rng.choice([200, 201, 400, 401, 404, 502])),
            duration_ms=float(rng.uniform(0, 500)),
            actor=actor,
            actor_type=("anonymous" if actor is None else
                        "api_key" if actor.startswith("key:") else "jwt"),
            ip="127.0.0.1" if rng.integers(2) else None,
            detail=None if rng.integers(3) else 'RuntimeError: "x" & y',
        ))
    return out


def entry(path="/v1/chat/completions", status=200) -> AuditEntry:
    return AuditEntry(
        ts=time.time(), method="POST", path=path, status=status,
        duration_ms=1.2, actor="admin", actor_type="jwt", ip="127.0.0.1",
    )


# ------------------------------------------------- held against the JAX one


@pytest.mark.parametrize("seed", range(4))
def test_batch_hash_matches_the_jax_package(seed):
    prev = ref_audit.GENESIS_HASH if seed == 0 else f"{seed:064x}"
    ours = _entries(seed, 1 + 7 * seed)
    ref = _entries(seed, 1 + 7 * seed, ref_audit.AuditEntry)
    assert [e.canonical() for e in ours] == [e.canonical() for e in ref]
    assert batch_hash(prev, ours) == ref_audit.batch_hash(prev, ref)


@pytest.mark.parametrize("query", [
    "bob", "created bob", 'say "hi"', "NEAR( a", "  path:*  ^x ", "",
    'a""b "c', "x*y OR z"])
def test_fts_quote_matches_the_jax_package(query):
    assert fts_quote(query) == ref_audit.fts_quote(query)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_chain_either_package_wrote_verifies_in_the_other(tmp_path, first):
    """Batches appended in turn by both packages to one file form one
    chain that both verify; an edited status and a deleted entry break it
    for both, with the same message."""
    path = str(tmp_path / "llmlb.db")
    ref_db, port_db = RefDatabase(path), Database(path)
    logs = {"jax": (ref_audit.AuditLog(ref_db), ref_audit.AuditEntry),
            "port": (AuditLog(port_db), AuditEntry)}
    order = [first, "port" if first == "jax" else "jax"] * 3
    for i, who in enumerate(order):
        log, cls = logs[who]
        for e in _entries(10 + i, 3 + i, cls):
            log.record(e)
        assert log.flush() == i + 1
        for log2, _ in logs.values():
            assert log2.verify() == (True, None)
    rows = port_db.query_one("SELECT COUNT(*) AS n FROM audit_log")["n"]
    assert rows == sum(3 + i for i in range(6))

    status = port_db.query_one("SELECT status FROM audit_log WHERE id=7")
    port_db.execute("UPDATE audit_log SET status=299 WHERE id=7")
    broken = [log.verify() for log, _ in logs.values()]
    assert broken[0] == broken[1] and broken[0][0] is False
    assert "hash mismatch" in broken[0][1]
    ref_db.execute("UPDATE audit_log SET status=? WHERE id=7",
                   (status["status"],))
    assert [log.verify() for log, _ in logs.values()] == [(True, None)] * 2

    ref_db.execute("DELETE FROM audit_log WHERE id=12")
    broken = [log.verify() for log, _ in logs.values()]
    assert broken[0] == broken[1] and broken[0][0] is False
    assert "entry count mismatch" in broken[0][1]
    ref_db.close()
    port_db.close()


def test_search_and_archive_match_the_jax_package(tmp_path):
    """The same entries give the same search hits (FTS and LIKE) and the
    same archive, with its re-anchored chain, in both packages."""
    results = []
    for Db, Log, Entry in ((RefDatabase, ref_audit.AuditLog,
                            ref_audit.AuditEntry),
                           (Database, AuditLog, AuditEntry)):
        db = Db(":memory:")
        log = Log(db)
        entries = sorted(_entries(3, 40, Entry), key=lambda e: e.ts)
        for i in range(0, 40, 8):  # five batches, oldest first
            for e in entries[i:i + 8]:
                log.record(e)
            log.flush()
        hits = {}
        for q in ("messages", "key", "RuntimeError x", '"x"', "NEAR(",
                  "chat completions"):
            hits[q] = [r["id"] for r in log.search(q=q, limit=1000)]
        db.fts_enabled = False
        hits["like"] = [r["id"] for r in log.search(q="key:", limit=1000)]
        hits["filters"] = [r["id"] for r in log.search(
            actor="alice", path_prefix="/v1", since=1.7e9 + 2e5,
            until=1.7e9 + 9e5, limit=5, offset=1)]
        arch = str(tmp_path / f"arch-{Db.__module__}.db")
        # the first two batches whole: the chain re-anchors on the third
        moved = log.archive_older_than(entries[16].ts, arch)
        results.append((hits, moved, log.verify(),
                        db.get_setting("audit.anchor_hash")))
    assert results[0] == results[1]
    assert results[1][1] == 16 and results[1][2] == (True, None)
    assert results[1][3] is not None


# ------------------------------------------- twins of tests/gateway/test_audit


def test_chain_verifies_and_detects_tampering():
    db = Database(":memory:")
    log = AuditLog(db)
    for batch in range(3):
        for _ in range(4):
            log.record(entry())
        log.flush()
    ok, err = log.verify()
    assert ok, err

    db.execute("UPDATE audit_log SET status=500 WHERE id=5")
    ok, err = log.verify()
    assert not ok
    assert "hash mismatch" in err


def test_chain_detects_deleted_entry():
    db = Database(":memory:")
    log = AuditLog(db)
    for _ in range(6):
        log.record(entry())
    log.flush()
    db.execute("DELETE FROM audit_log WHERE id=2")
    ok, err = log.verify()
    assert not ok


def test_search_filters():
    db = Database(":memory:")
    log = AuditLog(db)
    log.record(entry(path="/api/endpoints"))
    log.record(entry(path="/v1/chat/completions", status=502))
    log.flush()
    assert len(log.search(path_prefix="/api")) == 1
    assert len(log.search(q="chat")) == 1
    assert len(log.search()) == 2


def test_archive_reanchors_chain(tmp_path):
    db = Database(":memory:")
    log = AuditLog(db)
    old = AuditEntry(ts=time.time() - 100 * 86400, method="GET", path="/old",
                     status=200, duration_ms=1)
    log.record(old)
    log.flush()
    for _ in range(3):
        log.record(entry())
    log.flush()

    archive_path = str(tmp_path / "archive.db")
    moved = log.archive_older_than(time.time() - 90 * 86400, archive_path)
    assert moved == 1
    ok, err = log.verify()
    assert ok, err

    arch = sqlite3.connect(archive_path)
    assert arch.execute("SELECT COUNT(*) FROM audit_log").fetchone()[0] == 1
    arch.close()


def test_fts_search_and_injection_safety():
    db = Database(":memory:")
    assert db.fts_enabled
    log = AuditLog(db)
    log.record(AuditEntry(ts=time.time(), method="POST", path="/api/users",
                          status=201, duration_ms=1, actor="alice",
                          detail="created user bob"))
    log.record(AuditEntry(ts=time.time(), method="POST", path="/api/endpoints",
                          status=201, duration_ms=1, actor="carol",
                          detail="registered tpu endpoint"))
    log.flush()
    assert len(log.search(q="bob")) == 1
    assert len(log.search(q="alice")) == 1
    assert len(log.search(q="created bob")) == 1
    assert len(log.search(q="created carol")) == 0
    for hostile in ('NEAR(', 'a AND b OR', '"unbalanced', 'path:*', '^x'):
        log.search(q=hostile)  # must not raise
    assert len(log.search(q="   ")) == 2


def test_fts_stays_in_sync_with_deletes(tmp_path):
    db = Database(":memory:")
    log = AuditLog(db)
    log.record(AuditEntry(ts=time.time() - 100 * 86400, method="GET",
                          path="/ancient", status=200, duration_ms=1))
    log.flush()
    log.record(AuditEntry(ts=time.time(), method="GET", path="/fresh",
                          status=200, duration_ms=1))
    log.flush()
    log.archive_older_than(time.time() - 90 * 86400,
                           str(tmp_path / "archive.db"))
    assert len(log.search(q="ancient")) == 0
    assert len(log.search(q="fresh")) == 1


def test_search_like_fallback_when_fts_unavailable():
    db = Database(":memory:")
    db.fts_enabled = False  # a sqlite build without fts5
    log = AuditLog(db)
    log.record(AuditEntry(ts=time.time(), method="POST", path="/api/users",
                          status=201, duration_ms=1, detail="made bob"))
    log.flush()
    assert len(log.search(q="bob")) == 1
    assert len(log.search(q="nope")) == 0


def test_fts_backfill_on_upgrade(tmp_path):
    """A database from before the FTS table is backfilled at open, so
    archive deletes keep the external-content index whole."""
    path = str(tmp_path / "old.db")
    conn = sqlite3.connect(path)
    conn.executescript("""
        CREATE TABLE audit_log (
            id INTEGER PRIMARY KEY AUTOINCREMENT, ts REAL NOT NULL,
            method TEXT NOT NULL, path TEXT NOT NULL, status INTEGER NOT NULL,
            duration_ms REAL NOT NULL, actor TEXT, actor_type TEXT, ip TEXT,
            detail TEXT, batch_id INTEGER);
    """)
    conn.execute(
        "INSERT INTO audit_log (ts,method,path,status,duration_ms,detail) "
        "VALUES (?,?,?,?,?,?)",
        (time.time() - 100 * 86400, "GET", "/prehistoric", 200, 1.0, "old row"),
    )
    conn.commit()
    conn.close()

    db = Database(path)
    log = AuditLog(db)
    assert len(log.search(q="prehistoric")) == 1
    log.archive_older_than(time.time() - 90 * 86400,
                           str(tmp_path / "arch.db"))
    assert len(log.search(q="prehistoric")) == 0
    db.execute("INSERT INTO audit_log_fts(audit_log_fts) VALUES('integrity-check')")


def test_record_is_a_queue_append():
    """The middleware's call: no database write until the batch fills
    (FLUSH_MAX_ENTRIES) or the writer flushes."""
    from llmlb_tpu_torch.gateway import audit

    db = Database(":memory:")
    log = AuditLog(db)
    for _ in range(audit.FLUSH_MAX_ENTRIES - 1):
        log.record(entry())
    assert db.query_one("SELECT COUNT(*) AS n FROM audit_log")["n"] == 0
    log.record(entry())
    assert db.query_one("SELECT COUNT(*) AS n FROM audit_log")["n"] == \
        audit.FLUSH_MAX_ENTRIES
