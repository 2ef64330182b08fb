"""Authentication: JWT, passwords, users, API keys, invitations, the
bootstrap admin.

The port's counterpart of llmlb_tpu/gateway/auth.py. JWT is HS256 over
hmac/sha256 and API keys are stored as SHA-256 hashes with a display
prefix, as in the reference. One known difference: the reference hashes
passwords with argon2, a package the card's machine does not have, so this
gateway hashes them with the standard library's scrypt
(`$scrypt$ln=14,r=8,p=1$<salt>$<hash>`). A user row that holds an argon2
hash (a database written by the reference gateway) cannot be verified
here: `UserStore.authenticate` raises `UnsupportedPasswordHash`, which the
login handler answers with a 401 that says so.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import hmac
import json
import secrets
import sqlite3
import time
import uuid

from llmlb_tpu_torch.gateway.db import Database
from llmlb_tpu_torch.gateway.types import Permission, Role

JWT_TTL_S = 24 * 3600
MIN_PASSWORD_LENGTH = 8


class AuthError(Exception):
    pass


def constant_time_equal(a: bytes, b: bytes) -> bool:
    """Constant-time byte equality for auth tokens/signatures.

    hmac.compare_digest is already compiled constant-time C and beats a
    ctypes FFI round trip for digest-sized inputs, so it IS the hot path.
    llmlb_tpu_torch/native/router_core.cpp's ct_equal is the C twin for
    native-first callers, held bit-compatible by tests/test_torch_native.py —
    this wrapper exists so every auth compare goes through one audited
    entry point rather than ad-hoc == comparisons."""
    return hmac.compare_digest(a, b)


# ---------------------------------------------------------------------- JWT


# Dashboard cookie names (parity: reference auth/mod.rs DASHBOARD_*_COOKIE).
JWT_COOKIE = "llmlb_jwt"
CSRF_COOKIE = "llmlb_csrf"


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def create_jwt(
    secret: str,
    user_id: str,
    username: str,
    role: Role,
    ttl_s: int = JWT_TTL_S,
    now: float | None = None,
) -> str:
    now = now if now is not None else time.time()
    header = {"alg": "HS256", "typ": "JWT"}
    payload = {
        "sub": user_id,
        "username": username,
        "role": role.value,
        "iat": int(now),
        "exp": int(now + ttl_s),
    }
    signing_input = (
        _b64url(json.dumps(header, separators=(",", ":")).encode())
        + "."
        + _b64url(json.dumps(payload, separators=(",", ":")).encode())
    )
    sig = hmac.new(secret.encode(), signing_input.encode(), hashlib.sha256).digest()
    return signing_input + "." + _b64url(sig)


def verify_jwt(secret: str, token: str, now: float | None = None) -> dict:
    now = now if now is not None else time.time()
    try:
        signing_input, sig_part = token.rsplit(".", 1)
        header_part, payload_part = signing_input.split(".", 1)
        header = json.loads(_b64url_decode(header_part))
        payload = json.loads(_b64url_decode(payload_part))
        sig = _b64url_decode(sig_part)
    except (ValueError, json.JSONDecodeError) as e:
        raise AuthError(f"malformed token: {e}") from None
    if header.get("alg") != "HS256":
        raise AuthError("unsupported JWT algorithm")
    expected = hmac.new(
        secret.encode(), signing_input.encode(), hashlib.sha256
    ).digest()
    if not constant_time_equal(sig, expected):
        raise AuthError("invalid JWT signature")
    if payload.get("exp", 0) < now:
        raise AuthError("token expired")
    return payload


# ------------------------------------------------------------------ password


# scrypt cost: N = 2**14, r = 8, p = 1 (16 MiB, the interactive-login
# setting of the scrypt paper and of hashlib's documentation)
SCRYPT_LOG_N = 14
SCRYPT_R = 8
SCRYPT_P = 1


class UnsupportedPasswordHash(AuthError):
    """A stored password hash in a scheme this gateway cannot verify."""


def hash_password(password: str) -> str:
    salt = secrets.token_bytes(16)
    digest = hashlib.scrypt(password.encode(), salt=salt, n=1 << SCRYPT_LOG_N,
                            r=SCRYPT_R, p=SCRYPT_P, maxmem=64 << 20, dklen=32)
    return (f"$scrypt$ln={SCRYPT_LOG_N},r={SCRYPT_R},p={SCRYPT_P}"
            f"${_b64url(salt)}${_b64url(digest)}")


def verify_password(password_hash: str, password: str) -> bool:
    """True when `password` matches; raises UnsupportedPasswordHash for a
    hash in another scheme (an argon2 hash written by the reference)."""
    if password_hash.startswith("$argon2"):
        raise UnsupportedPasswordHash(
            "this account's password hash is argon2, which this gateway "
            "cannot verify; set a new password for it")
    try:
        _, scheme, params, salt, digest = password_hash.split("$")
        if scheme != "scrypt":
            raise ValueError(scheme)
        cost = dict(kv.split("=", 1) for kv in params.split(","))
        got = hashlib.scrypt(
            password.encode(), salt=_b64url_decode(salt),
            n=1 << int(cost["ln"]), r=int(cost["r"]), p=int(cost["p"]),
            maxmem=64 << 20, dklen=len(_b64url_decode(digest)))
    except (ValueError, KeyError) as e:
        raise UnsupportedPasswordHash(
            f"unrecognized password hash format ({e})") from None
    return hmac.compare_digest(got, _b64url_decode(digest))


def validate_password_policy(password: str) -> None:
    """Minimum policy (parity: auth/password.rs:17-50)."""
    if len(password) < MIN_PASSWORD_LENGTH:
        raise AuthError(f"password must be at least {MIN_PASSWORD_LENGTH} characters")
    if not any(c.isdigit() for c in password):
        raise AuthError("password must contain a digit")
    if not any(c.isalpha() for c in password):
        raise AuthError("password must contain a letter")


# --------------------------------------------------------------------- users


@dataclasses.dataclass
class User:
    id: str
    username: str
    role: Role
    must_change_password: bool = False
    created_at: float = 0.0


class UserStore:
    def __init__(self, db: Database):
        self.db = db

    def create(
        self, username: str, password: str, role: Role,
        must_change_password: bool = False, enforce_policy: bool = True,
    ) -> User:
        if enforce_policy:
            validate_password_policy(password)
        if self.db.query_one("SELECT id FROM users WHERE username=?", (username,)):
            raise AuthError(f"user {username!r} already exists")
        now = time.time()
        user_id = uuid.uuid4().hex
        self.db.execute(
            """INSERT INTO users (id, username, password_hash, role,
               must_change_password, created_at, updated_at) VALUES (?,?,?,?,?,?,?)""",
            (user_id, username, hash_password(password), role.value,
             int(must_change_password), now, now),
        )
        return User(user_id, username, role, must_change_password, now)

    def authenticate(self, username: str, password: str) -> User | None:
        """The user, or None on a wrong name or password; raises
        UnsupportedPasswordHash when the stored hash cannot be checked."""
        row = self.db.query_one("SELECT * FROM users WHERE username=?", (username,))
        if row is None or not verify_password(row["password_hash"], password):
            return None
        return self._to_user(row)

    def get(self, user_id: str) -> User | None:
        row = self.db.query_one("SELECT * FROM users WHERE id=?", (user_id,))
        return self._to_user(row) if row else None

    def get_by_username(self, username: str) -> User | None:
        row = self.db.query_one("SELECT * FROM users WHERE username=?", (username,))
        return self._to_user(row) if row else None

    def list(self) -> list[User]:
        return [self._to_user(r) for r in self.db.query("SELECT * FROM users")]

    def change_password(self, user_id: str, new_password: str) -> None:
        validate_password_policy(new_password)
        self.db.execute(
            """UPDATE users SET password_hash=?, must_change_password=0,
               updated_at=? WHERE id=?""",
            (hash_password(new_password), time.time(), user_id),
        )

    def set_role(self, user_id: str, role: Role) -> None:
        self.db.execute(
            "UPDATE users SET role=?, updated_at=? WHERE id=?",
            (role.value, time.time(), user_id),
        )

    def delete(self, user_id: str) -> bool:
        cur = self.db.execute("DELETE FROM users WHERE id=?", (user_id,))
        return cur.rowcount > 0

    @staticmethod
    def _to_user(row) -> User:
        return User(
            id=row["id"], username=row["username"], role=Role(row["role"]),
            must_change_password=bool(row["must_change_password"]),
            created_at=row["created_at"],
        )


def ensure_admin_exists(
    users: UserStore, username: str = "admin", password: str | None = None
) -> tuple[User, str | None]:
    """Bootstrap admin (parity: auth/bootstrap.rs). Returns (user,
    generated_password_or_None). A generated password forces a change on login."""
    existing = users.get_by_username(username)
    if existing:
        return existing, None
    generated = None
    if password is None:
        generated = secrets.token_urlsafe(12)
        password = generated
    try:
        user = users.create(
            username, password, Role.ADMIN,
            must_change_password=generated is not None, enforce_policy=False,
        )
    except (AuthError, sqlite3.IntegrityError):
        # multi-worker boot race: a sibling worker created the admin between
        # our existence check and the INSERT — adopt its row
        existing = users.get_by_username(username)
        if existing:
            return existing, None
        raise
    return user, generated


# ------------------------------------------------------------------ API keys


@dataclasses.dataclass
class ApiKey:
    id: str
    user_id: str
    name: str
    key_prefix: str
    permissions: list[Permission]
    created_at: float
    revoked: bool = False
    expires_at: float | None = None
    last_used_at: float | None = None


def _hash_key(raw: str) -> str:
    return hashlib.sha256(raw.encode()).hexdigest()


class ApiKeyStore:
    """API keys, stored as SHA-256 hashes.

    ``LLMLB_AUTH_CACHE_TTL`` (seconds) enables an in-memory verified-key
    cache: the proxy hot path then skips one SELECT and one last_used_at
    UPDATE per request. The price is bounded revocation latency — a
    revoked key keeps working for up to the TTL on workers other than the
    one that served the revoke (which invalidates its own cache
    immediately). Default: 0 (off, bit-identical historical behavior) for
    a single-worker gateway; 60 s with --workers > 1 — N workers must not
    serialize on the shared WAL writer lock once per request just to
    refresh a dashboard timestamp (docs/deployment.md). The env knob
    overrides either default (0 disables explicitly).
    """

    MULTI_WORKER_DEFAULT_TTL_S = 60.0

    def __init__(self, db: Database, cache_ttl_s: float | None = None):
        import threading

        self.db = db
        if cache_ttl_s is None:
            # standalone construction (scripts, tests): fall back to the
            # env-derived worker identity; build_app_state passes the TTL
            # explicitly from ITS WorkerInfo so in-process multi-worker
            # states agree with forked ones
            from llmlb_tpu_torch.gateway.config import env_float

            cache_ttl_s = env_float("LLMLB_AUTH_CACHE_TTL", 0.0)
        self.cache_ttl_s = cache_ttl_s
        self._cache_lock = threading.Lock()
        # key_hash -> (ApiKey, cached_at, last_used_written_at)
        self._cache: dict[str, tuple[ApiKey, float, float]] = {}

    def create(
        self, user_id: str, name: str, permissions: list[Permission],
        expires_at: float | None = None,
    ) -> tuple[ApiKey, str]:
        """Returns (record, raw_key). The raw key (sk_...) is shown exactly once."""
        raw = "sk_" + secrets.token_urlsafe(32)
        key_id = uuid.uuid4().hex
        now = time.time()
        self.db.execute(
            """INSERT INTO api_keys (id, user_id, name, key_hash, key_prefix,
               permissions, created_at, expires_at) VALUES (?,?,?,?,?,?,?,?)""",
            (key_id, user_id, name, _hash_key(raw), raw[:11],
             json.dumps([p.value for p in permissions]), now, expires_at),
        )
        return (
            ApiKey(key_id, user_id, name, raw[:11], permissions, now,
                   expires_at=expires_at),
            raw,
        )

    def verify(self, raw: str) -> ApiKey | None:
        key_hash = _hash_key(raw)
        now = time.time()
        ttl = self.cache_ttl_s
        if ttl > 0:
            with self._cache_lock:
                got = self._cache.get(key_hash)
            if got is not None:
                key, cached_at, used_written_at = got
                if now - cached_at < ttl:
                    if key.expires_at is not None and key.expires_at < now:
                        return None
                    if now - used_written_at >= ttl:
                        # last_used_at is dashboard telemetry; once per TTL
                        # keeps it honest without a write per request
                        self.db.execute(
                            "UPDATE api_keys SET last_used_at=? WHERE id=?",
                            (now, key.id),
                        )
                        with self._cache_lock:
                            self._cache[key_hash] = (key, cached_at, now)
                    return key
        row = self.db.query_one(
            "SELECT * FROM api_keys WHERE key_hash=?", (key_hash,)
        )
        if row is None or row["revoked"]:
            return None
        if row["expires_at"] is not None and row["expires_at"] < now:
            return None
        self.db.execute(
            "UPDATE api_keys SET last_used_at=? WHERE id=?", (now, row["id"])
        )
        key = self._to_key(row)
        if ttl > 0:
            with self._cache_lock:
                self._cache[key_hash] = (key, now, now)
        return key

    def list(self, user_id: str | None = None) -> list[ApiKey]:
        if user_id:
            rows = self.db.query(
                "SELECT * FROM api_keys WHERE user_id=?", (user_id,)
            )
        else:
            rows = self.db.query("SELECT * FROM api_keys")
        return [self._to_key(r) for r in rows]

    def revoke(self, key_id: str) -> bool:
        cur = self.db.execute(
            "UPDATE api_keys SET revoked=1 WHERE id=?", (key_id,)
        )
        with self._cache_lock:
            # this worker stops honoring the key immediately; siblings age
            # it out within the cache TTL
            for key_hash, (key, _, _) in list(self._cache.items()):
                if key.id == key_id:
                    del self._cache[key_hash]
        return cur.rowcount > 0

    @staticmethod
    def _to_key(row) -> ApiKey:
        perms = []
        for v in json.loads(row["permissions"] or "[]"):
            try:
                perms.append(Permission(v))
            except ValueError:
                continue
        return ApiKey(
            id=row["id"], user_id=row["user_id"], name=row["name"],
            key_prefix=row["key_prefix"], permissions=perms,
            created_at=row["created_at"], revoked=bool(row["revoked"]),
            expires_at=row["expires_at"], last_used_at=row["last_used_at"],
        )


# ---------------------------------------------------------------- invitations


class InvitationStore:
    def __init__(self, db: Database):
        self.db = db

    def create(
        self, created_by: str, role: Role = Role.VIEWER,
        ttl_s: float | None = 7 * 86400,
    ) -> dict:
        code = secrets.token_urlsafe(16)
        inv_id = uuid.uuid4().hex
        now = time.time()
        self.db.execute(
            """INSERT INTO invitations (id, code, role, created_by, created_at,
               expires_at) VALUES (?,?,?,?,?,?)""",
            (inv_id, code, role.value, created_by, now,
             now + ttl_s if ttl_s else None),
        )
        return {"id": inv_id, "code": code, "role": role.value,
                "expires_at": now + ttl_s if ttl_s else None}

    def redeem(self, code: str, username: str, password: str,
               users: UserStore) -> User:
        row = self.db.query_one(
            "SELECT * FROM invitations WHERE code=?", (code,)
        )
        if row is None or row["used_at"] is not None:
            raise AuthError("invalid or used invitation code")
        if row["expires_at"] is not None and row["expires_at"] < time.time():
            raise AuthError("invitation expired")
        user = users.create(username, password, Role(row["role"]))
        self.db.execute(
            "UPDATE invitations SET used_by=?, used_at=? WHERE id=?",
            (user.id, time.time(), row["id"]),
        )
        return user

    def list(self) -> list[dict]:
        return [dict(r) for r in self.db.query("SELECT * FROM invitations")]

    def delete(self, inv_id: str) -> bool:
        cur = self.db.execute("DELETE FROM invitations WHERE id=?", (inv_id,))
        return cur.rowcount > 0
