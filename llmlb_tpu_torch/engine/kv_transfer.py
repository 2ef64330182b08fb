"""Serialized KV page shipping: move cached state as bytes, not recompute.

The port's own copy of `llmlb_tpu/engine/kv_transfer.py`, the KVSH wire at
version 1, so that a blob crosses between the two packages byte for byte.
A request's KV pages (named by its block-table row) serialize into a
versioned, length-prefixed blob that an adopting engine lands straight into
its own page pool, entering decode with ZERO prefill dispatches.

Wire form (JSON-safe dict):
- every ``KVWireHeader`` field flat on the payload (version, layer count,
  page geometry, kv dtype, covered tokens): the compatibility gate reads
  ONLY the header, so an incompatible peer refuses before touching the
  blob and falls back to the replay path with a labelled reason;
- ``data``: base64 of ``KVSH`` + version + length-prefixed named sections.
  Plain pools ship ``{k, v}`` pages ``[L, P, page, K, D]``; int8 pools ship
  ``{k_q, k_s, v_q, v_s}``, the int8 codes AND their float32 per-vector
  scales, bit-exact copies of the donor's pool cells.

numpy has no bfloat16, so a bfloat16 section is held here as its raw bits,
an int16 array of the same shape (the JAX package holds the same bytes as
ml_dtypes' bfloat16); the scheduler views it back as torch.bfloat16.

The header field set is a dataclass on purpose: every declared field must
round-trip the wire, and an unknown inbound field is refused loudly; a
newer peer's extension must bump the version, never be silently dropped.

Token-identity contract (why shipping rows [0, n-1) is exactly enough):
the adopter sets ``seq_len = n-1`` and ``last_token = committed[-1]``; its
next decode step writes position n-1's KV itself and samples with the
pre-increment fold ``n-1``: the same kernel, step fold and cached bytes
the uninterrupted run used for that position, so greedy and seeded
continuations match (scheduler._insert_restored).
"""

from __future__ import annotations

import base64
import dataclasses
import struct

import numpy as np

KV_WIRE_VERSION = 1
KV_WIRE_MAGIC = b"KVSH"

# Hard caps: the payload crosses process boundaries; absurd figures mean a
# corrupted or hostile blob, not a real request (same stance as the handoff
# wire's _MAX_WIRE_TOKENS).
_MAX_PAGES = 1 << 20
_MAX_SECTION_BYTES = 1 << 33  # 8 GiB

# kv_dtype names this build can land into a pool. "int8" means quantized
# {q, s} pools: codes ship with their float32 per-vector scales.
_PLAIN_DTYPES = ("bfloat16", "float32", "float16")
_SECTIONS_PLAIN = ("k", "v")
_SECTIONS_INT8 = ("k_q", "k_s", "v_q", "v_s")


class KVTransferError(ValueError):
    """Malformed or unsupported KV page payload. ``reason`` is the
    fallback-counter label the caller records (version | error)."""

    def __init__(self, message: str, reason: str = "error"):
        super().__init__(message)
        self.reason = reason


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype a section of kv dtype `name` is held in: bfloat16 as
    its raw bits (int16), since numpy has no bfloat16."""
    if name == "bfloat16":
        return np.dtype(np.int16)
    return np.dtype(name)


@dataclasses.dataclass(frozen=True)
class KVWireHeader:
    """Everything the compatibility gate needs BEFORE touching the blob:
    every field here must round-trip the wire, and an undeclared inbound
    field is refused."""

    version: int
    layers: int
    page_size: int
    num_kv_heads: int
    head_dim: int
    kv_dtype: str  # "bfloat16" | "float32" | "float16" | "int8"
    tokens: int  # KV rows valid in [0, tokens) across the shipped pages
    num_pages: int


_HEADER_FIELDS = tuple(f.name for f in dataclasses.fields(KVWireHeader))


@dataclasses.dataclass
class KVPages:
    """Parsed, validated page payload: host numpy sections ready to land in
    a pool. ``source`` tags where it came from: "wire" (a resume payload)
    or "offload" (the host-RAM tier). On a mesh of ranks the header always
    names the whole model's KV heads, while the sections hold what this
    rank keeps: its own heads for the tier's copies, all of them on the
    leader for a wire payload, none on a follower (the leader sends the
    bytes over the mesh when they land)."""

    header: KVWireHeader
    sections: dict[str, np.ndarray]
    source: str = "wire"

    @property
    def nbytes(self) -> int:
        """The bytes of the whole payload, as the header sizes it: what one
        rank of the whole model would hold, whichever share this copy
        holds. The offload tier charges it, so every rank of a mesh admits
        and evicts alike."""
        return sum(int(np.prod(shape)) * _np_dtype(dtype).itemsize
                   for shape, dtype in expected_sections(self.header).values())


def expected_sections(header: KVWireHeader) -> dict[str, tuple[tuple, str]]:
    """Section name -> (shape, numpy dtype name) for a header's geometry."""
    shape = (header.layers, header.num_pages, header.page_size,
             header.num_kv_heads, header.head_dim)
    if header.kv_dtype == "int8":
        scale = shape[:-1]  # per-vector scales drop the head_dim axis
        return {"k_q": (shape, "int8"), "k_s": (scale, "float32"),
                "v_q": (shape, "int8"), "v_s": (scale, "float32")}
    return {"k": (shape, header.kv_dtype), "v": (shape, header.kv_dtype)}


def serialize_kv_pages(header: KVWireHeader,
                       sections: dict[str, np.ndarray]) -> dict:
    """JSON-safe wire payload: the flat header plus a base64 blob of
    length-prefixed sections. Shapes/dtypes are asserted against the header
    on the way OUT too — a malformed export must fail the exporter, never
    ship bytes an adopter would misread."""
    want = expected_sections(header)
    if set(sections) != set(want):
        raise KVTransferError(
            f"sections {sorted(sections)} do not match kv_dtype "
            f"{header.kv_dtype!r} (want {sorted(want)})"
        )
    parts = [KV_WIRE_MAGIC, struct.pack("<II", header.version, len(want))]
    for name in sorted(want):
        shape, dtype = want[name]
        arr = np.ascontiguousarray(sections[name])
        if tuple(arr.shape) != shape or arr.dtype != _np_dtype(dtype):
            raise KVTransferError(
                f"section {name!r} is {arr.dtype}{arr.shape}, header "
                f"implies {dtype}{shape}"
            )
        raw = arr.tobytes()
        nm = name.encode("ascii")
        parts.append(struct.pack("<H", len(nm)))
        parts.append(nm)
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    payload = dict(dataclasses.asdict(header))
    payload["data"] = base64.b64encode(b"".join(parts)).decode("ascii")
    return payload


def _int_field(payload: dict, key: str, lo: int, hi: int) -> int:
    v = payload.get(key)
    if isinstance(v, bool) or not isinstance(v, int) or not lo <= v <= hi:
        raise KVTransferError(
            f"kv payload field {key!r} must be an integer in "
            f"[{lo}, {hi}], got {v!r}"
        )
    return v


def parse_kv_header(payload: dict) -> KVWireHeader:
    """Validate the flat header of a kv_pages payload. Refuses version skew
    (reason="version") and any undeclared field — silently dropping an
    unknown field would desync the restore, same discipline as the handoff
    sampling block."""
    if not isinstance(payload, dict):
        raise KVTransferError("kv_pages payload must be a JSON object")
    if payload.get("version") != KV_WIRE_VERSION:
        raise KVTransferError(
            f"unsupported kv wire version {payload.get('version')!r} "
            f"(this engine speaks {KV_WIRE_VERSION})", reason="version",
        )
    unknown = set(payload) - set(_HEADER_FIELDS) - {"data"}
    if unknown:
        raise KVTransferError(
            f"unknown kv_pages fields on the wire: {sorted(unknown)}"
        )
    kv_dtype = payload.get("kv_dtype")
    if kv_dtype not in _PLAIN_DTYPES + ("int8",):
        raise KVTransferError(f"unsupported kv_dtype {kv_dtype!r}")
    num_pages = _int_field(payload, "num_pages", 1, _MAX_PAGES)
    page_size = _int_field(payload, "page_size", 1, 1 << 16)
    return KVWireHeader(
        version=KV_WIRE_VERSION,
        layers=_int_field(payload, "layers", 1, 1 << 12),
        page_size=page_size,
        num_kv_heads=_int_field(payload, "num_kv_heads", 1, 1 << 12),
        head_dim=_int_field(payload, "head_dim", 1, 1 << 16),
        kv_dtype=kv_dtype,
        tokens=_int_field(payload, "tokens", 1, num_pages * page_size),
        num_pages=num_pages,
    )


def parse_kv_payload(payload: dict) -> KVPages:
    """Full parse: header + blob -> host numpy sections shaped per the
    header. Every structural lie (bad magic, section count/name/length
    mismatch, trailing bytes) raises KVTransferError — the caller counts a
    labeled fallback and replays; a bad payload is never a client error."""
    header = parse_kv_header(payload)
    raw = payload.get("data")
    if not isinstance(raw, str):
        raise KVTransferError("kv_pages payload has no 'data' blob")
    try:
        blob = base64.b64decode(raw.encode("ascii"), validate=True)
    except Exception:
        raise KVTransferError("kv_pages 'data' is not valid base64")
    if blob[:4] != KV_WIRE_MAGIC:
        raise KVTransferError("kv_pages blob has a bad magic")
    off = 4
    if len(blob) < off + 8:
        raise KVTransferError("kv_pages blob is truncated")
    version, nsec = struct.unpack_from("<II", blob, off)
    off += 8
    if version != header.version:
        raise KVTransferError("kv_pages blob/header version mismatch",
                              reason="version")
    want = expected_sections(header)
    if nsec != len(want):
        raise KVTransferError(
            f"kv_pages blob carries {nsec} sections, header implies "
            f"{len(want)}"
        )
    sections: dict[str, np.ndarray] = {}
    for _ in range(nsec):
        if len(blob) < off + 2:
            raise KVTransferError("kv_pages blob is truncated")
        (nlen,) = struct.unpack_from("<H", blob, off)
        off += 2
        name = blob[off:off + nlen].decode("ascii", errors="replace")
        off += nlen
        if name not in want or name in sections:
            raise KVTransferError(f"unexpected kv section {name!r}")
        if len(blob) < off + 8:
            raise KVTransferError("kv_pages blob is truncated")
        (nbytes,) = struct.unpack_from("<Q", blob, off)
        off += 8
        shape, dtype = want[name]
        dt = _np_dtype(dtype)
        expect = int(np.prod(shape)) * dt.itemsize
        if nbytes != expect or nbytes > _MAX_SECTION_BYTES:
            raise KVTransferError(
                f"kv section {name!r} is {nbytes} bytes, geometry implies "
                f"{expect}"
            )
        if len(blob) < off + nbytes:
            raise KVTransferError("kv_pages blob is truncated")
        sections[name] = np.frombuffer(
            blob, dtype=dt, count=int(np.prod(shape)), offset=off
        ).reshape(shape)
        off += nbytes
    if off != len(blob):
        raise KVTransferError("kv_pages blob has trailing bytes")
    return KVPages(header=header, sections=sections)


def kv_compat_reason(header: KVWireHeader, *, layers: int, page_size: int,
                     num_kv_heads: int, head_dim: int,
                     kv_dtype: str) -> str | None:
    """None when this engine can land the shipped pages verbatim; otherwise
    the fallback-counter reason label (dtype | page_size | geometry). The
    check is strict equality on purpose: re-paging or re-quantizing foreign
    bytes would be a silent numerics change — mismatches replay instead."""
    if header.kv_dtype != kv_dtype:
        return "dtype"
    if header.page_size != page_size:
        return "page_size"
    if (header.layers, header.num_kv_heads, header.head_dim) != (
            layers, num_kv_heads, head_dim):
        return "geometry"
    return None
