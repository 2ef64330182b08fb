"""Best-effort state replication between gateway workers — same host and
across hosts. The port's copy of llmlb_tpu/gateway/gossip.py: the same
message kinds, wire versions and bytes, so a bus of either package reads
the other's messages.

Shared-nothing workers (gateway/worker.py) each hold their own copy of the
small mutable routing state: breaker states, TPS EMAs, the retry-budget
window, prefix-affinity pins, adapter residency, the prefix-heat map, and
(in global mode) rate-limit spend. This bus gossips those deltas over local
unix datagram sockets to same-host siblings and — when ``LLMLB_GOSSIP_BIND``
is set — over a UDP mesh to the workers of OTHER gateway hosts, with a TCP
fallback for payloads too large for one datagram.

Design constraints, in order:
  * **Correctness never depends on gossip.** Every message is advisory: a
    worker that misses updates only degrades steering/placement until its
    own in-band signals converge (LLMLB_GOSSIP=0 must be a safe mode, and
    a partitioned mesh must degrade to per-worker convergence, never
    worse — tests/test_torch_gateway_multiworker.py pins both).
  * **No wall clocks in conflict resolution.** Messages carry a per-origin
    Lamport sequence number; receivers keep a ``(seq, origin)`` version per
    state key and drop anything not newer. Wall stamps ride the envelope
    for the lag gauge ONLY — clock skew across hosts silently resurrected
    stale breaker state under a wall-stamp LWW.
  * **Versioned wire format.** Every message kind is a dataclass in
    ``MESSAGE_TYPES`` with its own wire version; unknown inbound fields and
    version mismatches refuse loudly (tests/test_torch_gateway_gossip.py
    probes every declared field, so adding one without wire coverage is a
    test failure).
  * **Never block the hot path.** Sends are non-blocking datagram writes;
    a full or missing peer drops the message (counted) instead of waiting.
    The TCP fallback runs on the event loop, never inline in publish().

Membership: same-host siblings are discovered by globbing ``{dir}/w*.sock``
as before. Mesh peers come from three sources merged at each refresh —
static seeds (``LLMLB_GOSSIP_PEERS``), the shared registry database (each
host advertises its mesh address into the gateway settings table, so a
host that can reach the DB finds the fleet without config), and addresses
learned from inbound ``hello`` heartbeats. A peer silent past
``PARTITION_SUSPECT_S`` flips the ``gossip_partition_suspected`` gauge —
the operator signal that the fleet is converging per-worker.
"""

from __future__ import annotations

import asyncio
import dataclasses
import glob
import json
import logging
import os
import random
import socket
import struct
import threading
import time
import typing

log = logging.getLogger("llmlb_tpu_torch.gateway.gossip")

# Re-list the peer sockets at most this often: publishes between refreshes
# reuse the cached listing (workers churn at process granularity, not per
# request).
PEER_REFRESH_S = 2.0

LAG_WINDOW = 64  # samples kept for the lag gauge

# Mesh payloads above this ride the TCP fallback: one datagram must fit a
# single unfragmented-ish UDP packet budget (prefix-heat maps and batched
# rl_spend flushes can outgrow it; unix datagrams on the same host are not
# subject to the limit but use the same threshold for one code path).
UDP_MAX_BYTES = 60_000
TCP_MAX_BYTES = 16 << 20  # refuse anything larger on the fallback listener
TCP_CONNECT_TIMEOUT_S = 2.0

# Mesh liveness: heartbeat cadence and the silence window after which a
# known peer is counted as suspected-partitioned.
HELLO_INTERVAL_S = 2.0
PARTITION_SUSPECT_S = 10.0

# Key prefix in the gateway settings table under which each host persists
# its advertised mesh address (membership from the registry DB).
MEMBER_KEY_PREFIX = "gossip.member."

# A version is a (seq, origin) tuple: per-origin Lamport sequence number
# first, origin id as the deterministic tiebreak. Tuple comparison IS the
# supersedes relation — see `newer`.
Version = typing.Tuple[int, str]


class GossipWireError(ValueError):
    """A gossip payload that must not be applied: unknown kind, version
    mismatch, unknown field (a newer peer's extension must version-bump,
    never silently drop), or malformed envelope."""


def newer(candidate: Version | None, current: Version | None) -> bool:
    """True when `candidate` supersedes `current` (None = never stamped).
    Lexicographic on (seq, origin): Lamport order first, origin id as a
    total-order tiebreak so two workers never disagree about a winner."""
    if candidate is None:
        return False
    if current is None:
        return True
    return tuple(candidate) > tuple(current)


class SeqClock:
    """Per-process Lamport clock: `tick` stamps every locally originated
    message/state change, `witness` folds in every received stamp, so any
    state change CAUSED by a remote observation outranks it. Thread-safe —
    publishes arrive from GC finalizers and executor threads."""

    __slots__ = ("_seq", "_lock")

    def __init__(self, start: int = 0):
        self._seq = int(start)
        self._lock = threading.Lock()

    def tick(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def witness(self, remote_seq: int) -> None:
        with self._lock:
            if remote_seq > self._seq:
                self._seq = remote_seq

    def peek(self) -> int:
        with self._lock:
            return self._seq


# --------------------------------------------------------------- wire format
#
# One frozen dataclass per message kind; KIND/VERSION are class attributes,
# every field must be JSON-safe. encode/decode are the ONLY paths on/off the
# wire — tests/test_torch_gateway_gossip.py round-trips probed non-default
# values for every declared field through them, so a field added here
# without surviving the wire is a tier-1 failure.


@dataclasses.dataclass(frozen=True)
class HelloMsg:
    """Mesh heartbeat + membership advertisement. `nonce` is a per-process
    random id so a restarted host (same advertise addr, reset SeqClock) is
    recognized and its per-origin dedupe state dropped."""

    KIND: typing.ClassVar[str] = "hello"
    VERSION: typing.ClassVar[int] = 1

    advertise: str = ""
    index: int = 0
    nonce: int = 0


@dataclasses.dataclass(frozen=True)
class TpsMsg:
    """One endpoint TPS EMA observation (balancer._maybe_gossip_tps)."""

    KIND: typing.ClassVar[str] = "tps"
    VERSION: typing.ClassVar[int] = 1

    eid: str = ""
    model: str = ""
    kind: str = "decode_tps"
    ema: float = 0.0
    samples: int = 1


@dataclasses.dataclass(frozen=True)
class TpsClearMsg:
    """Endpoint went offline: drop its TPS state everywhere."""

    KIND: typing.ClassVar[str] = "tps_clear"
    VERSION: typing.ClassVar[int] = 1

    eid: str = ""


@dataclasses.dataclass(frozen=True)
class AffinityMsg:
    """LRU prefix-affinity pin (balancer._gossip_affinity)."""

    KIND: typing.ClassVar[str] = "affinity"
    VERSION: typing.ClassVar[int] = 1

    model: str = ""
    hash: str = ""
    eid: str = ""


@dataclasses.dataclass(frozen=True)
class BreakerMsg:
    """Breaker transition. Ships the REMAINING open interval, not the
    deadline — wall deadlines don't cross process (or host) clocks; the
    receiver rebuilds open_until on its own monotonic clock."""

    KIND: typing.ClassVar[str] = "breaker"
    VERSION: typing.ClassVar[int] = 1

    eid: str = ""
    to: str = ""
    reason: str = ""
    remaining_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class RetrySpendMsg:
    """Retry-budget spends witnessed by one worker (`n` batched)."""

    KIND: typing.ClassVar[str] = "retry_spend"
    VERSION: typing.ClassVar[int] = 1

    n: int = 1


@dataclasses.dataclass(frozen=True)
class RegistryMsg:
    """The shared registry DB mutated: reload caches."""

    KIND: typing.ClassVar[str] = "registry"
    VERSION: typing.ClassVar[int] = 1

    hint: str = ""


@dataclasses.dataclass(frozen=True)
class RlSpendMsg:
    """Batched rate-limit spend deltas for the GLOBAL token buckets:
    {tenant_key: [requests, tokens]} consumed since the last flush.
    Receivers charge their local buckets by the delta — admission then
    approximates the fleet-wide limit instead of limit×workers
    (docs/resilience.md)."""

    KIND: typing.ClassVar[str] = "rl_spend"
    VERSION: typing.ClassVar[int] = 1

    spends: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ResidencyMsg:
    """Event-driven adapter residency: the health checker observed this
    endpoint's loaded-adapter set change (health._sync_lora_models) — the
    per-probe poll becomes a push, so siblings steer LoRA traffic within
    one gossip hop instead of one probe interval."""

    KIND: typing.ClassVar[str] = "residency"
    VERSION: typing.ClassVar[int] = 1

    eid: str = ""
    adapters: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class HeatMsg:
    """Prefix-heat deltas: {prefix_hash: [eid, hits]} — which endpoint
    actually holds which hot prefix cached, so rendezvous affinity steers
    by real cache contents (balancer, LLMLB_AFFINITY_HEAT)."""

    KIND: typing.ClassVar[str] = "heat"
    VERSION: typing.ClassVar[int] = 1

    model: str = ""
    entries: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class MigrateMsg:
    """Rebalancer directive (gateway/rebalance.py, primary worker only):
    every worker holding live streams on `eid` should move up to
    `max_streams` of them to `target` (empty = each worker re-selects).
    Advisory like all gossip — a worker that misses it just keeps serving
    from the overloaded engine until the next directive."""

    KIND: typing.ClassVar[str] = "migrate"
    VERSION: typing.ClassVar[int] = 1

    eid: str = ""
    target: str = ""
    reason: str = "hotspot"
    max_streams: int = 1
    directive_id: int = 0


MESSAGE_TYPES: dict[str, type] = {
    cls.KIND: cls
    for cls in (
        HelloMsg, TpsMsg, TpsClearMsg, AffinityMsg, BreakerMsg,
        RetrySpendMsg, RegistryMsg, RlSpendMsg, ResidencyMsg, HeatMsg,
        MigrateMsg,
    )
}


def encode_message(kind: str, data: dict, *, origin: str, seq: int,
                   ts: float | None = None) -> bytes:
    """The ONE path onto the wire. Raises GossipWireError for an unknown
    kind or a field the message type does not declare — a publish site
    that outgrows its dataclass fails loudly at the sender, where the bug
    is, not as a silent drop at every receiver."""
    cls = MESSAGE_TYPES.get(kind)
    if cls is None:
        raise GossipWireError(f"unknown gossip kind {kind!r}")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise GossipWireError(
            f"gossip {kind!r} does not declare field(s) "
            f"{', '.join(sorted(unknown))} — extend {cls.__name__} "
            "(and its wire probes) first"
        )
    msg = cls(**data)
    envelope = {
        "v": cls.VERSION,
        "k": kind,
        "o": origin,
        "s": int(seq),
        # wall stamp is DIAGNOSTIC (lag gauge) — never conflict resolution
        "ts": time.time() if ts is None else float(ts),
        "d": dataclasses.asdict(msg),
    }
    return json.dumps(envelope, separators=(",", ":")).encode()


def decode_message(raw: bytes | dict) -> tuple[str, dict, dict]:
    """The ONE path off the wire: → (kind, data, meta) with
    meta = {origin, seq, ver, ts, lag_s}. Raises GossipWireError for
    anything that must not be applied; the bus counts and drops."""
    if isinstance(raw, (bytes, bytearray)):
        try:
            env = json.loads(raw)
        except (ValueError, UnicodeDecodeError) as e:
            raise GossipWireError(f"gossip envelope is not JSON: {e}")
    else:
        env = raw
    if not isinstance(env, dict):
        raise GossipWireError("gossip envelope must be a JSON object")
    kind = env.get("k")
    cls = MESSAGE_TYPES.get(kind) if isinstance(kind, str) else None
    if cls is None:
        raise GossipWireError(f"unknown gossip kind {kind!r}")
    if env.get("v") != cls.VERSION:
        raise GossipWireError(
            f"gossip {kind!r} version {env.get('v')!r} != {cls.VERSION} "
            "(mixed-version fleet: upgrade in lockstep or bump the kind)"
        )
    origin = env.get("o")
    seq = env.get("s")
    if not isinstance(origin, str) or not origin:
        raise GossipWireError(f"gossip {kind!r}: 'o' must be a non-empty str")
    if not isinstance(seq, int) or isinstance(seq, bool) or seq < 0:
        raise GossipWireError(f"gossip {kind!r}: 's' must be a non-negative int")
    d = env.get("d")
    if d is None:
        d = {}
    if not isinstance(d, dict):
        raise GossipWireError(f"gossip {kind!r}: 'd' must be an object")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise GossipWireError(
            f"gossip {kind!r} carries unknown field(s) "
            f"{', '.join(sorted(unknown))} — a newer peer must bump "
            f"{cls.__name__}.VERSION, never rely on silent drops"
        )
    try:
        msg = cls(**d)
    except TypeError as e:
        raise GossipWireError(f"gossip {kind!r}: {e}")
    try:
        ts = float(env.get("ts", 0.0))
    except (TypeError, ValueError):
        raise GossipWireError(f"gossip {kind!r}: bad 'ts'")
    meta = {
        "origin": origin,
        "seq": seq,
        "ver": (seq, origin),
        "ts": ts,
        "lag_s": 0.0,  # filled by the receiving bus
    }
    return kind, dataclasses.asdict(msg), meta


# ------------------------------------------------------------ fault injection


GOSSIP_FAULT_KINDS = ("drop", "delay", "partition")


@dataclasses.dataclass
class GossipFaultRule:
    """One transport-injection rule, the faults.py discipline applied to
    the gossip boundary (LLMLB_GOSSIP_FAULTS is a JSON list of these)::

        {"kind": "drop",             # or delay | partition
         "message": "breaker",       # message kind, "*" matches all
         "peer": "w1",               # destination origin/address substring,
                                     # "*" matches every peer
         "every_n": 2,               # fire on every Nth matching send…
         "probability": 0.5,         # …or with seeded probability
         "delay_s": 0.2,             # kind=delay: added delivery delay
         "groups": [["w0"],["w1"]],  # kind=partition: origins in different
                                     # groups cannot reach each other
         "max_fires": 10}            # optional cap, then rule is inert

    `partition` ignores every_n/probability — it is a topology statement,
    deterministic by construction. Everything else fires via `every_n`
    counters or one seeded RNG, so chaos tests replay bit-for-bit.
    """

    kind: str
    message: str = "*"
    peer: str = "*"
    every_n: int | None = None
    probability: float | None = None
    delay_s: float = 0.0
    groups: list = dataclasses.field(default_factory=list)
    max_fires: int | None = None
    # runtime counters (not part of the config surface)
    seen: int = 0
    fires: int = 0

    def __post_init__(self):
        if self.kind not in GOSSIP_FAULT_KINDS:
            raise ValueError(
                f"unknown gossip fault kind {self.kind!r} (expected one of "
                f"{', '.join(GOSSIP_FAULT_KINDS)})"
            )

    def matches(self, message: str, peer: str) -> bool:
        if self.message != "*" and self.message != message:
            return False
        if self.peer == "*":
            return True
        return self.peer in peer

    def partitioned(self, src: str, dst: str) -> bool:
        """True when src and dst sit in DIFFERENT declared groups. Origins
        not named in any group are unaffected (they see everyone)."""
        src_g = dst_g = None
        for i, group in enumerate(self.groups):
            members = [str(m) for m in group]
            if any(m in src for m in members):
                src_g = i
            if any(m in dst for m in members):
                dst_g = i
        return src_g is not None and dst_g is not None and src_g != dst_g


class GossipFaults:
    """Rule table + deterministic firing state for the gossip transport.
    Consulted once per (message, destination) at send time — receive-side
    injection would double-fire the counters for loopback-free buses."""

    def __init__(self, rules: list[GossipFaultRule] | None = None,
                 seed: int = 0):
        self._lock = threading.Lock()
        self._rules: list[GossipFaultRule] = list(rules or [])
        self._rng = random.Random(seed)

    @classmethod
    def from_env(cls) -> "GossipFaults | None":
        raw = os.environ.get("LLMLB_GOSSIP_FAULTS")
        if not raw:
            return None
        try:
            spec = json.loads(raw)
            rules = [GossipFaultRule(**r) for r in spec]
        except (ValueError, TypeError) as e:
            raise ValueError(
                f"LLMLB_GOSSIP_FAULTS is not a valid rule list: {e}"
            )
        seed = int(os.environ.get("LLMLB_FAULTS_SEED", "0") or 0)
        return cls(rules, seed=seed)

    def add_rule(self, rule: GossipFaultRule) -> GossipFaultRule:
        with self._lock:
            self._rules.append(rule)
        return rule

    def remove_rule(self, rule: GossipFaultRule) -> None:
        with self._lock:
            if rule in self._rules:
                self._rules.remove(rule)

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()

    def decide(self, message: str, src: str, dst: str) -> tuple[bool, float]:
        """→ (drop, delay_s) for one send to one destination. Partition
        rules are pure topology; drop/delay advance deterministic per-rule
        counters exactly once per matching send."""
        drop = False
        delay = 0.0
        with self._lock:
            for rule in self._rules:
                if rule.kind == "partition":
                    if rule.partitioned(src, dst):
                        rule.fires += 1
                        drop = True
                    continue
                if not rule.matches(message, dst):
                    continue
                if rule.max_fires is not None and rule.fires >= rule.max_fires:
                    continue
                rule.seen += 1
                if rule.probability is not None:
                    fire = self._rng.random() < rule.probability
                else:
                    n = rule.every_n or 1
                    fire = rule.seen % n == 0
                if not fire:
                    continue
                rule.fires += 1
                if rule.kind == "drop":
                    drop = True
                else:
                    delay = max(delay, rule.delay_s)
        return drop, delay

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "kind": r.kind, "message": r.message, "peer": r.peer,
                    "every_n": r.every_n, "probability": r.probability,
                    "delay_s": r.delay_s if r.kind == "delay" else None,
                    "groups": r.groups if r.kind == "partition" else None,
                    "seen": r.seen, "fires": r.fires,
                }
                for r in self._rules
            ]


# -------------------------------------------------------------------- mesh


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Cross-host transport config. `bind` empty (the default) keeps the
    bus unix-only — exactly the pre-mesh behavior."""

    bind: str = ""        # "host:port" UDP+TCP listen address
    advertise: str = ""   # address peers should dial; defaults to bind
    peers: tuple = ()     # static seed addresses ("host:port", ...)

    @classmethod
    def from_env(cls) -> "MeshConfig":
        bind = (os.environ.get("LLMLB_GOSSIP_BIND") or "").strip()
        advertise = (os.environ.get("LLMLB_GOSSIP_ADVERTISE") or "").strip()
        raw = os.environ.get("LLMLB_GOSSIP_PEERS") or ""
        peers = tuple(p.strip() for p in raw.split(",") if p.strip())
        return cls(bind=bind, advertise=advertise or bind, peers=peers)

    @property
    def enabled(self) -> bool:
        return bool(self.bind)


def parse_addr(addr: str) -> tuple[str, int] | None:
    """'host:port' → (host, port); None for anything malformed (a bad peer
    entry must not take the bus down)."""
    host, sep, port = addr.rpartition(":")
    if not sep or not host:
        return None
    try:
        return host.strip("[]"), int(port)
    except ValueError:
        return None


class _Receiver(asyncio.DatagramProtocol):
    def __init__(self, bus: "GossipBus", transport_name: str):
        self.bus = bus
        self.name = transport_name

    def datagram_received(self, data: bytes, addr) -> None:
        self.bus._on_datagram(data, via=self.name)


class GossipBus:
    """Datagram fan-out between gateway workers: unix sockets to same-host
    siblings, UDP (TCP above UDP_MAX_BYTES) to mesh peers.

    Handlers are registered per message kind and run on the receiving
    worker's event loop; they must be fast and must NOT publish back
    (receivers apply remote state via ``apply_remote_*`` entry points that
    never re-gossip, or a two-worker group would ping-pong forever).
    """

    def __init__(self, directory: str, index: int, expected_peers: int = 0,
                 *, mesh: MeshConfig | None = None,
                 faults: GossipFaults | None = None,
                 membership: typing.Callable[[], dict] | None = None,
                 register: typing.Callable[[str, str], None] | None = None):
        self.directory = directory
        self.index = index
        # Sibling count this bus should eventually see: while the cached
        # listing is SHORTER than this, every publish re-globs — a worker
        # that boots milliseconds before its siblings must not cache the
        # empty directory for PEER_REFRESH_S and silently drop its first
        # (often most important: registry/breaker) messages.
        self.expected_peers = expected_peers
        self.mesh = mesh or MeshConfig()
        self.faults = faults
        # membership() → {origin: advertise_addr} from the shared registry
        # DB; register(origin, advertise) persists OUR address there.
        self._membership = membership
        self._register = register
        self.path = os.path.join(directory, f"w{index}.sock")
        # Origin id: globally unique per worker process. Same-host siblings
        # are "w{i}"; mesh workers prefix the advertised address so two
        # hosts' worker-0s never collide.
        if self.mesh.enabled and self.mesh.advertise:
            self.origin = f"{self.mesh.advertise}#w{index}"
        else:
            self.origin = f"w{index}"
        self.clock = SeqClock()
        self.nonce = random.getrandbits(63)
        self._handlers: dict[str, list[typing.Callable]] = {}
        self._send_sock: socket.socket | None = None
        self._udp_sock: socket.socket | None = None
        self._transport: asyncio.DatagramTransport | None = None
        self._udp_transport: asyncio.DatagramTransport | None = None
        self._tcp_server: asyncio.AbstractServer | None = None
        self._hello_task: asyncio.Task | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._peers: list[str] = []
        self._peers_refreshed = 0.0
        # mesh peers: addr "host:port" → {"last_seen": monotonic|None,
        # "origin": str|None, "nonce": int|None}; seeded from config +
        # registry membership, refined by hello heartbeats.
        self._mesh_peers: dict[str, dict] = {}
        self._mesh_refreshed = 0.0
        # per-(origin, kind) high-water marks: drop duplicated/reordered
        # datagrams for kinds where replays are not idempotent; reset when
        # a peer's hello nonce changes (process restart → fresh clock).
        self._origin_seq: dict[tuple[str, str], int] = {}
        self._lock = threading.Lock()
        self.on_heartbeat: list[typing.Callable[[], None]] = []
        # optional per-message lag observer (app_state wires the gossip
        # delay histogram here); must never raise into the receive path
        self.on_lag: typing.Callable[[float], None] | None = None
        # counters surfaced in /metrics (docs/monitoring/README.md)
        self.sent_total = 0
        self.received_total = 0
        self.send_errors_total = 0
        self.recv_rejected_total = 0
        self.fault_dropped_total = 0
        self._lag_samples: list[float] = []

    # ------------------------------------------------------------- lifecycle

    async def start(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        try:
            os.unlink(self.path)  # stale socket from a previous run
        except FileNotFoundError:
            pass
        recv = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        recv.bind(self.path)
        recv.setblocking(False)
        loop = asyncio.get_running_loop()
        self._loop = loop
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _Receiver(self, "unix"), sock=recv
        )
        send = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        send.setblocking(False)
        self._send_sock = send
        if self.mesh.enabled:
            await self._start_mesh(loop)
        log.info("gossip bus up at %s%s", self.path,
                 f" + mesh {self.mesh.bind}" if self.mesh.enabled else "")

    async def _start_mesh(self, loop: asyncio.AbstractEventLoop) -> None:
        addr = parse_addr(self.mesh.bind)
        if addr is None:
            log.warning("LLMLB_GOSSIP_BIND %r is not host:port; "
                        "mesh disabled", self.mesh.bind)
            return
        udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        udp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        udp.bind(addr)
        udp.setblocking(False)
        self._udp_transport, _ = await loop.create_datagram_endpoint(
            lambda: _Receiver(self, "udp"), sock=udp
        )
        out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        out.setblocking(False)
        self._udp_sock = out
        # TCP fallback listener on the same port: oversize payloads arrive
        # as one length-prefixed frame per connection.
        self._tcp_server = await asyncio.start_server(
            self._on_tcp_conn, host=addr[0], port=addr[1],
            reuse_address=True,
        )
        for peer in self.mesh.peers:
            if peer and peer != self.mesh.advertise:
                self._mesh_peers.setdefault(
                    peer, {"last_seen": None, "origin": None, "nonce": None})
        self._hello_task = loop.create_task(self._hello_loop())

    def close(self) -> None:
        if self._hello_task is not None:
            self._hello_task.cancel()
            self._hello_task = None
        if self._transport is not None:
            self._transport.close()
            self._transport = None
        if self._udp_transport is not None:
            self._udp_transport.close()
            self._udp_transport = None
        if self._tcp_server is not None:
            self._tcp_server.close()
            self._tcp_server = None
        for sk in (self._send_sock, self._udp_sock):
            if sk is not None:
                sk.close()
        self._send_sock = None
        self._udp_sock = None
        try:
            os.unlink(self.path)
        except OSError:
            pass

    # ------------------------------------------------------------ publishing

    def next_version(self) -> Version:
        """Allocate a fresh (seq, origin) version: callers stamp local state
        with it and pass seq back into publish(), so the wire stamp and the
        local stamp are THE SAME version — a delayed echo of an older
        remote update can never outrank the local transition it raced."""
        return (self.clock.tick(), self.origin)

    def _peer_paths(self) -> list[str]:
        now = time.monotonic()
        if (now - self._peers_refreshed > PEER_REFRESH_S
                or len(self._peers) < self.expected_peers):
            self._peers = [
                p for p in glob.glob(os.path.join(self.directory, "w*.sock"))
                if p != self.path
            ]
            self._peers_refreshed = now
        return self._peers

    def _mesh_addrs(self) -> list[str]:
        """Current mesh destinations: config seeds ∪ registry membership ∪
        hello-learned, minus ourselves."""
        now = time.monotonic()
        if (self._membership is not None
                and now - self._mesh_refreshed > PEER_REFRESH_S):
            self._mesh_refreshed = now
            try:
                members = self._membership() or {}
            except Exception:  # registry briefly unavailable: keep cache
                log.debug("gossip membership refresh failed", exc_info=True)
                members = {}
            for origin, addr in members.items():
                if not addr or addr == self.mesh.advertise:
                    continue
                entry = self._mesh_peers.setdefault(
                    addr, {"last_seen": None, "origin": None, "nonce": None})
                entry.setdefault("origin", origin)
        return list(self._mesh_peers)

    def publish(self, kind: str, data: dict, *, seq: int | None = None) -> Version:
        """Fire-and-forget to every peer; returns the (seq, origin) version
        the message carried. Callable from any thread (lease releases
        arrive from GC finalizers); plain sendto on non-blocking sockets,
        no event-loop round trip (the TCP fallback hops to the loop)."""
        if seq is None:
            seq = self.clock.tick()
        version = (seq, self.origin)
        payload = encode_message(kind, data, origin=self.origin, seq=seq)
        sock = self._send_sock
        if sock is None:
            return version
        with self._lock:
            peers = self._peer_paths()
            mesh_addrs = self._mesh_addrs() if self.mesh.enabled else []
            if log.isEnabledFor(logging.DEBUG):
                log.debug("gossip publish kind=%s to %d unix + %d mesh "
                          "peers", kind, len(peers), len(mesh_addrs))
            for peer in peers:
                # destination origin for fault matching: the sibling index
                # embedded in its socket name ({dir}/w{i}.sock)
                dst = os.path.basename(peer).rsplit(".", 1)[0]
                if not self._fault_gate(kind, dst, payload, peer, unix=True):
                    continue
                self._sendto_unix(sock, payload, peer)
            for addr in mesh_addrs:
                entry = self._mesh_peers.get(addr) or {}
                dst = entry.get("origin") or addr
                if not self._fault_gate(kind, dst, payload, addr, unix=False):
                    continue
                self._send_mesh(payload, addr)
        return version

    def _fault_gate(self, kind: str, dst: str, payload: bytes,
                    dest, *, unix: bool) -> bool:
        """Consult the fault table for one destination: False = suppressed
        here (dropped or rescheduled after a delay)."""
        if self.faults is None:
            return True
        drop, delay = self.faults.decide(kind, self.origin, dst)
        if drop:
            self.fault_dropped_total += 1
            return False
        if delay > 0:
            timer = threading.Timer(
                delay, self._deliver_delayed, (payload, dest, unix))
            timer.daemon = True
            timer.start()
            return False
        return True

    def _deliver_delayed(self, payload: bytes, dest, unix: bool) -> None:
        with self._lock:
            if unix:
                if self._send_sock is not None:
                    self._sendto_unix(self._send_sock, payload, dest)
            else:
                self._send_mesh(payload, dest)

    def _sendto_unix(self, sock: socket.socket, payload: bytes,
                     peer: str) -> None:
        try:
            sock.sendto(payload, peer)
            self.sent_total += 1
        except OSError:
            # peer gone / queue full: best-effort means drop, and the
            # peer's own in-band signals converge it later
            self.send_errors_total += 1

    def _send_mesh(self, payload: bytes, addr: str) -> None:
        parsed = parse_addr(addr)
        if parsed is None:
            self.send_errors_total += 1
            return
        if len(payload) > UDP_MAX_BYTES:
            # oversize → one-shot TCP frame, off the hot path on the loop
            loop = self._loop
            if loop is None or loop.is_closed():
                self.send_errors_total += 1
                return
            loop.call_soon_threadsafe(
                lambda: loop.create_task(self._tcp_send(parsed, payload)))
            return
        if self._udp_sock is None:
            return
        try:
            self._udp_sock.sendto(payload, parsed)
            self.sent_total += 1
        except OSError:
            self.send_errors_total += 1

    async def _tcp_send(self, addr: tuple[str, int], payload: bytes) -> None:
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(addr[0], addr[1]),
                timeout=TCP_CONNECT_TIMEOUT_S,
            )
            writer.write(struct.pack(">I", len(payload)) + payload)
            await writer.drain()
            writer.close()
            self.sent_total += 1
        except (OSError, asyncio.TimeoutError):
            self.send_errors_total += 1

    # -------------------------------------------------------------- receiving

    def subscribe(self, kind: str,
                  handler: typing.Callable[[dict, dict], None]) -> None:
        """``handler(data, meta)`` with
        meta = {origin, seq, ver, ts, lag_s}. ``ver`` is the (seq, origin)
        tuple receivers stamp per-key state with (see `newer`)."""
        self._handlers.setdefault(kind, []).append(handler)

    async def _on_tcp_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            header = await reader.readexactly(4)
            (size,) = struct.unpack(">I", header)
            if size > TCP_MAX_BYTES:
                self.recv_rejected_total += 1
                return
            raw = await reader.readexactly(size)
        except (asyncio.IncompleteReadError, OSError):
            self.recv_rejected_total += 1
            return
        finally:
            writer.close()
        self._on_datagram(raw, via="tcp")

    def _on_datagram(self, raw: bytes, via: str = "unix") -> None:
        try:
            kind, data, meta = decode_message(raw)
        except GossipWireError as e:
            self.recv_rejected_total += 1
            log.debug("gossip rejected (%s): %s", via, e)
            return
        origin = meta["origin"]
        if origin == self.origin:
            return  # our own message looped back via a seed list
        seq = meta["seq"]
        self.clock.witness(seq)
        self.received_total += 1
        lag = max(0.0, time.time() - meta["ts"])
        meta["lag_s"] = lag
        self._lag_samples.append(lag)
        if len(self._lag_samples) > LAG_WINDOW:
            del self._lag_samples[: len(self._lag_samples) - LAG_WINDOW]
        if self.on_lag is not None:
            try:
                self.on_lag(lag)
            except Exception:  # allow-silent: a metrics observer must not
                pass           # poison message delivery
        if kind == HelloMsg.KIND:
            self._note_hello(origin, data)
        elif via in ("udp", "tcp"):
            self._note_mesh_alive(origin)
        # per-origin duplicate/reorder suppression for non-idempotent kinds:
        # a replayed datagram must not double-charge buckets or budgets.
        # (Reset when the peer's hello nonce changes — see _note_hello.)
        if kind in (RlSpendMsg.KIND, RetrySpendMsg.KIND, MigrateMsg.KIND):
            last = self._origin_seq.get((origin, kind))
            if last is not None and seq <= last:
                return
            self._origin_seq[(origin, kind)] = seq
        for handler in self._handlers.get(kind, ()):
            try:
                handler(data, meta)
            except Exception:  # one bad handler must not poison the bus
                log.exception("gossip handler for %r failed", kind)

    def _note_hello(self, origin: str, data: dict) -> None:
        advertise = data.get("advertise") or ""
        nonce = int(data.get("nonce") or 0)
        if advertise and advertise != self.mesh.advertise:
            entry = self._mesh_peers.setdefault(
                advertise, {"last_seen": None, "origin": None, "nonce": None})
            entry["last_seen"] = time.monotonic()
            entry["origin"] = origin
            if entry["nonce"] is not None and entry["nonce"] != nonce:
                # peer restarted: its SeqClock reset — drop dedupe marks so
                # its fresh (low) sequence numbers are not mistaken for
                # replays of the previous incarnation
                for key in [k for k in self._origin_seq if k[0] == origin]:
                    del self._origin_seq[key]
            entry["nonce"] = nonce

    def _note_mesh_alive(self, origin: str) -> None:
        for entry in self._mesh_peers.values():
            if entry.get("origin") == origin:
                entry["last_seen"] = time.monotonic()
                return

    async def _hello_loop(self) -> None:
        """Mesh heartbeat: advertise membership (registry + wire), surface
        partition suspicion, and give batched publishers (rl_spend) a flush
        edge via on_heartbeat."""
        while True:
            try:
                if self._register is not None:
                    try:
                        self._register(self.origin, self.mesh.advertise)
                    except Exception:
                        log.debug("gossip membership register failed",
                                  exc_info=True)
                self.publish(HelloMsg.KIND, {
                    "advertise": self.mesh.advertise,
                    "index": self.index,
                    "nonce": self.nonce,
                })
                for hook in list(self.on_heartbeat):
                    try:
                        hook()
                    except Exception:
                        log.exception("gossip heartbeat hook failed")
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("gossip hello tick failed")
            await asyncio.sleep(HELLO_INTERVAL_S)

    # ------------------------------------------------------------- inspection

    def lag_seconds(self) -> float | None:
        """Mean one-way delay of recently received messages (the gossip-lag
        gauge); None until the first message arrives. Wall-clock based —
        diagnostic only, never ordering (see module docstring)."""
        if not self._lag_samples:
            return None
        return sum(self._lag_samples) / len(self._lag_samples)

    def mesh_peer_count(self) -> int:
        return len(self._mesh_peers)

    def partition_suspected(self) -> bool:
        """True when a mesh peer we HAVE heard from goes silent past the
        suspicion window (never-seen seeds are config, not partitions)."""
        if not self.mesh.enabled:
            return False
        now = time.monotonic()
        for entry in self._mesh_peers.values():
            seen = entry.get("last_seen")
            if seen is not None and now - seen > PARTITION_SUSPECT_S:
                return True
        return False

    def stats(self) -> dict:
        with self._lock:
            peers = len(self._peer_paths())
            mesh_peers = len(self._mesh_addrs()) if self.mesh.enabled else 0
        return {
            "origin": self.origin,
            "sent_total": self.sent_total,
            "received_total": self.received_total,
            "send_errors_total": self.send_errors_total,
            "recv_rejected_total": self.recv_rejected_total,
            "fault_dropped_total": self.fault_dropped_total,
            "lag_s": self.lag_seconds(),
            "peers": peers,
            "mesh_peers": mesh_peers,
            "partition_suspected": self.partition_suspected(),
            "seq": self.clock.peek(),
        }


def default_gossip_dir(port: int) -> str:
    """One bus per gateway instance: scope the socket dir by listen port so
    two gateways on one host never cross-gossip."""
    base = os.environ.get("LLMLB_GOSSIP_DIR")
    if base:
        return base
    data_dir = os.path.expanduser(
        os.environ.get("LLMLB_DATA_DIR", "~/.llmlb") or "~/.llmlb"
    )
    return os.path.join(data_dir, "gossip", str(port))
