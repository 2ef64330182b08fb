"""The device mesh of the port: counterpart of `llmlb_tpu/parallel/mesh.py`.

The engine scales over a mesh of ranks with the reference's named axes:

    dp — data parallel: one engine's batch rows split into dp groups (the
         ranks of one dp coordinate). Slot s belongs to group
         s // ceil(slots / dp), the block GSPMD gives the reference's
         dp-sharded batch axis (`slot_groups`); a group computes only its
         own rows of a dispatch (`DpRows`), and one collective over dp a
         dispatch gives every rank the whole batch's logits, and the KV
         cells each group wrote (`gather_rows`)
    sp — sequence parallel (ring attention over sequence chunks for a long
         prompt's prefill, ops/ring_attention.py)
    ep — expert parallel (the MoE expert dim split across ranks)
    tp — tensor parallel (Megatron sharding of heads, MLP widths and the
         vocab; innermost, so tp's per-layer collectives join the ranks
         nearest each other)

The reference's mesh is one JAX program over many devices, and GSPMD
inserts the collectives. Here a rank is one process holding one card (or,
in the tests, one CPU process): `Mesh` knows this rank's coordinate on
each axis and keeps one torch.distributed process group per axis, and the
model code calls the collectives it needs by name (`all_reduce`,
`all_gather`, `ppermute`, `broadcast_bytes`, `gather_rows`; the engine's
KV page moves `gather_heads` and `broadcast`). On a world of one rank
every collective is the identity and no process group exists.

Determinism: ranks of a lockstep engine sample with the same generator,
so every value all ranks read after a reduction must be bitwise equal on
all of them. `all_reduce` therefore gathers the partials and sums them in
rank order on every rank (one order, the same bits everywhere), instead
of relying on a backend's reduction order.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time

import numpy as np
import torch

AXES = ("dp", "sp", "ep", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes of the mesh axes. -1 means "use all remaining devices"."""

    dp: int = 1
    tp: int = -1
    sp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        dp, tp, sp, ep = self.dp, self.tp, self.sp, self.ep
        unknown = [a for a in (dp, tp, sp, ep) if a == -1]
        if len(unknown) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if tp == -1:
            tp = n_devices // (dp * sp * ep)
        if dp == -1:
            dp = n_devices // (tp * sp * ep)
        if sp == -1:
            sp = n_devices // (dp * tp * ep)
        if ep == -1:
            ep = n_devices // (dp * tp * sp)
        if dp * tp * sp * ep != n_devices:
            raise ValueError(
                f"mesh dp={dp} sp={sp} ep={ep} tp={tp} does not cover "
                f"{n_devices} devices"
            )
        return MeshConfig(dp=dp, tp=tp, sp=sp, ep=ep)


def default_tp(n_devices: int, num_heads: int, num_kv_heads: int) -> int:
    """Largest valid power-of-two tp degree for a model. kv heads may be
    replicated (tp a multiple of kv_heads) when tp exceeds the kv head count."""
    tp = 1
    while True:
        cand = tp * 2
        if cand > n_devices or n_devices % cand or num_heads % cand:
            break
        if num_kv_heads % cand and cand % num_kv_heads:
            break
        tp = cand
    return tp


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def validate_tp(num_heads: int, num_kv_heads: int, tp: int) -> None:
    if num_heads % tp != 0:
        raise ValueError(f"num_heads={num_heads} not divisible by tp={tp}")
    if num_kv_heads % tp != 0 and tp % num_kv_heads != 0:
        raise ValueError(
            f"num_kv_heads={num_kv_heads} incompatible with tp={tp}: "
            "need kv_heads % tp == 0 (sharded) or tp % kv_heads == 0 (replicated)"
        )


def rank_grid(config: MeshConfig) -> np.ndarray:
    """Ranks laid out on the (dp, sp, ep, tp) axes, row-major: tp innermost,
    as `build_mesh` lays the reference's devices."""
    return np.arange(config.dp * config.sp * config.ep * config.tp).reshape(
        config.dp, config.sp, config.ep, config.tp)


class Mesh:
    """This rank's view of a (dp, sp, ep, tp) mesh of processes.

    `shape` is {axis: size} (the reference's `mesh.shape`), `coord` this
    rank's index on each axis. `grid` maps coordinates to global ranks
    (default: `rank_grid`; `parallel.distributed.build_hybrid_mesh` lays
    dp/ep across hosts). A mesh of more than one rank makes its process
    groups when the default process group is initialised (`backend` is
    that group's, "gloo" or "nccl"); without one it is a layout only
    (coordinates and `rank_slice`), and a collective over an axis of size
    > 1 raises. A gloo mesh moves CUDA tensors through host memory (gloo's
    collectives on CUDA tensors cover broadcast and all_reduce only), so
    its collectives cannot be captured in a CUDA graph: `capturable` says
    whether they can."""

    def __init__(self, config: MeshConfig, *, rank: int = 0,
                 grid: np.ndarray | None = None, backend: str | None = None):
        self.grid = rank_grid(config) if grid is None else np.asarray(grid)
        if self.grid.shape != (config.dp, config.sp, config.ep, config.tp):
            raise ValueError(f"rank grid of shape {self.grid.shape} does not "
                             f"match {config}")
        self.shape = {a: int(n) for a, n in zip(AXES, self.grid.shape)}
        self.world = int(self.grid.size)
        self.rank = rank
        where = np.argwhere(self.grid == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not on the mesh")
        self.coord = {a: int(i) for a, i in zip(AXES, where[0])}
        self.backend = backend or "none"
        self._groups: dict[tuple[str, ...], tuple[object, list[int]]] = {}
        self._control = None
        self.connected = False
        # the tensor collectives run so far: calls, bytes sent, host seconds
        # (a gloo collective returns once its bytes are back on the card)
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
        if self.world > 1:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                self._make_groups()
                self.connected = True

    # ---------------------------------------------------------------- layout

    @property
    def trivial(self) -> bool:
        """One rank: every collective is the identity."""
        return self.world == 1

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    @property
    def capturable(self) -> bool:
        """Whether the collectives can sit inside a captured CUDA graph
        (NCCL's can; gloo's host round trips cannot)."""
        return self.trivial or self.backend == "nccl"

    def _make_groups(self) -> None:
        """One process group per axis of size > 1 (and for ("ep", "tp")
        when both are, the MoE reduction), made in one order on every rank,
        as new_group needs. A gloo group of all ranks carries the byte
        broadcasts, whatever the tensor backend."""
        import torch.distributed as dist

        for axes in (("dp",), ("sp",), ("ep",), ("tp",), ("ep", "tp")):
            if any(self.shape[a] == 1 for a in axes):
                continue
            rest = [a for a in AXES if a not in axes]
            for fixed in itertools.product(*(range(self.shape[a])
                                             for a in rest)):
                sel = dict(zip(rest, fixed))
                members = [int(self.grid[tuple(
                    sel[a] if a in sel else c[axes.index(a)] for a in AXES)])
                    for c in itertools.product(*(range(self.shape[a])
                                                 for a in axes))]
                group = dist.new_group(members)
                if all(sel[a] == self.coord[a] for a in rest):
                    self._groups[axes] = (group, members)
        self._control = (dist.new_group(backend="gloo")
                         if self.backend != "gloo" else None)

    def _group(self, axes):
        """The (group, ranks) of this rank over `axes` (those of size 1
        left out); None when none is left (the collective is the
        identity)."""
        axes = tuple(a for a in _axes(axes) if self.shape[a] > 1)
        if not axes:
            return None
        if not self.connected:
            raise RuntimeError(f"mesh {self.shape} has no process groups: "
                               "initialise torch.distributed first")
        return self._groups[axes]

    # ----------------------------------------------------------- collectives

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor the backend takes: gloo's through host memory."""
        x = x.contiguous()
        if self.backend == "gloo" and x.device.type != "cpu":
            return x.cpu()
        return x

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """Concatenate every rank's `x` along `dim`, in rank order over
        `axes`. The identity on an axis of size 1."""
        entry = self._group(axes)
        if entry is None:
            return x
        import torch.distributed as dist

        group, members = entry
        t0 = time.perf_counter()
        xs = self._host(x)
        parts = [torch.empty_like(xs) for _ in members]
        dist.all_gather(parts, xs, group=group)
        # the group's ranks come sorted; put them in axis order
        by_rank = dict(zip(sorted(members), parts))
        out = torch.cat([by_rank[m] for m in members], dim=dim).to(x.device)
        self._count(xs, t0)
        return out

    def all_reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The sum of every rank's `x` over `axes`, as a new tensor:
        gathered, then summed in rank order (the same bits on every
        rank). The identity on an axis of size 1."""
        entry = self._group(axes)
        if entry is None:
            return x
        parts = self.all_gather(x[None], axes, dim=0)
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out

    def ppermute(self, x: torch.Tensor, axis: str, shift: int = 1
                 ) -> torch.Tensor:
        """Send `x` to the rank `shift` steps ahead on `axis` (cyclically)
        and return what the rank `shift` steps behind sent: the reference's
        `lax.ppermute` with perm [(j, j + shift)]."""
        entry = self._group(axis)
        if entry is None:
            return x
        import torch.distributed as dist

        group, members = entry
        n = len(members)
        me = self.coord[axis]
        t0 = time.perf_counter()
        xs = self._host(x)
        out = torch.empty_like(xs)
        send = dist.isend(xs, dst=members[(me + shift) % n], group=group)
        dist.recv(out, src=members[(me - shift) % n], group=group)
        send.wait()
        out = out.to(x.device)
        self._count(xs, t0)
        return out

    def _count(self, sent: torch.Tensor, t0: float) -> None:
        self.stats["calls"] += 1
        self.stats["bytes"] += sent.numel() * sent.element_size()
        self.stats["seconds"] += time.perf_counter() - t0

    def broadcast(self, x: torch.Tensor | None, shape, dtype,
                  device) -> torch.Tensor:
        """The leader's tensor `x` (others pass None) on every rank of the
        world, of `shape` and `dtype`, on `device`: one broadcast from
        rank 0 on the mesh's backend (gloo's through host memory, NCCL's
        on the card)."""
        if self.trivial:
            return x.to(device)
        if not self.connected:
            raise RuntimeError("broadcast on a mesh with no process groups")
        import torch.distributed as dist

        t0 = time.perf_counter()
        where = "cpu" if self.backend == "gloo" else device
        buf = (x.to(where).contiguous() if self.is_leader
               else torch.empty(shape, dtype=dtype, device=where))
        dist.broadcast(buf, src=0)
        self._count(buf, t0)
        return buf.to(device)

    def gather_heads(self, x: torch.Tensor, dim: int,
                     num_heads: int) -> torch.Tensor:
        """The whole `num_heads` heads of `x` on every rank, in head order,
        from each tp rank's own along `dim` (`kv_heads`): one all_gather
        over tp, of bytes. Where tp exceeds num_heads a head is held by
        several ranks, and the first of them gives it."""
        tp = self.shape["tp"]
        if tp == 1:
            return x
        heads = x.movedim(dim, 0).contiguous()
        rows = heads.reshape(heads.shape[0], -1).view(torch.uint8)
        every = self.all_gather(rows, "tp", dim=0)
        if tp > num_heads:
            first: dict[int, int] = {}
            for c in range(tp):
                first.setdefault(self.kv_heads(num_heads, c).start, c)
            every = every[sorted(first.values())]
        return (every.contiguous().view(x.dtype)
                .reshape(num_heads, *heads.shape[1:]).movedim(0, dim))

    def kv_heads(self, num_heads: int, coord: int | None = None) -> slice:
        """The KV heads the rank at tp `coord` (default: this rank) holds of
        `num_heads`: its block of them over tp, or, where tp exceeds their
        count, the one its q heads read. The one rule of the KV heads'
        layout: the shards (models/llama.py `shard_params`), the pages and
        their exports read it here."""
        tp = self.shape["tp"]
        if tp == 1:
            return slice(0, num_heads)
        c = self.coord["tp"] if coord is None else coord
        if num_heads >= tp:
            per = num_heads // tp
            return slice(c * per, (c + 1) * per)
        head = c // (tp // num_heads)
        return slice(head, head + 1)

    def broadcast_bytes(self, payload: bytes | None) -> bytes:
        """Rank 0's `payload` on every rank (others pass None): its length,
        then the padded bytes, over a gloo group on the host."""
        if self.trivial:
            return payload or b""
        if not self.connected:
            raise RuntimeError("broadcast on a mesh with no process groups")
        import torch.distributed as dist

        group = self._control
        n = torch.tensor([len(payload) if self.is_leader else 0],
                         dtype=torch.int64)
        dist.broadcast(n, src=0, group=group)
        buf = torch.zeros(int(n[0]), dtype=torch.uint8)
        if self.is_leader:
            buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
        dist.broadcast(buf, src=0, group=group)
        return buf.numpy().tobytes()


    def dp_rows(self, groups) -> "DpRows | None":
        """The `DpRows` of a dispatch whose batch row i belongs to dp group
        groups[i]; None on a mesh without dp (every rank computes every
        row)."""
        if self.shape["dp"] == 1:
            return None
        return DpRows(groups, self.shape["dp"], self.coord["dp"])

    def gather_rows(self, parts: list[torch.Tensor], rows: "DpRows"
                    ) -> list[list[torch.Tensor]]:
        """Every dp group's rows of `parts` on every rank, in ONE collective
        over dp. Each part's leading dim is this group's rows (`rows.mine`,
        possibly none); its other dims and dtype are the same on every
        rank. The parts go as bytes, each padded to `rows.width` rows, in
        one buffer; returns, for each group g, its parts with
        len(rows.members[g]) rows, in the order given."""
        width = rows.width
        sizes = [math.prod(p.shape[1:]) * p.element_size() for p in parts]
        flat = []
        for p, nb in zip(parts, sizes):
            b = p.contiguous().reshape(p.shape[0], nb // p.element_size()
                                       ).view(torch.uint8)
            if p.shape[0] < width:
                b = torch.cat([b, b.new_zeros((width - p.shape[0], nb))])
            flat.append(b)
        every = self.all_gather(torch.cat(flat, dim=1), "dp", dim=0)
        out = []
        for g, members in enumerate(rows.members):
            block = every[g * width:g * width + len(members)]
            got, at = [], 0
            for p, nb in zip(parts, sizes):
                got.append(block[:, at:at + nb].contiguous().view(p.dtype)
                           .reshape(len(members), *p.shape[1:]))
                at += nb
            out.append(got)
        return out

    def gather_batch(self, parts: list[torch.Tensor], rows: "DpRows"
                     ) -> list[torch.Tensor]:
        """`gather_rows` laid out in batch order: each part's rows of every
        dp group, [len(rows.groups), ...] on every rank, row i the one
        group rows.groups[i] gave (the same one collective)."""
        got = self.gather_rows(parts, rows)
        dev = parts[0].device
        out = [p.new_empty((len(rows.groups), *p.shape[1:])) for p in parts]
        for g, members in enumerate(rows.members):
            if members:
                at = rows.index(dev, g)
                for whole, part in zip(out, got[g]):
                    whole[at] = part
        return out


def slot_groups(num_slots: int, dp: int) -> list[int]:
    """The dp group of each slot: blocks of ceil(num_slots / dp) consecutive
    slots, the block GSPMD gives a dp-sharded axis (when dp does not divide
    num_slots the last groups are shorter, or empty)."""
    per = -(-num_slots // dp)
    return [s // per for s in range(num_slots)]


class DpRows:
    """Which rows of one dispatch's batch each dp group computes: `groups`
    (row i's dp group), `members` (each group's rows, in batch order),
    `mine` (this rank's group's rows) and `width` (the most rows a group
    has: `Mesh.gather_rows` pads to it). Made on the host from the
    scheduler's slots, the same on every rank."""

    def __init__(self, groups, dp: int, me: int):
        self.groups = tuple(int(g) for g in groups)
        self.me = me
        self.members = [[i for i, g in enumerate(self.groups) if g == d]
                        for d in range(dp)]
        self.mine = self.members[me]
        self.width = max(len(m) for m in self.members)
        self._index: dict = {}

    def index(self, device, group: int | None = None) -> torch.Tensor:
        """Group `group`'s rows (default: this rank's) as an int64 index on
        `device`, made once."""
        key = (str(device), self.me if group is None else group)
        if key not in self._index:
            self._index[key] = torch.tensor(self.members[key[1]],
                                            dtype=torch.int64, device=device)
        return self._index[key]


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def build_mesh(config: MeshConfig | None = None, *, world: int | None = None,
               rank: int | None = None) -> Mesh:
    """A (dp, sp, ep, tp) mesh over the process group's ranks (default:
    the initialised world, else one rank)."""
    import torch.distributed as dist

    ready = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if ready else 1
    if rank is None:
        rank = dist.get_rank() if ready else 0
    config = (config or MeshConfig()).resolve(world)
    backend = dist.get_backend() if ready and world > 1 else None
    return Mesh(config, rank=rank, backend=backend)
