"""Device-resident LoRA adapter pool: counterpart of
`llmlb_tpu/lora/manager.py` (hot-load, LRU eviction, refcounts).

The manager owns the `<name>_lora_a` / `<name>_lora_b` param leaves the
model forward reads (stacked pools [L, N+1, in, R] / [L, N+1, R, out]):

- Row 0 is the reserved all-zero identity adapter: adapter-free requests
  carry index 0 and their delta is exactly +0.0, keeping them bit-identical
  to a LoRA-free engine.
- Rows 1..N hold up to `max_adapters` resident adapters. A request's
  adapter loads on first use (disk -> CPU tensors -> one in-place row write
  per leaf) and is evicted (LRU) only when no request holds it: acquired at
  submit, released at the request's terminal event, so queued requests pin
  their adapter too.

Thread safety: acquire/release run on HTTP threads while the step loop
dispatches. The bookkeeping sits under one lock. JAX rebinds immutable
arrays; here the rows are written IN PLACE (`pool[:, row].copy_(...)`) into
the very tensors the step loop reads. That is safe because no dispatch
reads a row that is being written: a row is written only while free (never
loaded, or evicted at refcount 0), and `_write_rows` synchronizes the
device after the copies and only then publishes the name into `_resident`,
so no request can name the row before its values are all on the card.
`slot_of`, which the step loop calls, takes no lock. The row writes hold
`device_lock`, which the engine's decode graphs hold around each capture and
replay, so an upload from an HTTP thread never interleaves with them.
"""

from __future__ import annotations

import logging
import threading
import time

import torch

from llmlb_tpu_torch.lora.store import (
    AdapterInfo,
    discover_adapters,
    load_adapter_tensors,
    lora_target_dims,
)

log = logging.getLogger("llmlb_tpu_torch.lora")

LORA_A = "_lora_a"
LORA_B = "_lora_b"
# Every projection of the Llama family takes adapters (the reference narrows
# this only for MoE experts, which the port does not serve).
TARGETS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


class LoraManager:
    """Adapter pool bookkeeping and the single writer of the pool leaves."""

    def __init__(
        self,
        cfg,
        *,
        lora_dir: str,
        max_adapters: int = 8,
        rank_cap: int = 16,
    ):
        self.cfg = cfg
        self.lora_dir = lora_dir
        self.max_adapters = max(1, int(max_adapters))
        self.rank_cap = max(1, int(rank_cap))
        self.targets = TARGETS
        self.params: dict[str, torch.Tensor] | None = None  # attach()
        self._lock = threading.RLock()
        # orders row writes against decode graph captures and replays
        self.device_lock = threading.Lock()
        self.available: dict[str, AdapterInfo] = discover_adapters(
            lora_dir, rank_cap=self.rank_cap, allowed_targets=self.targets
        )
        # name -> pool row (1-based; row 0 is the identity adapter)
        self._resident: dict[str, int] = {}
        self._free_rows = list(range(1, self.max_adapters + 1))
        self._refcounts: dict[str, int] = {}
        self._acquired: dict[str, str] = {}  # request token -> adapter name
        self._last_used: dict[str, float] = {}
        self.loads_total = 0
        self.evictions_total = 0

    # -------------------------------------------------------------- pool init

    def init_pool_leaves(self, dtype: torch.dtype,
                         device: torch.device | str) -> dict[str, torch.Tensor]:
        """The zero pool leaves the engine merges into its params."""
        n = self.max_adapters + 1  # + identity row 0
        layers = self.cfg.num_layers
        leaves: dict[str, torch.Tensor] = {}
        for tgt, (in_dim, out_dim) in lora_target_dims(self.cfg,
                                                       self.targets).items():
            leaves[tgt + LORA_A] = torch.zeros(
                (layers, n, in_dim, self.rank_cap), dtype=dtype, device=device)
            leaves[tgt + LORA_B] = torch.zeros(
                (layers, n, self.rank_cap, out_dim), dtype=dtype, device=device)
        return leaves

    def attach(self, params: dict[str, torch.Tensor]) -> None:
        """The engine's params, holding the pool leaves this manager
        writes."""
        self.params = params

    # ------------------------------------------------------------- validation

    def rescan(self) -> None:
        """Re-discover the adapter directory (new adapters appear without a
        restart; resident adapters keep the info they were loaded from)."""
        with self._lock:
            fresh = discover_adapters(
                self.lora_dir, rank_cap=self.rank_cap,
                allowed_targets=self.targets,
            )
            for name in self._resident:
                if name in self.available:
                    fresh[name] = self.available[name]
            self.available = fresh

    def validate(self, name: str) -> AdapterInfo:
        """The servable AdapterInfo for `name`, or ValueError whose message
        names the `lora` field (the server maps it to a 400)."""
        with self._lock:
            info = self.available.get(name)
            if info is None:
                self.rescan()
                info = self.available.get(name)
            if info is None:
                known = ", ".join(sorted(self.available)) or "none"
                raise ValueError(
                    f"'lora' names unknown adapter {name!r} "
                    f"(available: {known})"
                )
            if info.error is not None:
                raise ValueError(
                    f"'lora' adapter {name!r} is not servable: {info.error}"
                )
            return info

    # --------------------------------------------------------- acquire/release

    def acquire(self, name: str, token: str) -> int:
        """Pin adapter `name` for request `token` and return its pool row,
        loading it (and evicting an idle one) as needed. Idempotent per
        token. Raises ValueError (unknown or invalid adapter, or a pool
        full of adapters in use)."""
        with self._lock:
            prev = self._acquired.get(token)
            if prev == name:
                return self._resident[name]
            if prev is not None:
                self._release_name(prev)
                del self._acquired[token]
            info = self.validate(name)
            row = self._ensure_resident(info)
            self._acquired[token] = name
            self._refcounts[name] = self._refcounts.get(name, 0) + 1
            self._last_used[name] = time.monotonic()
            return row

    def release(self, token: str) -> None:
        """Unpin whatever `token` acquired. Idempotent."""
        with self._lock:
            name = self._acquired.pop(token, None)
            if name is not None:
                self._release_name(name)

    def _release_name(self, name: str) -> None:
        n = self._refcounts.get(name, 0)
        if n <= 1:
            self._refcounts.pop(name, None)
        else:
            self._refcounts[name] = n - 1

    def slot_of(self, name: str | None) -> int:
        """Pool row of a resident adapter (0 for None: the identity row).
        The caller holds a refcount through acquire, so the row cannot move.
        Lock-free: the step loop calls this while an HTTP thread may hold
        the lock across a load; a dict read is atomic under the GIL, and a
        name is published only after its rows are on the card."""
        if not name:
            return 0
        row = self._resident.get(name)
        if row is None:
            raise KeyError(f"adapter {name!r} is not resident")
        return row

    # ------------------------------------------------------------ load / evict

    def _ensure_resident(self, info: AdapterInfo) -> int:
        """Lock held. The adapter's pool row, loading it (and evicting an
        idle LRU adapter when the pool is full) if needed."""
        row = self._resident.get(info.name)
        if row is not None:
            return row
        if not self._free_rows and self._evict_lru_locked() is None:
            active = sorted(self._refcounts)
            raise ValueError(
                f"'lora' adapter pool exhausted: all {self.max_adapters} "
                f"resident adapters have active requests "
                f"({', '.join(active)}); retry shortly or raise "
                "--lora-max-adapters"
            )
        row = self._free_rows.pop(0)
        t0 = time.monotonic()
        try:
            self._write_rows(info, row)
        except BaseException:
            self._free_rows.insert(0, row)
            raise
        self._resident[info.name] = row
        self.loads_total += 1
        log.info("lora: loaded adapter %r (rank %d, targets %s) into row %d "
                 "in %.3fs", info.name, info.rank, "/".join(info.targets), row,
                 time.monotonic() - t0)
        return row

    def _evict_lru_locked(self) -> str | None:
        victim: str | None = None
        for name in self._resident:
            if self._refcounts.get(name, 0) > 0:
                continue
            if victim is None or (self._last_used.get(name, 0.0)
                                  < self._last_used.get(victim, 0.0)):
                victim = name
        if victim is None:
            return None
        row = self._resident.pop(victim)
        self._free_rows.append(row)
        self._last_used.pop(victim, None)
        self.evictions_total += 1
        log.info("lora: evicted idle adapter %r from row %d", victim, row)
        # the vacated rows are not zeroed: nothing reads a row no request
        # holds, and the next load overwrites every leaf's row
        return victim

    def _write_rows(self, info: AdapterInfo, row: int) -> None:
        """Write one adapter's factors into pool row `row` of every target
        leaf, in place, then synchronize the device (see the module
        docstring). A target the adapter does not touch gets a zero row: the
        row may hold a previous tenant's factors."""
        assert self.params is not None, "LoraManager.attach(params) first"
        some = self.params[self.targets[0] + LORA_A]
        host = load_adapter_tensors(info, self.cfg, pool_rank=self.rank_cap,
                                    dtype=some.dtype)
        with self.device_lock:
            for tgt in self.targets:
                pair = host.get(tgt)
                for leaf, value in zip((tgt + LORA_A, tgt + LORA_B),
                                       pair or (None, None)):
                    dst = self.params[leaf][:, row]
                    if value is None:
                        dst.zero_()
                    else:
                        dst.copy_(value)
            if some.device.type == "cuda":
                torch.cuda.synchronize(some.device)

    # ---------------------------------------------------------- introspection

    def resident_names(self) -> list[str]:
        with self._lock:
            return sorted(self._resident)

    def available_names(self) -> list[str]:
        with self._lock:
            return sorted(n for n, i in self.available.items()
                          if i.error is None)

    def info(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "dir": self.lora_dir,
                "max_adapters": self.max_adapters,
                "rank_cap": self.rank_cap,
                "targets": list(self.targets),
                "available": self.available_names(),
                "resident": sorted(self._resident),
                "active": {n: c for n, c in sorted(self._refcounts.items())},
                "loads_total": self.loads_total,
                "evictions_total": self.evictions_total,
            }
