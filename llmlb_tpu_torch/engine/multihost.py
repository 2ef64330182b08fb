"""Leader-follower lockstep for multi-rank serving: counterpart of
`llmlb_tpu/engine/multihost.py`.

When a model is sharded across ranks, every forward is a sequence of
collectives: ALL ranks must run the same dispatches in the same order or
the mesh deadlocks. HTTP requests arrive at one process only, so the
serving loop needs a control plane:

- rank 0 (the leader) serves HTTP and owns the request queue;
- each engine tick the leader broadcasts a *plan*: new requests,
  cancellations, shutdown (over a gloo group on the host,
  `Mesh.broadcast_bytes`);
- every rank then runs the identical scheduler logic on mirrored state, so
  the sequence of forwards (prefill / chunk / decode / sample) is the same
  everywhere, and the sampling generators stay in lockstep because they
  advance with the same draws from the same seed;
- adapters ride the plan too: a planned request carries its adapter's
  name, and every rank pins it when it applies the plan, in plan order
  (the leader does not pin at submit on a mesh), and unpins it at the
  request's terminal event, which every rank reaches on the same tick. So
  every rank's pool loads, places and evicts the same adapters in the
  same rows (the scheduler's `_plan_acquire`).

The broadcast is two-phase (length, then the padded payload), as the
reference's, because a broadcast needs the same buffer size on every rank
while plans vary in size.
"""

from __future__ import annotations

import pickle

from llmlb_tpu_torch.parallel.mesh import Mesh

_MAX_PLAN_BYTES = 64 * 1024 * 1024  # sanity bound: a plan is requests, not data


class PlanTooLarge(ValueError):
    """A plan over `_MAX_PLAN_BYTES`, refused before the broadcast."""


class StepCoordinator:
    """Per-tick plan broadcast from the leader to every follower."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.num_hosts = mesh.world
        self.is_leader = mesh.is_leader

    def exchange(self, plan: dict | None) -> dict:
        """Leader passes its plan (possibly empty); followers pass None.
        Returns the leader's plan on every rank. Blocking: this is the
        synchronization point that keeps ranks in lockstep."""
        payload = pickle.dumps(plan) if self.is_leader else None
        if payload is not None and len(payload) > _MAX_PLAN_BYTES:
            raise PlanTooLarge(f"tick plan too large: {len(payload)} bytes")
        return pickle.loads(self.mesh.broadcast_bytes(payload))
