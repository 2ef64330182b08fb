"""Disaggregated prefill/decode serving: the port's copy of
`llmlb_tpu/disagg/__init__.py`.

Two composable pieces on top of the engine:

- In-process split (`--role split`, disagg/split.py): one engine runs a
  prefill pool and a decode pool as two step loops over one shared page
  pool. The handoff is a page-id exchange (the block-table row moves, no
  KV byte does), and the adopted request activates in its decode slot as
  a parked request resumes, so streams are token-identical to `--role
  both`.
- Cross-process roles (`--role prefill|decode`, disagg/wire.py): engines
  advertise their role through /v1/models, the gateway (which stays with
  the JAX package) steers prefill-heavy requests to a prefill engine's
  /v1/handoff/prefill and hands the stream to a decode engine's
  /v1/handoff. The decode engine adopts it by the exact resume (the
  prompt prefills alone, the committed tokens go through decode steps),
  or lands the origin's KV pages when the envelope carries them.
"""

from llmlb_tpu_torch.disagg.wire import (  # noqa: F401
    HANDOFF_WIRE_VERSION,
    HandoffError,
    handoff_payload,
    parse_handoff,
)

ROLES = ("both", "split", "prefill", "decode")


def normalize_role(role: str | None) -> str:
    """Resolve a role string ('' and None fall back to 'both'); raises
    ValueError for anything outside ROLES."""
    r = (role or "both").strip().lower()
    if r not in ROLES:
        raise ValueError(f"role must be one of {ROLES}, got {role!r}")
    return r
