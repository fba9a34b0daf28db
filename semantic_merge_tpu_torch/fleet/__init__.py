"""The merge fleet — a routing tier over N merge daemons (the port of
the JAX package's ``fleet/``).

One supervised daemon is a single point of failure and a single queue;
the fleet puts a lightweight router in front of N supervised member
daemons with consistent-hash repo affinity (:mod:`.hashring`), a durable
dispatch WAL (:mod:`.wal`), health-aware failover and hedged reads
(:mod:`.router`), and a pluggable unix/TCP/mTLS member transport
(:mod:`.transport`). Each member is the port's daemon on its device (the
card unless ``fleet --device cpu``), so a routed merge runs the port's
hand kernels inside the member.

Postures (``SEMMERGE_FLEET``), as in the JAX package:

- ``off`` (default) — no fleet anywhere; the client path is the
  single-daemon service stack.
- ``auto`` — the client prefers an already-running fleet router on the
  service socket, and falls back to the plain ``SEMMERGE_DAEMON``
  posture when none is listening. Never worse than fleet-less.
- ``require`` — the client must reach a fleet router; failure is
  :class:`~semantic_merge_tpu_torch.errors.FleetFault` (exit 19).

The package is import-light (stdlib only at import time): the router
process never imports torch; the members carry the heavy runtime.
"""
from __future__ import annotations

from ..utils import reqenv

#: Posture env var (``off`` | ``auto`` | ``require``).
ENV_POSTURE = "SEMMERGE_FLEET"
#: Documented ``FleetFault`` exit code (see ``errors.EXIT_CODES``).
FLEET_EXIT = 19


def mode() -> str:
    """The effective fleet posture (overlay-aware)."""
    return reqenv.posture(ENV_POSTURE, default="off")
