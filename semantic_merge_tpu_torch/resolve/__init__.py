"""Conflict-resolution tier — the rung between "compose found
conflicts" and "exit 1".

The port of the JAX package's ``resolve/``: a resolver
(:class:`~semantic_merge_tpu_torch.resolve.search.SearchResolver`, the
deterministic search baseline) proposes per-conflict candidates, each
an op-stream rewrite, and :mod:`semantic_merge_tpu_torch.resolve.engine`
accepts a proposal set only when every verify gate passes (re-compose
on the device with no residual conflict, byte parity outside the
footprint, typecheck, format). Any gate failure, scoring tie or
resolver fault falls back to conflict-as-result, byte-identical to the
tier being off.

Posture (``--resolve`` / ``SEMMERGE_RESOLVE``):

- ``off`` (default) — the tier never runs;
- ``auto`` — resolve when possible; a resolver fault is contained
  (conflict-as-result), never an exit-code change;
- ``require`` — a resolver fault exits with
  :class:`~semantic_merge_tpu_torch.errors.ResolveFault`'s code (17),
  after the conflicts artifact is written. A run that resolves nothing
  still exits 1.

Strict mode (``--no-degrade`` / ``SEMMERGE_STRICT=1``) forces the tier
off whatever the posture: fail-fast runs must not synthesize output.
The JAX package's per-category circuit breakers are not ported (they
are a no-op outside its daemon unless ``SEMMERGE_BREAKER=on``).
"""
from __future__ import annotations

from ..utils import reqenv

#: Accepted ``SEMMERGE_RESOLVE`` / ``--resolve`` values.
POSTURES = ("off", "auto", "require")


def posture(args=None) -> str:
    """The effective resolution posture: the ``--resolve`` flag wins,
    then ``SEMMERGE_RESOLVE``; anything absent or unrecognized is
    ``off``. Strict-mode suppression is the CLI's call."""
    flag = getattr(args, "resolve", None) if args is not None else None
    raw = (flag or reqenv.get("SEMMERGE_RESOLVE", "") or "").strip().lower()
    return raw if raw in POSTURES else "off"
