"""Continuous batching: coalesce concurrent merges into one batched
fused dispatch on the card.

The port of the JAX package's ``batch/``. The merge service daemon
amortizes imports and warm state, but every request still pays a whole
fused merge program on its own: 628-642 kernel launches and 9-15 ms of
host time for 2.5-2.8 ms of device time at rung5 on an H100. This
package sits between the daemon and the fused engine and packs
concurrent, independent merges into ONE program over a leading merge
axis, so a batch of B merges pays that host cost once:

- :mod:`.scheduler` — the micro-batch window
  (``SEMMERGE_BATCH_WINDOW_MS``, ``SEMMERGE_BATCH_MAX``, bounded
  in-flight batches ``SEMMERGE_BATCH_INFLIGHT``) grouping queued
  requests by shape bucket;
- :mod:`.packer` — stacks the bucket-padded decl columns along the
  merge axis, as tensors on the scheduler's device;
- :mod:`.dispatcher` — runs one
  :func:`~semantic_merge_tpu_torch.ops.fused.batched_fused_program` per
  group and scatters each packed row to its request, whose host tail
  (decode, materialize, columnar apply) then runs per request,
  byte-identical to an unbatched run.

The daemon activates ONE process-global :class:`BatchScheduler` on its
device (:func:`activate` / :func:`deactivate`); the fused engine asks
:func:`plan_for_request` at its dispatch seam. Only a merge whose
engine sits on the scheduler's device joins a batch. Posture, read
through the per-request env overlay (``SEMMERGE_BATCH``):

- ``off``     — bypass the subsystem (inline dispatch);
- ``auto``    — batch when a scheduler is active; a batching fault
  degrades *that request only* to the inline dispatch on the same
  device, counted in ``batch_requests_total{outcome="degraded"}``; the
  default;
- ``require`` — must batch: no active scheduler, a merge on another
  device, or a batching fault raises
  :class:`~semantic_merge_tpu_torch.errors.BatchFault` (exit 16), which
  the ladder never hides.
"""
from __future__ import annotations

import threading
from typing import Optional

from .dispatcher import collect_request, submit_request
from .packer import BatchRequest, batch_bucket, pack_group
from .scheduler import BatchScheduler

__all__ = [
    "BatchRequest", "BatchScheduler", "activate", "batch_bucket",
    "collect_request", "current", "deactivate", "degrade_or_raise",
    "pack_group", "plan_for_request", "posture", "submit_request",
]

#: Per-request posture knob (carried by the daemon's request overlay).
ENV_POSTURE = "SEMMERGE_BATCH"

_lock = threading.Lock()
_active: Optional[BatchScheduler] = None


def activate(**kwargs) -> BatchScheduler:
    """Start (or return) the process-global batch scheduler. The
    service daemon calls this before it starts its executors; one-shot
    runs never do, so the engine seam stays inert outside the service."""
    global _active
    with _lock:
        if _active is not None and _active.alive():
            return _active
        _active = BatchScheduler(**kwargs).start()
        return _active


def deactivate() -> None:
    """Stop the process-global scheduler (daemon teardown). Queued
    requests fail with a typed fault, so waiting threads degrade to the
    inline dispatch instead of hanging."""
    global _active
    with _lock:
        sched = _active
        _active = None
    if sched is not None:
        sched.stop()


def current() -> Optional[BatchScheduler]:
    """The live scheduler, or ``None`` (a stopped scheduler reads as
    absent, so racing requests fall through to the inline dispatch)."""
    sched = _active
    return sched if sched is not None and sched.alive() else None


def posture() -> str:
    """``SEMMERGE_BATCH`` through the request overlay: ``off`` /
    ``auto`` (default) / ``require``; unknown values read as ``auto``."""
    from ..utils import reqenv
    value = (reqenv.get(ENV_POSTURE, "auto") or "auto").strip().lower()
    return value if value in ("off", "auto", "require") else "auto"


def plan_for_request(device=None, eligible: bool = True) -> Optional[BatchScheduler]:
    """Route one merge at the engine's dispatch seam: the scheduler to
    submit to, or ``None`` for the inline dispatch. ``device`` is the
    engine's: a merge on another device than the scheduler's never
    joins its batches. ``eligible`` is the engine's shape condition
    (single-device only: the dp-sharded merge has its own mesh
    program). Raises
    :class:`~semantic_merge_tpu_torch.errors.BatchFault` when posture
    ``require`` cannot be satisfied."""
    from ..errors import BatchFault
    mode = posture()
    sched = current()
    if mode == "off":
        if sched is not None:
            _count_outcome("bypass")
        return None
    if sched is None:
        if mode == "require":
            raise BatchFault("SEMMERGE_BATCH=require but no batch "
                             "scheduler is active", stage="batch")
        return None
    if not eligible:
        if mode == "require":
            raise BatchFault("SEMMERGE_BATCH=require but the mesh-sharded "
                             "engine cannot join a batch", stage="batch")
        _count_outcome("bypass")
        return None
    if device is not None and str(device) != str(sched.device):
        if mode == "require":
            raise BatchFault(f"SEMMERGE_BATCH=require but the merge runs on "
                             f"{device}, the batch scheduler on {sched.device}",
                             stage="batch")
        _count_outcome("bypass")
        return None
    return sched


def degrade_or_raise(fault) -> None:
    """Policy for a batching fault at the request seam: ``require``
    re-raises (typed, exit 16); otherwise the caller falls back to the
    inline dispatch on the same device — the affected request only;
    co-batched requests keep their rows. A
    :class:`~semantic_merge_tpu_torch.errors.MeshFault` under
    ``SEMMERGE_MESH=require`` re-raises whatever the batch posture (the
    mesh contract, exit 18, does not depend on whether batching may
    degrade)."""
    if posture() == "require":
        raise fault
    from ..errors import MeshFault
    from ..parallel.mesh import mesh_posture
    if isinstance(fault, MeshFault) and mesh_posture() == "require":
        raise fault
    from ..utils.loggingx import logger
    logger.warning("batched dispatch degraded to inline: %s", fault.describe())
    _count_outcome("degraded")


def _count_outcome(outcome: str) -> None:
    from ..obs import metrics as obs_metrics
    obs_metrics.REGISTRY.counter(
        "batch_requests_total",
        "Merge requests seen by the batching subsystem, by outcome",
    ).inc(1, outcome=outcome)
