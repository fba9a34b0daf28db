"""Dispatcher: run one batched fused program and scatter its rows back
to the waiting requests.

The port of the JAX package's ``batch/dispatcher.py``, on one device.
Two halves live here, on two different threads:

- the **request side** (:func:`submit_request` / :func:`collect_request`)
  runs on the merge request's own executor thread, so the per-request
  env overlay (``utils/reqenv``) is in scope — fault injection
  (``batch:pack`` / ``batch:mesh`` / ``batch:dispatch`` /
  ``batch:scatter``) and posture therefore scope to ONE request, never
  to its co-batched neighbours;
- the **leader side** (:func:`dispatch_group`) runs on the scheduler's
  dispatch pool: pack the group along the merge axis, take the bucket's
  program from the fused module's program cache, launch it, wait for
  the batch's completion on a CUDA event, fetch the ``[B, 8 + 24C]``
  stack in one copy and scatter each request's row to its future. Each
  row is the one-merge program's one-buffer layout, so the engine's
  one-buffer decode — and the host tail behind it — runs per request,
  unchanged.

The JAX dispatcher also shards the packed merge axis over a device
mesh; the port plans one device (:func:`mesh_stats` keeps the block's
keys), and ``SEMMERGE_MESH=require`` stays refused by the CLI (exit 70).

A leader-side error fails every member future; each request then
applies its own posture at :func:`collect_request` (auto → inline
dispatch, require → typed ``BatchFault``).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict

import numpy as np
import torch

from ..errors import fault_boundary
from ..obs import device as obs_device
from ..obs import metrics as obs_metrics
from ..obs import spans as obs_spans
from .packer import BatchRequest, pack_group

#: Small-integer buckets for the per-dispatch valid-merge count.
BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)

#: Bound on a request's wait for its batch row — a wedged leader must
#: degrade the request to the inline path, not hang the daemon.
_COLLECT_TIMEOUT_S = 300.0

_stats_lock = threading.Lock()
_dispatches = 0


def submit_request(scheduler, dev_b, dev_l, dev_r, hash_tab, dig_l, dig_r,
                   *, nb: int, nl: int, nr: int, C: int):
    """Request side, pre-dispatch: build the :class:`BatchRequest` and
    enqueue it. Runs in the request thread (overlay in scope); any
    failure is classified into a typed ``BatchFault``."""
    from ..utils import faults
    with fault_boundary("batch:pack"):
        faults.check("batch:pack")
        request = BatchRequest(dev_b, dev_l, dev_r, hash_tab, dig_l, dig_r,
                               nb=nb, nl=nl, nr=nr, C=C)
        # The leader thread has no request scope: batch spans reach each
        # member's trace only through these handles.
        request.recorder = obs_spans.current()
        request.trace_id = obs_spans.trace_id()
        return scheduler.submit(request)


def collect_request(future) -> np.ndarray:
    """Request side, post-dispatch: wait (bounded) for this request's
    packed row, a host int32 ``[8 + 24C]`` array. Leader-side errors
    surface here, wrapped into ``BatchFault``, so the caller applies
    posture per request. ``batch:mesh`` keeps the JAX package's
    request-side fault stage."""
    from ..utils import faults
    with fault_boundary("batch:mesh"):
        faults.check("batch:mesh")
    with fault_boundary("batch:dispatch"):
        faults.check("batch:dispatch")
        row = future.result(timeout=_COLLECT_TIMEOUT_S)
    with fault_boundary("batch:scatter"):
        faults.check("batch:scatter")
        flat = np.asarray(row)
    from . import _count_outcome
    _count_outcome("batched")
    return flat


def _graft(members, batch_id: str, name: str, seconds: float,
           t_start: float, **meta) -> None:
    """Record one leader-side batch span into every member's captured
    request recorder, stamped with the shared ``batch_id`` and the
    member's own ``trace_id`` (artifact only: the leader's own span
    already fed the histogram and the flight ring)."""
    for req, _fut in members:
        rec = getattr(req, "recorder", None)
        if rec is not None:
            obs_spans.record_into(
                rec, name, seconds, t_start=t_start, layer="batch",
                batch_id=batch_id, trace_id=getattr(req, "trace_id", None), **meta)


def mesh_stats() -> Dict[str, object]:
    """The status block of the JAX package's mesh-sharded dispatch, for
    the port's one device: posture ``off``, every dispatch on the
    single-device program."""
    with _stats_lock:
        dispatches = _dispatches
    return {"posture": "off", "dispatches": dispatches, "mesh_dispatches": 0,
            "last_shape": None, "last_rows_per_chip": 0, "last_chip_rows": [],
            "fallbacks": {}}


def dispatch_group(scheduler, members) -> None:
    """Leader side: pack → one batched program → wait → scatter.
    ``members`` is a same-bucket-key list of ``(BatchRequest, Future)``
    pairs. Every phase span is grafted into each member's request trace
    under one shared ``batch_id``."""
    global _dispatches
    reqs = [req for req, _fut in members]
    valid = len(reqs)
    batch_id = os.urandom(4).hex()

    t0 = time.perf_counter()
    with obs_spans.span("batch.pack", layer="batch", requests=valid, batch_id=batch_id):
        arrays, padded, placement = pack_group(reqs)
    _graft(members, batch_id, "batch.pack", time.perf_counter() - t0, t0, requests=valid)
    reg = obs_metrics.REGISTRY
    reg.histogram("batch_size", "Valid merges per batched fused dispatch",
                  buckets=BATCH_SIZE_BUCKETS).observe(valid)
    reg.gauge("batch_padding_waste_ratio",
              "Merge-axis padding fraction of the last batched dispatch"
              ).set((padded - valid) / padded)
    geom = reqs[0]
    t0 = time.perf_counter()
    dispatch_meta = {"requests": valid, "padded": padded, "C": geom.C}
    with obs_spans.span("batch.dispatch", layer="batch", batch_id=batch_id,
                        **dispatch_meta):
        from ..ops.fused import batched_fused_program
        program = batched_fused_program(padded, geom.nb, geom.nl, geom.nr, geom.C)
        rows = program(*arrays)
        if rows.device.type == "cuda":
            # The request threads read their rows on other host threads:
            # the whole batch completes before any row is handed out.
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(rows.device))
            done.synchronize()
        flat = rows.cpu().numpy()
        obs_device.record_transfer("d2h", flat.nbytes)
    _graft(members, batch_id, "batch.dispatch", time.perf_counter() - t0, t0,
           **dispatch_meta)
    with _stats_lock:
        _dispatches += 1
    t0 = time.perf_counter()
    with obs_spans.span("batch.scatter", layer="batch", requests=valid, batch_id=batch_id):
        for i, (_req, fut) in enumerate(members):
            if not fut.done():
                fut.set_result(flat[placement[i]])
    _graft(members, batch_id, "batch.scatter", time.perf_counter() - t0, t0,
           requests=valid)
    scheduler.note_batch(valid, padded)
