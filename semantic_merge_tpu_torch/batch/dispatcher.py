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

The mesh posture (``SEMMERGE_MESH`` / ``[engine] mesh``, see
:data:`semantic_merge_tpu_torch.parallel.mesh.MESH_POSTURES`) decides the
program: ``off`` keeps the single-device program; ``auto`` and
``require`` split the packed merge axis over the daemon's local devices
(:func:`~semantic_merge_tpu_torch.parallel.mesh.build_batch_mesh`, lane
block ``i`` on device ``i``). ``auto`` falls back to the single-device
program with one device, a failed mesh build or a failed mesh dispatch,
each counted in ``batch_mesh_fallbacks_total{reason}``; ``require``
raises a typed :class:`~semantic_merge_tpu_torch.errors.MeshFault`
(exit 18) instead. The lanes are independent, so the mesh's rows are
the single-device program's.

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

from ..errors import MeshFault, fault_boundary
from ..obs import device as obs_device
from ..obs import metrics as obs_metrics
from ..obs import spans as obs_spans
from ..utils.loggingx import logger
from .packer import BatchRequest, batch_bucket, pack_group

#: Small-integer buckets for the per-dispatch valid-merge count.
BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)

#: Bound on a request's wait for its batch row — a wedged leader must
#: degrade the request to the inline path, not hang the daemon.
_COLLECT_TIMEOUT_S = 300.0

_FALLBACKS_HELP = ("Mesh-sharded batch dispatches that fell back to "
                   "the single-device program, by reason")

_mesh_lock = threading.Lock()
_mesh_cache: Dict[tuple, object] = {}
_mesh_stats: Dict[str, object] = {
    "dispatches": 0, "mesh_dispatches": 0, "last_shape": None,
    "last_rows_per_chip": 0, "last_chip_rows": [], "fallbacks": {}}


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
        try:
            faults.check("batch:mesh")
        except Exception:
            _note_fallback("fault")
            raise
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


def _note_fallback(reason: str) -> None:
    obs_metrics.REGISTRY.counter(
        "batch_mesh_fallbacks_total", _FALLBACKS_HELP).inc(1, reason=reason)
    with _mesh_lock:
        fallbacks = _mesh_stats["fallbacks"]
        fallbacks[reason] = fallbacks.get(reason, 0) + 1


def _plan_mesh(posture: str, devices):
    """Leader side: the batch mesh over ``devices`` for this batch, or
    ``(None, 1)`` for the single-device program. ``auto`` falls back on
    one device and on a failed build (counted); ``require`` raises
    :class:`MeshFault` instead — the scheduler fails every member future
    with it, and each request's posture seam decides whether that is
    fatal (``SEMMERGE_MESH=require``) or an inline degrade."""
    from ..parallel.mesh import batch_mesh_shards, build_batch_mesh
    shards = batch_mesh_shards(devices)
    if shards < 2:
        _note_fallback("single-device")
        if posture == "require":
            raise MeshFault(f"SEMMERGE_MESH=require but the host has {len(devices)} "
                            f"device(s) — no batch mesh to shard over",
                            cause="single-device")
        return None, 1
    key = (shards, tuple(str(d) for d in devices))
    try:
        with _mesh_lock:
            mesh = _mesh_cache.get(key)
        if mesh is None:
            mesh = build_batch_mesh(devices, shards=shards)
            with _mesh_lock:
                mesh = _mesh_cache.setdefault(key, mesh)
    except Exception as exc:
        _note_fallback("build-error")
        if posture == "require":
            raise MeshFault(f"batch mesh build failed: {exc}",
                            cause=type(exc).__name__) from exc
        logger.warning("batch mesh build failed, using single-device program: %s", exc)
        return None, 1
    return mesh, shards


def mesh_stats() -> Dict[str, object]:
    """Status block of the mesh-sharded dispatch path: the live posture,
    the last mesh's shape, the per-device real-row occupancy of the last
    mesh dispatch, and the fallbacks by reason."""
    from ..parallel.mesh import mesh_posture
    from . import current
    sched = current()
    with _mesh_lock:
        return {
            "posture": mesh_posture(getattr(sched, "mesh_config", None)),
            "dispatches": _mesh_stats["dispatches"],
            "mesh_dispatches": _mesh_stats["mesh_dispatches"],
            "last_shape": _mesh_stats["last_shape"],
            "last_rows_per_chip": _mesh_stats["last_rows_per_chip"],
            "last_chip_rows": list(_mesh_stats["last_chip_rows"]),
            "fallbacks": dict(_mesh_stats["fallbacks"]),
        }


def _run_program(program, arrays) -> np.ndarray:
    """Launch ``program``, wait for the whole batch, fetch its rows."""
    rows = program(*arrays)
    if rows.device.type == "cuda":
        # The request threads read their rows on other host threads: the
        # whole batch completes before any row is handed out.
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(rows.device))
        done.synchronize()
    return rows.cpu().numpy()


def dispatch_group(scheduler, members) -> None:
    """Leader side: plan the mesh → pack → one batched program → wait →
    scatter. ``members`` is a same-bucket-key list of ``(BatchRequest,
    Future)`` pairs. Every phase span is grafted into each member's
    request trace under one shared ``batch_id``."""
    from ..parallel.mesh import local_devices, mesh_posture
    reqs = [req for req, _fut in members]
    valid = len(reqs)
    batch_id = os.urandom(4).hex()

    posture = mesh_posture(getattr(scheduler, "mesh_config", None))
    devices = getattr(scheduler, "mesh_devices", None)
    if devices is None:
        devices = local_devices(getattr(scheduler, "device", "cpu"))
    mesh, shards = (None, 1) if posture == "off" else _plan_mesh(posture, devices)
    mesh_shape = f"batch={shards}" if mesh is not None else None
    if mesh is not None:
        rows_per_chip = batch_bucket(valid, shards) // shards
        t0 = time.perf_counter()
        with obs_spans.span("batch.mesh_build", layer="batch", requests=valid,
                            batch_id=batch_id, mesh_shape=mesh_shape,
                            rows_per_chip=rows_per_chip):
            pass  # planned above; the span records the placement
        _graft(members, batch_id, "batch.mesh_build", time.perf_counter() - t0, t0,
               requests=valid, mesh_shape=mesh_shape, rows_per_chip=rows_per_chip)

    t0 = time.perf_counter()
    with obs_spans.span("batch.pack", layer="batch", requests=valid, batch_id=batch_id):
        arrays, padded, placement = pack_group(reqs, shards)
    _graft(members, batch_id, "batch.pack", time.perf_counter() - t0, t0, requests=valid)
    reg = obs_metrics.REGISTRY
    reg.histogram("batch_size", "Valid merges per batched fused dispatch",
                  buckets=BATCH_SIZE_BUCKETS).observe(valid)
    reg.gauge("batch_padding_waste_ratio",
              "Merge-axis padding fraction of the last batched dispatch"
              ).set((padded - valid) / padded)
    if mesh is not None:
        reg.gauge("batch_mesh_occupancy_ratio",
                  "Real-merge fraction of the last mesh-sharded batched "
                  "dispatch (valid rows / padded rows)").set(valid / padded)
    geom = reqs[0]
    t0 = time.perf_counter()
    dispatch_meta = {"requests": valid, "padded": padded, "C": geom.C}
    if mesh is not None:
        dispatch_meta.update(mesh_shape=mesh_shape, rows_per_chip=padded // shards)
    with obs_spans.span("batch.dispatch", layer="batch", batch_id=batch_id,
                        **dispatch_meta):
        from ..ops.fused import batched_fused_program
        flat = None
        if mesh is not None:
            try:
                flat = _run_program(batched_fused_program(
                    padded, geom.nb, geom.nl, geom.nr, geom.C, mesh=mesh), arrays)
            except Exception as exc:
                _note_fallback("dispatch-error")
                if posture == "require":
                    raise MeshFault(f"mesh-sharded batch dispatch failed: {exc}",
                                    cause=type(exc).__name__) from exc
                logger.warning("mesh-sharded dispatch failed, retrying on the "
                               "single-device program: %s", exc)
                mesh = None
        if flat is None:
            flat = _run_program(batched_fused_program(
                padded, geom.nb, geom.nl, geom.nr, geom.C), arrays)
        obs_device.record_transfer("d2h", flat.nbytes)
    _graft(members, batch_id, "batch.dispatch", time.perf_counter() - t0, t0,
           **dispatch_meta)
    with _mesh_lock:
        _mesh_stats["dispatches"] += 1
        if mesh is not None:
            _mesh_stats["mesh_dispatches"] += 1
            _mesh_stats["last_shape"] = mesh_shape
            _mesh_stats["last_rows_per_chip"] = padded // shards
            _mesh_stats["last_chip_rows"] = [
                sum(1 for i in range(valid) if i % shards == chip) for chip in range(shards)]
    t0 = time.perf_counter()
    with obs_spans.span("batch.scatter", layer="batch", requests=valid, batch_id=batch_id):
        for i, (_req, fut) in enumerate(members):
            if not fut.done():
                fut.set_result(flat[placement[i]])
    _graft(members, batch_id, "batch.scatter", time.perf_counter() - t0, t0,
           requests=valid)
    scheduler.note_batch(valid, padded)
