"""Micro-batch window scheduler.

The port of the JAX package's ``batch/scheduler.py``. One leader
thread owns an admission queue. The first request to
arrive opens a window of ``SEMMERGE_BATCH_WINDOW_MS``; everything that
lands inside it (up to ``SEMMERGE_BATCH_MAX``) joins the round, is
grouped by shape-bucket key, and each group is handed to the dispatch
pool (``SEMMERGE_BATCH_INFLIGHT`` bounds concurrently in-flight batched
programs — the leader keeps collecting the next window while earlier
batches run, which is what makes the batching *continuous* rather than
lock-step). Requests never block each other beyond the window: a
window with one request dispatches a batch of one.

The scheduler is posture-free by design — posture, fault injection and
degradation all happen on the request threads
(:mod:`~semantic_merge_tpu_torch.batch.dispatcher`), where the per-request
env overlay is in scope.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional

import torch

from ..obs import spans as obs_spans

#: Scheduler knobs (process env at activation — daemon-side settings).
ENV_WINDOW_MS = "SEMMERGE_BATCH_WINDOW_MS"
ENV_MAX_BATCH = "SEMMERGE_BATCH_MAX"
ENV_INFLIGHT = "SEMMERGE_BATCH_INFLIGHT"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if raw:
        try:
            return float(raw)
        except ValueError:
            from ..utils.loggingx import logger
            logger.warning("invalid %s=%r ignored", name, raw)
    return default


def _env_int(name: str, default: int) -> int:
    return int(_env_float(name, float(default)))


class BatchScheduler:
    """The daemon-side micro-batch window: admission queue + leader
    thread + bounded dispatch pool, for merges on ``device`` (the
    daemon's). One per process (see ``batch.activate``)."""

    def __init__(self, *, device="cpu", window_ms: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 mesh: Optional[str] = None, mesh_devices=None) -> None:
        if window_ms is None:
            window_ms = _env_float(ENV_WINDOW_MS, 5.0)
        #: The device whose merges co-batch (``batch.plan_for_request``).
        self.device = torch.device(device)
        #: The configured mesh posture (``[engine] mesh``) the dispatcher
        #: reads when ``SEMMERGE_MESH`` is unset, and the local devices a
        #: batch mesh may span (default: the cards, or the CPU for a CPU
        #: scheduler; ``parallel/mesh.py::local_devices``).
        self.mesh_config = mesh
        self.mesh_devices = list(mesh_devices) if mesh_devices is not None else None
        self.window_s = max(0.0, float(window_ms) / 1000.0)
        self.max_batch = max(1, max_batch if max_batch is not None
                             else _env_int(ENV_MAX_BATCH, 16))
        self.max_inflight = max(1, max_inflight if max_inflight is not None
                                else _env_int(ENV_INFLIGHT, 2))
        self._queue: "queue.Queue" = queue.Queue()
        self._stopping = threading.Event()
        self._sem = threading.Semaphore(self.max_inflight)
        self._pool = ThreadPoolExecutor(
            max_workers=self.max_inflight,
            thread_name_prefix="semmerge-batch")
        self._lock = threading.Lock()
        self._batches = 0
        self._requests = 0
        self._waste_sum = 0.0
        self._active = 0
        self._inflight_cap = self.max_inflight
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "BatchScheduler":
        self._thread = threading.Thread(
            target=self._run, name="semmerge-batch-window", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the leader and fail anything still queued — waiting
        request threads then degrade to the inline dispatch instead of
        hanging on an orphaned future."""
        self._stopping.set()
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._pool.shutdown(wait=True)
        self._fail_pending()

    def alive(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and not self._stopping.is_set())

    # -- request side ------------------------------------------------------

    def submit(self, request) -> Future:
        from ..errors import BatchFault
        if not self.alive():
            raise BatchFault("batch scheduler is not running",
                             stage="batch:pack")
        fut: Future = Future()
        self._queue.put((request, fut))
        return fut

    def set_inflight_cap(self, cap: int) -> None:
        """Shrink (or restore) the effective in-flight bound without
        rebuilding the pool — the daemon's RSS-watermark response. The
        semaphore keeps its full count; the leader additionally honors
        this soft cap before dispatching, so a shrink takes effect as
        running batches finish."""
        with self._lock:
            self._inflight_cap = max(1, min(int(cap), self.max_inflight))

    # -- accounting --------------------------------------------------------

    def note_batch(self, valid: int, padded: int) -> None:
        with self._lock:
            self._batches += 1
            self._requests += valid
            self._waste_sum += (padded - valid) / padded

    def stats(self) -> Dict[str, object]:
        """Status-endpoint block: queue depth, mean batch size and
        padding waste. ``program_cache`` keeps the JAX package's keys
        and reads empty: PyTorch compiles no program per bucket shape."""
        with self._lock:
            batches, requests = self._batches, self._requests
            waste_sum = self._waste_sum
        from .dispatcher import mesh_stats
        return {
            "device": str(self.device),
            "queue_depth": self._queue.qsize(),
            "mesh": mesh_stats(),
            "window_ms": self.window_s * 1e3,
            "max_batch": self.max_batch,
            "max_inflight": self.max_inflight,
            "inflight_cap": self._inflight_cap,
            "batches_total": batches,
            "requests_batched": requests,
            "mean_batch_size": (requests / batches) if batches else 0.0,
            "padding_waste_ratio": (waste_sum / batches) if batches else 0.0,
            "program_cache": {"programs": 0, "cap": 0, "hits": 0, "misses": 0,
                              "evictions": 0, "hit_rate": 0.0},
        }

    # -- leader ------------------------------------------------------------

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None or self._stopping.is_set():
                break
            opened = time.perf_counter()
            group = [item]
            deadline = opened + self.window_s
            while len(group) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stopping.set()
                    break
                group.append(nxt)
            window_s = time.perf_counter() - opened
            obs_spans.record("batch.window", window_s, layer="batch",
                             t_start=opened, requests=len(group))
            # Graft the window wait into every member's request trace —
            # the leader thread has no request scope, so the members'
            # captured recorders are the only route in.
            for request, _fut in group:
                rec = getattr(request, "recorder", None)
                if rec is not None:
                    obs_spans.record_into(
                        rec, "batch.window", window_s, t_start=opened,
                        layer="batch", requests=len(group),
                        trace_id=getattr(request, "trace_id", None))
            by_key: Dict[tuple, list] = {}
            for request, fut in group:
                by_key.setdefault(request.key, []).append((request, fut))
            for members in by_key.values():
                self._acquire_slot()
                try:
                    self._pool.submit(self._dispatch, members)
                except RuntimeError as exc:  # pool shut down underneath
                    self._release_slot()
                    self._fail_members(members, exc)
            if self._stopping.is_set():
                break

    def _acquire_slot(self) -> None:
        self._sem.acquire()
        while True:
            with self._lock:
                if self._active < self._inflight_cap \
                        or self._stopping.is_set():
                    self._active += 1
                    return
            time.sleep(0.002)

    def _release_slot(self) -> None:
        with self._lock:
            self._active -= 1
        self._sem.release()

    def _dispatch(self, members) -> None:
        from .dispatcher import dispatch_group
        try:
            dispatch_group(self, members)
        except BaseException as exc:  # noqa: BLE001 — futures carry it
            self._fail_members(members, exc)
        finally:
            self._release_slot()

    def _fail_members(self, members, exc) -> None:
        for _request, fut in members:
            if not fut.done():
                fut.set_exception(exc)

    def _fail_pending(self) -> None:
        from ..errors import BatchFault
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                self._fail_members([item], BatchFault(
                    "batch scheduler stopped", stage="batch:dispatch"))
