"""Per-phase tracing and profiling of one CLI run — the JAX package's
``runtime/trace.py`` with ``torch.profiler`` in place of the JAX
profiler.

Every CLI run carries a :class:`Tracer`. ``phase`` opens an
:func:`obs.spans.span` of layer ``cli``; while the tracer is collecting
(``--trace`` or ``--profile``) a
:class:`~semantic_merge_tpu_torch.obs.spans.SpanRecorder` is active
process-wide, so the spans emitted deep inside the scan, the backend,
the fused engine, the renderer, compose, the applier and the in-place
commit all land in the same artifact. Without either flag nothing is
recorded beyond the always-on phase histogram and flight ring, and no
profiler runs.

Artifacts written by :meth:`Tracer.write`:

- ``.semmerge-trace.json`` — the CLI phases, counters, the span tree,
  the device block (:func:`obs.device.snapshot`) and the metrics
  registry, in the JAX package's layout (``schema``, ``trace_id``,
  ``phases``, ``counters``, ``total_seconds``, ``device``, ``metrics``,
  ``spans``);
- ``.semmerge-events.jsonl`` — one JSON row per span/event, time-ordered;
- with ``--profile DIR``, the same trace JSON in
  ``DIR/semmerge-trace.json`` (``--trace`` or not), beside the profiler's
  own trace, ``DIR/<host>_<pid>.<ns>.pt.trace.json`` (Chrome trace
  format, which TensorBoard's profiler plugin and Perfetto read).

With ``profile_dir`` set the run is captured by ``torch.profiler``: CPU
and CUDA activities on the card, CPU only under ``--device cpu``. Every
phase is a ``semmerge/<phase>`` range (``record_function``), so the
kernels line up with the engine phases. A profiler session is an object
here, not the process-global session of the JAX profiler, but the
Kineto/CUPTI state under it is per process: one session at a time. A
second session started while one runs cancels the first, whose stop
then crashes the process, so :func:`start_profiler_session` never
starts one beside a live session: while the thread that started the
open session is alive and is not the caller, the start is refused
(``None``, counted with reason ``busy``). The caller that comes second
loses: a merge service request with ``--profile`` during a daemon
capture runs unprofiled (its bytes unchanged), and a daemon capture
during such a request reports ``profiler_started: false``. A session
whose starter has ended, or that the caller itself left open (an
aborted capture in a warm process), is stale: the start stops it
first, and after a failed start stops whatever profiler is on and
retries once. Every failure counts in
``profiler_capture_failures_total{reason}``. :meth:`Tracer.close` stops
and exports the capture on every exit path.

``torch.profiler`` records the CPU ranges (``record_function``) of the
thread that started the session only, and the CUDA activity (CUPTI)
of every thread in the process.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

from ..obs import device as obs_device
from ..obs import metrics as obs_metrics
from ..obs import spans as obs_spans

TRACE_SCHEMA_VERSION = 1

#: Counter recording every failed profiler start/stop/export, by reason
#: — a capture that silently goes dark is an observability bug in itself.
PROFILER_FAILURES = "profiler_capture_failures_total"

#: The profiler session this process started last and has not stopped,
#: and the thread that started it.
_open_session = None
_open_owner: threading.Thread | None = None
#: Held while a session starts or stops: two starts never race.
_session_lock = threading.Lock()


def _failures():
    return obs_metrics.REGISTRY.counter(
        PROFILER_FAILURES, "Profiler session start/stop failures, by reason")


def _live_elsewhere() -> bool:
    """Is the open session held by another thread that still runs?"""
    owner = _open_owner
    return (_open_session is not None and owner is not None
            and owner is not threading.current_thread() and owner.is_alive())


def start_profiler_session(cuda: bool):
    """Start a ``torch.profiler`` session (CPU activity, plus CUDA when
    ``cuda``) and return it, or ``None`` when it cannot start.

    While another live thread holds the open session the start is
    refused (reason ``busy``; see the module docstring). A stale session
    (its starter ended, or the caller left it open) is stopped first; a
    start that fails stops whatever profiler is on and is retried
    **once**; every failure counts in
    ``profiler_capture_failures_total{reason}`` so a dark profiler is at
    least visible in metrics."""
    global _open_session, _open_owner
    try:
        from torch.profiler import ProfilerActivity, profile
    except Exception:
        _failures().inc(1, reason="torch-import")
        return None
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with _session_lock:
        if _live_elsewhere():
            _failures().inc(1, reason="busy")
            return None
        if _open_session is not None:
            _stop_stale()  # never start beside it: that would cancel it
        for attempt in ("start", "start-retry"):
            prof = profile(activities=activities)
            try:
                prof.start()
                _open_session, _open_owner = prof, threading.current_thread()
                return prof
            except Exception:
                _failures().inc(1, reason=attempt)
            if attempt == "start":
                _stop_stale()
    return None


def _stop_stale() -> None:
    """Stop the stale open session, or a profiler some other code left
    enabled, so that the next start can succeed."""
    global _open_session, _open_owner
    stale, _open_session, _open_owner = _open_session, None, None
    try:
        if stale is not None:
            stale.stop()
        else:
            import torch
            torch.autograd._disable_profiler()
    except Exception:
        _failures().inc(1, reason="recovery-stop")


def stop_profiler_session(prof, profile_dir: str) -> bool:
    """Stop ``prof`` and write its Chrome trace into ``profile_dir``;
    returns whether it did (never raises)."""
    global _open_session, _open_owner
    with _session_lock:
        try:
            prof.stop()
        except Exception:
            _failures().inc(1, reason="stop")
            return False
        finally:
            if _open_session is prof:
                _open_session = _open_owner = None
    try:
        out = pathlib.Path(profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        return True
    except Exception:
        _failures().inc(1, reason="export")
        return False


@dataclass
class PhaseRecord:
    name: str
    seconds: float
    meta: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Tracer:
    """``enabled``: ``--trace``; ``profile_dir``: ``--profile DIR``;
    ``cuda``: profile the card's activity too (false under ``--device
    cpu``)."""

    enabled: bool = False
    profile_dir: str | None = None
    cuda: bool = True
    phases: List[PhaseRecord] = field(default_factory=list)
    counters: Dict[str, Any] = field(default_factory=dict)
    _profiler: Any = field(default=None, repr=False)
    _recorder: obs_spans.SpanRecorder | None = field(default=None, repr=False)

    def __post_init__(self) -> None:
        if self.enabled or self.profile_dir:
            self._recorder = obs_spans.SpanRecorder()
            obs_spans.activate(self._recorder)
        if self.profile_dir:
            self._profiler = start_profiler_session(self.cuda)

    @contextlib.contextmanager
    def phase(self, name: str, **meta: Any):
        annotation = contextlib.nullcontext()
        if self._profiler is not None:
            from torch.profiler import record_function
            annotation = record_function(f"semmerge/{name}")
        start = time.perf_counter()
        try:
            with annotation, obs_spans.span(name, layer="cli", **meta):
                yield
        finally:
            self.phases.append(PhaseRecord(name, time.perf_counter() - start, dict(meta)))

    def count(self, key: str, value: Any) -> None:
        self.counters[key] = value

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "schema": TRACE_SCHEMA_VERSION,
            "trace_id": obs_spans.trace_id(),
            "phases": [
                {"name": p.name, "seconds": round(p.seconds, 6), **({"meta": p.meta} if p.meta else {})}
                for p in self.phases
            ],
            "counters": self.counters,
            "total_seconds": round(sum(p.seconds for p in self.phases), 6),
            "device": obs_device.snapshot(),
            "metrics": obs_metrics.REGISTRY.to_dict(),
        }
        if self._recorder is not None:
            out["spans"] = self._recorder.span_dicts()
        return out

    def close(self) -> None:
        """Stop and export the profiler session if one is open and
        release the global span recorder. Idempotent; must run on every
        exit path (the CLI calls it in ``finally``), or an aborted run
        loses its capture and blocks the next session's start."""
        if self._profiler is not None:
            stop_profiler_session(self._profiler, self.profile_dir)
            self._profiler = None
        if self._recorder is not None:
            obs_spans.deactivate(self._recorder)

    def write(self, path: pathlib.Path | str = ".semmerge-trace.json") -> None:
        self.close()
        if not self.enabled and not self.profile_dir:
            return
        payload = json.dumps(self.to_dict(), indent=2, default=str)
        if self.profile_dir:
            # A profiled run keeps its phase timings next to the device
            # capture, --trace or not.
            prof = pathlib.Path(self.profile_dir)
            try:
                prof.mkdir(parents=True, exist_ok=True)
                (prof / "semmerge-trace.json").write_text(payload, encoding="utf-8")
            except OSError:
                pass
        if not self.enabled:
            return
        path = pathlib.Path(path)
        if not path.is_absolute():
            # Relative artifacts land in the request root when one is in
            # scope (utils/workdir), the cwd otherwise.
            from ..utils import workdir
            path = workdir.root() / path
        path.write_text(payload, encoding="utf-8")
        if self._recorder is not None:
            self._recorder.write_jsonl(path.with_name(obs_spans.EVENTS_ARTIFACT))
