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
here, not the process-global session of the JAX profiler, but a session
that was started and never stopped still blocks the next start:
:func:`start_profiler_session` stops it and retries once, and every
failure counts in ``profiler_capture_failures_total{reason}``.
:meth:`Tracer.close` stops and exports the capture on every exit path.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import socket
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

#: The profiler session this process started last and has not stopped.
_open_session = None


def _failures():
    return obs_metrics.REGISTRY.counter(
        PROFILER_FAILURES, "Profiler session start/stop failures, by reason")


def start_profiler_session(cuda: bool):
    """Start a ``torch.profiler`` session (CPU activity, plus CUDA when
    ``cuda``) and return it, or ``None`` when it cannot start.

    A session some earlier run started and never stopped (an aborted
    capture in a warm process) makes the next start raise: on failure
    the stale session is stopped and the start retried **once**; every
    failure counts in ``profiler_capture_failures_total{reason}`` so a
    dark profiler is at least visible in metrics."""
    global _open_session
    try:
        from torch.profiler import ProfilerActivity, profile
    except Exception:
        _failures().inc(1, reason="torch-import")
        return None
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for attempt in ("start", "start-retry"):
        prof = profile(activities=activities)
        try:
            prof.start()
            _open_session = prof
            return prof
        except Exception:
            _failures().inc(1, reason=attempt)
        if attempt == "start":
            # Recovery: a stale session from an aborted capture is the
            # common cause — close it and retry once.
            try:
                stale = _open_session
                _open_session = None
                if stale is not None:
                    stale.stop()
                else:
                    import torch
                    torch.autograd._disable_profiler()
            except Exception:
                _failures().inc(1, reason="recovery-stop")
    return None


def stop_profiler_session(prof, profile_dir: str) -> bool:
    """Stop ``prof`` and write its Chrome trace into ``profile_dir``;
    returns whether it did (never raises)."""
    global _open_session
    try:
        prof.stop()
    except Exception:
        _failures().inc(1, reason="stop")
        return False
    finally:
        if _open_session is prof:
            _open_session = None
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
