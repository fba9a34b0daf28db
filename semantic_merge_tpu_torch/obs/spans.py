"""Structured spans and events — the timing layer of
:mod:`semantic_merge_tpu_torch.obs`, a copy of the JAX package's
``obs/spans.py`` (stdlib only).

A :class:`SpanRecorder` collects nestable, thread-safe span records
(monotonic wall-time, depth/parent links, ok/error status, free-form
meta) and point events. Recorders resolve in two scopes:

- **Request scope** (:func:`request_scope`): a
  :class:`contextvars.ContextVar` carrying one request's recorder and
  its ``trace_id``; :func:`trace_id` exposes the id to any layer
  (postmortem bundles, error lines). The merge service, when it is
  ported, sets one around each request.
- **Global activation** (:func:`activate`): the CLI ``Tracer`` activates
  one recorder for ``--trace``/``--profile`` runs. Inside a request
  scope, ``activate`` rebinds the *scope's* recorder instead.

Three always-on guarantees keep instrumentation writable in hot paths:

- :func:`span` and :func:`record` feed the phase histogram of
  :mod:`semantic_merge_tpu_torch.obs.metrics` unconditionally (a dict
  update), so cumulative per-phase timing exists even without a
  recorder;
- the same call sites feed the bounded flight-recorder ring of
  :mod:`semantic_merge_tpu_torch.obs.flight` (one dict append), so a
  fault in an untraced run still leaves span-level evidence;
- full span records (nesting, meta, JSONL emission) are built only
  while a recorder is active, so untraced runs pay two ``perf_counter``
  calls per span, a histogram update and a ring append — nothing else.

Spans time the host. Around device work a span measures the dispatch
and whatever waits on the card inside it, as the JAX package's spans
do; no span adds a ``torch.cuda.synchronize()``. Device time comes from
the profiler (``--profile``). :func:`detailed_active` gates the extra
phase splits of the fused engine (``h2d``/``kernel``/``fetch``/...),
which exist only while someone asked for them (``--trace``,
``--profile``).

Artifacts: the recorder serializes to JSONL rows (``.semmerge-events.jsonl``,
written by ``Tracer.write``) and to the ``spans`` array of
``.semmerge-trace.json``; ``scripts/check_trace_schema.py`` validates
both.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import threading
import time
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

from . import flight, metrics

#: Default events artifact name (next to ``.semmerge-trace.json``).
EVENTS_ARTIFACT = ".semmerge-events.jsonl"

_state_lock = threading.Lock()
_active: "Optional[SpanRecorder]" = None
_tls = threading.local()


class _Scope:
    """One request's tracing scope: its recorder (may be rebound by a
    request-local ``Tracer``) and its wire-visible ``trace_id``."""

    __slots__ = ("recorder", "trace_id")

    def __init__(self, recorder: "Optional[SpanRecorder]",
                 trace_id: Optional[str]) -> None:
        self.recorder = recorder
        self.trace_id = trace_id


_SCOPE: "ContextVar[Optional[_Scope]]" = ContextVar(
    "semmerge_span_scope", default=None)


@dataclass(slots=True)
class SpanRecord:
    """One completed span. ``t_start`` is seconds since the recorder's
    epoch (monotonic clock); ``parent_id`` is ``-1`` for roots."""

    name: str
    layer: Optional[str]
    t_start: float
    seconds: float
    depth: int
    span_id: int
    parent_id: int
    thread: str
    status: str  # "ok" | "error"
    error: Optional[str]
    meta: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "layer": self.layer,
            "t_start": round(self.t_start, 6),
            "seconds": round(self.seconds, 6),
            "depth": self.depth,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "thread": self.thread,
            "status": self.status,
            "error": self.error,
            "meta": self.meta,
        }


class SpanRecorder:
    """Thread-safe sink for spans and events of one observed run.

    ``detailed`` opts the run into the fused engine's extra phase splits
    (``h2d``/``kernel``/``fetch``/...). Explicitly requested recorders
    (``--trace``, ``--profile``) default to detailed; an always-on
    per-request recorder would pass ``detailed=False``."""

    def __init__(self, detailed: bool = True) -> None:
        self._lock = threading.Lock()
        self._next_id = 0
        self.epoch = time.perf_counter()
        self.detailed = detailed
        self.spans: List[SpanRecord] = []
        self.events: List[dict] = []

    def _new_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def _add_span(self, rec: SpanRecord) -> None:
        with self._lock:
            self.spans.append(rec)

    def add_event(self, name: str, fields: Dict[str, Any]) -> None:
        row = {"name": name, "t_start": round(time.perf_counter() - self.epoch, 6),
               "thread": threading.current_thread().name, "fields": fields}
        with self._lock:
            self.events.append(row)

    def absorb(self, other: "SpanRecorder", **extra_meta: Any) -> None:
        """Graft another recorder's rows into this one: span starts are
        re-based onto this recorder's epoch, ids are remapped (parent
        links preserved within the absorbed set), and ``extra_meta``
        (typically ``trace_id=...``) is stamped on every span. The
        daemon's ``--events`` recorder absorbs each finished request's
        scoped recorder."""
        shift = other.epoch - self.epoch
        with other._lock:
            spans = list(other.spans)
            events = list(other.events)
        id_map = {sp.span_id: self._new_id() for sp in spans}
        with self._lock:
            for sp in spans:
                self.spans.append(SpanRecord(
                    name=sp.name, layer=sp.layer, t_start=sp.t_start + shift,
                    seconds=sp.seconds, depth=sp.depth, span_id=id_map[sp.span_id],
                    parent_id=id_map.get(sp.parent_id, -1), thread=sp.thread,
                    status=sp.status, error=sp.error, meta=dict(sp.meta, **extra_meta)))
            for e in events:
                self.events.append(dict(e, t_start=round(e["t_start"] + shift, 6)))

    def absorb_dicts(self, rows: List[dict], *, t_base: float = 0.0,
                     parent_id: int = -1, depth: int = 0,
                     **extra_meta: Any) -> None:
        """Graft plain span dicts (the wire form of :meth:`span_dicts`)
        into this recorder — the cross-process half of :meth:`absorb`
        (the fleet router grafts a member's shipped tree). ``perf_counter``
        epochs are not comparable between processes, so the caller
        anchors the grafted subtree at ``t_base`` (seconds relative to
        this recorder's epoch). Ids are remapped with parent links
        preserved inside the absorbed set; absorbed roots are re-parented
        under ``parent_id`` with their depth shifted by ``depth``;
        ``extra_meta`` (``member=...``, ``attempt=...``) is stamped on
        every span; ``seconds`` is carried through untouched."""
        keyed = [(row, self._new_id()) for row in rows]
        id_map = {row["span_id"]: new_id for row, new_id in keyed
                  if isinstance(row.get("span_id"), int)}
        with self._lock:
            for row, new_id in keyed:
                old_parent = row.get("parent_id", -1)
                self.spans.append(SpanRecord(
                    name=str(row.get("name", "")), layer=row.get("layer"),
                    t_start=float(row.get("t_start", 0.0)) + t_base,
                    seconds=float(row.get("seconds", 0.0)),
                    depth=int(row.get("depth", 0)) + depth,
                    span_id=id_map.get(row.get("span_id"), new_id),
                    parent_id=id_map.get(old_parent, parent_id),
                    thread=str(row.get("thread", "")),
                    status=str(row.get("status", "ok")), error=row.get("error"),
                    meta=dict(row.get("meta") or {}, **extra_meta)))

    # -- views ------------------------------------------------------------

    def span_dicts(self) -> List[dict]:
        with self._lock:
            return [s.to_dict() for s in
                    sorted(self.spans, key=lambda s: s.t_start)]

    def phase_totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        with self._lock:
            for s in self.spans:
                out[s.name] = out.get(s.name, 0.0) + s.seconds
        return out

    def layers(self) -> set:
        with self._lock:
            return {s.layer for s in self.spans if s.layer}

    def event_rows(self) -> List[dict]:
        """Every record as one JSONL-able row, time-ordered: spans carry
        ``type: "span"``, point events ``type: "event"``."""
        rows = [dict(s.to_dict(), type="span") for s in self.spans]
        with self._lock:
            rows += [dict(e, type="event") for e in self.events]
        rows.sort(key=lambda r: r["t_start"])
        return rows

    def write_jsonl(self, path: pathlib.Path | str) -> None:
        lines = [json.dumps(row, default=str) for row in self.event_rows()]
        pathlib.Path(path).write_text("\n".join(lines) + ("\n" if lines else ""),
                                      encoding="utf-8")


# ---------------------------------------------------------------------------
# Scope resolution: request-scoped recorder first, then the global one.

def current() -> Optional[SpanRecorder]:
    scope = _SCOPE.get()
    if scope is not None and scope.recorder is not None:
        return scope.recorder
    return _active


def active() -> bool:
    """True when a recorder is collecting full span records."""
    return current() is not None


def detailed_active() -> bool:
    """True when a *detailed* recorder is collecting — the gate for the
    fused engine's extra phase splits and the device-memory high-water
    reads. ``--trace``/``--profile`` recorders are detailed."""
    rec = current()
    return rec is not None and rec.detailed


def trace_id() -> Optional[str]:
    """The current request's ``trace_id``, or ``None`` outside any
    request scope (one-shot CLI runs)."""
    scope = _SCOPE.get()
    return scope.trace_id if scope is not None else None


@contextlib.contextmanager
def request_scope(trace_id: Optional[str],
                  recorder: "Optional[SpanRecorder]" = None
                  ) -> Iterator[_Scope]:
    """Scope a per-request recorder + trace id over the current
    thread/context (a server sets one around each request). While a scope is set,
    :func:`activate`/:func:`deactivate` rebind the scope's recorder
    instead of the process-global one."""
    scope = _Scope(recorder, trace_id)
    token = _SCOPE.set(scope)
    try:
        yield scope
    finally:
        _SCOPE.reset(token)


def activate(recorder: SpanRecorder) -> None:
    scope = _SCOPE.get()
    if scope is not None:
        scope.recorder = recorder
        return
    global _active
    with _state_lock:
        _active = recorder


def deactivate(recorder: Optional[SpanRecorder] = None) -> None:
    """Deactivate ``recorder`` (or whatever is active). A stale handle —
    some other recorder has since been activated — is a no-op, so
    overlapping Tracer lifetimes cannot clobber each other."""
    scope = _SCOPE.get()
    if scope is not None:
        if recorder is None or scope.recorder is recorder:
            scope.recorder = None
        return
    global _active
    with _state_lock:
        if recorder is None or _active is recorder:
            _active = None


@contextlib.contextmanager
def activated(recorder: SpanRecorder):
    activate(recorder)
    try:
        yield recorder
    finally:
        deactivate(recorder)


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


# ---------------------------------------------------------------------------
# Recording API

@contextlib.contextmanager
def span(name: str, layer: Optional[str] = None, **meta: Any):
    """Time a block. Always feeds the phase histogram and the flight
    ring; records a full :class:`SpanRecord` (with nesting links) when
    a recorder is active. Exceptions propagate and mark the span
    ``status="error"``."""
    rec = current()
    frame = None
    if rec is not None:
        stack = _stack()
        parent_id = stack[-1][1] if stack and stack[-1][0] is rec else -1
        depth = sum(1 for r, _ in stack if r is rec)
        frame = (rec, rec._new_id())
        stack.append(frame)
    status, error = "ok", None
    t0 = time.perf_counter()
    try:
        yield
    except BaseException as exc:
        status, error = "error", type(exc).__name__
        raise
    finally:
        dt = time.perf_counter() - t0
        metrics.observe_phase(name, dt)
        flight.note(name, dt, layer=layer, status=status, error=error,
                    trace_id=trace_id(), meta=meta or None)
        if frame is not None:
            stack = _stack()
            if frame in stack:
                stack.remove(frame)
            rec._add_span(SpanRecord(
                name=name, layer=layer,
                t_start=t0 - rec.epoch, seconds=dt,
                depth=depth, span_id=frame[1], parent_id=parent_id,
                thread=threading.current_thread().name,
                status=status, error=error, meta=dict(meta)))


def record(name: str, seconds: float, layer: Optional[str] = None, *,
           t_start: Optional[float] = None, **meta: Any) -> None:
    """Record an already-measured duration as a span — for call sites
    whose timing interleaves with retries or deferred work and cannot
    be a ``with`` block (the fused engine's phase splits).

    ``t_start`` is the span's real start as a ``time.perf_counter()``
    value (the ``t0`` the caller already holds). Without it the start
    is back-dated ``now - seconds``, which misorders spans whose work
    was deferred or retried between start and record — pass ``t_start``
    anywhere a true start exists."""
    metrics.observe_phase(name, seconds)
    flight.note(name, seconds, layer=layer, trace_id=trace_id(),
                meta=meta or None)
    rec = current()
    if rec is None:
        return
    stack = _stack()
    parent_id = stack[-1][1] if stack and stack[-1][0] is rec else -1
    depth = sum(1 for r, _ in stack if r is rec)
    rel = max(t_start - rec.epoch, 0.0) if t_start is not None else \
        max(time.perf_counter() - rec.epoch - seconds, 0.0)
    rec._add_span(SpanRecord(
        name=name, layer=layer, t_start=rel,
        seconds=seconds, depth=depth, span_id=rec._new_id(),
        parent_id=parent_id, thread=threading.current_thread().name,
        status="ok", error=None, meta=dict(meta)))


def record_into(recorder: SpanRecorder, name: str, seconds: float, *,
                t_start: Optional[float] = None,
                layer: Optional[str] = None, **meta: Any) -> None:
    """Record a span directly into ``recorder``, bypassing scope
    resolution — the batch leader thread grafts its pack, dispatch and
    scatter spans into every co-batched member's request recorder (with
    a shared ``batch_id`` in ``meta``). Artifact-only: the phase
    histogram and the flight ring are not fed here (the leader's own
    :func:`span` / :func:`record` call counted the work once)."""
    rel = max(t_start - recorder.epoch, 0.0) if t_start is not None else \
        max(time.perf_counter() - recorder.epoch - seconds, 0.0)
    recorder._add_span(SpanRecord(
        name=name, layer=layer, t_start=rel, seconds=seconds, depth=0,
        span_id=recorder._new_id(), parent_id=-1,
        thread=threading.current_thread().name, status="ok", error=None,
        meta=dict(meta)))


def event(name: str, **fields: Any) -> None:
    """Point event (no duration) — recorded only while a recorder is
    active; use a metrics counter for always-on occurrence counts."""
    rec = current()
    if rec is not None:
        rec.add_event(name, dict(fields))
