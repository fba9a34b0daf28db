"""OTLP export — the standard-wire-format edge of
:mod:`semantic_merge_tpu_torch.obs` (the port of the JAX package's
``obs/export.py``).

Maps the internal observability artifacts (span-dict trees from
:mod:`.spans`, the :meth:`~semantic_merge_tpu_torch.obs.metrics.Registry.to_dict`
registry form) onto OTLP JSON (``opentelemetry-proto`` JSON encoding),
and ships them to a collector over plain HTTP — so Jaeger/Tempo/
Prometheus-class backends ingest the daemon's traces without bespoke
glue.

Off by default: everything here is inert until
``SEMMERGE_OTLP_ENDPOINT`` names a collector base URL (the exporter
POSTs to ``<endpoint>/v1/traces`` and ``<endpoint>/v1/metrics``). The
merge service daemon is the only caller: it ships each served
request's trace; a one-shot CLI run exports nothing, as in the JAX
package. Export is fire-and-forget through a bounded queue drained by
one background thread; when the queue is full the payload is *dropped*
and counted (``otlp_dropped_total``) — telemetry never applies
backpressure to the merge path. Delivery outcomes land in
``otlp_exported_total{kind}`` / ``otlp_errors_total``; stdlib-only
(``urllib``), no SDK dependency.

The payloads are the JAX package's for the same span rows, registry,
epoch and pid, but for one field: ``scopeSpans[].scope.name`` and
``scopeMetrics[].scope.name`` name the package that made them,
``semantic_merge_tpu_torch`` (as the daemon's ``status`` names it in
``package``). The payload shape is enforced by ``validate_export`` in
``scripts/check_trace_schema.py``.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from . import metrics as obs_metrics

ENV_ENDPOINT = "SEMMERGE_OTLP_ENDPOINT"
ENV_QUEUE = "SEMMERGE_OTLP_QUEUE"
ENV_TIMEOUT = "SEMMERGE_OTLP_TIMEOUT"

DEFAULT_QUEUE = 256
DEFAULT_TIMEOUT_S = 3.0

#: The instrumentation scope of every payload: this package.
SCOPE_NAME = "semantic_merge_tpu_torch"

#: OTLP span status codes (``opentelemetry-proto`` Status.StatusCode).
_STATUS_OK = 1
_STATUS_ERROR = 2


def _hex_trace_id(trace_id: str) -> str:
    """Internal trace ids are 16 hex chars (``os.urandom(8).hex()``);
    OTLP wants exactly 32. Left-pad rather than re-mint so the exported
    id stays greppable against our artifacts."""
    tid = "".join(c for c in str(trace_id) if c in "0123456789abcdef")
    return (tid or "0").rjust(32, "0")[-32:]


def _hex_span_id(span_id: int) -> str:
    return format(int(span_id) & ((1 << 64) - 1), "016x")


def _attr_value(v: Any) -> Dict[str, Any]:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _attrs(pairs: Dict[str, Any]) -> List[dict]:
    return [{"key": k, "value": _attr_value(v)}
            for k, v in pairs.items() if v is not None]


def spans_to_otlp(trace_id: str, span_rows: List[dict], *,
                  service_name: str = "semmerge",
                  epoch_unix_nano: Optional[int] = None) -> dict:
    """OTLP ``ExportTraceServiceRequest`` (JSON form) for one trace.

    ``span_rows`` is the plain-dict form of
    :meth:`~semantic_merge_tpu_torch.obs.spans.SpanRecorder.span_dicts` —
    ``t_start`` offsets relative to a recorder epoch. OTLP wants
    absolute unix nanos, so the tree is anchored at ``epoch_unix_nano``
    (defaulting to "the latest span ended just now", the only anchor a
    monotonic-clock recorder can offer after the fact)."""
    if epoch_unix_nano is None:
        t_max = max((float(r.get("t_start", 0.0)) +
                     float(r.get("seconds", 0.0)) for r in span_rows),
                    default=0.0)
        epoch_unix_nano = time.time_ns() - int(t_max * 1e9)
    tid = _hex_trace_id(trace_id)
    spans = []
    for row in span_rows:
        start = epoch_unix_nano + int(float(row.get("t_start", 0.0)) * 1e9)
        end = start + int(float(row.get("seconds", 0.0)) * 1e9)
        attrs = _attrs({"layer": row.get("layer"),
                        "thread": row.get("thread")})
        attrs += _attrs(dict(row.get("meta") or {}))
        status: Dict[str, Any] = {"code": _STATUS_OK}
        if row.get("status") == "error":
            status = {"code": _STATUS_ERROR,
                      "message": str(row.get("error") or "")}
        span = {
            "traceId": tid,
            "spanId": _hex_span_id(row.get("span_id", 0)),
            "name": str(row.get("name", "")),
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(start),
            "endTimeUnixNano": str(end),
            "attributes": attrs,
            "status": status,
        }
        parent = row.get("parent_id", -1)
        if isinstance(parent, int) and parent >= 0:
            span["parentSpanId"] = _hex_span_id(parent)
        spans.append(span)
    return {
        "resourceSpans": [{
            "resource": {"attributes": _attrs(
                {"service.name": service_name, "process.pid": os.getpid()})},
            "scopeSpans": [{
                "scope": {"name": SCOPE_NAME},
                "spans": spans,
            }],
        }],
    }


def _metric_points(series: List[dict], now_ns: int) -> List[dict]:
    return [{"attributes": _attrs(s.get("labels") or {}),
             "timeUnixNano": str(now_ns),
             "asDouble": float(s.get("value", 0.0))} for s in series]


def metrics_to_otlp(registry_dict: dict, *,
                    service_name: str = "semmerge",
                    time_unix_nano: Optional[int] = None) -> dict:
    """OTLP ``ExportMetricsServiceRequest`` (JSON form) of a
    :meth:`~semantic_merge_tpu_torch.obs.metrics.Registry.to_dict` payload.
    Counters become cumulative monotonic sums, gauges gauges, histograms
    explicit-bucket histograms (our per-bucket counts map 1:1 onto OTLP
    ``bucketCounts``; per-bucket exemplars ride along)."""
    now_ns = time.time_ns() if time_unix_nano is None else time_unix_nano
    out_metrics: List[dict] = []
    for name in sorted(registry_dict.get("counters", ())):
        m = registry_dict["counters"][name]
        out_metrics.append({
            "name": name, "description": m.get("help", ""),
            "sum": {"aggregationTemporality": 2, "isMonotonic": True,
                    "dataPoints": _metric_points(m.get("series", []), now_ns)},
        })
    for name in sorted(registry_dict.get("gauges", ())):
        m = registry_dict["gauges"][name]
        out_metrics.append({
            "name": name, "description": m.get("help", ""),
            "gauge": {"dataPoints": _metric_points(m.get("series", []),
                                                   now_ns)},
        })
    for name in sorted(registry_dict.get("histograms", ())):
        m = registry_dict["histograms"][name]
        bounds = [float(b) for b in m.get("buckets", [])]
        points = []
        for s in m.get("series", []):
            exemplars = [{"traceId": _hex_trace_id(e.get("trace_id", "")),
                          "timeUnixNano": str(now_ns),
                          "asDouble": float(e.get("value", 0.0))}
                         for _, e in sorted((s.get("exemplars") or {}).items())]
            points.append({
                "attributes": _attrs(s.get("labels") or {}),
                "timeUnixNano": str(now_ns),
                "count": str(int(s.get("count", 0))),
                "sum": float(s.get("sum", 0.0)),
                "bucketCounts": [str(int(c)) for c in s.get("counts", [])],
                "explicitBounds": bounds,
                "exemplars": exemplars,
            })
        out_metrics.append({
            "name": name, "description": m.get("help", ""),
            "histogram": {"aggregationTemporality": 2,
                          "dataPoints": points},
        })
    return {
        "resourceMetrics": [{
            "resource": {"attributes": _attrs(
                {"service.name": service_name, "process.pid": os.getpid()})},
            "scopeMetrics": [{
                "scope": {"name": SCOPE_NAME},
                "metrics": out_metrics,
            }],
        }],
    }


class Exporter:
    """Bounded-queue background OTLP shipper.

    ``enqueue`` never blocks and never raises toward the merge path: a
    full queue drops the payload and bumps ``otlp_dropped_total{kind}``.
    One daemon thread drains the queue, POSTing JSON to
    ``<endpoint>/v1/traces`` / ``<endpoint>/v1/metrics``; delivery
    failures bump ``otlp_errors_total`` (the payload is not retried —
    a collector outage must not grow unbounded state here)."""

    def __init__(self, endpoint: str, *, queue_size: int = DEFAULT_QUEUE,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
        self.endpoint = endpoint.rstrip("/")
        self.timeout_s = timeout_s
        self._q: "queue.Queue[Optional[Tuple[str, dict]]]" = \
            queue.Queue(maxsize=max(1, queue_size))
        self._exported = obs_metrics.REGISTRY.counter(
            "otlp_exported_total", "OTLP payloads delivered, by kind.")
        self._dropped = obs_metrics.REGISTRY.counter(
            "otlp_dropped_total",
            "OTLP payloads dropped on a full export queue, by kind.")
        self._errors = obs_metrics.REGISTRY.counter(
            "otlp_errors_total", "OTLP delivery failures.")
        self._thread = threading.Thread(
            target=self._run, name="otlp-exporter", daemon=True)
        self._thread.start()

    def export_trace(self, trace_id: str, span_rows: List[dict],
                     **kwargs: Any) -> None:
        self._enqueue("traces", spans_to_otlp(trace_id, span_rows, **kwargs))

    def export_metrics(self, registry_dict: dict, **kwargs: Any) -> None:
        self._enqueue("metrics", metrics_to_otlp(registry_dict, **kwargs))

    def _enqueue(self, kind: str, payload: dict) -> None:
        try:
            self._q.put_nowait((kind, payload))
        except queue.Full:
            self._dropped.inc(kind=kind)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            kind, payload = item
            try:
                self._post(kind, payload)
                self._exported.inc(kind=kind)
            except Exception:
                self._errors.inc()

    def _post(self, kind: str, payload: dict) -> None:
        req = urllib.request.Request(
            f"{self.endpoint}/v1/{kind}",
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            resp.read()

    def close(self, timeout_s: float = 5.0) -> None:
        """Stop the worker after the queue drains (best-effort)."""
        try:
            self._q.put_nowait(None)
        except queue.Full:
            # A full queue must not wedge shutdown behind a dead
            # collector: drop one payload to make room for the sentinel.
            try:
                self._q.get_nowait()
                self._q.put_nowait(None)
            except (queue.Empty, queue.Full):
                pass
        self._thread.join(timeout=timeout_s)


_singleton_lock = threading.Lock()
_singleton: Optional[Exporter] = None
_singleton_endpoint: Optional[str] = None


def maybe_exporter() -> Optional[Exporter]:
    """The process-wide :class:`Exporter`, or ``None`` when
    ``SEMMERGE_OTLP_ENDPOINT`` is unset — callers gate on the return so
    export stays zero-cost when off."""
    global _singleton, _singleton_endpoint
    endpoint = os.environ.get(ENV_ENDPOINT, "").strip()
    if not endpoint:
        return None
    with _singleton_lock:
        if _singleton is None or _singleton_endpoint != endpoint:
            try:
                qsize = int(os.environ.get(ENV_QUEUE, "") or DEFAULT_QUEUE)
            except ValueError:
                qsize = DEFAULT_QUEUE
            try:
                timeout_s = float(os.environ.get(ENV_TIMEOUT, "")
                                  or DEFAULT_TIMEOUT_S)
            except ValueError:
                timeout_s = DEFAULT_TIMEOUT_S
            _singleton = Exporter(endpoint, queue_size=qsize,
                                  timeout_s=timeout_s)
            _singleton_endpoint = endpoint
        return _singleton
