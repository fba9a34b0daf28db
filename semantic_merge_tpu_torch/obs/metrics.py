"""Process-global metrics registry — the numeric spine of
:mod:`semantic_merge_tpu_torch.obs`, a copy of the JAX package's
``obs/metrics.py`` (stdlib only).

Counters, gauges and fixed-bucket histograms with labels, renderable as
Prometheus text exposition and as JSON. Every instrumented layer (scan,
backend, fused engine, render, compose, applier, in-place commit, the
ladder and the resolution tier) records here unconditionally — a dict
update under a lock — and three consumers read it:

- the :class:`~semantic_merge_tpu_torch.runtime.trace.Tracer` embeds
  :meth:`Registry.to_dict` into ``.semmerge-trace.json``;
- the flight recorder embeds it into every postmortem bundle;
- ``SEMMERGE_METRICS=path`` dumps the registry on interpreter exit
  (JSON, or Prometheus text when the path ends in ``.prom``), and
  ``stats`` pretty-prints either form.

Semantics follow the Prometheus data model: histogram buckets are
cumulative upper bounds (a value lands in every bucket whose ``le`` it
does not exceed), ``_sum``/``_count`` accompany each labeled series.
The series budget (``SEMMERGE_METRICS_MAX_SERIES``) collapses new label
sets past it into one overflow series, counted in
``metrics_series_dropped_total``.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

#: Default bucket ladder for phase wall-times (seconds): sub-ms host
#: hops up to the reference's 40 s cold-start budget.
PHASE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 40.0)

#: Byte-size ladder for transfer histograms.
BYTE_BUCKETS = (256.0, 1024.0, 4096.0, 16384.0, 65536.0, 262144.0,
                1048576.0, 4194304.0, 16777216.0, 67108864.0)


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


#: Per-metric series-cardinality budget (``SEMMERGE_METRICS_MAX_SERIES``,
#: default 512; ``0`` disables the cap). At production QPS unbounded
#: label sets (per-repo, per-member, per-category) make the registry
#: itself the outage — past the budget, NEW label sets collapse into one
#: overflow series and ``metrics_series_dropped_total`` counts them.
ENV_MAX_SERIES = "SEMMERGE_METRICS_MAX_SERIES"
DEFAULT_MAX_SERIES = 512
OVERFLOW_KEY: LabelKey = (("overflow", "true"),)
SERIES_DROPPED = "metrics_series_dropped_total"


def series_budget() -> int:
    raw = os.environ.get(ENV_MAX_SERIES, "").strip()
    if not raw:
        return DEFAULT_MAX_SERIES
    try:
        return max(0, int(float(raw)))
    except ValueError:
        return DEFAULT_MAX_SERIES


def _note_series_dropped(metric_name: str) -> None:
    if metric_name == SERIES_DROPPED:  # the counter never recurses
        return
    REGISTRY.counter(
        SERIES_DROPPED,
        "New label sets rejected by the per-metric cardinality budget"
    ).inc(1, metric=metric_name)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, object] = {}

    def _admit(self, key: LabelKey) -> LabelKey:
        """Cardinality gate (caller holds ``self._lock``): an existing
        series always records; a NEW one past the budget is rerouted to
        the overflow series so hot paths stay bounded either way."""
        if key in self._series or key == OVERFLOW_KEY:
            return key
        budget = series_budget()
        if budget <= 0 or len(self._series) < budget:
            return key
        _note_series_dropped(self.name)
        return OVERFLOW_KEY

    def _labelled(self) -> List[Tuple[LabelKey, object]]:
        with self._lock:
            return list(self._series.items())


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels: object) -> None:
        key = _label_key(labels)
        with self._lock:
            key = self._admit(key)
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels: object) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: object) -> None:
        with self._lock:
            self._series[self._admit(_label_key(labels))] = float(value)

    def max(self, value: float, **labels: object) -> None:
        """High-water-mark update: keep the larger of current/new."""
        key = _label_key(labels)
        with self._lock:
            key = self._admit(key)
            prev = self._series.get(key)
            if prev is None or value > prev:
                self._series[key] = float(value)

    def value(self, **labels: object) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = PHASE_BUCKETS) -> None:
        super().__init__(name, help)
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name!r} needs at least one bucket")

    def observe(self, value: float, exemplar: object = None,
                **labels: object) -> None:
        key = _label_key(labels)
        with self._lock:
            key = self._admit(key)
            series = self._series.get(key)
            if series is None:
                # counts has one slot per finite bucket plus +Inf.
                series = {"counts": [0] * (len(self.buckets) + 1),
                          "sum": 0.0, "count": 0}
                self._series[key] = series
            # Cumulative-upper-bound semantics: the first bucket whose
            # bound is >= value owns the observation (bisect_left puts a
            # value exactly on a bound INTO that bound's bucket).
            idx = bisect_left(self.buckets, value)
            series["counts"][idx] += 1
            series["sum"] += value
            series["count"] += 1
            if exemplar is not None:
                # Per-bucket exemplars (OpenMetrics): each bucket keeps
                # its own most recent trace_id, so a p99 outlier's id
                # survives the stream of p50 observations that follows.
                series.setdefault("exemplars", {})[idx] = {
                    "trace_id": str(exemplar), "value": float(value)}

    def sum(self, **labels: object) -> float:
        with self._lock:
            series = self._series.get(_label_key(labels))
            return float(series["sum"]) if series else 0.0

    def label_sums(self) -> Dict[LabelKey, float]:
        with self._lock:
            return {k: float(v["sum"]) for k, v in self._series.items()}

    def snapshot(self, **labels: object) -> Dict[str, object]:
        """Copy of one series (``counts``/``sum``/``count``) — empty
        zeros when the labelled series was never observed."""
        with self._lock:
            series = self._series.get(_label_key(labels))
            if series is None:
                return {"counts": [0] * (len(self.buckets) + 1),
                        "sum": 0.0, "count": 0}
            return {"counts": list(series["counts"]),
                    "sum": float(series["sum"]),
                    "count": int(series["count"])}

    def quantile(self, q: float, **labels: object) -> float:
        """Estimated ``q``-quantile of one labelled series via
        :func:`histogram_quantile`."""
        snap = self.snapshot(**labels)
        return histogram_quantile(self.buckets, snap["counts"], q)


class Registry:
    """Named metric store. ``counter``/``gauge``/``histogram`` are
    get-or-create: re-registering a name returns the existing metric
    (a kind mismatch raises — two layers disagreeing about a metric's
    type is a bug worth failing loudly on)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: "Dict[str, _Metric]" = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}")
                return existing
            metric = cls(name, help, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = PHASE_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self) -> None:
        """Drop every metric — test isolation only."""
        with self._lock:
            self._metrics.clear()

    def to_dict(self) -> dict:
        """JSON form: the schema ``scripts/check_trace_schema.py``
        validates and ``render_prometheus_from_dict`` renders — the
        round-trip contract."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self.metrics():
            if isinstance(m, Histogram):
                out["histograms"][m.name] = {
                    "help": m.help,
                    "buckets": list(m.buckets),
                    "series": [
                        dict({"labels": dict(key),
                              "counts": list(s["counts"]),
                              "sum": s["sum"], "count": s["count"]},
                             **({"exemplars": {str(i): dict(e)
                                               for i, e in
                                               sorted(s["exemplars"].items())}}
                                if s.get("exemplars") else {}))
                        for key, s in m._labelled()
                    ],
                }
            else:
                bucket = out["counters" if isinstance(m, Counter) else "gauges"]
                bucket[m.name] = {
                    "help": m.help,
                    "series": [{"labels": dict(key), "value": v}
                               for key, v in m._labelled()],
                }
        return out

    def render_prometheus(self) -> str:
        return render_prometheus_from_dict(self.to_dict())


def _fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def render_prometheus_from_dict(data: dict) -> str:
    """Prometheus text exposition (format 0.0.4) of a
    :meth:`Registry.to_dict` payload. A module function (not a method)
    so ``semmerge stats --prometheus`` can render archived artifacts
    from processes long gone."""
    lines: List[str] = []
    for kind in ("counters", "gauges"):
        for name in sorted(data.get(kind, ())):
            m = data[kind][name]
            if m.get("help"):
                lines.append(f"# HELP {name} {m['help']}")
            lines.append(f"# TYPE {name} {'counter' if kind == 'counters' else 'gauge'}")
            for s in m["series"]:
                lines.append(f"{name}{_fmt_labels(s['labels'])} "
                             f"{_fmt_value(s['value'])}")
    for name in sorted(data.get("histograms", ())):
        m = data["histograms"][name]
        if m.get("help"):
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} histogram")
        bounds = [_fmt_value(b) for b in m["buckets"]] + ["+Inf"]
        for s in m["series"]:
            cum = 0
            for bound, count in zip(bounds, s["counts"]):
                cum += count
                le = 'le="%s"' % bound
                lines.append(f"{name}_bucket{_fmt_labels(s['labels'], le)} "
                             f"{cum}")
            lines.append(f"{name}_sum{_fmt_labels(s['labels'])} "
                         f"{_fmt_value(s['sum'])}")
            lines.append(f"{name}_count{_fmt_labels(s['labels'])} "
                         f"{s['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


#: The process-global registry every instrumented layer records into.
REGISTRY = Registry()


def registry() -> Registry:
    return REGISTRY


# ---------------------------------------------------------------------------
# Quantile estimation over fixed-bucket histograms.

def histogram_quantile(buckets: Iterable[float], counts: Iterable[int],
                       q: float) -> float:
    """Prometheus-style quantile interpolation over one histogram
    series.

    ``buckets`` are the finite upper bounds; ``counts`` are the
    **non-cumulative** per-bucket observation counts with one extra
    trailing slot for the +Inf overflow bucket (the in-memory
    :class:`Histogram` layout and the ``to_dict`` wire shape). The
    estimate linearly interpolates within the bucket that holds the
    target rank, assuming observations spread uniformly between the
    bucket's lower and upper bound — the same model Prometheus's
    ``histogram_quantile()`` uses, so the port's math agrees with
    dashboard math. Values landing in the overflow bucket clamp to the
    highest finite bound (the estimate cannot exceed what the ladder
    can resolve). Empty series return ``0.0``.
    """
    bounds = tuple(buckets)
    counts = list(counts)
    if len(counts) != len(bounds) + 1:
        raise ValueError(
            f"counts length {len(counts)} != len(buckets)+1 "
            f"({len(bounds) + 1})")
    total = sum(counts)
    if total <= 0:
        return 0.0
    q = min(1.0, max(0.0, float(q)))
    rank = q * total
    cum = 0
    for i, count in enumerate(counts):
        prev_cum = cum
        cum += count
        if cum >= rank and count > 0:
            if i >= len(bounds):
                # Overflow bucket: unbounded above — clamp.
                return float(bounds[-1])
            lower = bounds[i - 1] if i > 0 else 0.0
            upper = bounds[i]
            frac = (rank - prev_cum) / count
            return float(lower + (upper - lower) * frac)
    return float(bounds[-1])


# ---------------------------------------------------------------------------
# Phase timing — the spine shared by spans and --trace.

PHASE_HISTOGRAM = "semmerge_phase_seconds"


def observe_phase(name: str, seconds: float) -> None:
    REGISTRY.histogram(
        PHASE_HISTOGRAM, "Wall seconds per instrumented pipeline phase",
        buckets=PHASE_BUCKETS).observe(seconds, phase=name)


def phase_totals() -> Dict[str, float]:
    """Cumulative wall seconds per phase name since process start."""
    hist = REGISTRY.histogram(PHASE_HISTOGRAM,
                              "Wall seconds per instrumented pipeline phase",
                              buckets=PHASE_BUCKETS)
    out: Dict[str, float] = {}
    for key, total in hist.label_sums().items():
        labels = dict(key)
        out[labels.get("phase", "?")] = out.get(labels.get("phase", "?"),
                                                0.0) + total
    return out


def phase_totals_since(before: Dict[str, float]) -> Dict[str, float]:
    """Per-phase wall-seconds delta against a :func:`phase_totals`
    snapshot (the worker scopes one request's phases with it)."""
    out = {}
    for name, total in phase_totals().items():
        delta = total - before.get(name, 0.0)
        if delta > 0.0:
            out[name] = delta
    return out


# ---------------------------------------------------------------------------
# Exit dump (SEMMERGE_METRICS=path)

def dump(path: str) -> None:
    """Write the registry to ``path``: Prometheus text when the name
    ends in ``.prom``, JSON otherwise."""
    if str(path).endswith(".prom"):
        payload = REGISTRY.render_prometheus()
    else:
        payload = json.dumps(REGISTRY.to_dict(), indent=2)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(payload)


def _install_exit_dump() -> None:
    path = os.environ.get("SEMMERGE_METRICS")
    if not path:
        return

    def _dump_at_exit() -> None:
        try:
            dump(path)
        except OSError:  # dumping diagnostics must never mask an exit
            pass

    atexit.register(_dump_at_exit)


_install_exit_dump()
