"""Streaming windowed aggregation — 1 s / 1 m rollups of request
latency and phase time, built on mergeable log-bucketed quantile
sketches. The port of
the JAX package's ``obs/agg.py``.

The raw registry (:mod:`semantic_merge_tpu_torch.obs.metrics`) is cumulative
since process start — good for totals, useless for "what is p99 *right
now*". This module keeps a ring of per-second slots, each holding a
:class:`QuantileSketch` plus error/phase/verb tallies; reading a window
merges the relevant slots. Sketches are mergeable by construction
(bucket-wise count addition), which is also what lets a router fold
member-shipped sketches into one fleet-wide estimate without holding
raw samples.

The sketch is DDSketch-shaped: value ``v`` lands in bucket
``ceil(log(v) / log(gamma))`` with ``gamma = (1+alpha)/(1-alpha)``,
giving a relative quantile-error guarantee of ``alpha`` (default 1%).
Memory is one small int-keyed dict per slot — bounded by the dynamic
range of observed latencies, not by their volume.

Consumers: the daemon's ``status()`` grows a ``window`` block, and
``/metrics`` exposes ``semmerge_window_*`` gauges that ``semmerge top``
polls fleet-wide. Import cost stays stdlib-only.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from . import metrics

#: Default relative accuracy of the sketch (1%).
DEFAULT_ALPHA = 0.01
#: Values below this collapse into the zero bucket.
MIN_TRACKED = 1e-9
#: Per-slot cap on distinct phase keys (the phase namespace is small
#: and closed today; the cap is a safety rail, not a tuning knob).
MAX_PHASES_PER_SLOT = 64
#: 1-second slots retained (>= the 1m window plus slack).
RING_SECONDS = 120

WINDOWS = ("1s", "1m")


class QuantileSketch:
    """Log-bucketed quantile sketch with exact-merge semantics.

    ``merge(a, b)`` is bucket-wise addition, so a merged sketch answers
    quantiles over the union stream with the same ``alpha`` guarantee
    as either input — the property test in ``tests/test_agg.py`` pins
    this. Not thread-safe; callers hold their own locks."""

    __slots__ = ("alpha", "_gamma", "_log_gamma", "zero", "buckets",
                 "count", "sum", "min", "max")

    def __init__(self, alpha: float = DEFAULT_ALPHA) -> None:
        self.alpha = float(alpha)
        self._gamma = (1.0 + self.alpha) / (1.0 - self.alpha)
        self._log_gamma = math.log(self._gamma)
        self.zero = 0
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += max(0.0, v)
        if v < self.min:
            self.min = max(0.0, v)
        if v > self.max:
            self.max = v
        if v <= MIN_TRACKED:
            self.zero += 1
            return
        key = math.ceil(math.log(v) / self._log_gamma)
        self.buckets[key] = self.buckets.get(key, 0) + 1

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """In-place bucket-wise merge; returns self. Requires equal
        ``alpha`` (mixed-resolution merges would silently lose the
        error guarantee)."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError("cannot merge sketches with different alpha")
        self.zero += other.zero
        for key, n in other.buckets.items():
            self.buckets[key] = self.buckets.get(key, 0) + n
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def quantile(self, q: float) -> float:
        """``q``-quantile estimate (midpoint of the owning bucket);
        ``0.0`` on an empty sketch."""
        if self.count <= 0:
            return 0.0
        q = min(1.0, max(0.0, float(q)))
        rank = q * (self.count - 1) + 1
        if rank <= self.zero:
            return 0.0
        cum = self.zero
        for key in sorted(self.buckets):
            cum += self.buckets[key]
            if cum >= rank:
                upper = self._gamma ** key
                return 2.0 * upper / (self._gamma + 1.0)
        return self.max

    def to_dict(self) -> Dict[str, Any]:
        return {"alpha": self.alpha, "zero": self.zero,
                "buckets": {str(k): v for k, v in self.buckets.items()},
                "count": self.count, "sum": round(self.sum, 9),
                "max": self.max,
                "min": 0.0 if self.min is math.inf else self.min}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "QuantileSketch":
        sketch = cls(float(data.get("alpha", DEFAULT_ALPHA)))
        sketch.zero = int(data.get("zero", 0))
        sketch.buckets = {int(k): int(v)
                          for k, v in (data.get("buckets") or {}).items()}
        sketch.count = int(data.get("count", 0))
        sketch.sum = float(data.get("sum", 0.0))
        sketch.max = float(data.get("max", 0.0))
        raw_min = data.get("min", 0.0)
        sketch.min = math.inf if sketch.count == 0 else float(raw_min)
        return sketch


class _Slot:
    __slots__ = ("sec", "count", "errors", "sketch", "phases", "verbs")

    def __init__(self, sec: int, alpha: float) -> None:
        self.sec = sec
        self.count = 0
        self.errors = 0
        self.sketch = QuantileSketch(alpha)
        self.phases: Dict[str, float] = {}
        self.verbs: Dict[str, int] = {}


class WindowAggregator:
    """Ring of 1-second slots rolled up into 1 s / 1 m windows.

    ``observe`` files one finished request (latency + optional per-phase
    seconds) into the current second's slot; ``window()`` merges the
    last *completed* second (``"1s"``) and the trailing 60 completed
    seconds (``"1m"``) into rollups. The clock is injectable so tests
    drive window boundaries deterministically."""

    def __init__(self, alpha: float = DEFAULT_ALPHA,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.alpha = float(alpha)
        self._clock = clock
        self._lock = threading.Lock()
        self._slots: deque = deque(maxlen=RING_SECONDS)

    def _slot(self, sec: int) -> _Slot:
        if self._slots and self._slots[-1].sec == sec:
            return self._slots[-1]
        slot = _Slot(sec, self.alpha)
        self._slots.append(slot)
        return slot

    def observe(self, verb: str, seconds: float, *,
                error: bool = False,
                phases: Optional[Dict[str, float]] = None) -> None:
        sec = int(self._clock())
        with self._lock:
            slot = self._slot(sec)
            slot.count += 1
            if error:
                slot.errors += 1
            slot.sketch.observe(float(seconds))
            slot.verbs[verb] = slot.verbs.get(verb, 0) + 1
            if phases:
                for name, secs in phases.items():
                    if (name not in slot.phases
                            and len(slot.phases) >= MAX_PHASES_PER_SLOT):
                        continue
                    slot.phases[name] = slot.phases.get(name, 0.0) \
                        + float(secs)

    def _roll(self, slots: List[_Slot], span: float) -> Dict[str, Any]:
        sketch = QuantileSketch(self.alpha)
        count = errors = 0
        phases: Dict[str, float] = {}
        verbs: Dict[str, int] = {}
        for slot in slots:
            sketch.merge(slot.sketch)
            count += slot.count
            errors += slot.errors
            for name, secs in slot.phases.items():
                phases[name] = phases.get(name, 0.0) + secs
            for verb, n in slot.verbs.items():
                verbs[verb] = verbs.get(verb, 0) + n
        return {
            "span_s": span,
            "count": count,
            "errors": errors,
            "qps": round(count / span, 4) if span > 0 else 0.0,
            "error_rate": round(errors / count, 6) if count else 0.0,
            "p50_ms": round(1000.0 * sketch.quantile(0.50), 3),
            "p99_ms": round(1000.0 * sketch.quantile(0.99), 3),
            "max_ms": round(1000.0 * sketch.max, 3),
            "phases_ms": {name: round(1000.0 * secs, 3)
                          for name, secs in sorted(phases.items())},
            "verbs": dict(sorted(verbs.items())),
        }

    def window(self) -> Dict[str, Any]:
        """The ``window`` block: ``{"1s": rollup, "1m": rollup}`` over
        completed seconds (the in-progress second is excluded so rates
        are never computed over a partial span)."""
        now_sec = int(self._clock())
        with self._lock:
            slots = list(self._slots)
        return {
            "1s": self._roll([s for s in slots if s.sec == now_sec - 1],
                             1.0),
            "1m": self._roll([s for s in slots
                              if now_sec - 60 <= s.sec <= now_sec - 1],
                             60.0),
        }

    def sketch_for(self, window: str = "1m") -> QuantileSketch:
        """Merged latency sketch over one window — the mergeable unit a
        router folds across members."""
        now_sec = int(self._clock())
        lo = now_sec - (1 if window == "1s" else 60)
        merged = QuantileSketch(self.alpha)
        with self._lock:
            for slot in self._slots:
                if lo <= slot.sec <= now_sec - 1:
                    merged.merge(slot.sketch)
        return merged

    def publish(self, registry: Optional[metrics.Registry] = None) -> None:
        """Mirror the rollups into ``semmerge_window_*`` gauges so
        ``/metrics`` scrapes (and the federated fleet view) carry them."""
        reg = registry or metrics.REGISTRY
        snap = self.window()
        qps = reg.gauge("semmerge_window_qps",
                        "Requests/s over the rollup window")
        p50 = reg.gauge("semmerge_window_p50_ms",
                        "Windowed p50 service latency (ms)")
        p99 = reg.gauge("semmerge_window_p99_ms",
                        "Windowed p99 service latency (ms)")
        err = reg.gauge("semmerge_window_error_rate",
                        "Windowed error fraction")
        for name in WINDOWS:
            roll = snap[name]
            qps.set(roll["qps"], window=name)
            p50.set(roll["p50_ms"], window=name)
            p99.set(roll["p99_ms"], window=name)
            err.set(roll["error_rate"], window=name)
