"""Online anomaly triage — robust-z / EWMA detectors on per-phase
timings, with auto-captured triage bundles (the port of the JAX
package's ``obs/anomaly.py``; the merge service feeds it).

The sampling layer (:mod:`semantic_merge_tpu_torch.obs.sampling`) decides
*what to keep*; this module decides *what to escalate*. Every finished
request feeds its per-phase wall seconds into one
:class:`EwmaDetector` per phase: an exponentially-weighted mean plus an
exponentially-weighted mean absolute deviation (a robust spread
estimate — one outlier cannot inflate its own threshold, because
breaching observations are excluded from the baseline update). A phase
*breaches* when its robust z-score exceeds ``SEMMERGE_ANOMALY_Z`` for
``SEMMERGE_ANOMALY_SUSTAIN`` consecutive requests; the detector then
fires exactly once and latches until the phase recovers (the same
number of consecutive in-band observations), so a sustained regression
produces one bundle, not one per request.

On fire, :class:`AnomalyTriage` captures a triage bundle through the
flight recorder (``reason="anomaly"``): the offending trace, the
nearest in-budget baseline trace (closest total latency among recent
healthy requests), and a phase-aligned diff whose top contributor is
named ``suspect_phase`` — the artifact ``semmerge trace diff`` renders
and ``scripts/check_trace_schema.py validate_triage`` pins.

Knobs: ``SEMMERGE_ANOMALY`` (``off`` disables), ``SEMMERGE_ANOMALY_Z``
(threshold, default 4.0), ``SEMMERGE_ANOMALY_MIN_N`` (warmup
observations per phase, default 32), ``SEMMERGE_ANOMALY_SUSTAIN``
(consecutive breaches to fire, default 3). Stdlib-only.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import flight, metrics

ENV_ENABLE = "SEMMERGE_ANOMALY"
ENV_Z = "SEMMERGE_ANOMALY_Z"
ENV_MIN_N = "SEMMERGE_ANOMALY_MIN_N"
ENV_SUSTAIN = "SEMMERGE_ANOMALY_SUSTAIN"

DEFAULT_Z = 4.0
DEFAULT_MIN_N = 32
DEFAULT_SUSTAIN = 3
#: EWMA smoothing for mean and deviation.
ALPHA = 0.05
#: Healthy requests retained as triage-diff baselines.
BASELINE_POOL = 16
#: Floor for the deviation estimate (seconds) so a perfectly-steady
#: phase cannot alert on scheduler jitter.
MIN_DEV_S = 0.0005
#: Phases cheaper than this never alert (noise floor).
MIN_MEAN_S = 0.0002


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def enabled() -> bool:
    return os.environ.get(ENV_ENABLE, "").strip().lower() not in (
        "off", "0", "false", "no")


class EwmaDetector:
    """One phase's breach detector. ``observe`` returns one of
    ``"warmup" | "ok" | "breach" | "fire" | "latched"`` — ``fire`` is
    emitted exactly once per sustained excursion."""

    __slots__ = ("z_threshold", "min_n", "sustain", "n", "mean", "dev",
                 "streak", "recovery", "latched")

    def __init__(self, z_threshold: float = DEFAULT_Z,
                 min_n: int = DEFAULT_MIN_N,
                 sustain: int = DEFAULT_SUSTAIN) -> None:
        self.z_threshold = float(z_threshold)
        self.min_n = int(min_n)
        self.sustain = max(1, int(sustain))
        self.n = 0
        self.mean = 0.0
        self.dev = 0.0
        self.streak = 0
        self.recovery = 0
        self.latched = False

    def _absorb(self, value: float) -> None:
        self.n += 1
        if self.n == 1:
            self.mean = value
            self.dev = abs(value) * 0.1
            return
        delta = value - self.mean
        self.mean += ALPHA * delta
        self.dev += ALPHA * (abs(delta) - self.dev)

    def zscore(self, value: float) -> float:
        return (value - self.mean) / max(self.dev, MIN_DEV_S)

    def observe(self, value: float) -> str:
        value = float(value)
        if self.n < self.min_n:
            self._absorb(value)
            return "warmup"
        breach = (self.zscore(value) > self.z_threshold
                  and value > max(self.mean, MIN_MEAN_S))
        if breach:
            # Breaching samples do not update the baseline — a
            # regression must not teach the detector that slow is
            # normal before it has even fired.
            self.recovery = 0
            self.streak += 1
            if self.latched:
                return "latched"
            if self.streak >= self.sustain:
                self.latched = True
                return "fire"
            return "breach"
        self._absorb(value)
        self.streak = 0
        if self.latched:
            self.recovery += 1
            if self.recovery >= self.sustain:
                self.latched = False
                self.recovery = 0
        return "ok"


class AnomalyTriage:
    """Per-phase detector bank + triage-bundle capture.

    ``observe`` is called once per finished request with its phase
    totals; when any phase fires, one bundle is written through
    :func:`flight.dump` carrying the offender, the nearest healthy
    baseline, and the phase-aligned diff."""

    def __init__(self, z_threshold: Optional[float] = None,
                 min_n: Optional[int] = None,
                 sustain: Optional[int] = None) -> None:
        self.enabled = enabled()
        self.z_threshold = (z_threshold if z_threshold is not None
                            else _env_float(ENV_Z, DEFAULT_Z))
        self.min_n = int(min_n if min_n is not None
                         else _env_float(ENV_MIN_N, DEFAULT_MIN_N))
        self.sustain = int(sustain if sustain is not None
                           else _env_float(ENV_SUSTAIN, DEFAULT_SUSTAIN))
        self._lock = threading.Lock()
        self._detectors: Dict[str, EwmaDetector] = {}
        self._baselines: deque = deque(maxlen=BASELINE_POOL)
        self._fired = 0
        self._last_bundle: Optional[str] = None

    def _detector(self, phase: str) -> EwmaDetector:
        det = self._detectors.get(phase)
        if det is None:
            det = self._detectors[phase] = EwmaDetector(
                self.z_threshold, self.min_n, self.sustain)
        return det

    def observe(self, trace_id: str, verb: str,
                phases: Dict[str, float], *,
                seconds: Optional[float] = None,
                spans: Optional[List[dict]] = None,
                root: Optional[str] = None) -> List[dict]:
        """Feed one finished request; returns the bundles captured (one
        per phase that fired this call, usually zero or one)."""
        if not self.enabled or not phases:
            return []
        total = float(seconds if seconds is not None
                      else sum(phases.values()))
        fired: List[dict] = []
        breached = False
        with self._lock:
            for phase, secs in sorted(phases.items()):
                det = self._detector(phase)
                z = det.zscore(float(secs)) if det.n >= det.min_n else 0.0
                verdict = det.observe(float(secs))
                if verdict in ("breach", "fire", "latched"):
                    breached = True
                if verdict == "fire":
                    fired.append({"phase": phase, "z": round(z, 3),
                                  "seconds": float(secs),
                                  "mean_s": round(det.mean, 6),
                                  "dev_s": round(det.dev, 6)})
            # A pre-fire "breach" must stay out of the baseline pool
            # too: the nearest-by-total selection would otherwise hand
            # the offender an identical polluted baseline and the
            # triage diff would read all-zero.
            anomalous = breached or any(
                d.latched for d in self._detectors.values())
            baseline = self._nearest_baseline(total) if fired else None
            if not anomalous:
                self._baselines.append({
                    "trace_id": str(trace_id), "verb": verb,
                    "seconds": total,
                    "phases": {k: float(v) for k, v in phases.items()}})
        bundles = []
        for hit in fired:
            bundle = self._capture(trace_id, verb, phases, total, hit,
                                   baseline, spans, root)
            if bundle is not None:
                bundles.append(bundle)
        return bundles

    def _nearest_baseline(self, total: float) -> Optional[dict]:
        if not self._baselines:
            return None
        return min(self._baselines,
                   key=lambda b: abs(b["seconds"] - total))

    def _capture(self, trace_id: str, verb: str,
                 phases: Dict[str, float], total: float, hit: dict,
                 baseline: Optional[dict],
                 spans: Optional[List[dict]],
                 root: Optional[str]) -> Optional[dict]:
        base_phases = baseline["phases"] if baseline else {}
        diff = phase_diff(phases, base_phases)
        triage = {
            "schema": 1,
            "phase": hit["phase"],
            "suspect_phase": diff["suspect_phase"] or hit["phase"],
            "z": hit["z"],
            "threshold_z": self.z_threshold,
            "sustain": self.sustain,
            "offender": {
                "trace_id": str(trace_id), "verb": verb,
                "seconds": round(total, 6),
                "phases_ms": {k: round(1000.0 * v, 3)
                              for k, v in sorted(phases.items())}},
            "baseline": ({
                "trace_id": baseline["trace_id"],
                "verb": baseline["verb"],
                "seconds": round(baseline["seconds"], 6),
                "phases_ms": {k: round(1000.0 * v, 3)
                              for k, v in
                              sorted(baseline["phases"].items())}}
                if baseline else None),
            "diff": diff["phases"],
            "ts": round(time.time(), 3),
        }
        extra: Dict[str, Any] = {"triage": triage}
        if spans:
            extra["offender_spans"] = spans
        path = flight.dump(trace_id, "anomaly", root=root, extra=extra)
        metrics.REGISTRY.counter(
            "anomaly_breaches_total",
            "Sustained per-phase latency breaches (one per excursion)"
        ).inc(1, phase=hit["phase"])
        with self._lock:
            self._fired += 1
            self._last_bundle = str(path) if path else None
        triage["bundle"] = str(path) if path else None
        return triage

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "z": self.z_threshold,
                "sustain": self.sustain,
                "fired": self._fired,
                "last_bundle": self._last_bundle,
                "latched": sorted(p for p, d in self._detectors.items()
                                  if d.latched),
                "phases_tracked": len(self._detectors),
                "baselines": len(self._baselines),
            }


def phase_diff(a_phases: Dict[str, float],
               b_phases: Dict[str, float]) -> Dict[str, Any]:
    """Phase-aligned diff of two per-phase wall-second maps (A =
    offender, B = baseline). Rows are sorted by descending delta so the
    first row — ``suspect_phase`` — names the regression's top
    contributor. Shared by auto-triage and ``semmerge trace diff``."""
    rows = []
    for phase in sorted(set(a_phases) | set(b_phases)):
        a_ms = 1000.0 * float(a_phases.get(phase, 0.0))
        b_ms = 1000.0 * float(b_phases.get(phase, 0.0))
        rows.append({
            "phase": phase,
            "a_ms": round(a_ms, 3),
            "b_ms": round(b_ms, 3),
            "delta_ms": round(a_ms - b_ms, 3),
            "ratio": round(a_ms / b_ms, 3) if b_ms > 0 else None,
        })
    rows.sort(key=lambda r: -r["delta_ms"])
    return {"phases": rows,
            "suspect_phase": rows[0]["phase"]
            if rows and rows[0]["delta_ms"] > 0 else None}
