"""Sliding-window SLO engine — latency/error objectives evaluated
against live daemon traffic with multi-window burn rates. The port of
the JAX package's ``obs/slo.py``.

The metrics registry (:mod:`semantic_merge_tpu_torch.obs.metrics`) keeps
*cumulative-forever* histograms: perfect for postmortems, useless for
"is the daemon healthy *right now*". This module layers a slot-ring
sliding window on the same fixed bucket ladder: every completed request
lands one observation in the current time slot's per-verb bucket
counts, and :meth:`SloEngine.evaluate` sums the slots inside each
window (fast ~5 min, slow ~1 h) to answer objective clauses like
``merge:p99<800ms,err<1%`` via the shared
:func:`~semantic_merge_tpu_torch.obs.metrics.histogram_quantile`
interpolation.

Burn-rate semantics (the Google SRE multi-window model): a clause
defines an error budget — ``p99<800ms`` allows 1% of requests over
800 ms, ``err<1%`` allows 1% failures — and the burn rate is the
observed violation fraction divided by that budget. Burn 1.0 = spending
the budget exactly as fast as allowed; burn 10 = ten times too fast.
The engine trips only when **both** windows burn at or above the
threshold (``SEMMERGE_SLO_TRIP``, default 1.0): the fast window makes
the alert responsive, the slow window keeps one latency spike from
paging anyone.

Configuration grammar (``SEMMERGE_SLO`` env or the ``[slo]`` config
table's ``objectives`` key)::

    objective  = target ":" clause ("," clause)*
    objectives = objective (";" objective)*
    target     = "merge" | "diff" | "rebase" | wire verb | "*"
    clause     = "p" NN "<" number ("ms" | "s")    ; latency
               | "err" "<" number "%"              ; error rate

State surfaces as ``slo_burn_rate{objective,window}`` gauges in the
registry (so ``/metrics``, ``SEMMERGE_METRICS`` dumps, and postmortem
bundles all carry it for free), as the ``slo`` block in daemon
``status``, and — via the daemon's monitor thread — as a degraded
``/healthz`` verdict and an ``slo-burn`` flight-recorder bundle on a
sustained trip. Import cost stays stdlib-only (the ``obs`` package
contract); ``observe`` is a few list additions under a lock.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import metrics

#: Objective grammar source (also read by ``config.py``'s ``[slo]``).
ENV_OBJECTIVES = "SEMMERGE_SLO"
#: Fast / slow evaluation windows, seconds.
ENV_FAST_WINDOW = "SEMMERGE_SLO_FAST_WINDOW"
ENV_SLOW_WINDOW = "SEMMERGE_SLO_SLOW_WINDOW"
#: Slot width of the sliding-window ring, seconds.
ENV_SLOT = "SEMMERGE_SLO_SLOT"
#: Monitor-thread evaluation cadence, seconds.
ENV_EVAL_INTERVAL = "SEMMERGE_SLO_EVAL_INTERVAL"
#: Burn-rate threshold at/above which (in both windows) a clause trips.
ENV_TRIP = "SEMMERGE_SLO_TRIP"
#: Opt-in: capture a profile bundle on the first burn trip.
ENV_AUTOPROFILE = "SEMMERGE_SLO_AUTOPROFILE"

DEFAULT_FAST_WINDOW = 300.0
DEFAULT_SLOW_WINDOW = 3600.0
DEFAULT_SLOT = 5.0
DEFAULT_EVAL_INTERVAL = 5.0
DEFAULT_TRIP = 1.0

#: Gauge published per (objective clause, window).
BURN_GAUGE = "slo_burn_rate"
#: Counter of edge-triggered burn trips, by objective clause.
TRIP_COUNTER = "slo_burn_trips_total"

#: CLI-friendly aliases for wire verbs.
VERB_ALIASES = {"merge": "semmerge", "diff": "semdiff",
                "rebase": "semrebase"}
_KNOWN_VERBS = ("semdiff", "semmerge", "semrebase")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class SloParseError(ValueError):
    """Raised for a malformed objective spec — loudly, at daemon
    startup, not silently at 3 a.m. when the alert should have fired."""


class Clause:
    """One parsed clause of an objective: either a latency quantile
    bound (``kind="latency"``: ``quantile`` in (0, 1), ``threshold_s``)
    or an error-rate bound (``kind="error"``). ``budget`` is the
    allowed violation fraction the burn rate divides by."""

    __slots__ = ("target", "kind", "quantile", "threshold_s", "budget",
                 "text")

    def __init__(self, target: str, kind: str, quantile: float,
                 threshold_s: float, budget: float, text: str) -> None:
        self.target = target
        self.kind = kind
        self.quantile = quantile
        self.threshold_s = threshold_s
        self.budget = budget
        self.text = text

    def to_dict(self) -> dict:
        out = {"objective": self.text, "target": self.target,
               "kind": self.kind, "budget": self.budget}
        if self.kind == "latency":
            out["quantile"] = self.quantile
            out["threshold_ms"] = round(self.threshold_s * 1e3, 3)
        return out


def _parse_clause(target: str, raw: str, verb: str) -> Clause:
    body = raw.strip().lower()
    text = f"{target}:{body}"
    if body.startswith("err"):
        rest = body[3:].strip()
        if not rest.startswith("<"):
            raise SloParseError(f"error clause needs '<': {raw!r}")
        pct = rest[1:].strip()
        if not pct.endswith("%"):
            raise SloParseError(f"error clause needs a '%' bound: {raw!r}")
        try:
            budget = float(pct[:-1]) / 100.0
        except ValueError:
            raise SloParseError(f"bad error bound: {raw!r}") from None
        if not 0.0 < budget <= 1.0:
            raise SloParseError(f"error budget out of (0,100]%: {raw!r}")
        return Clause(verb, "error", 0.0, 0.0, budget, text)
    if body.startswith("p"):
        head, sep, bound = body.partition("<")
        if not sep:
            raise SloParseError(f"latency clause needs '<': {raw!r}")
        try:
            q = float(head[1:]) / 100.0
        except ValueError:
            raise SloParseError(f"bad quantile: {raw!r}") from None
        if not 0.0 < q < 1.0:
            raise SloParseError(f"quantile out of (0,100): {raw!r}")
        bound = bound.strip()
        if bound.endswith("ms"):
            scale, bound = 1e-3, bound[:-2]
        elif bound.endswith("s"):
            scale, bound = 1.0, bound[:-1]
        else:
            raise SloParseError(
                f"latency bound needs an 'ms' or 's' unit: {raw!r}")
        try:
            threshold = float(bound) * scale
        except ValueError:
            raise SloParseError(f"bad latency bound: {raw!r}") from None
        if threshold <= 0.0:
            raise SloParseError(f"latency bound must be > 0: {raw!r}")
        # Budget: a pNN bound permits (1 - NN/100) of requests over it.
        return Clause(verb, "latency", q, threshold, 1.0 - q, text)
    raise SloParseError(f"unrecognised clause: {raw!r}")


def parse_objectives(spec: str) -> List[Clause]:
    """Parse an objective spec string into clauses; ``*`` targets
    expand to one clause per known wire verb."""
    clauses: List[Clause] = []
    for objective in str(spec).split(";"):
        objective = objective.strip()
        if not objective:
            continue
        target, sep, rest = objective.partition(":")
        if not sep or not rest.strip():
            raise SloParseError(
                f"objective needs 'target:clause[,clause]': {objective!r}")
        target = target.strip().lower()
        verbs: Sequence[str]
        if target == "*":
            verbs = _KNOWN_VERBS
        else:
            verbs = (VERB_ALIASES.get(target, target),)
        for raw in rest.split(","):
            if not raw.strip():
                continue
            for verb in verbs:
                # A `*` target expands to one labelled clause per verb;
                # a named target keeps the user's spelling in the label.
                label = verb if target == "*" else target
                clauses.append(_parse_clause(label, raw, verb))
    if not clauses:
        raise SloParseError(f"no clauses in spec: {spec!r}")
    return clauses


class _Slot:
    """One time slot of the ring: per-verb bucket counts + errors."""

    __slots__ = ("verbs",)

    def __init__(self) -> None:
        self.verbs: Dict[str, dict] = {}

    def observe(self, verb: str, seconds: float, error: bool,
                n_buckets: int, bucket_index) -> None:
        rec = self.verbs.get(verb)
        if rec is None:
            rec = {"counts": [0] * (n_buckets + 1), "count": 0,
                   "errors": 0}
            self.verbs[verb] = rec
        rec["counts"][bucket_index(seconds)] += 1
        rec["count"] += 1
        if error:
            rec["errors"] += 1


class SloEngine:
    """Slot-ring accounting plus clause evaluation. One instance per
    daemon; ``None`` (no engine) when no objectives are configured, so
    the unconfigured hot path pays nothing."""

    def __init__(self, clauses: Sequence[Clause], *,
                 fast_window: float = DEFAULT_FAST_WINDOW,
                 slow_window: float = DEFAULT_SLOW_WINDOW,
                 slot_seconds: float = DEFAULT_SLOT,
                 trip_threshold: float = DEFAULT_TRIP,
                 buckets: Sequence[float] = metrics.PHASE_BUCKETS,
                 clock=time.monotonic) -> None:
        if not clauses:
            raise ValueError("SloEngine needs at least one clause")
        self.clauses = list(clauses)
        self.fast_window = max(float(fast_window), slot_seconds)
        self.slow_window = max(float(slow_window), self.fast_window)
        self.slot_seconds = max(0.05, float(slot_seconds))
        self.trip_threshold = float(trip_threshold)
        self.buckets = tuple(sorted(buckets))
        self._clock = clock
        self._lock = threading.Lock()
        self._slots: Dict[int, _Slot] = {}
        self._tripped: Dict[str, bool] = {c.text: False for c in clauses}
        from bisect import bisect_left
        self._bisect = bisect_left

    # -- recording ---------------------------------------------------

    def _bucket_index(self, seconds: float) -> int:
        return self._bisect(self.buckets, seconds)

    def observe(self, verb: str, seconds: float,
                error: bool = False) -> None:
        now = self._clock()
        idx = int(now // self.slot_seconds)
        with self._lock:
            slot = self._slots.get(idx)
            if slot is None:
                slot = _Slot()
                self._slots[idx] = slot
                self._evict(idx)
            slot.observe(verb, float(seconds), bool(error),
                         len(self.buckets), self._bucket_index)

    def _evict(self, current_idx: int) -> None:
        horizon = current_idx - int(self.slow_window
                                    // self.slot_seconds) - 1
        for idx in [i for i in self._slots if i < horizon]:
            del self._slots[idx]

    # -- evaluation --------------------------------------------------

    def _window_totals(self, window_s: float) -> Dict[str, dict]:
        """Sum the slots covering the trailing ``window_s`` seconds
        into per-verb aggregates (bucket counts, count, errors)."""
        now = self._clock()
        lo = int((now - window_s) // self.slot_seconds)
        out: Dict[str, dict] = {}
        with self._lock:
            for idx, slot in self._slots.items():
                if idx < lo:
                    continue
                for verb, rec in slot.verbs.items():
                    agg = out.get(verb)
                    if agg is None:
                        agg = {"counts": [0] * (len(self.buckets) + 1),
                               "count": 0, "errors": 0}
                        out[verb] = agg
                    agg["count"] += rec["count"]
                    agg["errors"] += rec["errors"]
                    counts = agg["counts"]
                    for i, c in enumerate(rec["counts"]):
                        counts[i] += c
        return out

    def _fraction_over(self, counts: Sequence[int],
                       threshold_s: float) -> float:
        """Fraction of observations above ``threshold_s``, assuming
        uniform spread inside the bucket that straddles it (the inverse
        of the quantile interpolation, so the two agree)."""
        total = sum(counts)
        if total <= 0:
            return 0.0
        idx = self._bucket_index(threshold_s)
        if idx >= len(self.buckets):
            return counts[-1] / total
        below = sum(counts[:idx])
        inside = counts[idx]
        lower = self.buckets[idx - 1] if idx > 0 else 0.0
        upper = self.buckets[idx]
        frac_in = ((threshold_s - lower) / (upper - lower)
                   if upper > lower else 1.0)
        covered = below + inside * min(1.0, max(0.0, frac_in))
        return max(0.0, 1.0 - covered / total)

    def _clause_burn(self, clause: Clause, totals: Dict[str, dict]
                     ) -> Tuple[float, int]:
        agg = totals.get(clause.target)
        if agg is None or agg["count"] <= 0:
            return 0.0, 0
        if clause.kind == "error":
            violation = agg["errors"] / agg["count"]
        else:
            violation = self._fraction_over(agg["counts"],
                                            clause.threshold_s)
        return violation / clause.budget, agg["count"]

    def evaluate(self, consume_edges: bool = False) -> dict:
        """Compute burn rates for every clause over both windows,
        publish the gauges, and return the status-block payload:
        ``{"healthy", "objectives": [{objective, target, burn_fast,
        burn_slow, tripped, ...}], "windows": {...}}``.

        Trip *edges* (an objective crossing into burning) are latched
        into the returned ``newly_tripped`` list — but only when
        ``consume_edges=True`` (the daemon's monitor thread, which
        fires one postmortem per excursion). Status/healthz reads keep
        the default and never consume an edge, so a poll racing the
        monitor cannot swallow the bundle."""
        fast = self._window_totals(self.fast_window)
        slow = self._window_totals(self.slow_window)
        gauge = metrics.REGISTRY.gauge(
            BURN_GAUGE, "SLO burn rate (violation fraction / budget) "
                        "per objective clause and window")
        rows: List[dict] = []
        newly_tripped: List[dict] = []
        healthy = True
        for clause in self.clauses:
            burn_fast, n_fast = self._clause_burn(clause, fast)
            burn_slow, n_slow = self._clause_burn(clause, slow)
            gauge.set(burn_fast, objective=clause.text, window="fast")
            gauge.set(burn_slow, objective=clause.text, window="slow")
            tripped = (burn_fast >= self.trip_threshold
                       and burn_slow >= self.trip_threshold)
            if tripped:
                healthy = False
            row = dict(clause.to_dict(), burn_fast=round(burn_fast, 4),
                       burn_slow=round(burn_slow, 4),
                       samples_fast=n_fast, samples_slow=n_slow,
                       tripped=tripped)
            rows.append(row)
            if consume_edges:
                was = self._tripped.get(clause.text, False)
                self._tripped[clause.text] = tripped
                if tripped and not was:
                    metrics.REGISTRY.counter(
                        TRIP_COUNTER,
                        "Edge-triggered SLO burn-rate trips, "
                        "by objective").inc(1, objective=clause.text)
                    newly_tripped.append(row)
        return {
            "healthy": healthy,
            "objectives": rows,
            "newly_tripped": newly_tripped,
            "windows": {"fast_s": self.fast_window,
                        "slow_s": self.slow_window,
                        "slot_s": self.slot_seconds,
                        "trip_threshold": self.trip_threshold},
        }

    def status(self) -> dict:
        """The ``slo`` block for daemon ``status`` — a non-consuming
        :meth:`evaluate` verdict plus live window quantiles per verb."""
        verdict = self.evaluate()
        verdict.pop("newly_tripped", None)
        fast = self._window_totals(self.fast_window)
        verdict["window_quantiles"] = {
            verb: {
                "p50_ms": round(metrics.histogram_quantile(
                    self.buckets, agg["counts"], 0.50) * 1e3, 3),
                "p99_ms": round(metrics.histogram_quantile(
                    self.buckets, agg["counts"], 0.99) * 1e3, 3),
                "count": agg["count"],
                "errors": agg["errors"],
            }
            for verb, agg in sorted(fast.items())
        }
        return verdict

    def window_snapshot(self, window: str = "fast") -> Dict[str, dict]:
        """Per-verb aggregates for one window — the live-daemon source
        for ``semmerge perf record --daemon``."""
        window_s = (self.fast_window if window == "fast"
                    else self.slow_window)
        return self._window_totals(window_s)


def from_env(config_objectives: Optional[str] = None, *,
             config_fast_window: Optional[float] = None,
             config_slow_window: Optional[float] = None,
             clock=time.monotonic) -> Optional[SloEngine]:
    """Build the engine from ``SEMMERGE_SLO`` (env wins) or the
    ``[slo]`` config table's objective string; ``None`` when neither
    is set. Window env knobs override the config values."""
    spec = os.environ.get(ENV_OBJECTIVES, "").strip() \
        or (config_objectives or "").strip()
    if not spec:
        return None
    clauses = parse_objectives(spec)
    return SloEngine(
        clauses,
        fast_window=_env_float(
            ENV_FAST_WINDOW, config_fast_window or DEFAULT_FAST_WINDOW),
        slow_window=_env_float(
            ENV_SLOW_WINDOW, config_slow_window or DEFAULT_SLOW_WINDOW),
        slot_seconds=_env_float(ENV_SLOT, DEFAULT_SLOT),
        trip_threshold=_env_float(ENV_TRIP, DEFAULT_TRIP),
        clock=clock,
    )
