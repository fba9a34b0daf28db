"""Service-resilience primitives: per-rung circuit breakers and the
RSS watermark knobs the daemon's load shedding reads (the port of the
JAX package's ``service/resilience.py``).

The degradation ladder (``cli._merge_ladder``) contains one request's
fault: a broken rung costs that request a full attempt before the
ladder moves down. Under sustained failure every request re-pays that
cost. The circuit breaker amortizes it: after
``SEMMERGE_BREAKER_THRESHOLD`` failures inside a
``SEMMERGE_BREAKER_WINDOW``-second window the rung's breaker *opens*
and the ladder skips the rung immediately (recorded as a degradation
with ``cause="breaker-open"``); after ``SEMMERGE_BREAKER_COOLDOWN``
seconds one probe request is let through (*half-open*) — success closes
the breaker and restores the rung, failure re-opens it.

States are published as the ``breaker_state`` gauge per rung
(0 = closed, 1 = open, 2 = half-open) and every transition increments
``breaker_transitions_total{rung,to}``, as in the JAX package.

The port's ladder has one semantic rung (``torch``) above the text
rung, and a device fault never degrades; so only the faults that do
degrade feed the ``torch`` breaker (``cli._merge_ladder``): a breaker
opened by device faults would hide the device behind the text rung.

Posture (``SEMMERGE_BREAKER``): ``auto`` (default — on inside the
merge service daemon, off in one-shot processes, where cross-request
state would leak between unrelated invocations of an embedding test
or library caller), ``on``, ``off``. The breaker board is
process-global like the ladder's backends; the daemon is the process
whose requests share fate.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional

from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs import spans as obs_spans

#: ``breaker_state`` gauge values, by state name.
STATE_VALUES = {"closed": 0, "open": 1, "half-open": 2}

_STATE_HELP = "Circuit-breaker state per ladder rung (0 closed, 1 open, 2 half-open)"
_TRANSITIONS_HELP = "Circuit-breaker state transitions, by rung and target state"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def breaker_enabled() -> bool:
    """``SEMMERGE_BREAKER`` posture: ``on`` / ``off`` / ``auto``
    (default — enabled only inside the daemon process)."""
    raw = os.environ.get("SEMMERGE_BREAKER", "auto").strip().lower()
    if raw in ("on", "1"):
        return True
    if raw in ("off", "0"):
        return False
    return bool(os.environ.get("_SEMMERGE_IN_DAEMON"))


def rss_watermarks() -> tuple:
    """``(soft_mb, hard_mb)`` memory watermarks for the daemon's load
    shedding; 0 disables a watermark."""
    return (_env_float("SEMMERGE_RSS_SOFT_MB", 0.0),
            _env_float("SEMMERGE_RSS_HARD_MB", 0.0))


class CircuitBreaker:
    """One rung's breaker. Thread-safe; every state change publishes
    the gauge and the transition counter."""

    def __init__(self, rung: str, *, window_s: Optional[float] = None,
                 threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None) -> None:
        self.rung = rung
        self.window_s = window_s if window_s is not None else \
            _env_float("SEMMERGE_BREAKER_WINDOW", 30.0)
        self.threshold = max(1, int(threshold if threshold is not None else
                                    _env_float("SEMMERGE_BREAKER_THRESHOLD",
                                               3.0)))
        self.cooldown_s = cooldown_s if cooldown_s is not None else \
            _env_float("SEMMERGE_BREAKER_COOLDOWN", 5.0)
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures: Deque[float] = deque()
        self._opened_at = 0.0
        self._probing = False
        self._pending_dumps: list = []
        self._publish_state()

    # -- state machine ------------------------------------------------------

    def _publish_state(self) -> None:
        obs_metrics.REGISTRY.gauge("breaker_state", _STATE_HELP).set(
            STATE_VALUES[self._state], rung=self.rung)

    def _transition(self, to: str) -> None:
        if to == self._state:
            return
        self._state = to
        self._publish_state()
        obs_metrics.REGISTRY.counter(
            "breaker_transitions_total", _TRANSITIONS_HELP).inc(
                1, rung=self.rung, to=to)
        # Postmortem evidence for every transition — queued here (we
        # hold self._lock; dumping snapshots every breaker's state,
        # which re-enters locks) and flushed by the public methods
        # after the lock is released.
        self._pending_dumps.append(to)

    def _flush_dumps(self) -> None:
        """Write queued transition bundles. Called WITHOUT the lock."""
        while True:
            with self._lock:
                if not self._pending_dumps:
                    return
                to = self._pending_dumps.pop(0)
            from ..utils import workdir
            obs_flight.dump(
                obs_spans.trace_id(), "breaker-transition",
                breakers=breakers().snapshot(), root=workdir.root(),
                extra={"breaker": {"rung": self.rung, "to": to}})

    def allow(self) -> bool:
        """May the ladder attempt this rung now? Open breakers refuse;
        a cooled-down open breaker admits exactly one half-open probe
        at a time."""
        now = time.monotonic()
        try:
            with self._lock:
                if self._state == "closed":
                    return True
                if self._state == "open":
                    if now - self._opened_at < self.cooldown_s:
                        return False
                    self._transition("half-open")
                    self._probing = True
                    return True
                # half-open: one probe in flight at a time.
                if self._probing:
                    return False
                self._probing = True
                return True
        finally:
            self._flush_dumps()

    def record_success(self) -> None:
        with self._lock:
            self._failures.clear()
            self._probing = False
            self._transition("closed")
        self._flush_dumps()

    def record_failure(self) -> None:
        now = time.monotonic()
        with self._lock:
            if self._state == "half-open":
                # The probe failed: back to open, restart the cooldown.
                self._probing = False
                self._opened_at = now
                self._transition("open")
            else:
                self._failures.append(now)
                cutoff = now - self.window_s
                while self._failures and self._failures[0] < cutoff:
                    self._failures.popleft()
                if len(self._failures) >= self.threshold:
                    self._opened_at = now
                    self._transition("open")
        self._flush_dumps()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state


class BreakerBoard:
    """The process-global registry of per-rung breakers. All methods
    are no-ops (``allow`` always ``True``) when the posture is off, so
    the ladder's call sites stay unconditional."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def _get(self, rung: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(rung)
            if br is None:
                br = self._breakers[rung] = CircuitBreaker(rung)
            return br

    def allow(self, rung: str) -> bool:
        if not breaker_enabled():
            return True
        return self._get(rung).allow()

    def record_success(self, rung: str) -> None:
        if breaker_enabled():
            self._get(rung).record_success()

    def record_failure(self, rung: str) -> None:
        if breaker_enabled():
            self._get(rung).record_failure()

    def snapshot(self) -> Dict[str, str]:
        """Rung → state name, for the daemon status endpoint."""
        with self._lock:
            return {rung: br.state for rung, br in self._breakers.items()}

    def reset(self) -> None:
        """Drop all breaker state (tests; daemon never calls this)."""
        with self._lock:
            self._breakers.clear()


_BOARD = BreakerBoard()


def breakers() -> BreakerBoard:
    return _BOARD
