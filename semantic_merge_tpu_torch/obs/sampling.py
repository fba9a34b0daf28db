"""Fleet-consistent tail-based trace sampling + byte-budgeted stores
(the port of the JAX package's ``obs/sampling.py``).

Recording a full span tree for every request and writing every trace to
disk is dev-tool behavior that becomes the outage at production QPS. This module turns retention into a *decision*:

- every trace buffers in the existing flight-ring/recorder machinery
  until its terminal outcome;
- at that point :class:`SamplingPolicy` mints ONE keep/drop verdict —
  keep when the request was slow (rolling p99 estimate per verb),
  errored / degraded / breaker-tripped / resolver-engaged, or when the
  trace id falls in the deterministic 1-in-N head sample;
- the verdict travels in wire ``meta["sampling"]`` so router, member
  daemon, and subprocess worker agree about the same trace id — a
  downstream hop may *upgrade* drop→keep for outcomes only it can see
  (a failover, a transport fault), never downgrade;
- kept artifacts land in a :class:`TraceStore`, a byte-budgeted
  rotating directory that prunes oldest-first while protecting
  errored/degraded traces until nothing else is left to evict.

Head sampling is a hash of the trace id, not a coin flip, which is what
makes fleet consistency free: any process holding the same id computes
the same verdict with no coordination.

Knobs:

- ``SEMMERGE_TRACE_SAMPLE`` — head-sample rate ``N`` (keep ~1 in N of
  otherwise-uninteresting traces). Setting it (or the budget) enables
  sampling; unset, the policy keeps everything (``reason="always"``) —
  the pre-existing dev behavior every tier-1 test relies on. ``0``
  means *no* head sample: tails only.
- ``SEMMERGE_TRACE_BUDGET_MB`` — artifact-store byte budget (default
  256 MB once a store exists).
- ``SEMMERGE_TRACE_KEEP`` — artifact-store count cap (default 4096).
- ``SEMMERGE_TRACE_DIR`` — standalone-daemon sampled-trace directory
  (the fleet router keeps ``SEMMERGE_FLEET_TRACE_DIR``).

Import cost stays stdlib-only (the :mod:`obs` package contract).
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import metrics

ENV_SAMPLE = "SEMMERGE_TRACE_SAMPLE"
ENV_BUDGET_MB = "SEMMERGE_TRACE_BUDGET_MB"
ENV_KEEP = "SEMMERGE_TRACE_KEEP"
ENV_TRACE_DIR = "SEMMERGE_TRACE_DIR"

#: ``meta`` key the minted decision travels under on the wire.
META_KEY = "sampling"

#: Keep reasons, most- to least-interesting. ``always`` is the
#: sampling-disabled passthrough; ``sampled-out`` is the drop verdict.
KEEP_REASONS = ("error", "degraded", "breaker", "resolver", "slow",
                "head", "always")
DROP_REASON = "sampled-out"

#: Reasons the store refuses to evict while anything else remains.
PROTECTED_REASONS = frozenset(("error", "degraded", "breaker",
                               "resolver"))

DEFAULT_BUDGET_MB = 256.0
DEFAULT_KEEP = 4096
#: Observations per verb before the rolling p99 can call anything slow.
MIN_SLOW_SAMPLES = 30
#: Rolling-estimate window per verb.
P99_WINDOW = 512


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(float(raw))
    except ValueError:
        return default


def head_keep(trace_id: str, sample_n: int) -> bool:
    """Deterministic 1-in-N head sample: every process holding the same
    trace id reaches the same verdict with zero coordination. ``n <= 0``
    keeps nothing (tails only); ``n == 1`` keeps everything."""
    if sample_n <= 0:
        return False
    if sample_n == 1:
        return True
    digest = hashlib.sha256(str(trace_id).encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") % sample_n == 0


class Decision:
    """One minted keep/drop verdict. Immutable by convention — the only
    legal mutation across hops is :meth:`upgrade` (drop→keep)."""

    __slots__ = ("keep", "reason", "minted_by", "sample_n")

    def __init__(self, keep: bool, reason: str, *,
                 minted_by: str = "local",
                 sample_n: int = 0) -> None:
        self.keep = bool(keep)
        self.reason = str(reason)
        self.minted_by = str(minted_by)
        self.sample_n = int(sample_n)

    def to_meta(self) -> Dict[str, Any]:
        return {"keep": self.keep, "reason": self.reason,
                "minted_by": self.minted_by, "sample_n": self.sample_n}

    @classmethod
    def from_meta(cls, meta: Any) -> Optional["Decision"]:
        if not isinstance(meta, dict) or "keep" not in meta:
            return None
        return cls(bool(meta.get("keep")),
                   str(meta.get("reason") or DROP_REASON),
                   minted_by=str(meta.get("minted_by") or "unknown"),
                   sample_n=int(meta.get("sample_n") or 0))

    def upgrade(self, other: Optional["Decision"]) -> "Decision":
        """Merge with a later hop's local verdict: keep wins, the
        earliest minted keep's reason sticks, drop never overrides."""
        if other is None or self.keep or not other.keep:
            return self
        return other

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Decision(keep={self.keep}, reason={self.reason!r}, "
                f"minted_by={self.minted_by!r})")


class SamplingPolicy:
    """Tail-based sampling policy: terminal-outcome criteria + rolling
    per-verb p99 slowness + deterministic head sample.

    Thread-safe; one instance per daemon/router process. When neither
    ``SEMMERGE_TRACE_SAMPLE`` nor ``SEMMERGE_TRACE_BUDGET_MB`` is set
    the policy is *disabled* and every decision is ``keep/always`` —
    the historical write-everything behavior."""

    def __init__(self, sample_n: Optional[int] = None,
                 minted_by: str = "local") -> None:
        env_n = _env_int(ENV_SAMPLE, None)
        self.enabled = (sample_n is not None or env_n is not None
                        or bool(os.environ.get(ENV_BUDGET_MB, "").strip()))
        self.sample_n = sample_n if sample_n is not None else (
            env_n if env_n is not None else 0)
        self.minted_by = minted_by
        self._lock = threading.Lock()
        self._windows: Dict[str, deque] = {}
        self._decisions: Dict[str, int] = {}

    # -- rolling p99 ----------------------------------------------------
    def _p99(self, verb: str) -> Optional[float]:
        win = self._windows.get(verb)
        if win is None or len(win) < MIN_SLOW_SAMPLES:
            return None
        ordered = sorted(win)
        return ordered[min(len(ordered) - 1,
                           int(0.99 * len(ordered)))]

    def p99(self, verb: str) -> Optional[float]:
        with self._lock:
            return self._p99(verb)

    def observe(self, verb: str, seconds: float) -> None:
        with self._lock:
            win = self._windows.get(verb)
            if win is None:
                win = self._windows[verb] = deque(maxlen=P99_WINDOW)
            win.append(float(seconds))

    # -- the verdict ----------------------------------------------------
    def decide(self, trace_id: str, verb: str, seconds: float, *,
               error: bool = False, degraded: bool = False,
               breaker: bool = False, resolver: bool = False) -> Decision:
        """Mint the terminal verdict for one trace, then absorb its
        latency into the rolling estimate (so a burst of slow requests
        is judged against the regime *before* the burst)."""
        if not self.enabled:
            decision = Decision(True, "always", minted_by=self.minted_by,
                                sample_n=self.sample_n)
        elif error:
            decision = Decision(True, "error", minted_by=self.minted_by,
                                sample_n=self.sample_n)
        elif degraded:
            decision = Decision(True, "degraded",
                                minted_by=self.minted_by,
                                sample_n=self.sample_n)
        elif breaker:
            decision = Decision(True, "breaker", minted_by=self.minted_by,
                                sample_n=self.sample_n)
        elif resolver:
            decision = Decision(True, "resolver",
                                minted_by=self.minted_by,
                                sample_n=self.sample_n)
        else:
            with self._lock:
                p99 = self._p99(verb)
            if p99 is not None and seconds >= p99:
                decision = Decision(True, "slow", minted_by=self.minted_by,
                                    sample_n=self.sample_n)
            elif head_keep(trace_id, self.sample_n):
                decision = Decision(True, "head", minted_by=self.minted_by,
                                    sample_n=self.sample_n)
            else:
                decision = Decision(False, DROP_REASON,
                                    minted_by=self.minted_by,
                                    sample_n=self.sample_n)
        self.observe(verb, seconds)
        with self._lock:
            self._decisions[decision.reason] = \
                self._decisions.get(decision.reason, 0) + 1
        metrics.REGISTRY.counter(
            "trace_sampling_decisions_total",
            "Tail-sampling verdicts minted, by decision/reason").inc(
                1, decision="keep" if decision.keep else "drop",
                reason=decision.reason)
        return decision

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "sample_n": self.sample_n,
                "decisions": dict(self._decisions),
                "p99_ms": {
                    verb: round(1000.0 * p, 3)
                    for verb in self._windows
                    for p in (self._p99(verb),) if p is not None},
            }


# ---------------------------------------------------------------------------
# Bounded artifact directories.

def prune_dir(directory: pathlib.Path | str, *,
              max_count: Optional[int] = None,
              max_bytes: Optional[int] = None,
              pattern: str = "*.json",
              protect=None,
              counter: Optional[str] = None,
              **counter_labels: object) -> int:
    """Oldest-first pruning of an artifact directory down to count/byte
    caps. ``protect(path)`` may veto an eviction; protected files go
    only once every unprotected candidate is gone and the caps are
    still blown. Returns the number of files removed; never raises
    (retention must not add a failure to the path that triggered it)."""
    try:
        root = pathlib.Path(directory)
        entries: List[Tuple[float, int, pathlib.Path]] = []
        for path in root.glob(pattern):
            try:
                st = path.stat()
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, path))
        entries.sort()
        total = sum(size for _, size, _ in entries)
        count = len(entries)

        def over() -> bool:
            return ((max_count is not None and count > max_count)
                    or (max_bytes is not None and total > max_bytes))

        pruned = 0
        for pass_protected in (False, True):
            if not over():
                break
            for mtime, size, path in list(entries):
                if not over():
                    break
                if not pass_protected and protect is not None:
                    try:
                        if protect(path):
                            continue
                    except Exception:
                        continue
                try:
                    path.unlink()
                except OSError:
                    continue
                entries.remove((mtime, size, path))
                total -= size
                count -= 1
                pruned += 1
        if pruned and counter:
            metrics.REGISTRY.counter(counter).inc(pruned, **counter_labels)
        return pruned
    except Exception:
        return 0


class TraceStore:
    """Byte-budgeted rotating trace-artifact directory.

    Filenames stay ``<trace_id>.json`` (the shape every existing reader
    — ``trace analyze``, the fleet tests, OTLP re-export — globs for);
    protection is read from the artifact's embedded ``sampling`` block.
    Writes are atomic (tmp + rename) and pruning runs after each write,
    unprotected-oldest first, so the directory converges under the
    budget even across process restarts."""

    def __init__(self, directory: pathlib.Path | str,
                 budget_mb: Optional[float] = None,
                 max_count: Optional[int] = None) -> None:
        self.root = pathlib.Path(directory)
        self.budget_bytes = int(
            (budget_mb if budget_mb is not None
             else _env_float(ENV_BUDGET_MB, DEFAULT_BUDGET_MB)) * 1024 * 1024)
        self.max_count = (max_count if max_count is not None
                          else (_env_int(ENV_KEEP, DEFAULT_KEEP)
                                or DEFAULT_KEEP))
        self._lock = threading.Lock()
        # name -> protected? (None = unknown, read lazily at prune time
        # for files that predate this process).
        self._protected: Dict[str, Optional[bool]] = {}

    @classmethod
    def from_env(cls, env: str = ENV_TRACE_DIR) -> Optional["TraceStore"]:
        raw = os.environ.get(env, "").strip()
        return cls(raw) if raw else None

    @staticmethod
    def safe_name(trace_id: str) -> str:
        return "".join(ch if ch.isalnum() or ch in "._-" else "-"
                       for ch in str(trace_id))[:80] or "unknown"

    def path_for(self, trace_id: str) -> pathlib.Path:
        return self.root / f"{self.safe_name(trace_id)}.json"

    def _is_protected(self, path: pathlib.Path) -> bool:
        cached = self._protected.get(path.name)
        if cached is not None:
            return cached
        try:
            data = json.loads(path.read_text(encoding="utf-8"))
            reason = (data.get(META_KEY) or {}).get("reason")
            protected = reason in PROTECTED_REASONS
        except Exception:
            protected = False
        self._protected[path.name] = protected
        return protected

    def write(self, trace_id: str, payload: Dict[str, Any], *,
              decision: Optional[Decision] = None) -> Optional[pathlib.Path]:
        """Persist one kept trace (embedding the verdict under
        ``sampling``), then enforce the caps. Returns the artifact path
        or ``None`` on any failure — persistence is diagnostics, it
        must never fail the request it describes."""
        try:
            path = self.path_for(trace_id)
            body = dict(payload)
            if decision is not None and META_KEY not in body:
                body[META_KEY] = decision.to_meta()
            self.root.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".tmp")
            tmp.write_text(json.dumps(body, indent=2, default=str),
                           encoding="utf-8")
            os.replace(tmp, path)
            with self._lock:
                reason = (body.get(META_KEY) or {}).get("reason") \
                    if isinstance(body.get(META_KEY), dict) else None
                self._protected[path.name] = reason in PROTECTED_REASONS
                self._prune_locked()
            return path
        except Exception:
            return None

    def prune(self) -> int:
        with self._lock:
            return self._prune_locked()

    def _prune_locked(self) -> int:
        pruned = prune_dir(
            self.root, max_count=self.max_count,
            max_bytes=self.budget_bytes, protect=self._is_protected,
            counter="trace_store_pruned_total",
            store=str(self.root.name))
        if pruned:
            live = {p.name for p in self.root.glob("*.json")}
            for name in list(self._protected):
                if name not in live:
                    del self._protected[name]
        return pruned

    def total_bytes(self) -> int:
        total = 0
        for path in self.root.glob("*.json"):
            try:
                total += path.stat().st_size
            except OSError:
                continue
        return total

    def count(self) -> int:
        return sum(1 for _ in self.root.glob("*.json"))

    def stats(self) -> Dict[str, Any]:
        return {"dir": str(self.root), "count": self.count(),
                "bytes": self.total_bytes(),
                "budget_bytes": self.budget_bytes,
                "max_count": self.max_count}


# ---------------------------------------------------------------------------
# Span-derived outcome flags — shared by daemon and router so both ends
# classify "degraded / resolver-engaged" identically.

def outcome_flags(rows: List[dict]) -> Dict[str, bool]:
    """Scan completed span rows for the tail-keep outcome criteria."""
    degraded = False
    resolver = False
    breaker = False
    error = False
    for row in rows:
        name = str(row.get("name") or "")
        if row.get("status") == "error":
            error = True
        if name == "degradation" or name.startswith("degrade"):
            degraded = True
        if name.startswith("resolution.") or name.startswith("resolver"):
            resolver = True
        meta = row.get("meta")
        if isinstance(meta, dict) and meta.get("breaker") not in (
                None, "closed"):
            breaker = True
    return {"error": error, "degraded": degraded,
            "breaker": breaker, "resolver": resolver}
