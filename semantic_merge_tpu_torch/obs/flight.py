"""Always-on fault flight recorder — a bounded per-process ring of the
most recent span observations, dumped as a postmortem bundle when
something goes wrong (a copy of the JAX package's ``obs/flight.py``,
stdlib only).

Every ``span()``/``record()`` completion of
:mod:`semantic_merge_tpu_torch.obs.spans` appends one small dict to the
ring, with or without a recorder, so a fault in an untraced run still
leaves span-level evidence. :func:`dump` serializes the ring plus the
fault chain, breaker states, the metrics registry and an environment
fingerprint into ``.semmerge-postmortem/<trace_id>.json`` when a
``MergeFault`` escapes the ladder (``fault-escape``) or moves it down a
rung (``degradation``). ``scripts/check_trace_schema.py
validate_postmortem`` pins the bundle's shape.

Knobs:

- ``SEMMERGE_FLIGHT_SPANS`` — ring capacity (default 512; ``0``
  disables capture, bundles then carry an empty ``spans`` array).
- ``SEMMERGE_POSTMORTEM_DIR`` — override the bundle directory (the
  default is ``.semmerge-postmortem/`` under the caller-provided root,
  typically the merge repo's work tree).
- ``SEMMERGE_POSTMORTEM_KEEP`` / ``SEMMERGE_POSTMORTEM_BUDGET_MB`` —
  retention caps on the bundle directory (default 64 bundles / 64 MB;
  ``0`` disables a cap): every dump prunes oldest-first past either cap
  and counts the evictions in ``postmortem_pruned_total``.
"""
from __future__ import annotations

import json
import os
import pathlib
import platform
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import metrics

#: Ring-capacity env knob (number of retained span observations).
ENV_RING = "SEMMERGE_FLIGHT_SPANS"
#: Bundle directory override (absolute path wins over ``root``).
ENV_DIR = "SEMMERGE_POSTMORTEM_DIR"
#: Default ring capacity.
DEFAULT_RING = 512
#: Bundle directory name (relative to the dump root).
POSTMORTEM_DIR = ".semmerge-postmortem"
#: Bundle schema version (``scripts/check_trace_schema.py
#: validate_postmortem`` pins the shape).
POSTMORTEM_SCHEMA = 1

#: Retention caps for the bundle directory.
ENV_KEEP = "SEMMERGE_POSTMORTEM_KEEP"
ENV_BUDGET_MB = "SEMMERGE_POSTMORTEM_BUDGET_MB"
DEFAULT_KEEP = 64
DEFAULT_BUDGET_MB = 64.0

_lock = threading.Lock()
_ring: Optional[deque] = None
_ring_capacity: Optional[int] = None
_epoch = time.perf_counter()


def ring_capacity() -> int:
    """Configured ring size (``SEMMERGE_FLIGHT_SPANS``, default 512)."""
    raw = os.environ.get(ENV_RING, "").strip()
    if not raw:
        return DEFAULT_RING
    try:
        return max(0, int(float(raw)))
    except ValueError:
        return DEFAULT_RING


def reset() -> None:
    """Drop the ring and re-read the capacity env (tests)."""
    global _ring, _ring_capacity
    with _lock:
        _ring = None
        _ring_capacity = None


def _get_ring() -> Optional[deque]:
    global _ring, _ring_capacity
    if _ring_capacity is None:
        with _lock:
            if _ring_capacity is None:
                _ring_capacity = ring_capacity()
                _ring = deque(maxlen=_ring_capacity) if _ring_capacity \
                    else None
    return _ring


def note(name: str, seconds: float, *, layer: Optional[str] = None,
         status: str = "ok", error: Optional[str] = None,
         trace_id: Optional[str] = None,
         meta: Optional[Dict[str, Any]] = None) -> None:
    """Append one span observation to the ring. Called by
    ``obs.spans`` for every completed span/record — with or without an
    active recorder — so keep this cheap and never let it raise."""
    ring = _get_ring()
    if ring is None:
        return
    row = {
        "name": name,
        "t": round(time.perf_counter() - _epoch, 6),
        "seconds": round(seconds, 6),
        "layer": layer,
        "status": status,
        "error": error,
        "trace_id": trace_id,
        "thread": threading.current_thread().name,
        "meta": dict(meta) if meta else {},
    }
    with _lock:
        ring.append(row)


def snapshot() -> List[dict]:
    """The retained observations, oldest first."""
    ring = _get_ring()
    if ring is None:
        return []
    with _lock:
        return list(ring)


def _fault_payload(fault: Optional[BaseException]) -> Optional[dict]:
    if fault is None:
        return None
    return {
        "type": type(fault).__name__,
        "message": str(fault),
        "stage": getattr(fault, "stage", None),
        "cause": getattr(fault, "cause", None),
        "exit_code": getattr(fault, "exit_code", None),
    }


def _fault_chain(fault: Optional[BaseException]) -> List[str]:
    chain: List[str] = []
    seen = set()
    exc = fault
    while exc is not None and id(exc) not in seen and len(chain) < 16:
        seen.add(id(exc))
        chain.append(f"{type(exc).__name__}: {exc}")
        exc = exc.__cause__ or exc.__context__
    return chain


def _env_fingerprint() -> dict:
    return {
        "pid": os.getpid(),
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "argv": list(sys.argv[:6]),
        "env": {k: v for k, v in sorted(os.environ.items())
                if k.startswith("SEMMERGE_") or k == "_SEMMERGE_IN_DAEMON"},
    }


def default_trace_id() -> str:
    """A local id for dumps that happen outside any request scope
    (one-shot CLI runs)."""
    return f"local-{os.getpid():x}-{os.urandom(4).hex()}"


def dump(trace_id: Optional[str], reason: str, *,
         fault: Optional[BaseException] = None,
         breakers: Optional[Dict[str, str]] = None,
         root: Optional[pathlib.Path | str] = None,
         extra: Optional[Dict[str, Any]] = None) -> Optional[pathlib.Path]:
    """Write a postmortem bundle; return its path, or ``None`` when the
    bundle cannot be written (dumping must never add a second failure
    to the one being recorded)."""
    tid = trace_id or default_trace_id()
    safe = "".join(ch if ch.isalnum() or ch in "._-" else "-"
                   for ch in str(tid))[:80] or "unknown"
    try:
        override = os.environ.get(ENV_DIR, "").strip()
        if override:
            out_dir = pathlib.Path(override)
        else:
            out_dir = pathlib.Path(root) / POSTMORTEM_DIR if root \
                else pathlib.Path.cwd() / POSTMORTEM_DIR
        out_dir.mkdir(parents=True, exist_ok=True)
        bundle = {
            "schema": POSTMORTEM_SCHEMA,
            "trace_id": str(tid),
            "reason": reason,
            "ts": round(time.time(), 3),
            "spans": snapshot(),
            "fault": _fault_payload(fault),
            "fault_chain": _fault_chain(fault),
            "breakers": dict(breakers) if breakers else {},
            "metrics": metrics.REGISTRY.to_dict(),
            "env": _env_fingerprint(),
        }
        if extra:
            bundle.update(extra)
        path = out_dir / f"{safe}.json"
        path.write_text(json.dumps(bundle, indent=2, default=str),
                        encoding="utf-8")
        metrics.REGISTRY.counter(
            "postmortem_bundles_total",
            "Postmortem flight-recorder bundles written, by reason").inc(
                1, reason=reason)
        _prune_bundles(out_dir)
        return path
    except Exception:
        return None


def _cap(env: str, default: float) -> Optional[float]:
    """Parse a retention cap; ``0`` (or negative) disables it."""
    raw = os.environ.get(env, "").strip()
    try:
        value = float(raw) if raw else default
    except ValueError:
        value = default
    return value if value > 0 else None


def _prune_bundles(out_dir: pathlib.Path) -> int:
    """Enforce the bundle-directory retention caps: remove the oldest
    bundles (by mtime) until both caps hold, count the evictions in
    ``postmortem_pruned_total{dir}`` and return how many went (the JAX
    package's ``sampling.prune_dir`` without its veto hook). Never
    raises: retention must not add a failure to the path that triggered
    it."""
    keep = _cap(ENV_KEEP, DEFAULT_KEEP)
    budget = _cap(ENV_BUDGET_MB, DEFAULT_BUDGET_MB)
    max_count = int(keep) if keep is not None else None
    max_bytes = int(budget * 1024 * 1024) if budget is not None else None
    try:
        entries = []
        for path in out_dir.glob("*.json"):
            try:
                st = path.stat()
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, path))
        entries.sort()
        total = sum(size for _, size, _ in entries)
        count = len(entries)
        pruned = 0
        for _mtime, size, path in entries:
            if not ((max_count is not None and count > max_count)
                    or (max_bytes is not None and total > max_bytes)):
                break
            try:
                path.unlink()
            except OSError:
                continue
            total -= size
            count -= 1
            pruned += 1
        if pruned:
            metrics.REGISTRY.counter("postmortem_pruned_total").inc(
                pruned, dir=str(out_dir.name))
        return pruned
    except Exception:
        return 0
