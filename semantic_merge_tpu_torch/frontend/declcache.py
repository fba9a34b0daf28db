"""Per-file declaration cache.

The port's copy of the JAX package's ``frontend/declcache.py``: scan
results are cached per ``(path, content-hash, declared-set-hash)`` with
LRU eviction bounded by ``[core] memory_cap_mb``.

Why the declared-set hash is part of the key: the scanner resolves type
annotations against the set of type names declared anywhere in the
snapshot (the stand-in for the reference worker's no-default-lib
``ts.TypeChecker``, reference ``workers/ts/src/sast.ts:19-22``), so an
*unchanged* file's signatures can legitimately change when another file
adds or removes a type declaration. Keying on the global declared-set
hash keeps the cache exact, never heuristic: any snapshot that would
produce different decl nodes misses.

Within a single three-way merge the base/left/right snapshots share
almost every file, so only the files a side changed scan again. The
cache is process-wide (:func:`global_cache`) and always on: it changes
what is scanned, never what a scan returns. Its hit and miss counts are
cumulative; the backend records each call's share in its ``phases``.
"""
from __future__ import annotations

import functools
import hashlib
import os
import sys
import threading
from collections import OrderedDict
from typing import Any, Hashable, Optional

DEFAULT_CAP_MB = 512


class DeclCache:
    """LRU cache bounded by an approximate byte budget. Thread-safe: the
    merge service's concurrent requests scan through one cache."""

    def __init__(self, cap_mb: int = DEFAULT_CAP_MB) -> None:
        self.cap_bytes = cap_mb * 1024 * 1024
        self._store: "OrderedDict[Hashable, tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            entry = self._store.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._store.move_to_end(key)
            self.hits += 1
            return entry[0]

    def put(self, key: Hashable, value: Any, size: int | None = None) -> None:
        size = size if size is not None else approx_size(value)
        with self._lock:
            old = self._store.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._store[key] = (value, size)
            self._bytes += size
            while self._bytes > self.cap_bytes and len(self._store) > 1:
                _, (_, evicted_size) = self._store.popitem(last=False)
                self._bytes -= evicted_size
                self.evictions += 1

    def set_cap_mb(self, cap_mb: int) -> None:
        self.cap_bytes = cap_mb * 1024 * 1024

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self._bytes = 0

    def stats(self) -> dict:
        """The merge service's status block: lifetime counters, entries
        and bytes."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "entries": len(self._store),
                    "bytes": self._bytes}


def approx_size(value: Any) -> int:
    """Rough byte estimate for cap accounting — strings dominate.

    Deliberately flat (two levels, no recursion): cap accounting runs on
    every put and must not dominate a cold scan; the cached values are
    string collections and DeclNode lists, both covered exactly by the
    container → (string | attr-dict) shape."""
    if isinstance(value, str):
        return 49 + len(value)
    if isinstance(value, (list, tuple, frozenset, set)):
        total = 64
        for v in value:
            if isinstance(v, str):
                total += 49 + len(v)
                continue
            attrs = _attr_values(v)
            if attrs is not None:
                total += 80
                for a in attrs:
                    total += (49 + len(a)) if isinstance(a, str) else 24
            else:
                total += 24
        return total
    attrs = _attr_values(value)
    if attrs is not None:
        total = 80
        for a in attrs:
            total += (49 + len(a)) if isinstance(a, str) else 24
        return total
    return max(sys.getsizeof(value, 64), 16)


def _attr_values(v):
    """Attribute values of a record object, for size accounting —
    supports both ``__dict__``-backed and ``slots=True`` dataclasses
    (DeclNode is slotted: it is constructed ~90k times per 10k-file
    scan and slots measurably cheapen that)."""
    d = getattr(v, "__dict__", None)
    if d is not None:
        return d.values()
    names = _slot_names(type(v))
    if names:
        return [getattr(v, s, None) for s in names]
    return None


@functools.lru_cache(maxsize=None)
def _slot_names(klass) -> tuple:
    """All slot names of a type, inherited slots included — memoized:
    this runs once per *cached object* during size accounting (~90k
    DeclNodes per 10k-file cold scan)."""
    names: list = []
    for k in klass.__mro__:
        slots = k.__dict__.get("__slots__", ())
        names.extend((slots,) if isinstance(slots, str) else slots)
    return tuple(names)


def content_hash(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()[:32]


def declared_hash(declared) -> str:
    return hashlib.sha256("\n".join(sorted(declared)).encode("utf-8")).hexdigest()[:32]


_GLOBAL: Optional[DeclCache] = None


def enabled() -> bool:
    """Whether the process-wide cache is on: ``SEMMERGE_CACHE=0`` (or
    ``off``) turns it off, as in the JAX package."""
    return os.environ.get("SEMMERGE_CACHE", "1").strip().lower() not in ("0", "off")


def global_cache() -> Optional[DeclCache]:
    """The process-wide cache, or ``None`` when it is off
    (``SEMMERGE_CACHE=0``): every scan then parses every file, and the
    encode runs uncached."""
    global _GLOBAL
    if not enabled():
        return None
    if _GLOBAL is None:
        _GLOBAL = DeclCache()
    return _GLOBAL


def configure(memory_cap_mb: int) -> None:
    """Apply the ``[core] memory_cap_mb`` budget (the CLI calls this
    once config is loaded). Half the budget goes to the decl cache; the
    rest stays headroom for snapshots and device buffers."""
    cache = global_cache()
    if cache is not None:
        cache.set_cap_mb(max(1, memory_cap_mb // 2))


_PUBLISHED = {"hits": 0, "misses": 0, "evictions": 0}
_PUBLISH_METRICS = {"hits": "declcache_hits_total",
                    "misses": "declcache_misses_total",
                    "evictions": "declcache_evictions_total"}
_PUBLISH_HELP = {"hits": "Decl-cache lookups served from cache",
                 "misses": "Decl-cache lookups that re-scanned",
                 "evictions": "Decl-cache entries evicted by the byte cap"}


def publish_metrics() -> None:
    """Delta-sync the process-wide cache's counters into the metrics
    registry (``declcache_{hits,misses,evictions}_total``): one update
    per merge, at its end, instead of one per lookup. Safe when the
    cache was never touched."""
    cache = _GLOBAL
    if cache is None:
        return
    from ..obs import metrics as obs_metrics
    for name, metric in _PUBLISH_METRICS.items():
        current = getattr(cache, name)
        delta = current - _PUBLISHED[name]
        if delta > 0:
            obs_metrics.REGISTRY.counter(metric, _PUBLISH_HELP[name]).inc(delta)
        _PUBLISHED[name] = current
