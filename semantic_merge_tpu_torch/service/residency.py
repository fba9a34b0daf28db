"""Warm snapshot residency: encoded-base reuse across daemon requests
(the port of the JAX package's ``service/residency.py``).

A merge daemon serving a repository sees the same *base* tree over and
over — every merge of a feature branch against ``main`` re-ships the
identical base snapshot, and re-pays ``scan_encode`` (and the h2d copy
of the decl columns) for it on every request.
This module keeps the encoded form *resident*: a process-global,
byte-bounded LRU keyed by ``(repo_root, tree_oid, scope_fp)`` mapping
to the encoded decl tensor, scanned nodes, and the decl-cache identity
under which the fused engine holds the device-resident columns. A hit
skips the scan and the encode entirely, and — because the identity is
reused — the engine's decl-column cache hit skips the h2d re-ship too;
only the changed (delta) side of the merge is encoded.

Keys are *content* addresses (a git tree oid names exact bytes), but
three things can silently invalidate a resident entry, and every
lookup revalidates against all of them:

- **interner reset** (``outcome="stale-interner"``): the backend's
  unbounded-growth guard replaced the process-shared interner
  (``backends/ts_torch.py``); every cached id is meaningless under the
  new token.
- **repo GC** (``outcome="stale-tree"``): the tree object is gone from
  the repository (``git cat-file -e`` fails), so nothing can verify
  the entry still describes reachable history — drop it rather than
  serve bytes no ref can reproduce.
- **epoch bump** (``outcome="stale-epoch"``): fleet failover handed
  this member a repo it may have served before under a different
  routing epoch; :func:`bump_epoch` invalidates every resident handle
  so the rehashed member re-encodes from the repository of record.

Posture (``SEMMERGE_RESIDENCY_CACHE``): ``auto`` (default — on inside
the merge service daemon, off in one-shot processes, where a
process-global cache would never see a second request), ``on``,
``off``. Budget: ``SEMMERGE_RESIDENCY_CACHE_MB`` (default 256) bounds
the host-side estimate of resident bytes; the daemon's RSS pressure
monitor additionally clears the cache at the hard watermark
(``reason="rss-hard"``), mirroring how it already drops the engine
decl cache (``service/resilience.py`` owns the watermark knobs).

Telemetry, as in the JAX package: ``snapshot_residency_hits_total{outcome}``,
``snapshot_residency_bytes`` gauge,
``snapshot_residency_evictions_total{reason}``, and the
``residency.hit`` / ``residency.encode_delta`` spans recorded at the
lookup seam in ``backends/ts_torch.py``.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from ..obs import metrics as obs_metrics

#: ``Snapshot.__dict__`` attribute carrying the residency key.
ATTR = "_semmerge_residency"

ENV_POSTURE = "SEMMERGE_RESIDENCY_CACHE"
ENV_BUDGET_MB = "SEMMERGE_RESIDENCY_CACHE_MB"
DEFAULT_BUDGET_MB = 256.0

_HITS_HELP = "Snapshot residency-cache lookups, by outcome"
_BYTES_HELP = "Host-side byte estimate of resident encoded snapshots"
_EVICTIONS_HELP = "Snapshot residency-cache evictions, by reason"

#: Per-node host estimate (scanned decl node + list slot) added to the
#: decl tensor's exact column bytes when budgeting an entry.
_NODE_COST = 160


def residency_enabled() -> bool:
    """``SEMMERGE_RESIDENCY_CACHE`` posture: ``on`` / ``off`` /
    ``auto`` (default — enabled only inside the daemon process)."""
    raw = os.environ.get(ENV_POSTURE, "auto").strip().lower()
    if raw in ("on", "1"):
        return True
    if raw in ("off", "0"):
        return False
    return bool(os.environ.get("_SEMMERGE_IN_DAEMON"))


def budget_bytes() -> int:
    raw = os.environ.get(ENV_BUDGET_MB, "").strip()
    try:
        mb = float(raw) if raw else DEFAULT_BUDGET_MB
    except ValueError:
        mb = DEFAULT_BUDGET_MB
    return max(0, int(mb * 1024 * 1024))


def scope_fingerprint(paths) -> str:
    """Stable fingerprint of an incremental-merge scope. The encoded
    base under a restricted scope is a different tensor than the full
    tree's, so the scope participates in the residency key."""
    if paths is None:
        return ""
    h = hashlib.sha1()
    for p in sorted(paths):
        h.update(p.encode("utf-8", "surrogatepass"))
        h.update(b"\0")
    return h.hexdigest()[:16]


def annotate(snapshot, repo_root: str, tree_oid: str, scope=None) -> None:
    """Attach a residency key to a snapshot object. ``repo_root`` may
    be ``""`` for synthetic snapshots (benches, tests) — the GC
    revalidation is skipped for those, everything else applies."""
    if not tree_oid:
        return
    snapshot.__dict__[ATTR] = (str(repo_root), str(tree_oid),
                               scope_fingerprint(scope))


def resident_key(snapshot) -> Optional[Tuple[str, str, str]]:
    key = snapshot.__dict__.get(ATTR)
    if (isinstance(key, tuple) and len(key) == 3
            and all(isinstance(p, str) for p in key)):
        return key
    return None


class _Entry:
    __slots__ = ("t", "nodes", "identity", "nbytes", "epoch")

    def __init__(self, t, nodes, identity, nbytes: int, epoch: int) -> None:
        self.t = t
        self.nodes = nodes
        self.identity = identity
        self.nbytes = nbytes
        self.epoch = epoch


def entry_nbytes(t, nodes) -> int:
    """Host-side byte estimate of one resident entry: the decl
    tensor's exact column bytes plus a flat per-node cost for the
    scanned node objects."""
    total = 0
    for col in (getattr(t, "sym", None), getattr(t, "addr", None),
                getattr(t, "name", None), getattr(t, "file", None)):
        nb = getattr(col, "nbytes", None)
        if nb is not None:
            total += int(nb)
    return total + _NODE_COST * len(nodes)


def _tree_exists(repo_root: str, tree_oid: str) -> bool:
    try:
        proc = subprocess.run(
            ["git", "-C", repo_root, "cat-file", "-e", tree_oid],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            timeout=10)
        return proc.returncode == 0
    except (OSError, subprocess.SubprocessError):
        return False


class ResidencyCache:
    """Byte-bounded LRU of encoded base snapshots. Thread-safe; every
    lookup outcome and eviction publishes its counter, and the byte
    gauge tracks the resident total."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[str, str, str], _Entry]" = \
            OrderedDict()
        self._bytes = 0
        self._epoch = 0
        self._lookups = 0
        self._hits = 0
        self._evictions: Dict[str, int] = {}

    # -- metrics ------------------------------------------------------------

    def _count(self, outcome: str) -> None:
        obs_metrics.REGISTRY.counter(
            "snapshot_residency_hits_total", _HITS_HELP).inc(
                1, outcome=outcome)

    def _publish_bytes(self) -> None:
        obs_metrics.REGISTRY.gauge(
            "snapshot_residency_bytes", _BYTES_HELP).set(self._bytes)

    def _evict(self, key, entry, reason: str) -> None:
        """Drop one entry. Caller holds the lock."""
        self._entries.pop(key, None)
        self._bytes -= entry.nbytes
        self._evictions[reason] = self._evictions.get(reason, 0) + 1
        obs_metrics.REGISTRY.counter(
            "snapshot_residency_evictions_total", _EVICTIONS_HELP).inc(
                1, reason=reason)
        self._publish_bytes()

    # -- cache protocol -----------------------------------------------------

    def lookup(self, key: Tuple[str, str, str], *,
               token) -> Optional[_Entry]:
        """The resident entry for ``key``, revalidated, or ``None``.
        ``token`` is the backend interner's current token; entries
        encoded under any other token are dead."""
        repo_root = key[0]
        with self._lock:
            self._lookups += 1
            entry = self._entries.get(key)
            if entry is None:
                self._count("miss")
                return None
            if entry.identity[0] != token:
                self._evict(key, entry, "stale")
                self._count("stale-interner")
                return None
            if entry.epoch != self._epoch:
                self._evict(key, entry, "stale")
                self._count("stale-epoch")
                return None
        # The GC probe shells out to git — never under the lock.
        if repo_root and not _tree_exists(repo_root, key[1]):
            with self._lock:
                cur = self._entries.get(key)
                if cur is entry:
                    self._evict(key, entry, "stale")
            self._count("stale-tree")
            return None
        with self._lock:
            if self._entries.get(key) is not entry:
                self._count("miss")
                return None
            self._entries.move_to_end(key)
            self._hits += 1
        self._count("hit")
        return entry

    def put(self, key: Tuple[str, str, str], t, nodes, identity) -> None:
        if identity is None:
            return
        nbytes = entry_nbytes(t, nodes)
        budget = budget_bytes()
        if nbytes > budget:
            return  # one entry over budget: never admit it
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                self._bytes -= old.nbytes
                del self._entries[key]
            self._entries[key] = _Entry(t, nodes, identity, nbytes,
                                        self._epoch)
            self._bytes += nbytes
            while self._bytes > budget and len(self._entries) > 1:
                victim_key, victim = next(iter(self._entries.items()))
                if victim_key == key:
                    break
                self._evict(victim_key, victim, "lru")
            self._publish_bytes()

    def clear(self, reason: str = "clear") -> int:
        """Drop every entry (RSS hard watermark, tests). Returns the
        number of entries dropped."""
        with self._lock:
            dropped = len(self._entries)
            for key in list(self._entries):
                self._evict(key, self._entries[key], reason)
            self._publish_bytes()
        return dropped

    def bump_epoch(self) -> None:
        """Invalidate every resident handle without dropping the
        byte accounting eagerly — entries lazily evict as
        ``stale-epoch`` on next lookup. Called on fleet failover
        rehash, where this member may hold handles for repos it last
        served under a different routing epoch."""
        with self._lock:
            self._epoch += 1

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """Status-endpoint block: entry count, resident bytes, hit
        rate over process lifetime, evictions by reason."""
        with self._lock:
            lookups = self._lookups
            return {
                "enabled": residency_enabled(),
                "entries": len(self._entries),
                "bytes": self._bytes,
                "budget_bytes": budget_bytes(),
                "lookups": lookups,
                "hits": self._hits,
                "hit_rate": (self._hits / lookups) if lookups else 0.0,
                "evictions": dict(self._evictions),
                "epoch": self._epoch,
            }

    def reset(self) -> None:
        """Tests only: drop entries AND lifetime counters."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._epoch = 0
            self._lookups = 0
            self._hits = 0
            self._evictions.clear()
            self._publish_bytes()


_CACHE = ResidencyCache()


def cache() -> ResidencyCache:
    return _CACHE
