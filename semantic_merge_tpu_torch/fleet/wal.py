"""Per-router dispatch WAL — durable in-flight requests (the JAX
package's ``fleet/wal.py``, with the same on-disk records, so each
package reads the other's journal).

The router journals every merge request *before* dispatching it to a
member and acknowledges it after the response is written back toward
the client. That turns two crash windows into retries instead of
losses:

- **member crash mid-request** — the dispatching thread sees the
  transport failure and retries on the rehashed owner; the entry just
  stays open a little longer;
- **router crash** — on restart the router replays every journaled
  entry without an ack to the entry's current owner.

Exactly-once *effects* come from the layers below: every journaled
request carries an idempotency key (the router mints one when the
client sent none), so a member that already executed it replays its
cached response, and a re-executed ``--inplace`` merge is safe under
the in-place journal and the repo lockfile. The WAL guarantees
at-least-once dispatch with stable keys.

Format: one append-only JSONL file (``wal.jsonl``) in the router's WAL
directory (default ``<socket>.semmerge-fleet-wal/``, next to the port's
router socket). Records:

- ``{"kind": "request", "key", "verb", "params", "trace_id", "t"}`` —
  fsync'd before the first dispatch; ``params`` is the full wire params
  dict, so replay needs no other source;
- ``{"kind": "dispatch", "key", "member", "t"}`` — one per attempt
  (audit trail; not fsync'd);
- ``{"kind": "ack", "key", "t"}`` — the entry is settled.

A torn tail (SIGKILL mid-append) is skipped by the reader, which can
only lose the *last* record: a lost ``request`` was never dispatched, a
lost ``ack`` costs one idempotent replay. :meth:`WriteAheadLog.open`
archives the previous incarnation's file as ``wal.<n>.jsonl`` and
carries its open entries into a fresh ``wal.jsonl``; the newest
:data:`KEEP_SEGMENTS` segments are kept for the audit
(:func:`read_records`).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

#: Journal directory name suffix (appended to the router socket path).
WAL_DIRNAME = ".semmerge-fleet-wal"
#: Journal file inside the WAL directory.
WAL_FILE = "wal.jsonl"
#: Documented record kinds.
RECORD_KINDS = ("request", "dispatch", "ack")
#: Archived segments kept after an open/compact cycle.
KEEP_SEGMENTS = 16


def default_dir(socket_path: str) -> str:
    """The per-router WAL directory for a router socket path."""
    return socket_path + WAL_DIRNAME


def _segment_numbers(directory: str) -> List[int]:
    nums = []
    for name in os.listdir(directory):
        if name.startswith("wal.") and name.endswith(".jsonl"):
            mid = name[len("wal."):-len(".jsonl")]
            if mid.isdigit():
                nums.append(int(mid))
    return nums


def _records(path: str) -> List[Dict[str, Any]]:
    """The decodable object records of one journal file (torn or
    undecodable lines skipped; an unreadable file has none)."""
    try:
        fh = open(path, "r", encoding="utf-8")
    except OSError:
        return []
    out = []
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail from a SIGKILL mid-append
            if isinstance(rec, dict):
                out.append(rec)
    return out


class WriteAheadLog:
    """Append-only dispatch journal, fsync'd on ``request`` records.
    Thread-safe: the router's connection threads append under one
    lock."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        self.path = os.path.join(directory, WAL_FILE)
        self._lock = threading.Lock()
        self._fh: Optional[Any] = None
        self._open_keys: Dict[str, Dict[str, Any]] = {}
        self.replayable: List[Dict[str, Any]] = []

    # -- lifecycle ---------------------------------------------------

    def open(self) -> List[Dict[str, Any]]:
        """Open (creating the directory), archive and compact, and
        return the entries a previous incarnation journaled but never
        acked — this start's replay set."""
        os.makedirs(self.directory, exist_ok=True)
        pending = self._read_pending()
        if os.path.exists(self.path):
            self._archive_current()
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            for rec in pending:
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._open_keys = {rec["key"]: rec for rec in pending}
        self.replayable = list(pending)
        return list(pending)

    def _archive_current(self) -> None:
        nums = [0] + _segment_numbers(self.directory)
        os.replace(self.path,
                   os.path.join(self.directory, f"wal.{max(nums) + 1}.jsonl"))
        for n in sorted(n for n in nums if n)[:-KEEP_SEGMENTS]:
            try:
                os.unlink(os.path.join(self.directory, f"wal.{n}.jsonl"))
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None

    # -- mutators ----------------------------------------------------

    def record_request(self, key: str, verb: str, params: Dict[str, Any],
                       trace_id: Optional[str]) -> None:
        """Journal a request durably (fsync) before its first dispatch.
        Re-journaling an open key is a no-op: a replayed entry keeps its
        original record."""
        with self._lock:
            if key in self._open_keys:
                return
            rec = {"kind": "request", "key": key, "verb": verb,
                   "params": params, "trace_id": trace_id, "t": time.time()}
            self._append(rec, durable=True)
            self._open_keys[key] = rec

    def record_dispatch(self, key: str, member: str) -> None:
        """Audit one dispatch attempt (best-effort, not fsync'd)."""
        with self._lock:
            self._append({"kind": "dispatch", "key": key, "member": member,
                          "t": time.time()}, durable=False)

    def ack(self, key: str) -> None:
        """Settle an entry. A lost ack costs one idempotent replay,
        never a wrong result."""
        with self._lock:
            if key not in self._open_keys:
                return
            self._append({"kind": "ack", "key": key, "t": time.time()},
                         durable=False)
            del self._open_keys[key]

    def open_count(self) -> int:
        with self._lock:
            return len(self._open_keys)

    # -- internals ---------------------------------------------------

    def _append(self, rec: Dict[str, Any], *, durable: bool) -> None:
        if self._fh is None:  # closed (teardown race): drop silently
            return
        self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
        self._fh.flush()
        if durable:
            os.fsync(self._fh.fileno())

    def _read_pending(self) -> List[Dict[str, Any]]:
        """The existing journal's unacked request records, in journal
        order."""
        requests: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        for rec in _records(self.path):
            key = rec.get("key")
            if not isinstance(key, str):
                continue
            if rec.get("kind") == "request" and key not in requests:
                requests[key] = rec
                order.append(key)
            elif rec.get("kind") == "ack":
                requests.pop(key, None)
        return [requests[k] for k in order if k in requests]


def read_records(directory: str) -> List[Dict[str, Any]]:
    """Every decodable record across the retained segments and the
    active file, oldest first — the audit surface that checks each
    settled request was journaled once."""
    try:
        nums = _segment_numbers(directory)
    except OSError:
        return []
    paths = [os.path.join(directory, f"wal.{n}.jsonl") for n in sorted(nums)]
    paths.append(os.path.join(directory, WAL_FILE))
    return [rec for path in paths for rec in _records(path)]
