"""Crash-safe ``--inplace`` apply: stage → journal → atomic commit.

The port's copy of the JAX package's ``runtime/inplace.py``; ``root``
defaults to the process's working directory.

A plain in-place copy of the merged tree, file by file, into the
working tree would leave a *torn* tree (half old, half new) after a
crash mid-copy (OOM-killed CLI, ctrl-C, power loss), which the git
merge driver would then publish as the merge result. This module
makes the commit two-phase:

1. **Stage**: every file of the merged tree is copied into a sibling
   ``.semmerge-stage/`` directory inside the target root (same
   filesystem, so the later renames are atomic). A crash here leaves
   only a stray stage directory; the work tree is bitwise untouched.
2. **Journal**: the intended writes and deletes are recorded in
   ``.semmerge-journal.json`` — written to a temp name, fsynced, then
   atomically renamed into place. The journal's existence IS the
   commit marker: from this instant the merge is redo-able.
3. **Commit**: each staged file is ``os.replace``d onto its target
   (atomic per file) and each journaled delete unlinked; the journal
   and stage directory are then removed.

A process killed at ANY point leaves one of two recoverable states:

- stage dir without journal → the commit never started; **rollback**
  (remove the stage dir, work tree untouched);
- journal present → the commit may be partial; **roll forward**
  (replay the remaining renames/deletes — ``os.replace`` of an
  already-moved file is skipped because its staged source is gone).

:func:`recover` implements both and is invoked automatically at the
start of every ``--inplace`` merge and explicitly by
``semmerge --resume``.

Cross-process exclusion: the stage/journal protocol is crash-safe but
not *concurrent*-safe — two simultaneous ``--inplace`` merges in the
same work tree would interleave on ``.semmerge-stage/`` and clobber
each other's journal. :func:`repo_lock` is the shared repo-level mutex:
an ``O_EXCL`` lockfile carrying ``pid mtime``, with the same staleness
heuristic as the merge driver's latch (old mtime, or a recorded pid
that no longer exists). The CLI takes it around every ``--inplace``
commit and recovery; it is the same lockfile the JAX package takes, so
the two packages' merges exclude each other too.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import pathlib
import shutil
import time
from typing import Iterable, Iterator, List, Tuple

from ..errors import ApplyFault
from ..obs import metrics as obs_metrics
from ..obs import spans as obs_spans
from ..utils import faults, workdir
from ..utils.procs import env_seconds

logger = logging.getLogger(__name__)

JOURNAL = ".semmerge-journal.json"
STAGE_DIR = ".semmerge-stage"
JOURNAL_SCHEMA = 1

LOCKFILE = ".semmerge-inplace.lock"
#: Same age cutoff as the merge driver's ``.git/.semmerge.lock`` latch.
STALE_LOCK_SECONDS = 3600.0


def _break_stale_lock(path: pathlib.Path) -> bool:
    """Break a stale lock **exactly once** across concurrent
    contenders. A bare ``unlink`` races: two contenders can both judge
    the lock stale, and between their unlinks a third contender's fresh
    ``O_EXCL`` create can land — the second unlink then destroys the
    *fresh* lock and two processes hold the mutex. Breakers therefore
    serialize on a guard file (``<lock>.breaker``, itself ``O_EXCL``):
    only the guard holder may unlink a lock it did not create, and its
    staleness recheck under the guard is authoritative — a live owner
    only ever unlinks its *own* lock, so a lock still stale inside the
    guarded section cannot have been replaced by a live one. Returns
    ``True`` when this call broke the lock."""
    guard = path.with_name(path.name + ".breaker")
    try:
        fd = os.open(guard, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
    except FileExistsError:
        # Another breaker is in its guarded section — let it win. A
        # guard abandoned by a killed breaker is itself reclaimed by
        # the same staleness test; the next loop iteration retries.
        if _lock_is_stale(guard):
            with contextlib.suppress(OSError):
                guard.unlink()
        return False
    except OSError:
        return False
    try:
        os.write(fd, f"{os.getpid()} {int(time.time())}\n".encode("ascii"))
    finally:
        os.close(fd)
    try:
        if not _lock_is_stale(path):
            return False  # released (or re-acquired live) since the probe
        path.unlink(missing_ok=True)
        logger.warning("reclaiming stale in-place lock %s", path)
        obs_metrics.REGISTRY.counter(
            "semmerge_inplace_lock_stale_total",
            "Stale repo-level in-place locks reclaimed").inc(1)
        return True
    finally:
        with contextlib.suppress(OSError):
            guard.unlink()


def _lock_is_stale(path: pathlib.Path) -> bool:
    """A lock left by a dead or long-gone process: old mtime (the
    driver-latch heuristic), or a recorded pid that no longer exists."""
    try:
        st = path.stat()
    except OSError:
        return False  # raced with the owner's own unlink
    if time.time() - st.st_mtime > STALE_LOCK_SECONDS:
        return True
    try:
        pid = int(path.read_text(encoding="utf-8").split()[0])
    except (OSError, ValueError, IndexError):
        return False  # unreadable content: trust mtime alone
    if pid == os.getpid():
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    except OSError:
        pass
    return False


@contextlib.contextmanager
def repo_lock(root: pathlib.Path | None = None,
              timeout: float | None = None) -> Iterator[pathlib.Path]:
    """Repo-level ``--inplace`` mutex: ``O_CREAT|O_EXCL`` on
    ``.semmerge-inplace.lock`` under ``root`` (default: the working
    directory). Blocks up to ``timeout`` seconds
    (``SEMMERGE_INPLACE_LOCK_TIMEOUT``, default 600; 0 waits forever),
    reclaiming stale locks on the way; expiry raises an
    :class:`~semantic_merge_tpu_torch.errors.ApplyFault` (exit 13) so a
    wedged peer surfaces as a fault, not a silent hang."""
    root = pathlib.Path(root) if root is not None else workdir.root()
    path = root / LOCKFILE
    if timeout is None:
        timeout = env_seconds("SEMMERGE_INPLACE_LOCK_TIMEOUT", 600.0)
    deadline = time.monotonic() + timeout if timeout > 0 else None
    waited = False
    while True:
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
            break
        except FileExistsError:
            if _lock_is_stale(path):
                _break_stale_lock(path)
                continue
            if deadline is not None and time.monotonic() > deadline:
                raise ApplyFault(
                    f"timed out after {timeout:g}s waiting for the "
                    f"in-place lock {path}", stage="commit",
                    cause="lock-timeout")
            waited = True
            time.sleep(0.05)
    try:
        os.write(fd, f"{os.getpid()} {int(time.time())}\n".encode("ascii"))
    finally:
        os.close(fd)
    if waited:
        obs_metrics.REGISTRY.counter(
            "semmerge_inplace_lock_waits_total",
            "In-place merges that waited for the repo lock").inc(1)
    try:
        yield path
    finally:
        path.unlink(missing_ok=True)


def _safe_rel(rel: str) -> pathlib.PurePosixPath:
    """Validate a journaled relative path: inside the root, no tricks.
    (The journal is our own artifact, but recovery must not follow a
    corrupted or tampered one outside the work tree.)"""
    p = pathlib.PurePosixPath(rel)
    if p.is_absolute() or ".." in p.parts or not p.parts:
        raise ValueError(f"journal entry escapes the work tree: {rel!r}")
    return p


def commit_tree_inplace(tree: pathlib.Path, deletes: Iterable[str] = (),
                        root: pathlib.Path | None = None) -> None:
    """Publish ``tree`` into ``root`` (default :func:`workdir.root`)
    crash-safely: the ``inplace_stage`` span copies it into the stage,
    the journal is written, the ``commit`` fault-injection stage fires,
    and the ``inplace_commit`` span renames the stage into place
    (``semmerge_inplace_commits_total``)."""
    tree = pathlib.Path(tree)
    root = pathlib.Path(root) if root is not None else workdir.root()
    stage = root / STAGE_DIR
    if stage.exists():
        shutil.rmtree(stage)
    writes: List[str] = []
    with obs_spans.span("inplace_stage", layer="runtime"):
        for path in sorted(tree.rglob("*")):
            if not path.is_file():
                continue
            rel = path.relative_to(tree).as_posix()
            dst = stage / rel
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(path, dst)
            writes.append(rel)
    journal = {
        "schema": JOURNAL_SCHEMA,
        "state": "committing",
        "writes": writes,
        "deletes": sorted({pathlib.PurePosixPath(d).as_posix()
                           for d in deletes}),
    }
    _write_journal(root, journal)
    faults.check("commit")
    with obs_spans.span("inplace_commit", layer="runtime",
                        writes=len(writes), deletes=len(journal["deletes"])):
        _roll_forward(root, journal)
    obs_metrics.REGISTRY.counter(
        "semmerge_inplace_commits_total",
        "Crash-safe in-place commits completed").inc(1)


def _write_journal(root: pathlib.Path, journal: dict) -> None:
    jpath = root / JOURNAL
    tmp = root / (JOURNAL + ".tmp")
    payload = json.dumps(journal, indent=0)
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(payload)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, jpath)


def _roll_forward(root: pathlib.Path, journal: dict) -> None:
    """Replay a journal to completion: idempotent, so it serves both
    the live commit and crash recovery."""
    stage = root / STAGE_DIR
    for rel in journal.get("writes", []):
        rel_p = _safe_rel(rel)
        src = stage / rel_p
        if not src.is_file():
            continue  # already committed before the interruption
        dst = root / rel_p
        dst.parent.mkdir(parents=True, exist_ok=True)
        os.replace(src, dst)
    for rel in journal.get("deletes", []):
        (root / _safe_rel(rel)).unlink(missing_ok=True)
    (root / JOURNAL).unlink(missing_ok=True)
    shutil.rmtree(stage, ignore_errors=True)


def recover(root: pathlib.Path | None = None) -> Tuple[str, int]:
    """Resolve any interrupted in-place commit under ``root``.

    Returns ``(action, n_writes)`` where action is ``"none"`` (nothing
    pending), ``"rolled-forward"`` (journal replayed to completion), or
    ``"rolled-back"`` (pre-journal stage discarded; work tree was never
    touched). A torn/unreadable journal rolls back: the journal write
    is atomic, so an unreadable one cannot have committed anything.
    """
    root = pathlib.Path(root) if root is not None else workdir.root()
    jpath = root / JOURNAL
    stage = root / STAGE_DIR
    if jpath.exists():
        try:
            journal = json.loads(jpath.read_text(encoding="utf-8"))
            if not isinstance(journal, dict):
                raise ValueError("journal is not an object")
        except (ValueError, OSError) as exc:
            logger.warning("discarding unreadable in-place journal: %s", exc)
            jpath.unlink(missing_ok=True)
            shutil.rmtree(stage, ignore_errors=True)
            return "rolled-back", 0
        n = len(journal.get("writes", []))
        logger.warning("resuming interrupted in-place commit (%d writes)", n)
        try:
            _roll_forward(root, journal)
        except ValueError as exc:
            # A journal entry escaping the work tree: refuse to act on
            # it (the journal stays for forensics) — a fault with the
            # documented ApplyFault exit, never a traversal.
            raise ApplyFault(str(exc), stage="commit",
                             cause="journal-tampered") from exc
        _count_recovery("rolled-forward")
        return "rolled-forward", n
    if stage.exists():
        logger.warning("discarding pre-commit stage from an interrupted "
                       "merge (work tree was never touched)")
        shutil.rmtree(stage, ignore_errors=True)
        _count_recovery("rolled-back")
        return "rolled-back", 0
    return "none", 0


def _count_recovery(action: str) -> None:
    obs_metrics.REGISTRY.counter(
        "semmerge_inplace_recoveries_total",
        "Interrupted in-place commits resolved").inc(1, action=action)
