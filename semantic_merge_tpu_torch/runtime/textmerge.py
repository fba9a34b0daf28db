"""Per-file 3-way text-merge fallback — requirement [FBK-001].

The port's copy of the JAX package's ``runtime/textmerge.py``.

The reference *requires* that files the semantic engine cannot handle
fall back to git's text 3-way merge for that file only (reference
``requirements.md:105`` [FBK-001]) but never implements it: its applier
starts from the base tree, so changes to non-indexed files silently
revert in ``--inplace`` merges (the e2e path survives only because git
routes just ``*.ts`` to the merge driver). This module implements the
requirement: after op application, every file *outside* the indexed
extension set merges textually — trivial resolutions (one side
unchanged, both sides identical) in-process, true both-sided edits via
``git merge-file``; marker conflicts surface as ``TextMergeConflict``
records in ``.semmerge-conflicts.json`` with the conflicting file as
the minimal slice.

Binary files (undecodable as UTF-8) resolve one-side changes and
report both-side changes as conflicts — never text-merged.
"""
from __future__ import annotations

import io
import logging
import pathlib
import subprocess
import tarfile
import tempfile
from typing import Dict, List, Optional, Tuple

from ..core.conflict import Conflict, text_merge_conflict
from ..frontend.snapshot import SOURCE_EXTENSIONS

logger = logging.getLogger(__name__)


def tar_file_map(tar_bytes: bytes) -> Dict[str, bytes]:
    """Every regular file in an archive, path → raw bytes."""
    out: Dict[str, bytes] = {}
    with tarfile.open(fileobj=io.BytesIO(tar_bytes)) as tar:
        for member in tar.getmembers():
            if not member.isfile():
                continue
            fh = tar.extractfile(member)
            if fh is not None:
                out[member.name] = fh.read()
    return out


def apply_text_fallback(merged_tree: pathlib.Path, base_tar: bytes,
                        left_tar: bytes, right_tar: bytes, *,
                        indexed_extensions=None,
                        ) -> Tuple[List[Conflict], List[str], List[str]]:
    """Textually merge non-indexed files into ``merged_tree``.

    ``indexed_extensions`` is the *active backend's* extension set —
    only those files belong to the semantic pipeline; everything else
    (including other backends' languages) falls back to text merge.
    Returns ``(conflicts, deleted_paths, written_paths)``; the caller
    must propagate deletions when copying the merged tree elsewhere
    (``--inplace``), and ``written_paths`` feeds touched-scope
    formatting.
    """
    merged_tree = pathlib.Path(merged_tree)
    indexed = (frozenset(indexed_extensions) if indexed_extensions is not None
               else frozenset(SOURCE_EXTENSIONS))
    base = tar_file_map(base_tar)
    left = tar_file_map(left_tar)
    right = tar_file_map(right_tar)

    conflicts: List[Conflict] = []
    deleted: List[str] = []
    written: List[str] = []
    paths = sorted((set(left) | set(right) | set(base)))
    for path in paths:
        if pathlib.PurePosixPath(path).suffix in indexed:
            # The semantic pipeline owns indexed files — EXCEPT a file
            # that exists on a side but neither in base nor in the
            # op-applied tree: a pure one-sided add the op vocabulary
            # has no whole-file handler for (the reference applier
            # skips addDecl too, reference ``semmerge/applier.py:30-31``
            # — its real driver flow leans on git fast-forwarding pure
            # adds, which a standalone ``semmerge`` invocation cannot).
            # Those fall through to the text layer, which resolves a
            # one-sided add trivially and a both-sided divergent add as
            # a conflict.
            if path in base or (merged_tree / path).exists():
                continue
        base_c = base.get(path)
        resolved, conflict = _resolve(path, base_c, left.get(path),
                                      right.get(path))
        if conflict is not None:
            conflicts.append(conflict)
            continue
        target = merged_tree / path
        if resolved is None:
            if target.exists():
                target.unlink()
            if base_c is not None:
                deleted.append(path)
            continue
        if resolved == base_c:
            continue  # already on disk from the base tree
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_bytes(resolved)
        written.append(path)
    return conflicts, deleted, written


def _resolve(path: str, base: Optional[bytes], a: Optional[bytes],
             b: Optional[bytes]) -> Tuple[Optional[bytes], Optional[Conflict]]:
    """Classic 3-way per-file resolution; (content-or-None, conflict)."""
    if a == base and b == base:
        return base, None
    if a == base:
        return b, None
    if b == base:
        return a, None
    if a == b:
        return a, None
    # Both sides changed, differently. Delete-vs-edit or binary → conflict.
    if a is None or b is None or _is_binary(a) or _is_binary(b) \
            or (base is not None and _is_binary(base)):
        return None, text_merge_conflict(path, "both sides changed incompatibly")
    merged, clean, failure = _git_merge_file(base or b"", a, b)
    if clean:
        return merged, None
    return None, text_merge_conflict(path, failure or "overlapping text edits")


def _is_binary(data: Optional[bytes]) -> bool:
    if data is None:
        return False
    if b"\x00" in data[:8192]:
        return True
    try:
        data.decode("utf-8")
        return False
    except UnicodeDecodeError:
        return True


def _git_merge_file(base: bytes, a: bytes, b: bytes,
                    ) -> Tuple[bytes, bool, Optional[str]]:
    """3-way merge via ``git merge-file``; (result, was_clean,
    failure_reason) — ``failure_reason`` set only for environment
    failures (so a missing git is not reported as a content conflict)."""
    with tempfile.TemporaryDirectory(prefix="semmerge_txt_") as tmp:
        tmp_path = pathlib.Path(tmp)
        (tmp_path / "base").write_bytes(base)
        (tmp_path / "a").write_bytes(a)
        (tmp_path / "b").write_bytes(b)
        try:
            proc = subprocess.run(
                ["git", "merge-file", "--stdout", "-L", "A", "-L", "base",
                 "-L", "B", str(tmp_path / "a"), str(tmp_path / "base"),
                 str(tmp_path / "b")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        except OSError as exc:  # git missing → conservative conflict
            logger.warning("git merge-file unavailable: %s", exc)
            return b"", False, f"text merge unavailable ({exc})"
        # Exit status: 0 clean, >0 = number of conflicts, <0 error.
        return proc.stdout, proc.returncode == 0, None

