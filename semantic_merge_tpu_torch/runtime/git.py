"""Git plumbing: revisions, commit times and in-memory snapshots.

The port's part of the JAX package's ``runtime/git.py``: a revision's
tree is read through one ``git archive`` piped to an in-process tar
reader; only the merge's apply step materializes one (the base tree) on
disk, in a temporary directory. Every command runs in ``cwd`` (the
process's working directory when ``None``).
"""
from __future__ import annotations

import collections
import contextlib
import datetime
import io
import pathlib
import shutil
import subprocess
import tarfile
import tempfile
from typing import Iterable, Iterator

from ..frontend.snapshot import SOURCE_EXTENSIONS, Snapshot
from ..utils import workdir


def run_git(args: Iterable[str], cwd: pathlib.Path | None = None) -> str:
    # cwd=None is the scoped request root inside a merge service
    # request, the process's working directory otherwise (utils/workdir).
    proc = subprocess.run(["git", *args], check=True, stdout=subprocess.PIPE,
                          text=True, cwd=cwd if cwd is not None else workdir.current())
    return proc.stdout.strip()


def resolve_rev(rev: str, cwd: pathlib.Path | None = None) -> str:
    return run_git(["rev-parse", rev], cwd=cwd)


def tree_oid(rev: str, cwd: pathlib.Path | None = None) -> str:
    """The tree object id a revision points at — the content address
    the warm residency cache (``service/residency.py``) keys encoded
    base snapshots under."""
    return run_git(["rev-parse", rev + "^{tree}"], cwd=cwd)


def commit_timestamp_iso(rev: str, cwd: pathlib.Path | None = None) -> str:
    """The commit's committer time as a UTC ISO-8601 string — the
    deterministic replacement for the reference's wall-clock provenance
    (reference ``workers/ts/src/lift.ts:9``)."""
    try:
        epoch = int(run_git(["show", "-s", "--format=%ct", rev], cwd=cwd).splitlines()[0])
    except (subprocess.CalledProcessError, ValueError, IndexError):
        return "1970-01-01T00:00:00Z"
    dt = datetime.datetime.fromtimestamp(epoch, tz=datetime.timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%SZ")


def archive_bytes(rev: str, cwd: pathlib.Path | None = None) -> bytes:
    """One ``git archive`` round-trip for a revision's full tree."""
    resolved = resolve_rev(rev, cwd=cwd)
    proc = subprocess.run(["git", "archive", resolved], check=True,
                          stdout=subprocess.PIPE,
                          cwd=cwd if cwd is not None else workdir.current())
    return proc.stdout


def extract_tree_to_temp(tar_bytes: bytes) -> pathlib.Path:
    """Materialize already-fetched archive bytes into a temp dir."""
    tmpdir = pathlib.Path(tempfile.mkdtemp(prefix="semmerge_tree_"))
    with tarfile.open(fileobj=io.BytesIO(tar_bytes)) as tar:
        tar.extractall(tmpdir, filter="data")
    return tmpdir


@contextlib.contextmanager
def temp_tree(tar_bytes: bytes) -> Iterator[pathlib.Path]:
    """:func:`extract_tree_to_temp` as a context manager: the temp tree
    is removed on every exit path."""
    tmpdir = extract_tree_to_temp(tar_bytes)
    try:
        yield tmpdir
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def checkout_tree_to_temp(rev: str, cwd: pathlib.Path | None = None) -> pathlib.Path:
    """Materialize ``rev`` into a new temporary directory (the caller
    removes it): ``semrebase`` replays an op log onto it."""
    return extract_tree_to_temp(archive_bytes(rev, cwd=cwd))


def snapshot_from_bytes(tar_bytes: bytes, paths=None) -> Snapshot:
    """Parse archive bytes into a Snapshot of the source files, sorted
    by path. ``paths`` (a set) restricts it to those files: the
    incremental scope (:func:`merge_scope`)."""
    files = []
    with tarfile.open(fileobj=io.BytesIO(tar_bytes)) as tar:
        for member in tar.getmembers():
            if not member.isfile():
                continue
            if paths is not None and member.name not in paths:
                continue
            suffix = pathlib.PurePosixPath(member.name).suffix
            if suffix not in SOURCE_EXTENSIONS:
                continue
            fh = tar.extractfile(member)
            if fh is None:
                continue
            files.append({"path": member.name, "content": fh.read().decode("utf-8")})
    files.sort(key=lambda f: f["path"])
    return Snapshot(files=files)


# --------------------------------------------------------------------------
# The incremental scope (the JAX package's ``runtime/git.py``): the files
# either side touched, unless a TypeScript symbol id of a scoped file has
# an out-of-scope twin. The guard indexes TypeScript files only, as in the
# JAX package, so a Java or C# collision with an out-of-scope twin does
# change which occurrence the last-wins join keeps; the engines that read
# the scope (``cli.py``) give the JAX CLI's bytes with it.

def changed_files_between(rev1: str, rev2: str, cwd: pathlib.Path | None = None) -> list:
    """Paths touched between two revisions; ``--no-renames`` keeps a
    rename as its delete and add, so both paths are in the scope."""
    out = run_git(["diff", "--name-only", "--no-renames", f"{rev1}..{rev2}"], cwd=cwd)
    return [line for line in out.splitlines() if line]


def diff_scope(rev1: str, rev2: str, cwd: pathlib.Path | None = None) -> "set[str] | None":
    """``semdiff``'s scope; ``None`` (the full tree) when git cannot answer."""
    try:
        return set(changed_files_between(rev1, rev2, cwd=cwd))
    except subprocess.CalledProcessError:
        return None


def merge_scope(base: str, a: str, b: str,
                cwd: pathlib.Path | None = None) -> "set[str] | None":
    """``semmerge``'s scope: every path either side touched relative to
    ``base``; ``None`` (the full tree) when git cannot answer."""
    try:
        return (set(changed_files_between(base, a, cwd=cwd))
                | set(changed_files_between(base, b, cwd=cwd)))
    except subprocess.CalledProcessError:
        return None


_SYMID_INDEX_CACHE: "collections.OrderedDict[str, dict]" = collections.OrderedDict()


def snapshot_symbol_index(snap: Snapshot) -> dict:
    """{path: symbol ids} of a snapshot's TypeScript files, scanned
    through the process-wide decl cache."""
    from ..frontend.scanner import scan_snapshot_keyed
    from ..frontend.snapshot import TS_EXTENSIONS, filter_files
    files = filter_files(snap, TS_EXTENSIONS)
    return {f["path"]: [n.symbolId for n in nodes]
            for f, (_, nodes) in zip(files, scan_snapshot_keyed(files))}


def full_tree_symbol_index(tar_bytes: bytes, rev: str | None = None) -> dict:
    """:func:`snapshot_symbol_index` of a revision's full tree, kept for
    the last 8 commits."""
    if rev is not None and rev in _SYMID_INDEX_CACHE:
        _SYMID_INDEX_CACHE.move_to_end(rev)
        return _SYMID_INDEX_CACHE[rev]
    index = snapshot_symbol_index(snapshot_from_bytes(tar_bytes))
    if rev is not None:
        _SYMID_INDEX_CACHE[rev] = index
        while len(_SYMID_INDEX_CACHE) > 8:
            _SYMID_INDEX_CACHE.popitem(last=False)
    return index


def collision_safe_scope(scope: "set[str] | None", base_tar: bytes, base_rev: str | None,
                         scoped_snaps) -> "set[str] | None":
    """``scope``, or ``None`` (the full tree) when a symbol id that a
    scoped file indexes in any of ``scoped_snaps`` also occurs in an
    out-of-scope file of the base tree."""
    if not scope:
        return scope
    scoped_ids: set = set()
    out_ids: set = set()
    for path, ids in full_tree_symbol_index(base_tar, base_rev).items():
        (scoped_ids if path in scope else out_ids).update(ids)
    for snap in scoped_snaps:
        for ids in snapshot_symbol_index(snap).values():
            scoped_ids.update(ids)
    return None if scoped_ids & out_ids else scope
