"""Git plumbing: revisions, commit times and in-memory snapshots.

The port's part of the JAX package's ``runtime/git.py``: a revision's
tree is read through one ``git archive`` piped to an in-process tar
reader; only the merge's apply step materializes one (the base tree) on
disk, in a temporary directory. Every command runs in ``cwd`` (the
process's working directory when ``None``).
"""
from __future__ import annotations

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


def snapshot_from_bytes(tar_bytes: bytes) -> Snapshot:
    """Parse archive bytes into a Snapshot of the source files, sorted
    by path."""
    files = []
    with tarfile.open(fileobj=io.BytesIO(tar_bytes)) as tar:
        for member in tar.getmembers():
            if not member.isfile():
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
