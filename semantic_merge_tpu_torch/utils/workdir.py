"""Per-request working directory: where relative artifacts land.

Repo-relative work (git plumbing, ``.semmerge.toml`` discovery, the
conflict and trace artifacts, postmortem bundles, the in-place commit
root) resolves against :func:`root`: the request root when one is
scoped, the process cwd otherwise. A one-shot CLI run never scopes one,
so it behaves exactly as with ``pathlib.Path.cwd()``; a process that
serves requests for several repositories (the merge service, when it is
ported) scopes each request with :func:`scoped`. The root lives in a
:class:`contextvars.ContextVar`, so each thread sees only its own.
(A copy of the JAX package's ``utils/workdir.py``.)
"""
from __future__ import annotations

import contextlib
import pathlib
from contextvars import ContextVar
from typing import Iterator, Optional

_ROOT: "ContextVar[Optional[str]]" = ContextVar("semmerge_workdir", default=None)


def current() -> Optional[pathlib.Path]:
    """The scoped request root, or ``None`` outside any request scope
    (callers that pass ``cwd=None`` to subprocesses want exactly that)."""
    value = _ROOT.get()
    return pathlib.Path(value) if value is not None else None


def root() -> pathlib.Path:
    """The directory repo-relative work resolves against: the scoped
    request root when inside one, the process cwd otherwise."""
    return current() or pathlib.Path.cwd()


def path(rel: str) -> pathlib.Path:
    """A repo-relative artifact path (``.semmerge-conflicts.json`` and
    friends) under :func:`root`."""
    return root() / rel


@contextlib.contextmanager
def scoped(new_root: pathlib.Path | str) -> Iterator[pathlib.Path]:
    """Scope the working directory for the current thread/context."""
    resolved = pathlib.Path(new_root).resolve()
    token = _ROOT.set(str(resolved))
    try:
        yield resolved
    finally:
        _ROOT.reset(token)
