"""Per-request environment overlay — how the daemon honors a client's
``SEMMERGE_*`` variables without mutating ``os.environ`` (the port of
the JAX package's ``utils/reqenv.py``).

A one-shot CLI reads behavior toggles (``SEMMERGE_FAULT``,
``SEMMERGE_STRICT``, ``SEMMERGE_RESOLVE``, the ``SEMMERGE_BATCH``
batching posture) straight
from its process environment. The merge
service daemon executes many clients' requests from one process, so a
request's environment must scope to the request: mutating
``os.environ`` would race concurrent requests and forcing every
override-carrying request to run exclusively would serialize exactly
the workloads the daemon exists to overlap.

The overlay is a :class:`contextvars.ContextVar` dict the daemon sets
around each request (:func:`overlay`); :func:`get` consults it first
and falls back to ``os.environ`` — so the overlay-aware read sites
behave identically in one-shot processes (the var is never set there).
The overlay dict also hosts request-scoped mutable state keyed by
dunder names (the fault-injection hit counters live at
``__fault_counters__``), giving each daemon request the fresh
process-local counters a one-shot run would have had.
"""
from __future__ import annotations

import contextlib
import os
from contextvars import ContextVar
from typing import Dict, Iterator, Optional

_OVERLAY: "ContextVar[Optional[dict]]" = ContextVar("semmerge_reqenv",
                                                    default=None)


def get(name: str, default: Optional[str] = None) -> Optional[str]:
    """``os.environ.get`` with the request overlay consulted first."""
    ov = _OVERLAY.get()
    if ov is not None and name in ov:
        return ov[name]
    return os.environ.get(name, default)


def posture(name: str, default: str = "off",
            choices: tuple = ("off", "auto", "require")) -> str:
    """Parse a three-state ``off|auto|require`` posture variable.

    The service postures (``SEMMERGE_DAEMON``, ``SEMMERGE_MESH``,
    ``SEMMERGE_FLEET``) share one vocabulary; this is the one
    overlay-aware parser for it. Unknown or empty values normalize to
    ``default`` — a misspelled posture must degrade to the safe
    default, never crash a merge. Common boolean spellings map onto
    the vocabulary (``1/on/yes/true`` → ``auto``, ``0/no/false`` →
    ``off``) so operators who treat the knob as a switch get the
    conservative reading.
    """
    raw = (get(name) or "").strip().lower()
    if raw in choices:
        return raw
    if raw in ("1", "on", "yes", "true"):
        return "auto"
    if raw in ("0", "no", "false"):
        return "off"
    return default


def active() -> Optional[dict]:
    """The current overlay dict (request-scoped mutable state lives
    here), or ``None`` outside any request scope."""
    return _OVERLAY.get()


@contextlib.contextmanager
def overlay(env: Dict[str, str]) -> Iterator[dict]:
    """Scope ``env`` over ``os.environ`` for the current thread/context.
    The yielded dict is the live overlay — request-scoped state may be
    stashed in it under dunder keys."""
    ov = dict(env)
    token = _OVERLAY.set(ov)
    try:
        yield ov
    finally:
        _OVERLAY.reset(token)
