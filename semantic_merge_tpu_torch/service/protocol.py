"""Merge-service wire protocol: newline-delimited JSON-RPC over a unix
socket — the port of the JAX package's ``service/protocol.py``, with the
same framing and messages.

Request/response shapes::

    → {"id": 1, "method": "semmerge",
       "params": {"argv": ["BASE", "A", "B", "--inplace"],
                  "cwd": "/abs/repo", "env": {"SEMMERGE_STRICT": "1"},
                  "deadline_s": 30.0, "trace_id": "9f2ab34cc01d77e6"}}
    ← {"id": 1, "result": {"exit_code": 0, "stdout": "…", "stderr": "…",
                           "meta": {"queue_wait_s": 0.001,
                                    "trace_id": "9f2ab34cc01d77e6", …}}}

``trace_id`` is minted by the client (one per request, not per retry
attempt) and threads through the daemon executor and the batch
dispatcher, naming that request's spans, artifacts, and postmortem
bundle (``.semmerge-postmortem/<trace_id>.json``).

Verb methods are the three merge-shaped CLI commands; control methods
are ``hello`` (startup/liveness handshake carrying the protocol
version), ``status``, ``metrics`` (live registry: Prometheus text +
health JSON), ``drain``, ``profile`` (params ``seconds``, optional
``out_dir``: a bounded profiler capture, answered when the window ends
with ``ok``, ``dir``, ``profiler_started``, ``seconds`` and ``files``,
or ``ok: false`` and ``error``, ``busy`` included) and ``shutdown``.

The port's daemon names its package (:data:`PACKAGE`) in its ``hello``
and ``status`` replies, and its ``hello`` names the checkout it runs
from (:data:`CHECKOUT`). Its default socket is not the JAX package's
(:func:`socket_path`): the two packages' daemons run side by side, and
a port client that reaches a daemon answering for another package (say
through a shared ``SEMMERGE_SERVICE_SOCKET``) or for another checkout
of this one treats it as no daemon (:func:`is_ours`) — otherwise its
merge would quietly run on another engine or on other code. Errors come back as
``{"id": n, "error": {"message", "fault", "stage", "exit_code",
"trace_id"}}`` — a *typed* error (``exit_code`` present) is a final
answer the client exits with; an untyped or malformed response is a
transport failure the client treats as daemon-unavailable.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

PROTOCOL_VERSION = 1

#: The package this daemon and client speak for (``hello``/``status``).
PACKAGE = "semantic_merge_tpu_torch"

#: The directory this package was imported from (``hello``): two
#: checkouts of the package on one machine never serve each other.
CHECKOUT = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))

#: CLI commands a client may delegate.
VERBS = ("semdiff", "semmerge", "semrebase")

#: Env vars NOT shipped with a request: daemon-routing knobs would
#: recurse, SEMMERGE_METRICS is a process-atexit artifact of whichever
#: process owns it, the service socket is connection metadata, and the
#: SLO engine is daemon-lifetime state — a client's objectives must not
#: reconfigure a shared daemon per request (the OTLP exporter is a
#: process-lifetime background shipper with the same ownership rule).
_UNSHIPPED_PREFIXES = ("SEMMERGE_SERVICE_", "SEMMERGE_SLO",
                       "SEMMERGE_FLEET", "SEMMERGE_OTLP")
_UNSHIPPED = frozenset({"SEMMERGE_DAEMON", "SEMMERGE_METRICS",
                        "SEMMERGE_METRICS_PORT"})


class ProtocolError(Exception):
    """The peer spoke something that is not the protocol."""


def socket_path(explicit: Optional[str] = None) -> str:
    """Resolve the service socket path: explicit argument, then
    ``SEMMERGE_SERVICE_SOCKET``, then
    ``$XDG_RUNTIME_DIR/semmerge-torch.sock``, then a per-uid path in
    the temp directory (``$TMPDIR``, else ``/tmp``; the name carries the
    uid; the daemon binds it 0600). The
    defaults are not the JAX package's ``semmerge.sock`` /
    ``/tmp/semmerge-<uid>.sock``, so both packages' daemons can serve
    one user at once."""
    if explicit:
        return explicit
    env = os.environ.get("SEMMERGE_SERVICE_SOCKET", "").strip()
    if env:
        return env
    runtime_dir = os.environ.get("XDG_RUNTIME_DIR", "").strip()
    if runtime_dir:
        return os.path.join(runtime_dir, "semmerge-torch.sock")
    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(tempfile.gettempdir(), f"semmerge-torch-{uid}.sock")


def is_ours(answer: Dict[str, Any]) -> bool:
    """Whether a ``hello`` answer comes from a daemon of this package
    running from this checkout."""
    return answer.get("package") == PACKAGE and answer.get("checkout") == CHECKOUT


def request_env() -> Dict[str, str]:
    """The client's ``SEMMERGE_*`` environment, minus the unshipped set
    — this rides with each request and is applied daemon-side as a
    per-request overlay (:mod:`semantic_merge_tpu_torch.utils.reqenv`), so a
    client's ``SEMMERGE_STRICT`` / ``SEMMERGE_FAULT`` scope to its own
    request instead of leaking into the daemon process."""
    out: Dict[str, str] = {}
    for key, value in os.environ.items():
        if not key.startswith("SEMMERGE_"):
            continue
        if key in _UNSHIPPED or key.startswith(_UNSHIPPED_PREFIXES):
            continue
        out[key] = value
    return out


def write_message(wfile, obj: Dict[str, Any]) -> None:
    """One JSON object, one line, flushed — a message is visible to the
    peer the moment this returns."""
    wfile.write(json.dumps(obj, separators=(",", ":"),
                           default=str) + "\n")
    wfile.flush()


def read_message(rfile) -> Optional[Dict[str, Any]]:
    """The next message, ``None`` on EOF. Blank lines are skipped
    (keepalive-friendly); a non-JSON or non-object line is a
    :class:`ProtocolError`."""
    while True:
        line = rfile.readline()
        if line == "":
            return None
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
        except ValueError as exc:
            raise ProtocolError(f"undecodable frame: {exc}") from exc
        if not isinstance(msg, dict):
            raise ProtocolError(f"frame is not an object: {type(msg).__name__}")
        return msg


def fault_error(fault, retry_after_ms: Optional[int] = None,
                trace_id: Optional[str] = None) -> Dict[str, Any]:
    """The wire form of a typed
    :class:`~semantic_merge_tpu_torch.errors.MergeFault`: everything the client needs to reproduce the one-shot
    behavior (stderr line + documented exit code). ``retry_after_ms``
    rides on *transient* admission rejections (queue-full, overload)
    and invites the client to retry against the daemon after that
    delay instead of treating the rejection as final. ``trace_id``
    echoes the request's id so the client-visible error names the same
    trace the daemon's spans and postmortem bundle carry."""
    err = {
        "message": fault.describe(),
        "fault": type(fault).__name__,
        "stage": fault.stage,
        "exit_code": fault.exit_code,
    }
    if retry_after_ms is not None:
        err["retry_after_ms"] = int(retry_after_ms)
    if trace_id:
        err["trace_id"] = str(trace_id)
    return err
