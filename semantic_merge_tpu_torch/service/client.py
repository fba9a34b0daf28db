"""Merge-service client: delegate merge-shaped CLI invocations to a
warm daemon (the port of the JAX package's ``service/client.py``).

``SEMMERGE_DAEMON`` selects the posture:

- ``off`` (default) — never delegate; plain one-shot CLI.
- ``auto`` — connect to a running port daemon, spawn one if absent
  (``python -m semantic_merge_tpu_torch serve``, with a startup
  handshake), and on ANY transport failure — no daemon, spawn timeout,
  protocol garbage, connection died mid-request — run the request
  in-process, one-shot, on the device its argv names. The work tree is
  never left worse than a one-shot run: delegation failures happen
  before this process touches the tree, and a daemon killed
  mid-``--inplace`` leaves the journaled state the one-shot path's
  ``recover()`` resolves first.
- ``require`` — delegate or fail with the ``WorkerFault`` exit (12).

A *typed* wire error (``exit_code`` present) is a final answer in both
``auto`` and ``require`` — the daemon executed the request and the
fault is the result, exactly as a one-shot run with the same injected
fault would have exited.

Only a daemon that answers ``hello`` for this package counts: a daemon
of the JAX package on the socket (a shared ``SEMMERGE_SERVICE_SOCKET``)
is no daemon, so ``auto`` runs one-shot on the card and ``require``
exits 12 — never a merge quietly run by another engine.

``SEMMERGE_FLEET`` layers fleet discovery on top, as in the JAX client:
``auto`` prefers an already-listening fleet router of this package on
the service socket (never spawns one) and falls back to the plain
``SEMMERGE_DAEMON`` posture; ``require`` demands the socket answer *as
a fleet router* (its hello carries ``fleet: true``) and fails with the
``FleetFault`` exit (19) otherwise. The fleet dial goes through
:mod:`semantic_merge_tpu_torch.fleet.transport` (a ``tcp://`` socket
reaches a remote router, mTLS under ``SEMMERGE_FLEET_TLS_*``; the
``net:*`` fault stages fire there): a
:class:`~semantic_merge_tpu_torch.errors.TransportFault` exits 21 under
``require`` with the work tree untouched, and falls through under
``auto``. A routed request runs in a member daemon, never in this
process, unless the posture is ``auto`` and no router answers.

:func:`delegate` is called from the package's ``__main__`` before the
CLI (and with it torch) is imported: the client path stays light.
"""
from __future__ import annotations

import contextlib
import os
import random
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import protocol
from ..errors import TransportFault  # stdlib-only module: stays cheap

#: Exit for ``require`` mode with no usable daemon — the WorkerFault
#: code (errors.EXIT_CODES), hardcoded so this module never imports
#: the heavy package half.
_REQUIRE_FAILED_EXIT = 12

#: Exit for ``SEMMERGE_FLEET=require`` with no fleet router — the
#: FleetFault code (errors.EXIT_CODES), hardcoded for the same reason.
_FLEET_REQUIRE_EXIT = 19

_Conn = Tuple[socket.socket, Any, Any]  # (sock, rfile, wfile)


class DaemonUnavailable(Exception):
    """No daemon could be reached/spawned, or the transport broke."""


class _RetryableRejection(Exception):
    """A typed admission rejection carrying a ``retry_after_ms`` hint —
    transient overload, not a final answer: the client may retry the
    daemon after the hinted delay."""

    def __init__(self, exit_code: int, message: str,
                 retry_after_ms: int) -> None:
        super().__init__(message)
        self.exit_code = exit_code
        self.message = message
        self.retry_after_ms = retry_after_ms


def mode() -> str:
    return os.environ.get("SEMMERGE_DAEMON", "off").strip().lower()


def fleet_mode() -> str:
    """The ``SEMMERGE_FLEET`` posture, parsed here (not through
    ``fleet.mode``) so the client path keeps its import set."""
    raw = os.environ.get("SEMMERGE_FLEET", "").strip().lower()
    if raw in ("auto", "require"):
        return raw
    return "off"


def delegate(argv: Sequence[str]) -> Optional[int]:
    """Run ``argv`` (full CLI argv, ``argv[0]`` the subcommand) on the
    daemon. Returns the exit code, or ``None`` when the invocation
    should proceed in-process (daemon mode off, non-verb command, a
    rank of a several-process job — every rank runs its share of the
    sharded merge itself — or an auto-mode transport failure)."""
    argv = [str(a) for a in argv]
    if not argv or argv[0] not in protocol.VERBS:
        return None
    if os.environ.get("_SEMMERGE_IN_DAEMON"):
        return None  # belt and suspenders: the daemon never re-delegates
    # The process count of parallel/distributed.py's contract, read here
    # without importing torch.
    procs = os.environ.get("SEMMERGE_NUM_PROCESSES") or os.environ.get("JAX_NUM_PROCESSES")
    if (procs or "1").strip() != "1":
        return None
    fm = fleet_mode()
    if fm in ("auto", "require"):
        # Fleet discovery: reach for a listening router first. Never
        # spawns — a client-spawned daemon would not be a fleet — and
        # only a socket that answers AS a fleet router counts.
        try:
            return _run_on_daemon(argv[0], argv[1:], spawn=False,
                                  require_fleet=True)
        except TransportFault as exc:
            # The transport refused to carry the request; nothing ran
            # and the work tree is untouched.
            if fm == "require":
                sys.stderr.write(f"semmerge: fleet transport failed: "
                                 f"{exc} (exit {exc.exit_code})\n")
                return exc.exit_code
        except DaemonUnavailable as exc:
            if fm == "require":
                sys.stderr.write(f"semmerge: fleet required but "
                                 f"unavailable: {exc} "
                                 f"(exit {_FLEET_REQUIRE_EXIT})\n")
                return _FLEET_REQUIRE_EXIT
            # fleet auto: no router listening — the plain daemon posture.
    m = mode()
    if m not in ("auto", "require"):
        return None
    try:
        return _run_on_daemon(argv[0], argv[1:])
    except DaemonUnavailable as exc:
        if m == "require":
            sys.stderr.write(f"semmerge: daemon required but unavailable: "
                             f"{exc} (exit {_REQUIRE_FAILED_EXIT})\n")
            return _REQUIRE_FAILED_EXIT
        return None  # auto: warm path failed, run one-shot


def _run_on_daemon(verb: str, rest: List[str], *, spawn: bool = True,
                   require_fleet: bool = False) -> int:
    """Delegate with bounded retries. Two retry-worthy outcomes exist:

    - a **transient admission rejection** (``retry_after_ms`` on the
      wire error — queue full, load shed): sleep the hinted delay
      (jittered, so a herd of rejected clients does not re-arrive in
      lockstep) and retry; exhausted retries fall back in-process in
      ``auto`` (the merge still happens, never worse than one-shot)
      and exit with the typed code in ``require``;
    - a **transport failure** (daemon died mid-request, spawn lost a
      race): retry against a fresh connection with short backoff. The
      idempotency key makes the resend safe — a daemon that already
      completed the first execution replays the recorded response
      instead of executing twice.

    Typed errors without ``retry_after_ms`` stay FINAL answers."""
    deadline = _env_float("SEMMERGE_SERVICE_DEADLINE", 0.0)
    # A daemon spawned for this request runs where the request does.
    device = "cpu" if "--device=cpu" in rest or any(
        a == "--device" and b == "cpu" for a, b in zip(rest, rest[1:])) else None
    retries = max(0, int(_env_float("SEMMERGE_SERVICE_RETRIES", 2)))
    idem_key = f"{os.getpid():x}-{os.urandom(8).hex()}"
    # One trace id per REQUEST (not per retry attempt): a replayed
    # idempotent response and the original execution share one trace.
    trace_id = os.urandom(8).hex()
    attempt = 0
    backoff = 0.0
    while True:
        try:
            return _attempt_on_daemon(verb, rest, deadline, idem_key,
                                      trace_id, spawn=spawn, device=device,
                                      require_fleet=require_fleet)
        except _RetryableRejection as rej:
            if attempt >= retries:
                if mode() == "require" or require_fleet:
                    if rej.message:
                        sys.stderr.write(f"semmerge: {rej.message} "
                                         f"(exit {rej.exit_code})\n")
                    return rej.exit_code
                raise DaemonUnavailable(
                    f"daemon still shedding after {attempt + 1} "
                    f"attempts: {rej.message}")
            time.sleep(min((rej.retry_after_ms / 1000.0)
                           * random.uniform(0.5, 1.5), 5.0))
        except DaemonUnavailable:
            if attempt >= retries:
                raise
            backoff = _reconnect_backoff_s(backoff)
            time.sleep(backoff)
        attempt += 1


def _reconnect_backoff_s(prev: float, base: float = 0.05,
                         cap: float = 2.0) -> float:
    """Decorrelated-jitter reconnect backoff: ``min(cap, uniform(base,
    prev * 3))``. The old fixed exponential schedule kept a herd of
    clients that failed together re-arriving in lockstep (its ±50%
    jitter band still clusters around the same powers of two); each
    draw here depends on the *previous draw*, so the herd spreads out
    within a retry or two."""
    return min(cap, random.uniform(base, max(prev * 3.0, base)))


def _attempt_on_daemon(verb: str, rest: List[str], deadline: float,
                       idem_key: str, trace_id: str, *,
                       spawn: bool = True, device: Optional[str] = None,
                       require_fleet: bool = False) -> int:
    sock, rfile, wfile = _connect_or_spawn(spawn=spawn, device=device,
                                           require_fleet=require_fleet)
    try:
        params: Dict[str, Any] = {
            "argv": rest,
            "cwd": os.getcwd(),
            "env": protocol.request_env(),
            "idempotency_key": idem_key,
            "trace_id": trace_id,
        }
        if deadline > 0:
            params["deadline_s"] = deadline
            # Transport timeout trails the request deadline: the daemon
            # answers deadline expiry itself (typed DeadlineFault); the
            # socket timeout only catches a wedged daemon.
            sock.settimeout(deadline + 30.0)
        try:
            protocol.write_message(wfile, {"id": 1, "method": verb,
                                           "params": params})
            resp = protocol.read_message(rfile)
        except (OSError, ValueError, protocol.ProtocolError) as exc:
            raise DaemonUnavailable(f"transport failed: {exc}") from exc
        if resp is None:
            raise DaemonUnavailable("daemon closed the connection "
                                    "mid-request")
        if resp.get("id") != 1:
            raise DaemonUnavailable("response id mismatch")
        error = resp.get("error")
        if error is not None:
            exit_code = error.get("exit_code")
            retry_after = error.get("retry_after_ms")
            if isinstance(exit_code, int) and isinstance(retry_after, int):
                raise _RetryableRejection(exit_code,
                                          error.get("message", ""),
                                          retry_after)
            if isinstance(exit_code, int):
                # Typed fault: a FINAL answer (see module docstring).
                # The trace id on the stderr line is the postmortem
                # bundle name (.semmerge-postmortem/<trace_id>.json).
                message = error.get("message", "")
                if message:
                    tid = error.get("trace_id") or trace_id
                    sys.stderr.write(f"semmerge: {message} "
                                     f"(exit {exit_code}) "
                                     f"[trace {tid}]\n")
                return exit_code
            raise DaemonUnavailable(
                f"protocol error: {error.get('message', 'unknown')}")
        result = resp.get("result")
        if not isinstance(result, dict) or "exit_code" not in result:
            raise DaemonUnavailable("malformed result frame")
        sys.stdout.write(result.get("stdout", ""))
        sys.stderr.write(result.get("stderr", ""))
        sys.stdout.flush()
        sys.stderr.flush()
        return int(result["exit_code"])
    finally:
        _close(sock, rfile, wfile)


# ----------------------------------------------------------------------
# connection management


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def _close(sock, rfile, wfile) -> None:
    for closable in (rfile, wfile, sock):
        try:
            closable.close()
        except OSError:
            pass


def _handshake(path: str, timeout: float, via_transport: bool = False):
    """Connect + ``hello``: ``(sock, rfile, wfile, hello result)``, or
    ``None`` when nothing on ``path`` completes the handshake (an absent
    or stale socket, a peer that does not speak the protocol).

    A ``tcp://`` address, and every dial with ``via_transport`` (the
    fleet dial), goes through the fleet transport, which handles TLS and
    fires the ``net:*`` fault stages: an injected fault raises
    :class:`TransportFault` out of here, while a real dead address stays
    ``None``."""
    check_read = None
    if via_transport or path.startswith("tcp://"):
        from ..fleet import transport as fleet_transport
        sock = fleet_transport.dial(path, timeout=timeout)
        if sock is None:
            return None
        check_read = fleet_transport.check_read_faults
    else:
        if not os.path.exists(path):
            return None
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    try:
        if check_read is None:
            sock.connect(path)
        rfile = sock.makefile("r", encoding="utf-8")
        wfile = sock.makefile("w", encoding="utf-8")
        protocol.write_message(wfile, {
            "id": 0, "method": "hello",
            "params": {"version": protocol.PROTOCOL_VERSION}})
        if check_read is not None:
            check_read()
        resp = protocol.read_message(rfile)
    except (OSError, ValueError, protocol.ProtocolError):
        with contextlib.suppress(OSError):
            sock.close()
        return None
    if not (isinstance(resp, dict) and resp.get("id") == 0
            and isinstance(resp.get("result"), dict)
            and resp["result"].get("ok")):
        _close(sock, rfile, wfile)
        return None
    return sock, rfile, wfile, resp["result"]


def _try_connect(path: str, timeout: float = 5.0,
                 require_fleet: bool = False) -> Optional[_Conn]:
    """A connection to this package's daemon on ``path``, handshake
    done; ``None`` when nothing usable listens there — a daemon of
    another package or another checkout (:func:`protocol.is_ours`)
    included. With ``require_fleet`` the peer must answer as a fleet
    router (``fleet: true`` in its hello): a plain daemon on the path
    counts as unusable."""
    got = _handshake(path, timeout, via_transport=require_fleet)
    if got is None:
        return None
    sock, rfile, wfile, answer = got
    if not protocol.is_ours(answer) or (require_fleet and not answer.get("fleet")):
        _close(sock, rfile, wfile)
        return None
    sock.settimeout(None)
    return sock, rfile, wfile


def hello(path: str, timeout: float = 2.0) -> Optional[Dict[str, Any]]:
    """The ``hello`` answer of whatever daemon listens on ``path``,
    whichever package it speaks for, or ``None`` when nothing answers
    the handshake."""
    got = _handshake(path, timeout)
    if got is None:
        return None
    _close(*got[:3])
    return got[3]


def _spawn_daemon(path: str, device: Optional[str] = None) -> subprocess.Popen:
    """Start a detached daemon on ``path``. Its cwd is ``/`` so any
    repo-relative work missing the request working-dir scope fails
    loudly instead of landing in whichever repo spawned the daemon.
    ``SEMMERGE_FAULT`` is stripped — injection is per-request (it rides
    the request env overlay), not a property of the daemon process. The
    daemon runs on the card unless ``device`` (the spawning request's
    ``--device``) is ``"cpu"``."""
    env = dict(os.environ)
    env.pop("SEMMERGE_FAULT", None)
    env.pop("SEMMERGE_DAEMON", None)
    log_path = path + ".log"
    with open(log_path, "ab") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "semantic_merge_tpu_torch", "serve",
             "--socket", path, *(["--device", device] if device else [])],
            stdin=subprocess.DEVNULL, stdout=log, stderr=log,
            cwd="/", env=env, start_new_session=True)


def _connect_or_spawn(*, spawn: bool = True, device: Optional[str] = None,
                      require_fleet: bool = False) -> _Conn:
    path = protocol.socket_path()
    conn = _try_connect(path, require_fleet=require_fleet)
    if conn is not None:
        return conn
    if not spawn:
        raise DaemonUnavailable(
            f"no {'fleet router' if require_fleet else 'daemon'} "
            f"listening on {path}")
    spawn_timeout = _env_float("SEMMERGE_SERVICE_SPAWN_TIMEOUT", 30.0)
    proc = _spawn_daemon(path, device)
    t0 = time.monotonic()
    while time.monotonic() - t0 < spawn_timeout:
        conn = _try_connect(path)
        if conn is not None:
            return conn
        if proc.poll() is not None:
            # The spawned process exited — usually because it lost the
            # startup bind race to a concurrent spawner. The winner may
            # still be warming up (it binds its socket well before it
            # can answer the handshake), so a single probe here turned
            # real winners into spurious cold-path fallbacks. Keep
            # reconnecting for a bounded window instead.
            reconnect = _env_float("SEMMERGE_SERVICE_RECONNECT", 2.0)
            r0 = time.monotonic()
            while time.monotonic() - r0 < reconnect:
                conn = _try_connect(path)
                if conn is not None:
                    return conn
                time.sleep(0.1)
            raise DaemonUnavailable(
                f"daemon exited rc={proc.returncode} during startup "
                f"(log: {path}.log)")
        time.sleep(0.1)
    raise DaemonUnavailable(
        f"daemon did not come up within {spawn_timeout:g}s "
        f"(log: {path}.log)")


# ----------------------------------------------------------------------
# control plane (status / shutdown — used by the CLI, bench, tests)


def call_control(method: str, params: Optional[dict] = None,
                 path: Optional[str] = None, timeout: float = 10.0) -> dict:
    """One control-method round trip against a RUNNING daemon (never
    spawns). Raises :class:`DaemonUnavailable` when none is reachable
    or the answer is not a result frame."""
    resolved = protocol.socket_path(path)
    conn = _try_connect(resolved, timeout=timeout)
    if conn is None:
        raise DaemonUnavailable(f"no daemon on {resolved}")
    sock, rfile, wfile = conn
    try:
        sock.settimeout(timeout)
        try:
            protocol.write_message(wfile, {"id": 1, "method": method,
                                           "params": params or {}})
            resp = protocol.read_message(rfile)
        except (OSError, ValueError, protocol.ProtocolError) as exc:
            raise DaemonUnavailable(f"transport failed: {exc}") from exc
        if not (isinstance(resp, dict) and resp.get("id") == 1
                and isinstance(resp.get("result"), dict)):
            raise DaemonUnavailable(f"malformed {method} response")
        return resp["result"]
    finally:
        _close(sock, rfile, wfile)


def capture_profile(seconds: float, out_dir: Optional[str] = None,
                    path: Optional[str] = None) -> dict:
    """Ask a RUNNING daemon for an on-demand profile capture. The
    daemon blocks the control connection for the capture window, so
    the transport timeout trails ``seconds`` by a wide margin. Returns
    the capture result dict (``ok``/``dir``/``files`` or
    ``ok=False``/``error``)."""
    params: Dict[str, Any] = {"seconds": float(seconds)}
    if out_dir:
        params["out_dir"] = str(out_dir)
    return call_control("profile", params=params, path=path,
                        timeout=float(seconds) + 30.0)


def call_verb(verb: str, params: dict, path: Optional[str] = None,
              timeout: Optional[float] = None) -> dict:
    """Raw verb request against a RUNNING daemon, returning the full
    response frame (``result`` or ``error``) — the bench and the
    concurrency tests drive the protocol directly with this."""
    resolved = protocol.socket_path(path)
    conn = _try_connect(resolved, timeout=timeout or 10.0)
    if conn is None:
        raise DaemonUnavailable(f"no daemon on {resolved}")
    sock, rfile, wfile = conn
    try:
        sock.settimeout(timeout)
        try:
            protocol.write_message(wfile, {"id": 1, "method": verb,
                                           "params": params})
            resp = protocol.read_message(rfile)
        except (OSError, ValueError, protocol.ProtocolError) as exc:
            raise DaemonUnavailable(f"transport failed: {exc}") from exc
        if resp is None:
            raise DaemonUnavailable("daemon closed the connection")
        return resp
    finally:
        _close(sock, rfile, wfile)
