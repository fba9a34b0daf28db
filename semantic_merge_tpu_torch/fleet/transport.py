"""Pluggable fleet member transport: unix sockets, TCP, optional mTLS
(the JAX package's ``fleet/transport.py``, same addresses, TLS
variables, deadlines and metric names).

Every router↔member round-trip — verb dispatch, control calls, health
heartbeats — and the client's fleet-socket dial goes through this seam.
Addresses select the transport::

    /run/semmerge-torch.sock.m0    # plain path: AF_UNIX (the default)
    tcp://10.0.0.7:7633            # TCP: members on other hosts
    tcp://[::1]:7633               # bracketed IPv6

TLS is configured by environment (both sides of a fleet share it):

=========================  ============================================
env var                    meaning
=========================  ============================================
SEMMERGE_FLEET_TLS_CERT    PEM cert chain this endpoint presents
SEMMERGE_FLEET_TLS_KEY     its private key (defaults to the cert file)
SEMMERGE_FLEET_TLS_CA      CA bundle the *peer* must chain to — setting
                           it turns verification on in both directions
                           (mTLS); a fleet pins its own private CA, so
                           hostname checks are off (members are
                           addressed by IP/port, identity comes from
                           the CA signature)
=========================  ============================================

Robustness: per-call connect/read deadlines
(``SEMMERGE_FLEET_CONNECT_TIMEOUT``, ``SEMMERGE_FLEET_READ_TIMEOUT``),
jittered exponential backoff between bounded resends
(``SEMMERGE_FLEET_RESENDS`` — safe because every fleet request carries
an idempotency key), and application-level heartbeats
(:func:`heartbeat`, a ``hello`` round trip under
``SEMMERGE_FLEET_HEARTBEAT_TIMEOUT``) that detect half-open connections
TCP keepalive would sit on for minutes. Transport-shaped failures raise
:class:`~semantic_merge_tpu_torch.errors.TransportFault` (exit 21 under
``SEMMERGE_FLEET=require``; under ``auto`` every caller degrades).

Listeners are closed with :func:`close_listener`, which shuts the
socket down before closing it: on Linux a bare ``close()`` of a socket
another thread is blocked in ``accept()`` on leaves it listening, so a
"dead" member would still accept dials.

The ``net:*`` fault stages (``utils/faults.py``) are wired here:
``net:connect`` fires before each dial, ``net:read`` before each reply
read, ``net:partition`` at both seams, and ``net:slow`` injects
``SEMMERGE_FAULT_NET_SLOW_S`` (default 0.2 s) of latency per dial when
given a verbatim kind token (``net:slow:lag``).

Import-light: stdlib, the error taxonomy and the fault harness — the
client dials through this module before torch exists in the process.
"""
from __future__ import annotations

import contextlib
import os
import random
import socket
import ssl
import time
from typing import Any, Dict, Optional, Tuple

from ..errors import TransportFault, fault_boundary
from ..service import protocol
from ..utils import faults
from ..utils.procs import env_seconds

#: Address prefix selecting the TCP transport.
TCP_PREFIX = "tcp://"

ENV_TLS_CERT = "SEMMERGE_FLEET_TLS_CERT"
ENV_TLS_KEY = "SEMMERGE_FLEET_TLS_KEY"
ENV_TLS_CA = "SEMMERGE_FLEET_TLS_CA"

_ERRORS_HELP = "Fleet transport failures, by operation"
_RESENDS_HELP = "Idempotency-keyed transport resends after a failed leg"
_HEARTBEATS_HELP = "Application-level member heartbeats, by outcome"

#: Documented ``fleet_transport_errors_total`` op label values.
OPS = ("dial", "read", "control", "heartbeat")
#: Documented ``fleet_heartbeats_total`` outcome label values.
HEARTBEAT_OUTCOMES = ("ok", "connect", "timeout", "error")


# ----------------------------------------------------------------------
# addresses


def is_tcp(address: str) -> bool:
    """True when ``address`` selects the TCP transport."""
    return str(address).startswith(TCP_PREFIX)


def tcp_endpoint(address: str) -> Tuple[str, int]:
    """``(host, port)`` of a ``tcp://host:port`` address (bracketed
    IPv6 accepted). Raises ``ValueError`` on anything else."""
    if not is_tcp(address):
        raise ValueError(f"not a tcp:// address: {address!r}")
    rest = address[len(TCP_PREFIX):]
    host, sep, port = rest.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"malformed tcp address: {address!r}")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    if not host:
        raise ValueError(f"malformed tcp address: {address!r}")
    return host, int(port)


def describe(address: str) -> str:
    """Short log-friendly form of an address."""
    return address if is_tcp(address) else os.path.basename(address) or \
        address


def bound_address(sock: socket.socket, address: str) -> str:
    """The concrete address a listener bound — resolves a ``:0``
    ephemeral TCP port to the kernel-assigned one so a member can
    advertise something dialable."""
    if not is_tcp(address):
        return address
    host, port = tcp_endpoint(address)
    if port != 0:
        return address
    actual = sock.getsockname()[1]
    rendered = f"[{host}]" if ":" in host else host
    return f"{TCP_PREFIX}{rendered}:{actual}"


# ----------------------------------------------------------------------
# knobs


def connect_timeout() -> float:
    return env_seconds("SEMMERGE_FLEET_CONNECT_TIMEOUT", 5.0)


def read_timeout(default: float) -> float:
    return env_seconds("SEMMERGE_FLEET_READ_TIMEOUT", default)


def heartbeat_timeout() -> float:
    return env_seconds("SEMMERGE_FLEET_HEARTBEAT_TIMEOUT", 2.0)


def resends() -> int:
    raw = os.environ.get("SEMMERGE_FLEET_RESENDS", "").strip()
    try:
        return max(0, int(raw)) if raw else 2
    except ValueError:
        return 2


def backoff_s(attempt: int, base: float = 0.05, cap: float = 2.0) -> float:
    """Full-jitter exponential backoff: ``uniform(0, min(cap,
    base * 2^attempt))`` — resending peers decorrelate instead of
    hammering a recovering member in lockstep."""
    return random.uniform(0.0, min(cap, base * (2.0 ** attempt)))


# ----------------------------------------------------------------------
# TLS


def _tls_env() -> Tuple[str, str, str]:
    cert = os.environ.get(ENV_TLS_CERT, "").strip()
    key = os.environ.get(ENV_TLS_KEY, "").strip() or cert
    ca = os.environ.get(ENV_TLS_CA, "").strip()
    return cert, key, ca


def tls_enabled() -> bool:
    """True when any fleet TLS material is configured."""
    cert, _key, ca = _tls_env()
    return bool(cert or ca)


def client_context() -> Optional[ssl.SSLContext]:
    """The dial-side TLS context, or ``None`` for plaintext. With a CA
    configured the server must chain to it; with a cert configured this
    endpoint presents it (the server's mTLS requirement)."""
    cert, key, ca = _tls_env()
    if not (cert or ca):
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    if ca:
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(cafile=ca)
    else:
        ctx.verify_mode = ssl.CERT_NONE
    if cert:
        ctx.load_cert_chain(certfile=cert, keyfile=key)
    return ctx


def server_context() -> Optional[ssl.SSLContext]:
    """The listen-side TLS context, or ``None`` for plaintext. Needs a
    cert to serve; with a CA configured every client must present a
    cert chaining to it (mTLS)."""
    cert, key, ca = _tls_env()
    if not cert:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile=cert, keyfile=key)
    if ca:
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(cafile=ca)
    return ctx


# ----------------------------------------------------------------------
# fault seams


def _slow_s() -> float:
    raw = os.environ.get("SEMMERGE_FAULT_NET_SLOW_S", "").strip()
    try:
        return float(raw) if raw else 0.2
    except ValueError:
        return 0.2


def check_dial_faults() -> None:
    """The ``net:connect`` / ``net:slow`` / ``net:partition`` injection
    seams, fired before every dial. Plain ``raise`` kinds classify into
    :class:`TransportFault` at the boundary."""
    with fault_boundary("net:connect"):
        faults.check("net:connect")
    with fault_boundary("net:slow"):
        token = faults.check("net:slow")
    if token is not None:
        time.sleep(_slow_s())
    with fault_boundary("net:partition"):
        faults.check("net:partition")


def check_read_faults() -> None:
    """The ``net:read`` / ``net:partition`` seams, fired before every
    reply read."""
    with fault_boundary("net:read"):
        faults.check("net:read")
    with fault_boundary("net:partition"):
        faults.check("net:partition")


# ----------------------------------------------------------------------
# metrics (lazy: the client imports this module pre-everything)


def _count_error(op: str) -> None:
    from ..obs import metrics as obs_metrics
    obs_metrics.REGISTRY.counter("fleet_transport_errors_total",
                                 _ERRORS_HELP).inc(1, op=op)


def count_resend() -> None:
    from ..obs import metrics as obs_metrics
    obs_metrics.REGISTRY.counter("fleet_transport_resends_total",
                                 _RESENDS_HELP).inc(1)


def _count_heartbeat(outcome: str) -> None:
    from ..obs import metrics as obs_metrics
    obs_metrics.REGISTRY.counter("fleet_heartbeats_total",
                                 _HEARTBEATS_HELP).inc(1, outcome=outcome)


# ----------------------------------------------------------------------
# dial / listen


def dial(address: str, timeout: Optional[float] = None,
         tls: bool = True) -> Optional[socket.socket]:
    """Connect to a member address under the connect deadline. Returns
    the connected (TLS-wrapped when configured) socket, or ``None``
    when nothing usable is listening — absent path, refused, connect
    timeout, failed TLS handshake. Injected ``net:*`` faults raise
    :class:`TransportFault` instead."""
    check_dial_faults()
    t = timeout if timeout is not None else connect_timeout()
    if is_tcp(address):
        host, port = tcp_endpoint(address)
        try:
            sock = socket.create_connection((host, port), timeout=t)
        except OSError:
            _count_error("dial")
            return None
        ctx = client_context() if tls else None
        if ctx is not None:
            try:
                sock = ctx.wrap_socket(sock, server_hostname=host)
            except (OSError, ssl.SSLError):
                _count_error("dial")
                with contextlib.suppress(OSError):
                    sock.close()
                return None
        return sock
    if not os.path.exists(address):
        return None
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(t)
    try:
        sock.connect(address)
    except OSError:
        _count_error("dial")
        with contextlib.suppress(OSError):
            sock.close()
        return None
    return sock


def listen(address: str, backlog: int = 128) -> socket.socket:
    """Bind + listen on a TCP address (TLS-wrapped when a server cert
    is configured — accepted connections handshake on first I/O).
    Raises ``OSError`` on bind failure (the half-made socket is closed
    with :func:`close_listener`); unix paths stay with their owner's
    stale-socket dance (``daemon._bind``). Close the listener with
    :func:`close_listener`."""
    host, port = tcp_endpoint(address)
    family = socket.AF_INET6 if ":" in host else socket.AF_INET
    sock = socket.socket(family, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        sock.listen(backlog)
        ctx = server_context()
        if ctx is not None:
            sock = ctx.wrap_socket(sock, server_side=True)
    except OSError:  # ssl.SSLError included
        close_listener(sock)
        raise
    return sock


def close_listener(sock: Optional[socket.socket]) -> None:
    """Shut a listening socket down, then close it. ``shutdown`` wakes
    a thread blocked in ``accept()`` and stops the kernel from
    completing new connections; a bare ``close()`` while another thread
    sits in ``accept()`` leaves the socket listening on Linux."""
    if sock is None:
        return
    with contextlib.suppress(OSError):
        sock.shutdown(socket.SHUT_RDWR)
    with contextlib.suppress(OSError):
        sock.close()


# ----------------------------------------------------------------------
# round trips


def roundtrip(address: str, payload: Dict[str, Any], *,
              connect_deadline: Optional[float] = None,
              read_deadline: Optional[float] = None) -> Dict[str, Any]:
    """One dial → write → read. Raises :class:`TransportFault` on any
    transport-shaped failure, with ``cause`` naming the seam that died:
    ``connect`` (nothing answered the dial), ``read-timeout`` (the
    connection is up but the reply never came — the half-open shape),
    ``eof`` (peer closed mid-request), or the exception class name."""
    sock = dial(address, timeout=connect_deadline)
    if sock is None:
        raise TransportFault(f"dial failed: {describe(address)}",
                             stage="transport", cause="connect")
    try:
        sock.settimeout(read_deadline if read_deadline is not None
                        else read_timeout(connect_timeout()))
        rfile = sock.makefile("r", encoding="utf-8")
        wfile = sock.makefile("w", encoding="utf-8")
        try:
            protocol.write_message(wfile, payload)
            check_read_faults()
            resp = protocol.read_message(rfile)
        except socket.timeout as exc:
            _count_error("read")
            raise TransportFault(
                f"read deadline expired: {describe(address)}",
                stage="transport", cause="read-timeout") from exc
        except (OSError, ValueError, protocol.ProtocolError) as exc:
            _count_error("read")
            raise TransportFault(str(exc), stage="transport",
                                 cause=type(exc).__name__) from exc
    finally:
        with contextlib.suppress(OSError):
            sock.close()
    if resp is None:
        _count_error("read")
        raise TransportFault(f"peer closed: {describe(address)}",
                             stage="transport", cause="eof")
    return resp


def call(address: str, method: str, params: Dict[str, Any], *,
         timeout: Optional[float] = None,
         read_deadline: Optional[float] = None,
         retries: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """Resilient control round-trip: bounded resends with jittered
    exponential backoff (control verbs are idempotent), ``None`` after
    the budget is spent or on a non-result answer."""
    budget = resends() if retries is None else max(0, retries)
    for attempt in range(budget + 1):
        if attempt:
            count_resend()
            time.sleep(backoff_s(attempt - 1))
        try:
            resp = roundtrip(
                address, {"id": 0, "method": method, "params": params},
                connect_deadline=timeout,
                read_deadline=read_deadline if read_deadline is not None
                else timeout)
        except TransportFault:
            _count_error("control")
            continue
        result = resp.get("result")
        return result if isinstance(result, dict) else None
    return None


def heartbeat(address: str,
              timeout: Optional[float] = None) -> Dict[str, Any]:
    """Application-level liveness probe: one ``hello`` round trip under
    the heartbeat deadline. Returns the hello result; raises
    :class:`TransportFault` whose ``cause`` distinguishes a dead member
    (``connect``) from a half-open/partitioned one (``read-timeout`` —
    the dial succeeds upstream of the break, the answer never comes)."""
    t = timeout if timeout is not None else heartbeat_timeout()
    try:
        resp = roundtrip(address,
                         {"id": 0, "method": "hello", "params": {}},
                         connect_deadline=t, read_deadline=t)
    except TransportFault as exc:
        _count_heartbeat("connect" if exc.cause == "connect"
                         else "timeout" if exc.cause == "read-timeout"
                         else "error")
        raise
    result = resp.get("result")
    if not isinstance(result, dict) or not result.get("ok"):
        _count_heartbeat("error")
        raise TransportFault(f"malformed hello from {describe(address)}",
                             stage="transport", cause="handshake")
    _count_heartbeat("ok")
    return result
