"""The port's fleet transport against the JAX package's
(``fleet/transport.py``): addresses, deadlines and backoff, TLS and
mTLS on loopback, dead versus half-open, and elastic membership over
real TCP.

- ``tcp://host:port`` (bracketed IPv6 included) parses as in the JAX
  package, a malformed address is a ``ValueError`` in both; a ``:0``
  listener resolves to a dialable address.
- Backoff is jittered and capped (the transport's resends and the
  client's reconnects).
- With ``SEMMERGE_FLEET_TLS_*`` set the loopback round trip is mTLS, and
  a client without a certificate is refused.
- ``heartbeat`` tells a dead member (``connect``) from a half-open one
  (``read-timeout``); the test server shuts its listener down before
  closing it (:func:`transport.close_listener`), so the dead member is
  really dead — a bare ``close()`` of a socket another thread sits in
  ``accept()`` on leaves it listening on Linux.
- The injected ``net:*`` faults raise the JAX package's
  ``TransportFault``s.
- A port daemon joins a pure-remote port router over TCP (``serve
  --join``), shows up in ``member_status`` as a remote ready member with
  ``transport: tcp``, drains as ``draining`` (not ``dead``) and leaves;
  a SIGTERM announces the leave; the router's status has its transport
  block; a daemon of another package is refused at ``join``.
- A non-loopback metrics bind is refused without TLS and served as
  HTTPS with it.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import ssl
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from semantic_merge_tpu import errors as jax_errors
from semantic_merge_tpu.fleet import transport as jax_transport
from semantic_merge_tpu_torch.errors import TransportFault
from semantic_merge_tpu_torch.fleet import transport
from semantic_merge_tpu_torch.service import protocol, telemetry
from semantic_merge_tpu_torch.utils import faults

from test_torch_fleet import (WAIT, control, counter_total, env_for, spawn_router,
                              stop_router)


# --- addresses --------------------------------------------------------------------------

GOOD = ["tcp://10.0.0.7:7633", "tcp://[::1]:7633", "tcp://localhost:0", "tcp://h:1"]
BAD = ["/run/semmerge.sock", "tcp://", "tcp://host", "tcp://host:port", "tcp://:7633",
       "tcp://[]:7633"]


@pytest.mark.parametrize("address", GOOD + BAD)
def test_tcp_addresses_parse_as_in_jax(address):
    assert transport.is_tcp(address) == jax_transport.is_tcp(address)
    assert transport.describe(address) == jax_transport.describe(address)
    if address in GOOD:
        assert transport.tcp_endpoint(address) == jax_transport.tcp_endpoint(address)
    else:
        for pkg in (transport, jax_transport):
            with pytest.raises(ValueError):
                pkg.tcp_endpoint(address)


def test_bound_address_resolves_an_ephemeral_port():
    srv = transport.listen("tcp://127.0.0.1:0")
    try:
        addr = transport.bound_address(srv, "tcp://127.0.0.1:0")
        host, port = transport.tcp_endpoint(addr)
        assert host == "127.0.0.1" and port == srv.getsockname()[1] > 0
    finally:
        transport.close_listener(srv)
    assert transport.bound_address(None, "/run/x.sock") == "/run/x.sock"


def test_knobs_are_the_jax_packages(monkeypatch):
    for value in ("", "3.5", "bogus"):
        for name in ("SEMMERGE_FLEET_CONNECT_TIMEOUT", "SEMMERGE_FLEET_HEARTBEAT_TIMEOUT",
                     "SEMMERGE_FLEET_RESENDS"):
            monkeypatch.setenv(name, value)
        assert transport.connect_timeout() == jax_transport.connect_timeout()
        assert transport.heartbeat_timeout() == jax_transport.heartbeat_timeout()
        assert transport.resends() == jax_transport.resends()
    assert (transport.OPS, transport.HEARTBEAT_OUTCOMES) == \
        (jax_transport.OPS, jax_transport.HEARTBEAT_OUTCOMES)


def test_resend_backoff_is_jittered_and_capped():
    for attempt in range(12):
        ceiling = min(2.0, 0.05 * (2.0 ** attempt))
        assert all(0.0 <= transport.backoff_s(attempt) <= ceiling for _ in range(50))
    assert len({round(transport.backoff_s(6), 9) for _ in range(50)}) > 1


def test_client_reconnect_backoff_decorrelated():
    from semantic_merge_tpu_torch.service.client import _reconnect_backoff_s
    assert _reconnect_backoff_s(0.0) == pytest.approx(0.05)
    for prev in (0.05, 0.2, 1.0, 50.0):
        hi = min(2.0, max(prev * 3.0, 0.05))
        assert all(0.05 <= _reconnect_backoff_s(prev) <= hi for _ in range(100))
    assert len({round(_reconnect_backoff_s(1.0), 9) for _ in range(50)}) > 1


# --- loopback round trips ---------------------------------------------------------------

class HelloServer:
    """A minimal in-process member answering ``hello`` on a transport
    listener. ``mute=True`` accepts and never replies (half-open);
    ``slam=True`` closes right after accept. :meth:`close` shuts the
    listener down before closing it."""

    def __init__(self, *, mute=False, slam=False):
        self.sock = transport.listen("tcp://127.0.0.1:0")
        self.address = transport.bound_address(self.sock, "tcp://127.0.0.1:0")
        self._mute, self._slam, self._held = mute, slam, []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except ssl.SSLError:  # a refused client handshake: keep serving
                continue
            except (OSError, ValueError):
                return
            if self._slam:
                conn.close()
                continue
            if self._mute:
                self._held.append(conn)
                continue
            try:
                req = protocol.read_message(conn.makefile("r", encoding="utf-8"))
                protocol.write_message(conn.makefile("w", encoding="utf-8"), {
                    "id": req["id"],
                    "result": {"ok": True, "pid": os.getpid(),
                               "version": protocol.PROTOCOL_VERSION, "fleet": False,
                               "draining": False}})
            except Exception:  # noqa: BLE001 — a test peer
                pass
            finally:
                with contextlib.suppress(OSError):
                    conn.close()

    def close(self):
        transport.close_listener(self.sock)
        self._thread.join(timeout=10)
        for conn in self._held:
            with contextlib.suppress(OSError):
                conn.close()


def test_plaintext_tcp_roundtrip_and_heartbeat():
    srv = HelloServer()
    try:
        hello = transport.heartbeat(srv.address, timeout=10.0)
        assert hello["ok"] and hello["draining"] is False
        assert transport.call(srv.address, "hello", {}, timeout=10.0)["ok"]
    finally:
        srv.close()


def test_heartbeat_distinguishes_dead_from_half_open():
    srv = HelloServer()
    dead = srv.address
    srv.close()
    assert not srv._thread.is_alive()  # the accept loop woke and ended
    with pytest.raises(TransportFault) as info:
        transport.heartbeat(dead, timeout=2.0)
    assert info.value.cause == "connect"
    mute = HelloServer(mute=True)
    try:
        with pytest.raises(TransportFault) as info:
            transport.heartbeat(mute.address, timeout=0.5)
        assert info.value.cause == "read-timeout" and info.value.exit_code == 21
    finally:
        mute.close()


def test_close_listener_stops_a_blocked_accept():
    sock = transport.listen("tcp://127.0.0.1:0")
    address = transport.bound_address(sock, "tcp://127.0.0.1:0")
    woke = threading.Event()

    def accept():
        with contextlib.suppress(OSError, ValueError):
            sock.accept()
        woke.set()

    threading.Thread(target=accept, daemon=True).start()
    time.sleep(0.2)  # the thread is in accept()
    transport.close_listener(sock)
    assert woke.wait(10)
    assert transport.dial(address, timeout=2.0) is None


def test_roundtrip_peer_close_is_typed():
    srv = HelloServer(slam=True)
    try:
        with pytest.raises(TransportFault) as info:
            transport.roundtrip(srv.address, {"id": 0, "method": "hello", "params": {}},
                                read_deadline=5.0)
        assert info.value.cause in ("eof", "ProtocolError", "ConnectionResetError",
                                    "BrokenPipeError")
    finally:
        srv.close()


def test_call_returns_none_after_the_resend_budget():
    t0 = time.monotonic()
    assert transport.call("tcp://127.0.0.1:1", "hello", {}, timeout=0.5, retries=1) is None
    assert time.monotonic() - t0 < 30.0


@pytest.mark.parametrize("spec", ["net:connect:fault", "net:connect:raise",
                                  "net:partition:fault", "net:read:raise"])
def test_injected_net_faults_are_the_jax_packages(monkeypatch, spec):
    monkeypatch.setenv("SEMMERGE_FAULT", spec)
    faults.reset()
    got = []
    for pkg, fault_type in ((transport, TransportFault),
                            (jax_transport, jax_errors.TransportFault)):
        with pytest.raises(fault_type) as info:
            pkg.check_dial_faults() if "read" not in spec else pkg.check_read_faults()
        exc = info.value
        got.append((str(exc), exc.stage, exc.cause, exc.exit_code))
    assert got[0] == got[1] and got[0][3] == 21


def test_net_slow_injects_latency(monkeypatch):
    monkeypatch.setenv("SEMMERGE_FAULT", "net:slow:lag")
    monkeypatch.setenv("SEMMERGE_FAULT_NET_SLOW_S", "0.3")
    t0 = time.monotonic()
    transport.check_dial_faults()
    assert time.monotonic() - t0 >= 0.3


# --- TLS / mTLS -------------------------------------------------------------------------

def make_certs(tmp_path):
    """A private CA and one endpoint certificate signed by it."""
    ca_key, ca_pem = str(tmp_path / "ca.key"), str(tmp_path / "ca.pem")
    ep_key, ep_csr, ep_pem = (str(tmp_path / "ep.key"), str(tmp_path / "ep.csr"),
                              str(tmp_path / "ep.pem"))

    def run(*argv):
        subprocess.run(argv, check=True, capture_output=True, timeout=WAIT)

    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", ca_key,
        "-out", ca_pem, "-days", "2", "-subj", "/CN=semmerge-test-ca")
    run("openssl", "req", "-newkey", "rsa:2048", "-nodes", "-keyout", ep_key, "-out", ep_csr,
        "-subj", "/CN=127.0.0.1")
    run("openssl", "x509", "-req", "-in", ep_csr, "-CA", ca_pem, "-CAkey", ca_key,
        "-CAcreateserial", "-out", ep_pem, "-days", "2")
    return ca_pem, ep_pem, ep_key


def _tls_env(monkeypatch, tmp_path):
    if not os.path.exists("/usr/bin/openssl"):
        pytest.skip("openssl unavailable")
    ca_pem, ep_pem, ep_key = make_certs(tmp_path)
    monkeypatch.setenv(transport.ENV_TLS_CERT, ep_pem)
    monkeypatch.setenv(transport.ENV_TLS_KEY, ep_key)
    monkeypatch.setenv(transport.ENV_TLS_CA, ca_pem)
    return ca_pem, ep_pem, ep_key


def test_mtls_roundtrip_and_unauthenticated_client_refused(tmp_path, monkeypatch):
    _ca, ep_pem, ep_key = _tls_env(monkeypatch, tmp_path)
    assert transport.tls_enabled() and jax_transport.tls_enabled()
    srv = HelloServer()  # the listener wraps itself from the same environment
    try:
        assert transport.heartbeat(srv.address, timeout=10.0)["ok"]
        # The JAX package's transport speaks to it with the same material.
        assert jax_transport.heartbeat(srv.address, timeout=10.0)["ok"]
        monkeypatch.delenv(transport.ENV_TLS_CERT)
        monkeypatch.delenv(transport.ENV_TLS_KEY)
        with pytest.raises(TransportFault):
            transport.heartbeat(srv.address, timeout=5.0)
        monkeypatch.setenv(transport.ENV_TLS_CERT, ep_pem)
        monkeypatch.setenv(transport.ENV_TLS_KEY, ep_key)
        assert transport.heartbeat(srv.address, timeout=10.0)["ok"]
    finally:
        srv.close()


def test_metrics_bind_beyond_loopback_needs_tls(tmp_path, monkeypatch):
    for name in (transport.ENV_TLS_CERT, transport.ENV_TLS_KEY, transport.ENV_TLS_CA):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="without SEMMERGE_FLEET_TLS_CERT"):
        telemetry.TelemetryServer(0, lambda: {"ok": True}, host="0.0.0.0")
    ca_pem, ep_pem, ep_key = _tls_env(monkeypatch, tmp_path)
    server = telemetry.TelemetryServer(0, lambda: {"ok": True, "draining": False},
                                       host="0.0.0.0").start()
    try:
        assert server.tls
        ctx = ssl.create_default_context(cafile=ca_pem)
        ctx.check_hostname = False
        ctx.load_cert_chain(ep_pem, ep_key)
        with urllib.request.urlopen(f"https://127.0.0.1:{server.port}/healthz",
                                    context=ctx, timeout=10) as resp:
            assert json.loads(resp.read())["ok"] is True
    finally:
        server.stop()


# --- elastic membership over TCP ----------------------------------------------------------

def spawn_member(router_sock, tmp_path, *, member_id="blue", join_interval="0.5",
                 capacity=2, package="semantic_merge_tpu_torch"):
    argv = [sys.executable, "-m", package, "serve", "--socket", "tcp://127.0.0.1:0",
            "--join", str(router_sock), "--member-id", member_id, "--capacity", str(capacity),
            "--idle-exit", "120"]
    if package == "semantic_merge_tpu_torch":
        argv += ["--device", "cpu"]
    with open(tmp_path / f"member-{member_id}.log", "ab") as log:
        return subprocess.Popen(
            argv, stdin=subprocess.DEVNULL, stdout=log, stderr=log, cwd="/",
            env=env_for(SEMMERGE_FLEET_JOIN_INTERVAL=join_interval,
                        SEMMERGE_SERVICE_DRAIN_TIMEOUT="2"),
            start_new_session=True)


def wait_members(router_sock, want_ids, timeout=WAIT):
    deadline = time.monotonic() + timeout
    status = None
    while time.monotonic() < deadline:
        status = control(router_sock, "status")
        if {m["id"] for m in (status or {}).get("members", [])} == set(want_ids):
            return status
        time.sleep(0.2)
    raise AssertionError(f"members never settled to {want_ids}: {status}")


def stop_member(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    return proc.returncode


def test_tcp_member_joins_drains_and_leaves(tmp_path):
    sock = tmp_path / "fleet.sock"
    router = spawn_router(sock, members=0)
    member = None
    try:
        # One announce (a long interval): the leave below must stick.
        member = spawn_member(sock, tmp_path, join_interval="3600")
        status = wait_members(sock, {"blue"})
        blue = {m["id"]: m for m in status["members"]}["blue"]
        assert blue["remote"] is True and blue["state"] == "ready" and blue["capacity"] == 2
        assert transport.tcp_endpoint(blue["socket"])[1] > 0
        assert status["members_up"] == 1
        assert counter_total(status, "fleet_joins_total") >= 1
        block = control(sock, "member_status")["members"]["blue"]
        assert block["state"] == "ready" and block["router_view"]["remote"] is True
        assert block["transport"] == "tcp" and block["fleet_member"] == "blue"
        assert block["fleet_join"]["joined_as"] == "blue" and block["package"] == \
            protocol.PACKAGE
        ack = control(sock, "drain", {"member": "blue"})
        assert ack["ok"] and ack["member_ack"]["draining"] is True
        status = control(sock, "status")
        assert {m["id"]: m for m in status["members"]}["blue"]["state"] == "draining"
        assert (status["members_draining"], status["members_dead"],
                status["members_up"]) == (1, 0, 0)
        ack = control(sock, "leave", {"member": "blue"})
        assert ack["ok"] and ack["member"] == "blue"
        assert all(m["id"] != "blue" for m in control(sock, "status")["members"])
        assert stop_member(member) == 0
    finally:
        if member is not None:
            stop_member(member)
        stop_router(router)


def test_tcp_member_sigterm_announces_leave(tmp_path):
    sock = tmp_path / "fleet.sock"
    router = spawn_router(sock, members=0, SEMMERGE_FLEET_HEALTH_INTERVAL="0.3")
    member = None
    try:
        member = spawn_member(sock, tmp_path, member_id="ephem", join_interval="0.4")
        wait_members(sock, {"ephem"})
        assert stop_member(member) == 0
        member = None
        status = wait_members(sock, set())
        assert counter_total(status, "fleet_failovers_total", reason="leave") >= 1
        assert counter_total(status, "fleet_failovers_total", reason="health") == 0
    finally:
        if member is not None:
            stop_member(member)
        stop_router(router)


def test_router_refuses_a_daemon_of_another_package(tmp_path):
    """The JAX package's daemon announces itself: the port's router
    refuses it, so no routed merge runs on another engine; the router's
    status has its transport block."""
    sock = tmp_path / "fleet.sock"
    router = spawn_router(sock, members=0)
    member = None
    try:
        status = control(sock, "status")
        t = status["transport"]
        assert t["tls"] is False and t["connect_timeout_s"] > 0 and \
            t["heartbeat_timeout_s"] > 0 and t["resends"] >= 0 and t["handoff_max"] >= 1
        assert isinstance(status["affinity_epoch"], int)
        member = spawn_member(sock, tmp_path, member_id="jx", join_interval="0.5",
                              package="semantic_merge_tpu")
        deadline = time.monotonic() + WAIT
        log = tmp_path / "member-jx.log"
        while "join rejected" not in (log.read_text() if log.exists() else ""):
            assert member.poll() is None and time.monotonic() < deadline
            time.sleep(0.2)
        assert "is not a semantic_merge_tpu_torch daemon" in log.read_text()
        assert control(sock, "status")["members"] == []
    finally:
        if member is not None:
            stop_member(member)
        stop_router(router)
