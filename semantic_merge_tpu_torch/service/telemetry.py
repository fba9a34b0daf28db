"""Local-only HTTP telemetry listener for the merge service daemon (the
port of the JAX package's ``service/telemetry.py``).

``SEMMERGE_METRICS_PORT=<port>`` makes the daemon serve two read-only
endpoints on ``127.0.0.1`` (never a routable interface — this is an
operator loopback, not an ingress):

- ``GET /metrics`` — live Prometheus text exposition (format 0.0.4) of
  the process registry, scrape-ready;
- ``GET /healthz`` — one JSON object with the daemon's health surface
  (queue depth, in-flight count, breaker states, RSS, uptime — the
  same shape ``semmerge serve --status`` prints). When the daemon has
  SLO objectives configured and the SLO engine reports a tripped
  burn-rate clause, the endpoint answers **503** with
  ``"degraded": true`` so plain HTTP health checks (load balancers,
  systemd watchdogs) see the burn without parsing the body.

``SEMMERGE_METRICS_PORT=0`` binds an ephemeral port; the bound port is
reported in the daemon ``status()`` payload (``metrics_port``) so
tests and tooling can discover it. Unset/empty disables the listener
entirely — the daemon never opens a TCP socket unless asked.

``SEMMERGE_METRICS_BIND=<host>`` widens the bind address so cross-host
fleets can scrape members directly — but only under TLS, as in the JAX
package: a non-loopback bind is **refused** (the listener stays dark,
loudly) unless the fleet's TLS material (``SEMMERGE_FLEET_TLS_CERT`` /
``_KEY`` / ``_CA``, :mod:`semantic_merge_tpu_torch.fleet.transport`) is
configured, in which case the listener serves HTTPS with the same cert,
and a configured CA makes it mutual.
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from ..fleet import transport as fleet_transport
from ..obs import metrics as obs_metrics
from ..utils.loggingx import logger

ENV_PORT = "SEMMERGE_METRICS_PORT"
ENV_BIND = "SEMMERGE_METRICS_BIND"

_LOOPBACK = ("127.0.0.1", "::1", "localhost", "")


def _bind_host() -> str:
    return os.environ.get(ENV_BIND, "").strip() or "127.0.0.1"


class _Handler(BaseHTTPRequestHandler):
    server_version = "semmerge-telemetry"
    protocol_version = "HTTP/1.1"

    def _send(self, code: int, content_type: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (http.server contract)
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                metrics_fn = getattr(self.server, "semmerge_metrics", None)
                text = metrics_fn() if metrics_fn is not None \
                    else obs_metrics.REGISTRY.render_prometheus()
                self._send(200, "text/plain; version=0.0.4; charset=utf-8",
                           text.encode("utf-8"))
            elif path in ("/healthz", "/health"):
                health = self.server.semmerge_health()  # type: ignore[attr-defined]
                slo = health.get("slo") if isinstance(health, dict) else None
                degraded = bool(slo) and not slo.get("healthy", True)
                if isinstance(health, dict):
                    health = dict(health, degraded=degraded)
                self._send(503 if degraded else 200, "application/json",
                           json.dumps(health, default=str).encode("utf-8"))
            else:
                self._send(404, "text/plain; charset=utf-8", b"not found\n")
        except Exception as exc:  # serving telemetry must never crash a conn
            try:
                self._send(500, "text/plain; charset=utf-8",
                           f"{type(exc).__name__}: {exc}\n".encode("utf-8"))
            except OSError:
                pass

    def log_message(self, format: str, *args: object) -> None:
        pass  # scrape traffic does not belong on the daemon's stderr


class TelemetryServer:
    """A loopback-bound threading HTTP server; start/stop mirror the
    daemon's serve/teardown lifecycle."""

    def __init__(self, port: int,
                 health_fn: Callable[[], dict],
                 metrics_fn: Optional[Callable[[], str]] = None,
                 host: Optional[str] = None) -> None:
        bind = host if host is not None else _bind_host()
        tls_ctx = None
        if bind not in _LOOPBACK:
            # Widened bind: TLS or nothing. Plaintext metrics on a
            # routable interface leak repo paths and member topology.
            tls_ctx = fleet_transport.server_context()
            if tls_ctx is None:
                raise ValueError(
                    f"refusing non-loopback metrics bind {bind!r} "
                    f"without SEMMERGE_FLEET_TLS_CERT material")
        self._httpd = ThreadingHTTPServer((bind, port), _Handler)
        if tls_ctx is not None:
            self._httpd.socket = tls_ctx.wrap_socket(
                self._httpd.socket, server_side=True)
        self.tls = tls_ctx is not None
        self._httpd.daemon_threads = True
        self._httpd.semmerge_health = health_fn  # type: ignore[attr-defined]
        # Optional exposition override: the daemon publishes its window
        # gauges before rendering; the fleet router serves its federated
        # view (member scrapes + rollups).
        self._httpd.semmerge_metrics = metrics_fn  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    def start(self) -> "TelemetryServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="svc-telemetry", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)


def maybe_start(health_fn: Callable[[], dict],
                metrics_fn: Optional[Callable[[], str]] = None
                ) -> Optional[TelemetryServer]:
    """Start the listener when ``SEMMERGE_METRICS_PORT`` is set; return
    ``None`` (and stay dark) when unset, unparsable, or unbindable —
    telemetry must never stop the daemon from serving merges."""
    raw = os.environ.get(ENV_PORT, "").strip()
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        return None
    try:
        return TelemetryServer(port, health_fn, metrics_fn).start()
    except ValueError as exc:
        # Refused non-loopback bind: stay dark, but say why.
        logger.error("telemetry listener disabled: %s", exc)
        return None
    except OSError:
        return None
