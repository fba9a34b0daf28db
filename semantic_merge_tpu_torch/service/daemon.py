"""The merge service daemon: warm state behind a unix socket (the port
of the JAX package's ``service/daemon.py``, on one device).

One process holds everything a one-shot CLI rebuilds per invocation —
torch and the loaded kernels (``nvcc`` builds once per process), the
process-wide decl cache, the shared interner with its device string
table and the identity-keyed device decl columns (warm residency,
:mod:`.residency`), the batch scheduler (:mod:`semantic_merge_tpu_torch.batch`),
the embedding matcher — and executes merge-shaped requests against it.
Requests flow:

    accept (handler thread)  →  bounded queue  →  executor thread

- **Admission**: ``service.accept`` span; a full queue rejects with a
  typed ``WorkerFault`` (exit 12, ``cause="queue-full"``) instead of
  unbounded buffering.
- **Dispatch**: the executor records ``service.queue_wait``, enforces
  the request deadline (expiry → ``DeadlineFault``, exit 15), and
  serializes same-repo ``--inplace`` requests behind a per-repo lock;
  the cross-process half of that exclusion is the lockfile the CLI's
  commit path takes (:func:`runtime.inplace.repo_lock`).
- **Execute**: ``service.execute`` span around the port's CLI ``main``
  under the request's working-dir scope (:mod:`utils.workdir`) and env
  overlay (:mod:`utils.reqenv`), stdout/stderr routed per thread back
  to the client (:class:`_ThreadTee`). Every ``MergeFault`` — injected
  ``service:*`` stage faults included — becomes a typed wire error; the
  daemon itself never dies of a request.

The daemon runs on its device (``serve`` runs on CUDA, ``--device
cpu`` for the tests); each request runs on the device its argv names,
as the one-shot CLI would, and only merges on the daemon's device join
its batches. There is no CPU rung: a device fault is the request's
answer.

Lifecycle: SIGTERM/SIGINT stop admission, drain in-flight work
(bounded by ``SEMMERGE_SERVICE_DRAIN_TIMEOUT``), then exit 0. A stale
socket left by a dead daemon is detected by a probe connect and
replaced; a live port daemon on the socket makes a second ``serve``
exit 0 immediately, a daemon of another package makes it exit 12. An
idle daemon exits after ``SEMMERGE_SERVICE_IDLE_EXIT`` seconds; idle
per-repo state is reaped after ``SEMMERGE_SERVICE_TTL``.

Live tools, as in the JAX daemon:

- **OTLP export**: with ``SEMMERGE_OTLP_ENDPOINT`` set, each served
  request's trace (its span rows, under its ``trace_id``) is shipped
  through :func:`~semantic_merge_tpu_torch.obs.export.maybe_exporter`
  after its telemetry is finished; a dead collector only counts in
  ``otlp_errors_total``, never in the request's answer. A fleet member
  exports nothing itself: it ships the span tree to the router (below),
  which exports the stitched trace once.
- **Profile capture** (the ``profile`` control method, ``profile
  --daemon``): a bounded ``torch.profiler`` window (0.1-60 s) over
  whatever the daemon serves meanwhile, with CUDA activity when the
  daemon runs on the card, written as a bundle directory
  ``profile-<stamp>-<pid>-<hex>`` holding the profiler's Chrome trace
  and ``bundle.json`` (the metrics before and after, the flight ring,
  the SLO verdict). One capture at a time: a second answers ``busy``.
  The session is started on the connection thread, so the trace holds
  the CUDA kernels and CUDA runtime calls of every thread, but no CPU
  op or range of the executor threads that run the requests
  (``torch.profiler`` records CPU activity on the starting thread only;
  ``chip_smoke.py`` prints both from the card). A request that carries ``--profile DIR`` during a
  capture runs unprofiled, and a capture during such a request
  reports ``profiler_started: false`` (one session per process;
  :mod:`semantic_merge_tpu_torch.runtime.trace`). With
  ``SEMMERGE_SLO_AUTOPROFILE`` on, the first SLO trip of the daemon's
  life starts one capture.

The daemon keeps normal GC cadence (``SEMMERGE_GC_TUNE=0``,
:mod:`semantic_merge_tpu_torch.utils.gctune`).

Fleet membership, as in the JAX daemon
(:mod:`semantic_merge_tpu_torch.fleet`): a router-spawned member runs
with ``SEMMERGE_FLEET_MEMBER`` set; its ``hello`` (the router's
heartbeat) carries ``fleet_member``, and under ``SEMMERGE_FLEET_STITCH``
(default on) each response ships the request's span tree in
``meta.spans`` for the router to graft into one stitched trace. A
``tcp://host:port`` socket listens on TCP (mTLS when
``SEMMERGE_FLEET_TLS_*`` is set; ``:0`` picks an ephemeral port,
resolved before anything is advertised). ``--join ROUTER`` announces
this daemon to a fleet router with a ``join`` handshake carrying the
advertised address, capacity and an announce epoch, re-announces every
``SEMMERGE_FLEET_JOIN_INTERVAL`` seconds (so an ejected member rejoins
once reachable), stops announcing while draining, and sends a
best-effort ``leave`` on shutdown. The ``prewarm`` verb (the router's
affinity handoff) resolves a repository's HEAD tree without touching
the device.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import queue
import signal
import socket
import ssl
import sys
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional

from ..errors import DeadlineFault, MergeFault, WorkerFault, fault_boundary
from ..fleet import transport as fleet_transport
from ..obs import agg as obs_agg
from ..obs import anomaly as obs_anomaly
from ..obs import export as obs_export
from ..obs import metrics as obs_metrics
from ..obs import sampling as obs_sampling
from ..obs import slo as obs_slo
from ..obs import spans as obs_spans
from ..obs import flight as obs_flight
from ..utils import faults, reqenv, workdir
from ..utils.loggingx import logger
from ..utils.procs import env_seconds
from . import protocol, resilience, telemetry
from . import residency as residency_mod

_OUTCOME_BY_EXIT = {0: "ok", 1: "conflicts", 2: "typecheck", 3: "git-error"}

_REQUESTS_HELP = "Service requests, by verb and outcome"
_LATENCY_HELP = "End-to-end service request seconds, by verb"
_QUEUE_DEPTH_HELP = "Requests currently waiting in the admission queue"
_SHED_HELP = "Requests shed by admission control, by reason"
_RSS_HELP = "Daemon resident set size (MiB), sampled by the pressure monitor"
_IDEM_HELP = "Requests answered from the idempotency cache"

#: What :meth:`Daemon._bind` returns when a daemon of another package
#: (or something not speaking the protocol) holds the socket.
_FOREIGN = object()

#: Pressure levels the RSS monitor publishes (watermark crossings).
_PRESSURE_NONE, _PRESSURE_SOFT, _PRESSURE_HARD = 0, 1, 2


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def _rss_mb() -> float:
    """Resident set size in MiB, from ``/proc/self/status`` (Linux);
    best-effort 0.0 elsewhere."""
    try:
        with open("/proc/self/status", encoding="ascii") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        pass
    return 0.0


def _request_batches() -> bool:
    """Will the current request's fused dispatches join the batch
    scheduler? Evaluated under the request's env overlay, so a
    client-shipped ``SEMMERGE_BATCH=off`` reads as non-batched."""
    from .. import batch
    return batch.posture() != "off" and batch.current() is not None


class _ThreadTee(io.TextIOBase):
    """A stdout/stderr stand-in routing writes to a per-thread buffer
    when one is pushed (an executor running a request) and to the real
    stream otherwise (daemon logs, stray prints from handler threads).
    ``print``/``sys.stdout`` resolve at call time, so swapping this in
    once at startup covers every write the CLI makes."""

    def __init__(self, fallback) -> None:
        self._fallback = fallback
        self._tls = threading.local()

    def push(self, buf: io.StringIO) -> None:
        self._tls.buf = buf

    def pop(self) -> None:
        self._tls.buf = None

    def _target(self):
        return getattr(self._tls, "buf", None) or self._fallback

    def write(self, s: str) -> int:
        return self._target().write(s)

    def flush(self) -> None:
        try:
            self._target().flush()
        except (OSError, ValueError):
            pass

    def writable(self) -> bool:
        return True

    @property
    def encoding(self):  # some libraries sniff it off sys.stdout
        return getattr(self._fallback, "encoding", "utf-8")


class _Request:
    __slots__ = ("id", "verb", "argv", "cwd", "env", "deadline_s",
                 "idem_key", "trace_id", "recorder", "t_accept", "done",
                 "response", "phases")

    def __init__(self, req_id, verb: str, params: Dict[str, Any]) -> None:
        self.id = req_id
        self.verb = verb
        self.argv = [str(a) for a in (params.get("argv") or [])]
        self.cwd = str(params.get("cwd") or "/")
        env = params.get("env") or {}
        self.env = {str(k): str(v) for k, v in env.items()}
        raw_deadline = params.get("deadline_s")
        self.deadline_s = float(raw_deadline) if raw_deadline else 0.0
        raw_idem = params.get("idempotency_key")
        self.idem_key = str(raw_idem) if raw_idem else None
        # Client-minted request trace id (a pre-trace_id client gets one
        # minted here); every span, artifact, worker frame, and
        # postmortem bundle of this request carries it.
        raw_trace = params.get("trace_id")
        self.trace_id = str(raw_trace) if raw_trace else os.urandom(8).hex()
        self.recorder = obs_spans.SpanRecorder(detailed=False)
        self.t_accept = time.monotonic()
        self.done = threading.Event()
        self.response: Optional[Dict[str, Any]] = None
        self.phases: Optional[Dict[str, Any]] = None


class Daemon:
    """One ``serve`` process. Construct (``device``: ``None``/``"cuda"``
    for the card, ``"cpu"`` only when asked; no card raises
    :class:`~semantic_merge_tpu_torch.device.DeviceUnavailable` here,
    before anything is bound), then :meth:`serve_forever`."""

    def __init__(self, socket_path: Optional[str] = None,
                 workers: Optional[int] = None,
                 queue_size: Optional[int] = None,
                 idle_exit: Optional[float] = None,
                 repo_ttl: Optional[float] = None,
                 events_path: Optional[str] = None,
                 device: Optional[str] = None,
                 join: Optional[str] = None,
                 advertise: Optional[str] = None,
                 capacity: Optional[int] = None,
                 member_id: Optional[str] = None) -> None:
        from ..device import resolve_device
        self._device = resolve_device(device)
        self._socket_path = protocol.socket_path(socket_path)
        # Elastic membership: announce to a fleet router instead of
        # being a router-spawned subprocess. The advertised address
        # defaults to the bound socket (resolved after an ephemeral :0
        # bind).
        self._join_addr = (join or os.environ.get("SEMMERGE_FLEET_JOIN", "").strip()
                           or None)
        self._advertise = (advertise
                           or os.environ.get("SEMMERGE_FLEET_ADVERTISE", "").strip()
                           or None)
        self._capacity = max(1, capacity if capacity is not None else
                             _env_int("SEMMERGE_FLEET_CAPACITY", 1))
        self._member_id = (member_id
                           or os.environ.get("SEMMERGE_FLEET_MEMBER_ID", "").strip()
                           or None)
        self._join_epoch = 0
        self._joined_as: Optional[str] = None
        # A router-spawned member: its id names it in the hello, the
        # sampling verdicts and the shipped span trees.
        self._fleet_member = os.environ.get("SEMMERGE_FLEET_MEMBER") or None
        self._workers_n = workers if workers is not None else \
            max(1, _env_int("SEMMERGE_SERVICE_WORKERS", 4))
        qsize = queue_size if queue_size is not None else \
            _env_int("SEMMERGE_SERVICE_QUEUE", 16)
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=max(1, qsize))
        self._idle_exit = idle_exit if idle_exit is not None else \
            env_seconds("SEMMERGE_SERVICE_IDLE_EXIT", 900.0)
        self._repo_ttl = repo_ttl if repo_ttl is not None else \
            env_seconds("SEMMERGE_SERVICE_TTL", 600.0)
        self._events_path = events_path
        self._recorder: Optional[obs_spans.SpanRecorder] = None
        self._stop = threading.Event()
        self._locks_lock = threading.Lock()
        self._repo_locks: Dict[str, Dict[str, Any]] = {}
        self._state_lock = threading.Lock()
        self._in_flight = 0
        self._served = 0
        self._last_activity = time.monotonic()
        self._t0 = time.time()
        # Admission control / load shedding state (see runbook,
        # "Overload & self-healing").
        self._exec_ewma = 0.0  # EWMA of one request's execute seconds
        self._soft_mb, self._hard_mb = resilience.rss_watermarks()
        self._pressure = _PRESSURE_NONE
        self._idem_cap = max(0, _env_int("SEMMERGE_SERVICE_IDEM_CACHE", 256))
        # Idempotency entries older than the TTL are dropped on lookup:
        # a resend after that long is treated as a fresh request (safe —
        # merges are deterministic and --inplace is journal-protected).
        # 0 (the default) keeps the pre-TTL behavior: size-only LRU.
        self._idem_ttl = max(0.0, env_seconds("SEMMERGE_SERVICE_IDEM_TTL",
                                              0.0))
        self._idem_lock = threading.Lock()
        self._idem: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        # Draining: admission closed (new requests get a *retryable*
        # typed rejection), in-flight work finishes. Set by the `drain`
        # wire verb and by the signal handler.
        self._draining = False
        self._telemetry: Optional[telemetry.TelemetryServer] = None
        # SLO engine: SEMMERGE_SLO env wins, then the [slo] config
        # table found from the daemon's cwd; None = no objectives, no
        # per-request overhead. A malformed spec raises here — at
        # startup, visibly — instead of silently serving unmonitored.
        cfg_objectives = cfg_fast = cfg_slow = None
        try:
            from ..config import load_config
            cfg = load_config()
            cfg_objectives = cfg.slo.objectives
            cfg_fast, cfg_slow = cfg.slo.fast_window_s, cfg.slo.slow_window_s
        except obs_slo.SloParseError:
            raise
        except Exception:
            pass  # unreadable config: env-only SLO setup still applies
        self._slo = obs_slo.from_env(cfg_objectives,
                                     config_fast_window=cfg_fast,
                                     config_slow_window=cfg_slow)
        # Telemetry pipeline: windowed rollups feed /metrics and the
        # status `window` block; the sampling policy mints one
        # keep/drop verdict per terminal outcome (propagated in wire
        # meta); the anomaly bank escalates sustained per-phase
        # regressions into triage bundles. The trace store is only
        # live when SEMMERGE_TRACE_DIR points somewhere.
        self._window = obs_agg.WindowAggregator()
        self._sampler = obs_sampling.SamplingPolicy(
            minted_by=self._fleet_member or "daemon")
        self._anomaly = obs_anomaly.AnomalyTriage()
        self._trace_store = obs_sampling.TraceStore.from_env()
        # One profile capture at a time (``profile`` wire verb, SLO
        # autoprofile); the autoprofile fires once per daemon life.
        self._profile_lock = threading.Lock()
        self._autoprofiled = False

    # ------------------------------------------------------------------
    # lifecycle

    def serve_forever(self) -> int:
        self._configure_process_env()
        sock = self._bind()
        if sock is None:
            # A live daemon already owns the socket: not an error —
            # whoever raced us to it serves the requests.
            print(f"semmerge serve: daemon already running on "
                  f"{self._socket_path}")
            return 0
        if sock is _FOREIGN:
            print(f"semmerge serve: {self._socket_path} is served by a daemon "
                  f"of another package or checkout; choose another --socket", file=sys.stderr)
            return WorkerFault.exit_code
        if self._events_path:
            self._recorder = obs_spans.SpanRecorder()
            obs_spans.activate(self._recorder)
        self._install_stdio_router()
        self._install_signal_handlers()
        # Continuous batching: one process-global micro-batch scheduler
        # on the daemon's device coalesces concurrent requests' fused
        # dispatches. Activated only here — one-shot CLI processes never
        # batch. The [engine] mesh posture rides along, so the dispatcher
        # can split the packed merge axis over the local devices
        # (SEMMERGE_MESH still wins inside mesh_posture).
        from .. import batch
        from ..config import load_config
        from ..parallel.mesh import local_devices, mesh_posture
        try:
            mesh_cfg = load_config().engine.mesh
        except Exception:  # config errors surface per request, not here
            mesh_cfg = None
        batch.activate(device=self._device, mesh=mesh_cfg)
        logger.info("batch scheduler on %s", self._device)
        logger.info("batch dispatch mesh posture: %s (%d local device(s))",
                    mesh_posture(mesh_cfg), len(local_devices(self._device)))
        for _ in range(self._workers_n):
            threading.Thread(target=self._executor, daemon=True).start()
        if self._repo_ttl > 0:
            threading.Thread(target=self._reaper, daemon=True).start()
        if self._soft_mb > 0 or self._hard_mb > 0:
            threading.Thread(target=self._pressure_monitor,
                             daemon=True).start()
        if self._slo is not None:
            threading.Thread(target=self._slo_monitor,
                             daemon=True).start()
            logger.info("SLO engine active: %s",
                        "; ".join(c.text for c in self._slo.clauses))
        self._telemetry = telemetry.maybe_start(self.status,
                                                self._render_metrics)
        if self._telemetry is not None:
            logger.info("telemetry listening on 127.0.0.1:%d "
                        "(/metrics, /healthz)", self._telemetry.port)
        if self._join_addr:
            threading.Thread(target=self._join_loop, daemon=True,
                             name="svc-fleet-join").start()
        logger.info("merge service listening on %s (%d workers, queue %d)",
                    self._socket_path, self._workers_n, self._queue.maxsize)
        try:
            self._accept_loop(sock)
        finally:
            self._teardown(sock)
        return 0

    def _configure_process_env(self) -> None:
        """The daemon's own process posture: never self-delegate, keep
        normal GC cadence (``utils/gctune``: freezing per-request
        garbage into the permanent generation would leak it), share one
        supervised subprocess worker across requests
        (``backends/subproc.py``: each one-shot worker pays its own CUDA
        start); the breakers and warm residency read
        ``_SEMMERGE_IN_DAEMON``."""
        os.environ["_SEMMERGE_IN_DAEMON"] = "1"
        os.environ["SEMMERGE_DAEMON"] = "off"
        os.environ["SEMMERGE_GC_TUNE"] = "0"
        os.environ["SEMMERGE_WORKER_KEEPALIVE"] = "1"

    def _bind(self):
        """The listening socket; ``None`` when a live port daemon owns
        the path, :data:`_FOREIGN` when a daemon of another package or
        checkout does; a dead daemon's leftover socket is replaced."""
        path = self._socket_path
        if fleet_transport.is_tcp(path):
            try:
                sock = fleet_transport.listen(path)
            except OSError:
                # Port taken: a live port daemon there serves the
                # requests (as on the unix path); anything else that
                # answers is foreign; a dead port is a real bind error.
                from .client import hello
                answer = hello(path, timeout=2.0)
                if answer is not None:
                    return None if protocol.is_ours(answer) else _FOREIGN
                raise
            # An ephemeral :0 bind resolves here, so logs, status and
            # the join announce all advertise something dialable.
            self._socket_path = fleet_transport.bound_address(sock, path)
            return sock
        if os.path.exists(path):
            from .client import hello
            answer = hello(path, timeout=2.0)
            if answer is not None:
                return None if protocol.is_ours(answer) else _FOREIGN
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            probe.settimeout(2.0)
            try:
                probe.connect(path)
            except OSError:
                # Nothing listening: a dead daemon's leftover. Replace.
                logger.warning("replacing stale service socket %s", path)
                with contextlib.suppress(OSError):
                    os.unlink(path)
            else:
                return _FOREIGN  # listening, but not speaking the protocol
            finally:
                with contextlib.suppress(OSError):
                    probe.close()
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(path)
        with contextlib.suppress(OSError):
            os.chmod(path, 0o600)
        sock.listen(64)
        return sock

    def _install_stdio_router(self) -> None:
        if not isinstance(sys.stdout, _ThreadTee):
            sys.stdout = _ThreadTee(sys.stdout)
        if not isinstance(sys.stderr, _ThreadTee):
            sys.stderr = _ThreadTee(sys.stderr)

    def _install_signal_handlers(self) -> None:
        def _on_signal(signum, frame):
            logger.info("signal %d: draining and shutting down", signum)
            self._draining = True
            self._stop.set()
        try:
            signal.signal(signal.SIGTERM, _on_signal)
            signal.signal(signal.SIGINT, _on_signal)
        except ValueError:
            pass  # not the main thread (embedded/test use)

    def _accept_loop(self, sock: socket.socket) -> None:
        sock.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _addr = sock.accept()
            except socket.timeout:
                self._maybe_idle_exit()
                continue
            except ssl.SSLError:
                # One client's failed TLS handshake must not stop the
                # accept loop.
                continue
            except OSError:
                break
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True).start()

    def _maybe_idle_exit(self) -> None:
        if self._idle_exit <= 0:
            return
        with self._state_lock:
            busy = self._in_flight > 0
        if busy or not self._queue.empty():
            return
        if time.monotonic() - self._last_activity > self._idle_exit:
            logger.info("idle for %.0fs: exiting", self._idle_exit)
            self._stop.set()

    def _teardown(self, sock: socket.socket) -> None:
        # Socket handoff: close + unlink FIRST, then drain — a
        # supervisor's replacement daemon can bind the path while this
        # process finishes its in-flight work, so new requests land on
        # the replacement instead of racing the shutdown. Clients
        # already connected keep their established connections.
        fleet_transport.close_listener(sock)
        if not fleet_transport.is_tcp(self._socket_path):
            with contextlib.suppress(OSError):
                os.unlink(self._socket_path)
        if self._join_addr and self._joined_as:
            # Deliberate departure: tell the router, so the ring update
            # is a "leave", not a heartbeat-timeout eject.
            with contextlib.suppress(Exception):
                fleet_transport.call(self._join_addr, "leave",
                                     {"member": self._joined_as},
                                     timeout=2.0, retries=0)
        drain = env_seconds("SEMMERGE_SERVICE_DRAIN_TIMEOUT", 30.0)
        deadline = time.monotonic() + drain if drain > 0 else None
        while True:
            with self._state_lock:
                busy = self._in_flight > 0
            if not busy and self._queue.empty():
                break
            if deadline is not None and time.monotonic() > deadline:
                logger.warning("drain timeout: abandoning in-flight work")
                break
            time.sleep(0.05)
        from .. import batch
        batch.deactivate()
        from ..backends.subproc import shutdown_shared
        shutdown_shared()
        if self._telemetry is not None:
            self._telemetry.stop()
        if self._recorder is not None:
            obs_spans.deactivate(self._recorder)
            with contextlib.suppress(OSError):
                self._recorder.write_jsonl(pathlib.Path(self._events_path))
        # Flush diagnostics inside the drain handler: the
        # ``SEMMERGE_METRICS`` atexit hook does not fire reliably on
        # signal-initiated shutdowns (and never on a supervisor
        # respawn's SIGTERM), so a drained daemon writes its registry —
        # and, when a postmortem directory is configured, its flight
        # ring — here, where the shutdown path is guaranteed to pass.
        metrics_path = os.environ.get("SEMMERGE_METRICS")
        if metrics_path:
            with contextlib.suppress(OSError):
                obs_metrics.dump(metrics_path)
        if os.environ.get(obs_flight.ENV_DIR):
            obs_flight.dump(None, "daemon-drain",
                            breakers=resilience.breakers().snapshot())
        logger.info("merge service stopped (%d requests served)",
                    self._served)

    # ------------------------------------------------------------------
    # connection handling (one thread per client connection)

    def _handle_conn(self, conn: socket.socket) -> None:
        rfile = conn.makefile("r", encoding="utf-8")
        wfile = conn.makefile("w", encoding="utf-8")
        try:
            while True:
                msg = protocol.read_message(rfile)
                if msg is None:
                    break
                self._last_activity = time.monotonic()
                req_id = msg.get("id")
                method = msg.get("method")
                params = msg.get("params") or {}
                if method == "hello":
                    # The hello names the package and the checkout: a
                    # client of another package or checkout treats this
                    # daemon as no daemon. It doubles as the fleet
                    # heartbeat: the router reads `draining` off it.
                    hello = {"ok": True, "pid": os.getpid(),
                             "version": protocol.PROTOCOL_VERSION,
                             "draining": self._draining,
                             "package": protocol.PACKAGE,
                             "checkout": protocol.CHECKOUT}
                    member = self._fleet_member or self._joined_as
                    if member is not None:
                        hello["fleet_member"] = member
                    protocol.write_message(wfile,
                                           {"id": req_id, "result": hello})
                    continue
                if method == "drain":
                    # Close admission but keep serving in-flight and
                    # queued work; new requests get a retryable typed
                    # rejection.
                    self._draining = True
                    with self._state_lock:
                        in_flight = self._in_flight
                    protocol.write_message(wfile, {
                        "id": req_id,
                        "result": {"ok": True, "draining": True,
                                   "in_flight": in_flight,
                                   "queue_depth": self._queue.qsize()}})
                    continue
                if method == "status":
                    protocol.write_message(wfile,
                                           {"id": req_id,
                                            "result": self.status()})
                    continue
                if method == "metrics":
                    # Live telemetry without waiting for process exit:
                    # the same payloads the HTTP listener serves.
                    protocol.write_message(wfile, {
                        "id": req_id,
                        "result": {
                            "prometheus":
                                obs_metrics.REGISTRY.render_prometheus(),
                            "metrics": obs_metrics.REGISTRY.to_dict(),
                            "health": self.status(),
                        }})
                    continue
                if method == "profile":
                    # Blocks this connection thread for the capture
                    # window; merge traffic keeps flowing through the
                    # executor pool meanwhile — that traffic is what
                    # the capture is *of*.
                    protocol.write_message(wfile, {
                        "id": req_id,
                        "result": self._capture_profile(params)})
                    continue
                if method == "prewarm":
                    # Affinity handoff: the router warms a rehashed repo
                    # key onto its new owner before traffic lands there.
                    protocol.write_message(wfile, {
                        "id": req_id, "result": self._prewarm(params)})
                    continue
                if method == "shutdown":
                    protocol.write_message(wfile,
                                           {"id": req_id,
                                            "result": {"ok": True}})
                    self._stop.set()
                    break
                if method not in protocol.VERBS:
                    protocol.write_message(wfile, {
                        "id": req_id,
                        "error": {"message": f"unknown method {method!r}"}})
                    continue
                self._serve_request(req_id, method, params, wfile)
        except (protocol.ProtocolError, OSError, ValueError):
            pass  # client went away or spoke garbage: drop the connection
        finally:
            with contextlib.suppress(OSError):
                conn.close()

    def _serve_request(self, req_id, verb: str, params: Dict[str, Any],
                       wfile) -> None:
        req = _Request(req_id, verb, params)
        with obs_spans.request_scope(req.trace_id, req.recorder), \
                reqenv.overlay(req.env):
            cached = self._idem_lookup(req)
            if cached is not None:
                # A retried request whose first execution completed:
                # answer from the idempotency cache — never re-execute.
                self._count_request(verb, "replayed")
                protocol.write_message(wfile, cached)
                return
            try:
                with obs_spans.span("service.accept", layer="service",
                                    verb=verb), \
                        fault_boundary("service:accept"):
                    faults.check("service:accept")
                    self._admit(req)
            except MergeFault as fault:
                self._count_request(verb, "rejected")
                if self._slo is not None:
                    # Shed work never ran, but the client still saw an
                    # error — it burns the error budget at zero latency.
                    self._slo.observe(verb, 0.0, error=True)
                protocol.write_message(wfile, {
                    "id": req.id,
                    "error": protocol.fault_error(
                        fault,
                        retry_after_ms=self._retry_after_for(fault),
                        trace_id=req.trace_id)})
                return
        self._publish_queue_depth()
        req.done.wait()
        self._last_activity = time.monotonic()
        if req.response is not None:
            protocol.write_message(wfile, req.response)

    #: Rejection causes a client may retry against this daemon after
    #: ``retry_after_ms`` — transient overload, not request-shaped
    #: failures.
    _RETRYABLE_CAUSES = frozenset(
        {"queue-full", "overload", "projected-deadline", "draining"})

    def _admit(self, req: _Request) -> None:
        """Admission control, cheapest checks first: hard-watermark
        pressure sheds everything, soft pressure sheds work that will
        not batch (batched work amortizes device cost; inline work
        pays full price at the worst time), a projected queue wait
        past the request deadline is rejected up front instead of
        timing out in the queue, and finally the bounded queue itself."""
        if self._draining:
            self._shed("draining")
            raise WorkerFault(
                "daemon is draining: admission closed",
                stage="service:accept", cause="draining")
        if self._pressure >= _PRESSURE_HARD:
            self._shed("rss-hard")
            raise WorkerFault(
                f"shedding load: RSS above the {self._hard_mb:g} MiB "
                f"hard watermark", stage="service:accept",
                cause="overload")
        if self._pressure >= _PRESSURE_SOFT and not _request_batches():
            self._shed("rss-soft")
            raise WorkerFault(
                f"shedding non-batched work: RSS above the "
                f"{self._soft_mb:g} MiB soft watermark",
                stage="service:accept", cause="overload")
        projected = self._projected_wait()
        if req.deadline_s and projected > req.deadline_s:
            self._shed("projected-deadline")
            raise DeadlineFault(
                f"projected queue wait {projected:.2f}s exceeds the "
                f"{req.deadline_s:g}s deadline",
                stage="service:accept", cause="projected-deadline")
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise WorkerFault(
                f"admission queue full "
                f"({self._queue.maxsize} waiting)",
                stage="service:accept", cause="queue-full")

    def _projected_wait(self) -> float:
        """Expected queue wait for a request admitted now: queue depth
        × the EWMA of execute time, spread over the worker pool."""
        with self._state_lock:
            ewma = self._exec_ewma
        if ewma <= 0:
            return 0.0
        return self._queue.qsize() * ewma / max(1, self._workers_n)

    def _retry_after_ms(self) -> int:
        """How long a rejected client should wait before retrying:
        the projected drain time of the current queue, clamped to
        [100 ms, 5 s]."""
        with self._state_lock:
            ewma = self._exec_ewma
        per_slot = ewma if ewma > 0 else 0.25
        projected = ((self._queue.qsize() + 1) * per_slot
                     / max(1, self._workers_n))
        return int(min(max(projected * 1000.0, 100.0), 5000.0))

    def _retry_after_for(self, fault: MergeFault) -> Optional[int]:
        if getattr(fault, "cause", None) not in self._RETRYABLE_CAUSES:
            return None
        return self._retry_after_ms()

    def _shed(self, reason: str) -> None:
        obs_metrics.REGISTRY.counter(
            "service_shed_total", _SHED_HELP).inc(1, reason=reason)

    # -- idempotency cache -------------------------------------------------

    def _idem_lookup(self, req: _Request) -> Optional[Dict[str, Any]]:
        if not req.idem_key or not self._idem_cap:
            return None
        with self._idem_lock:
            entry = self._idem.get(req.idem_key)
            if entry is None:
                return None
            if self._idem_ttl > 0 and \
                    time.monotonic() - entry["t"] > self._idem_ttl:
                # Expired: the resend re-executes as a fresh request —
                # safe (deterministic merges; --inplace is protected by
                # the commit journal + repo lockfile), and it frees the
                # slot instead of replaying arbitrarily stale output.
                del self._idem[req.idem_key]
                return None
            self._idem.move_to_end(req.idem_key)
            cached = entry["response"]
        obs_metrics.REGISTRY.counter(
            "service_idempotent_replays_total", _IDEM_HELP).inc(1)
        resp = dict(cached)
        resp["id"] = req.id
        return resp

    def _idem_store(self, req: _Request) -> None:
        if not req.idem_key or not self._idem_cap or req.response is None:
            return
        with self._idem_lock:
            self._idem[req.idem_key] = {"response": req.response,
                                        "t": time.monotonic()}
            self._idem.move_to_end(req.idem_key)
            while len(self._idem) > self._idem_cap:
                self._idem.popitem(last=False)

    # ------------------------------------------------------------------
    # execution (executor thread pool)

    def _executor(self) -> None:
        while True:
            try:
                req = self._queue.get(timeout=0.3)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            self._publish_queue_depth()
            with self._state_lock:
                self._in_flight += 1
            try:
                self._execute(req)
            finally:
                self._idem_store(req)
                with self._state_lock:
                    self._in_flight -= 1
                    self._served += 1
                self._last_activity = time.monotonic()
                req.done.set()

    def _execute(self, req: _Request) -> None:
        verb = req.verb
        queue_wait = time.monotonic() - req.t_accept
        outcome = "fault"
        with obs_spans.request_scope(req.trace_id, req.recorder), \
                reqenv.overlay(req.env):
            obs_spans.record("service.queue_wait", queue_wait,
                             layer="service", verb=verb)
            try:
                if req.deadline_s and queue_wait > req.deadline_s:
                    raise DeadlineFault(
                        f"request waited {queue_wait:.3f}s past its "
                        f"{req.deadline_s:g}s deadline",
                        stage="service:dispatch", cause="deadline")
                with fault_boundary("service:dispatch"):
                    faults.check("service:dispatch")
                with self._repo_lock_for(req):
                    code, out, err, t_start, t_end = self._run_cli(req)
                duration = t_end - t_start
                with self._state_lock:
                    self._exec_ewma = (
                        duration if self._exec_ewma <= 0
                        else 0.3 * duration + 0.7 * self._exec_ewma)
                outcome = _OUTCOME_BY_EXIT.get(code, f"exit-{code}")
                req.response = {
                    "id": req.id,
                    "result": {
                        "exit_code": code,
                        "stdout": out,
                        "stderr": err,
                        "meta": {
                            "pid": os.getpid(),
                            "queue_wait_s": round(queue_wait, 6),
                            "t_execute_start": t_start,
                            "t_execute_end": t_end,
                            "trace_id": req.trace_id,
                        },
                    },
                }
                if req.phases:
                    # The CLI's seconds per phase (scan, encode, fused,
                    # apply, ...): what the request cost inside.
                    req.response["result"]["meta"]["phases"] = {
                        k: round(v, 6) if isinstance(v, float) else v
                        for k, v in req.phases.items()}
                if self._fleet_member is not None and os.environ.get(
                        "SEMMERGE_FLEET_STITCH", "on").strip() != "off":
                    # Fleet member: ship the request's span tree back so
                    # the router grafts it into one stitched trace.
                    req.response["result"]["meta"]["spans"] = \
                        req.recorder.span_dicts()
                obs_metrics.REGISTRY.histogram(
                    "service_request_seconds", _LATENCY_HELP).observe(
                        queue_wait + duration, exemplar=req.trace_id,
                        verb=verb)
                if self._slo is not None:
                    # Conflicts/typecheck exits are request-shaped
                    # answers, not service errors — only faults and
                    # unexpected exit codes burn the error budget.
                    self._slo.observe(
                        verb, queue_wait + duration,
                        error=outcome not in ("ok", "conflicts",
                                              "typecheck"))
            except MergeFault as fault:
                req.response = {"id": req.id,
                                "error": protocol.fault_error(
                                    fault, trace_id=req.trace_id)}
                if self._slo is not None:
                    self._slo.observe(
                        verb, time.monotonic() - req.t_accept,
                        error=True)
            finally:
                from ..frontend.declcache import publish_metrics
                publish_metrics()
                self._count_request(verb, outcome)
                self._finish_telemetry(req, verb, outcome, queue_wait)
                if self._recorder is not None:
                    # --events: graft the request's scoped spans into
                    # the daemon-lifetime recorder, tagged by trace_id,
                    # so the events artifact still covers everything.
                    self._recorder.absorb(req.recorder,
                                          trace_id=req.trace_id)
                # A standalone daemon exports this request's trace; a
                # fleet member ships its spans to the router, which
                # exports the stitched tree once. Export never reaches
                # the request: a dead collector only counts in
                # otlp_errors_total.
                if self._fleet_member is None:
                    try:
                        exporter = obs_export.maybe_exporter()
                        if exporter is not None:
                            exporter.export_trace(req.trace_id,
                                                  req.recorder.span_dicts())
                    except Exception:
                        logger.debug("OTLP export error", exc_info=True)

    def _run_cli(self, req: _Request):
        """The actual CLI invocation: ``service.execute`` span, request
        working-dir scope, per-thread stdout/stderr capture. The span
        opens AFTER the per-repo lock is held, so two same-repo
        requests' execute windows never overlap — the serialization
        test asserts exactly that."""
        out_buf, err_buf = io.StringIO(), io.StringIO()
        routed = isinstance(sys.stdout, _ThreadTee) and \
            isinstance(sys.stderr, _ThreadTee)
        if routed:
            sys.stdout.push(out_buf)
            sys.stderr.push(err_buf)
        t_start = time.monotonic()
        try:
            with obs_spans.span("service.execute", layer="service",
                                verb=req.verb), \
                    fault_boundary("service:execute"), \
                    workdir.scoped(req.cwd):
                faults.check("service:execute")
                from ..cli import last_phases, main as cli_main
                try:
                    code = cli_main([req.verb, *req.argv], delegate=False)
                except SystemExit as exc:  # argparse usage errors
                    code = exc.code if isinstance(exc.code, int) else 2
                req.phases = last_phases()
        finally:
            t_end = time.monotonic()
            if routed:
                sys.stdout.pop()
                sys.stderr.pop()
        return code, out_buf.getvalue(), err_buf.getvalue(), t_start, t_end

    def _finish_telemetry(self, req: _Request, verb: str, outcome: str,
                          queue_wait: float) -> None:
        """Terminal-outcome telemetry: mint the sampling verdict,
        attach it to wire ``meta``, feed the window rollups and the
        anomaly bank, and persist kept traces. Runs inside the
        request's scope finally-block; must never raise."""
        try:
            total_s = time.monotonic() - req.t_accept
            rows = req.recorder.span_dicts()
            phases: Dict[str, float] = {}
            for row in rows:
                name = str(row.get("name") or "?")
                try:
                    phases[name] = phases.get(name, 0.0) + \
                        float(row.get("seconds") or 0.0)
                except (TypeError, ValueError):
                    continue
            flags = obs_sampling.outcome_flags(rows)
            error_flag = flags["error"] or outcome not in (
                "ok", "conflicts", "typecheck")
            decision = self._sampler.decide(
                req.trace_id, verb, total_s, error=error_flag,
                degraded=flags["degraded"], breaker=flags["breaker"],
                resolver=flags["resolver"])
            self._window.observe(verb, total_s, error=error_flag,
                                 phases=phases)
            self._anomaly.observe(
                req.trace_id, verb, phases, seconds=total_s,
                spans=rows if rows else None, root=req.cwd)
            if isinstance(req.response, dict) and \
                    isinstance(req.response.get("result"), dict):
                req.response["result"].setdefault("meta", {})[
                    obs_sampling.META_KEY] = decision.to_meta()
            if decision.keep and self._trace_store is not None:
                self._trace_store.write(req.trace_id, {
                    "schema": 1,
                    "kind": "trace",
                    "trace_id": req.trace_id,
                    "verb": verb,
                    "outcome": outcome,
                    "seconds": round(total_s, 6),
                    "queue_wait_s": round(queue_wait, 6),
                    "spans": rows,
                }, decision=decision)
        except Exception:
            logger.debug("telemetry pipeline error", exc_info=True)

    def _render_metrics(self) -> str:
        """Live ``/metrics`` exposition with the window gauges freshly
        published — scrapes see current-window p50/p99/QPS, not the
        values from the last request."""
        self._window.publish()
        return obs_metrics.REGISTRY.render_prometheus()

    def _repo_lock_for(self, req: _Request):
        """Same-repo ``--inplace`` requests serialize; everything else
        (read-only verbs, different repos) overlaps freely. The lock
        key is the resolved request root — the tree being mutated."""
        if req.verb not in ("semmerge", "semrebase") or \
                "--inplace" not in req.argv:
            return contextlib.nullcontext()
        key = str(pathlib.Path(req.cwd).resolve())
        with self._locks_lock:
            entry = self._repo_locks.setdefault(
                key, {"lock": threading.Lock(), "last": 0.0})
            entry["last"] = time.time()
        return entry["lock"]

    def _pressure_monitor(self) -> None:
        """Sample RSS against the watermarks (1 Hz): publish the
        ``service_rss_mb`` gauge, raise/lower the pressure level, and
        apply the mitigations — shrink the batch in-flight bound while
        under pressure (running batches finish; new ones serialize),
        and clear the decl cache at the hard watermark. Admission-side
        shedding reads ``self._pressure`` (see :meth:`_admit`)."""
        from .. import batch
        from ..frontend.declcache import global_cache
        while not self._stop.wait(1.0):
            rss = _rss_mb()
            obs_metrics.REGISTRY.gauge("service_rss_mb", _RSS_HELP).set(
                round(rss, 3))
            level = _PRESSURE_NONE
            if self._hard_mb > 0 and rss >= self._hard_mb:
                level = _PRESSURE_HARD
            elif self._soft_mb > 0 and rss >= self._soft_mb:
                level = _PRESSURE_SOFT
            if level == self._pressure:
                continue
            prev, self._pressure = self._pressure, level
            logger.warning(
                "memory pressure %d -> %d (rss %.0f MiB, "
                "soft %.0f, hard %.0f)", prev, level, rss,
                self._soft_mb, self._hard_mb)
            sched = batch.current()
            if sched is not None:
                sched.set_inflight_cap(
                    1 if level > _PRESSURE_NONE else sched.max_inflight)
            if level >= _PRESSURE_HARD:
                cache = global_cache()
                if cache is not None:
                    cache.clear()
                # Resident encoded snapshots are the other large host
                # allocation this process owns outright — drop them too.
                residency_mod.cache().clear(reason="rss-hard")

    def _slo_monitor(self) -> None:
        """Evaluate the SLO engine on a fixed cadence
        (``SEMMERGE_SLO_EVAL_INTERVAL``), publishing the burn-rate
        gauges. On the edge of a trip (both windows at/above the
        threshold): log it, dump an ``slo-burn`` postmortem bundle with
        the verdict attached, and — with ``SEMMERGE_SLO_AUTOPROFILE``
        set — capture one profile bundle for the first trip of the
        daemon's life (one, not per trip: a burning daemon must spend
        its cycles serving, not profiling)."""
        interval = max(0.1, obs_slo._env_float(
            obs_slo.ENV_EVAL_INTERVAL, obs_slo.DEFAULT_EVAL_INTERVAL))
        autoprofile = os.environ.get(
            obs_slo.ENV_AUTOPROFILE, "").strip().lower() \
            not in ("", "0", "off", "false")
        while not self._stop.wait(interval):
            try:
                verdict = self._slo.evaluate(consume_edges=True)
            except Exception:
                continue  # evaluation must never kill the monitor
            newly = verdict.get("newly_tripped") or []
            if not newly:
                continue
            logger.warning(
                "SLO burn: %s",
                "; ".join(f"{r['objective']} (fast {r['burn_fast']}x, "
                          f"slow {r['burn_slow']}x)" for r in newly))
            obs_flight.dump(None, "slo-burn",
                            breakers=resilience.breakers().snapshot(),
                            extra={"slo": verdict})
            if autoprofile and not self._autoprofiled:
                self._autoprofiled = True
                threading.Thread(
                    target=self._capture_profile,
                    args=({"seconds": 1.0},),
                    name="svc-autoprofile", daemon=True).start()

    def _capture_profile(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """On-demand profile capture from the live daemon: a bounded
        ``torch.profiler`` window over whatever traffic flows during it
        (CUDA activity too when the daemon runs on the card), plus a
        metrics before/after delta, the flight-ring span sample, and
        the SLO verdict, written into a timestamped bundle directory.
        Serialized by ``_profile_lock``; a session that cannot start
        (another thread's ``--profile`` request holds the process's
        one session) gives a bundle with ``profiler_started: false``,
        counted in ``profiler_capture_failures_total``. Every failure is
        an answer, never a dropped connection."""
        try:
            seconds = float(params.get("seconds") or 1.0)
        except (TypeError, ValueError):
            seconds = 1.0
        seconds = min(60.0, max(0.1, seconds))
        out_base = str(params.get("out_dir") or "").strip() \
            or os.environ.get("SEMMERGE_PROFILE_DIR", "").strip()
        if not out_base:
            import tempfile
            out_base = os.path.join(tempfile.gettempdir(),
                                    "semmerge-profiles")
        captures = obs_metrics.REGISTRY.counter(
            "profile_captures_total",
            "On-demand daemon profile captures, by result")
        if not self._profile_lock.acquire(blocking=False):
            captures.inc(1, result="busy")
            return {"ok": False,
                    "error": "a profile capture is already in progress"}
        try:
            from ..runtime import trace as rt_trace
            stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
            bundle_dir = pathlib.Path(out_base) / (
                f"profile-{stamp}-{os.getpid()}-{os.urandom(2).hex()}")
            bundle_dir.mkdir(parents=True, exist_ok=True)
            before = obs_metrics.REGISTRY.to_dict()
            t0 = time.time()
            session = rt_trace.start_profiler_session(
                cuda=self._device.type == "cuda")
            started = session is not None
            # The capture window: sample whatever the daemon serves
            # meanwhile (interruptible so shutdown never waits on it).
            self._stop.wait(seconds)
            if started:
                rt_trace.stop_profiler_session(session, str(bundle_dir))
            bundle = {
                "schema": 1,
                "ok": True,
                "profiler_started": started,
                "seconds": seconds,
                "t_start": round(t0, 3),
                "t_end": round(time.time(), 3),
                "pid": os.getpid(),
                "metrics_before": before,
                "metrics_after": obs_metrics.REGISTRY.to_dict(),
                "spans": obs_flight.snapshot(),
                "slo": (self._slo.status()
                        if self._slo is not None else None),
            }
            (bundle_dir / "bundle.json").write_text(
                json.dumps(bundle, indent=2, default=str),
                encoding="utf-8")
            files = sorted(str(p.relative_to(bundle_dir))
                           for p in bundle_dir.rglob("*") if p.is_file())
            captures.inc(1, result="ok")
            return {"ok": True, "dir": str(bundle_dir),
                    "profiler_started": started, "seconds": seconds,
                    "files": files}
        except Exception as exc:  # capture failure must not kill the conn
            captures.inc(1, result="error")
            return {"ok": False,
                    "error": f"{type(exc).__name__}: {exc}"}
        finally:
            self._profile_lock.release()

    def _prewarm(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Warm a repo key this daemon just became the owner of: one
        bounded ``git rev-parse`` against the repo (no device work); a
        prewarm failure is an answer, never a fault."""
        cwd = str(params.get("cwd") or "").strip()
        if not cwd or not os.path.isdir(cwd):
            return {"ok": False, "cwd": cwd, "error": "no such directory"}
        import subprocess
        try:
            proc = subprocess.run(["git", "-C", cwd, "rev-parse", "HEAD^{tree}"],
                                  capture_output=True, text=True, timeout=10.0)
        except (OSError, subprocess.SubprocessError) as exc:
            return {"ok": False, "cwd": cwd, "error": f"{type(exc).__name__}: {exc}"}
        if proc.returncode != 0:
            return {"ok": False, "cwd": cwd, "error": (proc.stderr or "").strip()[:200]}
        with self._locks_lock:
            entry = self._repo_locks.setdefault(
                cwd, {"lock": threading.Lock(), "last": 0.0})
            entry["last"] = time.time()
        return {"ok": True, "cwd": cwd, "tree_oid": proc.stdout.strip()}

    def _join_loop(self) -> None:
        """Announce this daemon to the fleet router, then keep
        re-announcing — the re-announce is also the rejoin path after a
        partition eject. Draining suppresses the announce so a
        deliberate departure never looks alive again."""
        advertise = self._advertise or self._socket_path
        interval = max(0.2, env_seconds("SEMMERGE_FLEET_JOIN_INTERVAL", 5.0))
        while True:
            if not self._draining:
                self._join_epoch += 1
                params = {"address": advertise, "capacity": self._capacity,
                          "epoch": self._join_epoch}
                if self._member_id:
                    params["member"] = self._member_id
                elif self._joined_as:
                    params["member"] = self._joined_as
                result = fleet_transport.call(
                    self._join_addr, "join", params,
                    timeout=fleet_transport.connect_timeout(), retries=0)
                if result and result.get("ok"):
                    member = str(result.get("member") or "")
                    if member and member != self._joined_as:
                        self._joined_as = member
                        logger.info("joined fleet %s as member %s (advertising %s)",
                                    self._join_addr, member, advertise)
                elif result is not None:
                    logger.warning("fleet join rejected: %s", result.get("error"))
            if self._stop.wait(interval):
                return

    def _reaper(self) -> None:
        """Evict per-repo state idle past the TTL."""
        interval = max(1.0, min(self._repo_ttl / 2.0, 60.0))
        while not self._stop.wait(interval):
            cutoff = time.time() - self._repo_ttl
            with self._locks_lock:
                for key in [k for k, e in self._repo_locks.items()
                            if e["last"] < cutoff
                            and not e["lock"].locked()]:
                    del self._repo_locks[key]

    # ------------------------------------------------------------------
    # introspection

    def _count_request(self, verb: str, outcome: str) -> None:
        obs_metrics.REGISTRY.counter(
            "service_requests_total", _REQUESTS_HELP).inc(
                1, verb=verb, outcome=outcome)

    def _publish_queue_depth(self) -> None:
        obs_metrics.REGISTRY.gauge(
            "service_queue_depth", _QUEUE_DEPTH_HELP).set(
                self._queue.qsize())

    def status(self) -> Dict[str, Any]:
        """The JAX daemon's status block (same keys), plus ``package``
        and ``device`` (``platform`` ``gpu`` or ``cpu``, ``kind`` the
        card's name, ``launches`` the hand kernels' launches so far)."""
        from ..frontend.declcache import global_cache
        cache = global_cache()
        decl = cache.stats() if cache is not None else {}
        hits = decl.get("hits", 0)
        lookups = hits + decl.get("misses", 0)
        with self._state_lock:
            in_flight, served = self._in_flight, self._served
        from .. import batch
        scheduler = batch.current()
        return {
            "ok": True,
            "package": protocol.PACKAGE,
            "device": self._device_block(),
            "pid": os.getpid(),
            "version": protocol.PROTOCOL_VERSION,
            "socket": self._socket_path,
            "uptime_s": round(time.time() - self._t0, 3),
            "queue_depth": self._queue.qsize(),
            "in_flight": in_flight,
            "served_total": served,
            "workers": self._workers_n,
            "draining": self._draining,
            "fleet_member": self._fleet_member or self._joined_as,
            "fleet_join": ({"router": self._join_addr,
                            "advertise": self._advertise or self._socket_path,
                            "capacity": self._capacity,
                            "joined_as": self._joined_as,
                            "announces": self._join_epoch}
                           if self._join_addr else None),
            "transport": ("tcp+tls" if fleet_transport.is_tcp(self._socket_path)
                          and fleet_transport.tls_enabled()
                          else "tcp" if fleet_transport.is_tcp(self._socket_path)
                          else "unix"),
            "repos_tracked": len(self._repo_locks),
            "rss_mb": round(_rss_mb(), 3),
            "metrics_port": (self._telemetry.port
                             if self._telemetry is not None else None),
            "declcache": decl,
            "declcache_hit_rate": (hits / lookups) if lookups else 0.0,
            "batch": scheduler.stats() if scheduler is not None else None,
            "residency": residency_mod.cache().stats(),
            "slo": self._slo.status() if self._slo is not None else None,
            "window": self._window.window(),
            "sampling": self._sampler.stats(),
            "anomaly": self._anomaly.stats(),
            "trace_store": (self._trace_store.stats()
                            if self._trace_store is not None else None),
            "resilience": {
                "pressure": self._pressure,
                "rss_soft_mb": self._soft_mb,
                "rss_hard_mb": self._hard_mb,
                "exec_ewma_s": round(self._exec_ewma, 6),
                "projected_wait_s": round(self._projected_wait(), 6),
                "idempotency_cached": len(self._idem),
                "breakers": resilience.breakers().snapshot(),
            },
            "metrics": obs_metrics.REGISTRY.to_dict(),
        }

    def _device_block(self) -> Dict[str, Any]:
        """The daemon's device, and the hand kernels' launches in this
        process so far (``kernels.LAUNCHES``)."""
        from .. import kernels
        launches = dict(kernels.LAUNCHES)
        if self._device.type == "cuda":
            import torch
            return {"platform": "gpu", "type": "cuda",
                    "kind": torch.cuda.get_device_name(self._device), "launches": launches}
        return {"platform": "cpu", "type": self._device.type, "kind": "cpu",
                "launches": launches}
