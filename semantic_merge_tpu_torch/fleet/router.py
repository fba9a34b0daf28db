"""The fleet router: N supervised member daemons behind one socket (the
port of the JAX package's ``fleet/router.py``).

The router binds the service socket (so every existing client talks to
the fleet unchanged) and spawns N member daemons on derived socket paths
(``<socket>.m0``, ``<socket>.m1``, …), each under a per-member respawn
policy (:class:`~semantic_merge_tpu_torch.service.supervisor.MemberSupervisor`).
Like the supervisor, the router process is deliberately boring: this
module imports no torch and no engine, and the router creates no CUDA
context — the members hold the card.

Port-specific decisions:

- **Member argv.** Each member is ``python -m semantic_merge_tpu_torch
  serve --socket S --idle-exit 0 --device D``: the port's daemon on the
  fleet's device (``fleet --device``, default ``cuda``). A member that
  cannot reach the card exits (11) and stays out of the ring, respawned
  with backoff; it is never replaced by a CPU member.
- **Member environment.** The JAX router's (fleet off, the member id in
  ``SEMMERGE_FLEET_MEMBER``, an ephemeral loopback telemetry port, no
  inherited fault injection, metrics dump or service socket), plus
  ``SEMMERGE_GC_TUNE=0`` as the port's daemon sets for itself.
- **Membership is the port's.** The router's ``hello`` names the package
  and checkout (a port client accepts only its own package's router,
  :func:`~semantic_merge_tpu_torch.service.protocol.is_ours`), and a
  ``join`` is admitted only from a daemon whose ``hello`` names this
  package: a routed merge never runs on another engine.
- **Bytes and names.** Wire messages, status keys, metric and span names
  (``fleet_*``, ``fleet.*``) and the WAL and stitched-trace artifacts are
  the JAX router's; ``status`` adds ``package`` and ``device``.

Request flow::

    client conn thread → WAL journal → rendezvous rank → member dispatch
                                  ↘ (transport failure) failover to next
                                  ↘ (idle, non-inplace) hedge to second

- **Affinity**: requests hash by resolved request cwd
  (:func:`~.hashring.repo_key`), so per-repo state concentrates on one
  member; failover order and hedge targets come from the same ranking.
- **Membership**: a health thread ticks every member's supervisor,
  probes liveness (the member's loopback ``/healthz`` when its telemetry
  port is known, the transport heartbeat otherwise), ejects failed or
  draining members from the ring (``fleet_rehash_moves_total`` counts
  the keys whose owner moved) and re-admits them when they come back.
  Remote daemons (usually over ``tcp://``, :mod:`.transport`) announce
  themselves with ``join``, are probed by the same heartbeats (a
  half-open link ejects with reason ``partition``) and depart with
  ``leave`` or drain. Every ring change hands the moved keys off to
  their new owners (``prewarm``, bounded by
  ``SEMMERGE_FLEET_HANDOFF_MAX``).
- **Durability**: every verb request is journaled to the WAL before its
  first dispatch and acked after the response is written toward the
  client; a router restart replays unacked entries to their rehashed
  owners. Idempotency keys (router-minted when the client sent none)
  plus the in-place journal and repo lockfile collapse at-least-once
  dispatch into exactly-once effects.
- **Hedging**: a non-``--inplace`` request may be hedged to the
  second-ranked member after a p99-derived delay
  (``SEMMERGE_FLEET_HEDGE=off`` disables); the first response wins and
  the loser's connection is closed.
- **Stitching**: each request's router spans and the span tree its
  member ships back are grafted into one trace per ``trace_id``, sealed
  off the response path into ``SEMMERGE_FLEET_TRACE_DIR`` and the OTLP
  exporter. ``/metrics`` is federated over the members' scrapes.

Typed wire errors from a member (``exit_code`` present) pass through to
the client unchanged; the router only turns *transport* loss into
failover. A router drain (SIGTERM or the ``drain`` control verb) closes
admission with retryable ``FleetFault`` rejections, finishes in-flight
dispatches, then SIGTERMs the members so they drain too.
"""
from __future__ import annotations

import contextlib
import json
import os
import queue
import signal
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..errors import (FleetFault, MergeFault, TransportFault,
                      fault_boundary)
from ..obs import agg as obs_agg
from ..obs import export as obs_export
from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs import sampling as obs_sampling
from ..obs import slo as obs_slo
from ..obs import spans as obs_spans
from ..service import protocol, telemetry
from ..service.supervisor import MemberSupervisor
from ..utils import faults
from ..utils.loggingx import logger
from ..utils.procs import env_seconds
from . import hashring, transport, wal as fleet_wal

_MEMBERS_HELP = "Fleet members currently in the routing ring"
_FAILOVERS_HELP = "Fleet failovers (member ejections/re-dispatches), by reason"
_REHASH_HELP = "Repo keys whose owner moved on a membership change"
_HEDGES_HELP = "Hedged dispatches issued for slow primaries"
_HEDGE_WINS_HELP = "Hedged dispatches where the hedge answered first"
_REPLAY_HELP = "WAL entries replayed after a router restart"
_HANDOFFS_HELP = "Affinity handoffs (prewarms of moved keys), by reason"
_MISSES_HELP = "Routed requests that landed on a cold (non-warm) member"
_JOINS_HELP = "Member join handshakes accepted"
_DRAINING_HELP = ("Members alive but draining (1=draining) — "
                  "deliberate departures, not failures")

#: Health-probe failures before a member is ejected from the ring.
_EJECT_AFTER = 3


def _label_member(exposition: str, member: str) -> str:
    """Inject ``member="<id>"`` into every sample line of a Prometheus
    text exposition (comments pass through; lines that already carry a
    ``member`` label — the fleet rollups — are left alone)."""
    out = []
    for line in exposition.splitlines():
        if not line or line.startswith("#") or 'member="' in line:
            out.append(line)
            continue
        brace = line.rfind("}")
        if brace != -1 and "{" in line:
            out.append(f'{line[:brace]},member="{member}"{line[brace:]}')
        else:
            space = line.find(" ")
            if space == -1:
                out.append(line)
            else:
                out.append(f'{line[:space]}{{member="{member}"}}'
                           f'{line[space:]}')
    return "\n".join(out)


def _dedupe_comments(exposition: str) -> str:
    """Drop repeated ``# HELP``/``# TYPE`` lines — concatenating N
    member scrapes repeats them, and strict parsers reject that."""
    seen: set = set()
    out = []
    for line in exposition.splitlines():
        if line.startswith("#"):
            if line in seen:
                continue
            seen.add(line)
        out.append(line)
    return "\n".join(out)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


class _MemberTransport(Exception):
    """A member connection died mid-request (crash, SIGKILL, garbage,
    partition) — the failover trigger, never surfaced to the client
    directly. ``reason`` feeds the failover counter/span:
    ``transport`` for connect-shaped loss, ``partition`` when the
    connection was up but the read deadline expired (half-open)."""

    def __init__(self, message: str, reason: str = "transport") -> None:
        super().__init__(message)
        self.reason = reason


class _Member:
    """Router-side view of one member daemon — a local child under a
    :class:`MemberSupervisor`, or a remote (``sup=None``) daemon that
    announced itself over the transport and is supervised elsewhere."""

    def __init__(self, member_id: str, address: str,
                 sup: Optional[MemberSupervisor] = None,
                 capacity: int = 1, epoch: int = 0) -> None:
        self.id = member_id
        self.address = address
        self.sup = sup
        self.remote = sup is None
        self.in_ring = False
        self.draining = False
        # When the router last *initiated* a drain of this member —
        # health probes that started before this instant carry a
        # pre-drain heartbeat and must not flip the member back.
        self.drain_ts = 0.0
        self.dead = False
        self.fail_streak = 0
        self.last_fault: Optional[str] = None
        self.capacity = capacity
        self.epoch = epoch
        self.metrics_port: Optional[int] = None
        self.dispatches = 0

    @property
    def socket_path(self) -> str:
        return self.address

    def state(self) -> str:
        """``ready`` (serving, in ring), ``draining`` (alive but
        refusing new work — NOT a failure), ``dead`` (crashed, ejected,
        or partitioned), or ``starting`` (known, not yet admitted)."""
        if self.dead:
            return "dead"
        if self.draining:
            return "draining"
        if self.in_ring:
            return "ready"
        return "starting"

    def view(self) -> Dict[str, Any]:
        return {"id": self.id, "socket": self.address,
                "pid": self.sup.pid if self.sup is not None else None,
                "in_ring": self.in_ring,
                "draining": self.draining,
                "state": self.state(),
                "remote": self.remote,
                "capacity": self.capacity,
                "epoch": self.epoch,
                "last_fault": self.last_fault,
                "restarts": self.sup.restarts if self.sup is not None
                else None,
                "last_rc": self.sup.last_rc if self.sup is not None
                else None,
                "metrics_port": self.metrics_port,
                "dispatches": self.dispatches}


class FleetRouter:
    """One ``semmerge fleet`` process. Construct, then
    :meth:`serve_forever`."""

    def __init__(self, socket_path: Optional[str] = None,
                 members: Optional[int] = None,
                 workers: Optional[int] = None,
                 queue_size: Optional[int] = None,
                 wal_dir: Optional[str] = None,
                 device: Optional[str] = None) -> None:
        self._socket_path = protocol.socket_path(socket_path)
        # The members' device; the router itself never touches it.
        self._device = device or "cuda"
        n = members if members is not None else \
            _env_int("SEMMERGE_FLEET_MEMBERS", 3)
        # 0 local members is a pure-remote fleet: every member arrives
        # over the transport with a join handshake.
        self._n = max(0, n)
        self._workers = workers
        self._queue_size = queue_size
        self._wal = fleet_wal.WriteAheadLog(
            wal_dir or os.environ.get("SEMMERGE_FLEET_WAL_DIR", "").strip()
            or fleet_wal.default_dir(self._socket_path))
        self._members: List[_Member] = []
        self._ring_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._in_flight = 0
        self._served = 0
        self._replayed = 0
        self._stop = threading.Event()
        self._draining = False
        self._t0 = time.time()
        self._seen_keys: "deque[str]" = deque(maxlen=1024)
        self._seen_set: set = set()
        self._latencies: "deque[float]" = deque(maxlen=256)
        self._hedge_on = os.environ.get(
            "SEMMERGE_FLEET_HEDGE", "").strip().lower() not in (
                "off", "0", "no", "false")
        self._hedge_default_ms = _env_int("SEMMERGE_FLEET_HEDGE_MS", 250)
        self._hedge_min_ms = _env_int("SEMMERGE_FLEET_HEDGE_MIN_MS", 50)
        self._hedge_cap_ms = _env_int("SEMMERGE_FLEET_HEDGE_CAP_MS", 2000)
        self._ready_timeout = env_seconds("SEMMERGE_FLEET_READY_TIMEOUT",
                                          60.0)
        self._health_interval = env_seconds(
            "SEMMERGE_FLEET_HEALTH_INTERVAL", 0.5)
        self._request_timeout = env_seconds("SEMMERGE_FLEET_TIMEOUT", 600.0)
        # Cross-host transport knobs (fleet/transport.py): per-call
        # connect deadline, bounded idempotency-keyed resends, and the
        # application-level heartbeat deadline that declares half-open
        # connections dead.
        self._connect_timeout = transport.connect_timeout()
        self._resends = transport.resends()
        self._heartbeat_timeout = transport.heartbeat_timeout()
        self._handoff_max = _env_int("SEMMERGE_FLEET_HANDOFF_MAX", 256)
        # Warm-affinity tracking: key → member ids that have served it.
        # A dispatch to a non-warm member is an affinity miss; ring
        # changes hand moved keys off to their new owners (prewarm).
        self._warm: Dict[str, set] = {}
        self._affinity_epoch = 0
        self._remote_seq = 0
        self._telemetry: Optional[telemetry.TelemetryServer] = None
        # Trace stitching: one router-side recorder per request grafts
        # the router's own fleet spans together with the span trees the
        # members ship back (SEMMERGE_FLEET_STITCH=off goes dark).
        self._stitch = os.environ.get(
            "SEMMERGE_FLEET_STITCH", "on").strip().lower() != "off"
        self._trace_dir = os.environ.get(
            "SEMMERGE_FLEET_TRACE_DIR", "").strip() or None
        # The trace dir is a byte-budgeted rotating store
        # (SEMMERGE_TRACE_BUDGET_MB / SEMMERGE_TRACE_KEEP); the router
        # mints/merges one sampling verdict
        # per trace (member decisions arrive in wire meta and can only
        # be upgraded here) and keeps 1 s/1 m routed-latency rollups.
        self._trace_store = (obs_sampling.TraceStore(self._trace_dir)
                             if self._trace_dir else None)
        self._sampler = obs_sampling.SamplingPolicy(minted_by="router")
        self._window = obs_agg.WindowAggregator()
        # Sealing a stitched trace (artifact write + OTLP serialize)
        # happens off the response path: requests hand their recorder
        # to a bounded background queue; a full queue drops the trace
        # (counted) rather than stall the reply.
        self._trace_q: "queue.Queue[Optional[Tuple[str, Any]]]" = \
            queue.Queue(maxsize=256)
        self._sealer: Optional[threading.Thread] = None
        if self._stitch:
            self._sealer = threading.Thread(target=self._trace_sealer,
                                            daemon=True,
                                            name="fleet-trace-sealer")
            self._sealer.start()
        # Router-level SLOs: same engine/knobs as the member daemons,
        # observed over routed (end-to-end) latencies.
        self._slo = obs_slo.from_env()

    # ------------------------------------------------------------------
    # lifecycle

    def member_argv(self, member_sock: str) -> List[str]:
        """The port's daemon on the fleet's device (the JAX router
        spawns ``-m semantic_merge_tpu serve``)."""
        argv = [sys.executable, "-m", "semantic_merge_tpu_torch", "serve",
                "--socket", member_sock, "--idle-exit", "0"]
        if self._workers is not None:
            argv += ["--workers", str(self._workers)]
        if self._queue_size is not None:
            argv += ["--queue", str(self._queue_size)]
        return argv + ["--device", self._device]

    def _member_env(self, member_id: str) -> Dict[str, str]:
        env = dict(os.environ)
        # Members are plain daemons: no fleet recursion, no inherited
        # fault injection (requests carry their own overlay), and an
        # ephemeral loopback telemetry port so the router can probe
        # /healthz without port bookkeeping.
        env["SEMMERGE_FLEET"] = "off"
        env["SEMMERGE_FLEET_MEMBER"] = member_id
        env["SEMMERGE_METRICS_PORT"] = "0"
        # The daemon's own GC posture (it sets this for itself too).
        env["SEMMERGE_GC_TUNE"] = "0"
        env.pop("SEMMERGE_FAULT", None)
        env.pop("SEMMERGE_METRICS", None)
        env.pop("SEMMERGE_SERVICE_SOCKET", None)
        return env

    def _member_socket(self, member_id: str) -> str:
        """Local members always speak AF_UNIX; when the router itself
        binds ``tcp://`` their sockets derive from the WAL directory
        instead of the (meaningless as a path) router address."""
        if transport.is_tcp(self._socket_path):
            return os.path.join(self._wal.directory, f"{member_id}.sock")
        return f"{self._socket_path}.{member_id}"

    def _bind(self) -> Optional[socket.socket]:
        path = self._socket_path
        if transport.is_tcp(path):
            try:
                return transport.listen(path)
            except OSError:
                probe = transport.dial(path, timeout=2.0)
                if probe is not None:
                    with contextlib.suppress(OSError):
                        probe.close()
                    return None
                raise
        if os.path.exists(path):
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            probe.settimeout(2.0)
            try:
                probe.connect(path)
            except OSError:
                logger.warning("replacing stale fleet socket %s", path)
                with contextlib.suppress(OSError):
                    os.unlink(path)
            else:
                probe.close()
                return None
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
        sock.listen(128)
        return sock

    def serve_forever(self) -> int:
        sock = self._bind()
        if sock is None:
            print(f"semmerge fleet: something already listening on "
                  f"{self._socket_path}")
            return 0
        try:
            signal.signal(signal.SIGTERM, self._on_signal)
            signal.signal(signal.SIGINT, self._on_signal)
        except ValueError:
            pass  # not the main thread (test embedding)
        pending = self._wal.open()
        for i in range(self._n):
            self._reclaim_orphan(self._member_socket(f"m{i}"))
        for i in range(self._n):
            member_id = f"m{i}"
            member_sock = self._member_socket(member_id)
            sup = MemberSupervisor(member_id,
                                   self.member_argv(member_sock),
                                   env=self._member_env(member_id))
            self._members.append(_Member(member_id, member_sock, sup))
        threading.Thread(target=self._health_loop, daemon=True,
                         name="fleet-health").start()
        if pending:
            threading.Thread(target=self._replay, args=(pending,),
                             daemon=True, name="fleet-replay").start()
        obs_metrics.REGISTRY.gauge("fleet_members", _MEMBERS_HELP).set(0)
        self._telemetry = telemetry.maybe_start(self.status,
                                                self._federated_metrics)
        if self._telemetry is not None:
            logger.info("fleet telemetry on 127.0.0.1:%d",
                        self._telemetry.port)
        logger.info("fleet router listening on %s (%d members, wal %s)",
                    self._socket_path, self._n, self._wal.directory)
        sock.settimeout(0.5)
        try:
            while not self._stop.is_set():
                try:
                    conn, _addr = sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                threading.Thread(target=self._handle_conn, args=(conn,),
                                 daemon=True).start()
        finally:
            self._teardown(sock)
        return 0

    def _reclaim_orphan(self, path: str) -> None:
        """Shut down a member left behind by a previous incarnation.

        A SIGKILLed router orphans its member daemons; they keep their
        sockets, so this incarnation's children would lose the bind
        race forever (a daemon spawned onto a live socket exits
        "already listening"). Members are stateless — the WAL and the
        idempotency layers own the durable story — so the clean
        reclaim is to shut the orphan down and let the fresh
        supervisor respawn onto the path.
        """
        if not os.path.exists(path):
            return
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(2.0)
        try:
            s.connect(path)
        except OSError:
            with contextlib.suppress(OSError):
                s.close()
            with contextlib.suppress(OSError):
                os.unlink(path)  # dead member's leftover
            return
        try:
            rfile = s.makefile("r", encoding="utf-8")
            wfile = s.makefile("w", encoding="utf-8")
            protocol.write_message(wfile, {"id": 0, "method": "shutdown",
                                           "params": {}})
            protocol.read_message(rfile)
        except (OSError, ValueError, protocol.ProtocolError):
            pass
        finally:
            with contextlib.suppress(OSError):
                s.close()
        logger.warning("reclaiming orphaned fleet member on %s", path)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and os.path.exists(path):
            time.sleep(0.1)  # the daemon unlinks its socket on exit

    def _on_signal(self, signum, frame) -> None:
        logger.info("fleet signal %d: draining", signum)
        self._draining = True
        self._stop.set()

    def _teardown(self, sock: socket.socket) -> None:
        self._draining = True
        transport.close_listener(sock)
        if not transport.is_tcp(self._socket_path):
            with contextlib.suppress(OSError):
                os.unlink(self._socket_path)
        drain = env_seconds("SEMMERGE_SERVICE_DRAIN_TIMEOUT", 30.0)
        deadline = time.monotonic() + drain if drain > 0 else None
        while True:
            with self._state_lock:
                busy = self._in_flight > 0
            if not busy:
                break
            if deadline is not None and time.monotonic() > deadline:
                logger.warning("fleet drain timeout: abandoning dispatches")
                break
            time.sleep(0.05)
        for m in self._members:
            if m.sup is not None:
                m.sup.terminate()
        child_deadline = time.monotonic() + (drain if drain > 0 else 30.0)
        for m in self._members:
            proc = m.sup.proc if m.sup is not None else None
            if proc is None:
                continue
            remain = child_deadline - time.monotonic()
            try:
                proc.wait(timeout=max(0.1, remain))
            except Exception:
                m.sup.kill()
                with contextlib.suppress(Exception):
                    proc.wait(timeout=5)
        if self._sealer is not None:
            # Flush queued traces (FIFO ahead of the sentinel), then
            # give the OTLP exporter its drain window.
            with contextlib.suppress(queue.Full):
                self._trace_q.put_nowait(None)
            self._sealer.join(timeout=10.0)
            exporter = obs_export.maybe_exporter()
            if exporter is not None:
                exporter.close()
        self._wal.close()
        if self._telemetry is not None:
            self._telemetry.stop()
        metrics_path = os.environ.get("SEMMERGE_METRICS")
        if metrics_path:
            with contextlib.suppress(OSError):
                obs_metrics.dump(metrics_path)
        if os.environ.get(obs_flight.ENV_DIR):
            obs_flight.dump(None, "daemon-drain")
        logger.info("fleet router stopped (%d requests routed)",
                    self._served)

    # ------------------------------------------------------------------
    # membership / health

    def _ring(self) -> List[str]:
        with self._ring_lock:
            return [m.id for m in self._members if m.in_ring]

    def _member_by_id(self, member_id: str) -> Optional[_Member]:
        for m in self._members:
            if m.id == member_id:
                return m
        return None

    def _set_ring(self, member: _Member, up: bool, reason: str) -> None:
        with self._ring_lock:
            if member.in_ring == up:
                return
            before = [m.id for m in self._members if m.in_ring]
            member.in_ring = up
            after = [m.id for m in self._members if m.in_ring]
            seen = list(self._seen_set)
            self._affinity_epoch += 1
            if not up:
                # The member's warm state is suspect the moment it
                # leaves the ring (a crash respawns it cold); rejoin
                # re-warms through dispatches and handoffs.
                for warm in self._warm.values():
                    warm.discard(member.id)
        moved = hashring.moved_keys(seen, before, after)
        gauge = obs_metrics.REGISTRY.gauge("fleet_members", _MEMBERS_HELP)
        gauge.set(len(after))
        if moved:
            obs_metrics.REGISTRY.counter(
                "fleet_rehash_moves_total", _REHASH_HELP).inc(len(moved))
        if not up:
            obs_metrics.REGISTRY.counter(
                "fleet_failovers_total", _FAILOVERS_HELP).inc(
                    1, reason=reason)
            obs_spans.record("fleet.failover", 0.0, layer="fleet",
                             reason=reason, member=member.id)
            if moved:
                # Keys moved owners: any resident encoded snapshot this
                # process holds (co-located router+member deployments,
                # in-process test fleets) may now belong to a repo it no
                # longer serves authoritatively — invalidate them all
                # (lazy stale-epoch eviction on next lookup) so rehashed
                # owners re-encode from the repository of record.
                from ..service import residency
                residency.cache().bump_epoch()
            obs_flight.dump(
                None, "fleet-failover",
                extra={"fleet": {"member": member.id, "reason": reason,
                                 "ring": after,
                                 "rehash_moves": len(moved)}})
            logger.warning("fleet member %s ejected (%s); ring=%s, "
                           "%d keys rehashed", member.id, reason, after,
                           len(moved))
        else:
            logger.info("fleet member %s joined; ring=%s", member.id,
                        after)
        if moved and after and not self._draining:
            # Incremental affinity handoff, off the caller's path: the
            # moved keys' new owners get prewarmed so post-churn
            # requests land warm instead of cold.
            threading.Thread(
                target=self._handoff,
                args=(sorted(moved), list(after),
                      "join" if up else reason),
                daemon=True, name="fleet-handoff").start()

    def _handoff(self, moved: List[str], ring: List[str],
                 reason: str) -> None:
        """Prewarm each moved key onto its new rendezvous owner
        (bounded by ``SEMMERGE_FLEET_HANDOFF_MAX``) — the incremental
        rebalance that keeps the post-churn rehash miss rate down
        instead of letting every moved key fault in cold."""
        for key in moved[:self._handoff_max]:
            if self._stop.is_set() or self._draining:
                return
            owner_id = hashring.owner(key, ring)
            owner = self._member_by_id(owner_id) if owner_id else None
            if owner is None or not owner.in_ring:
                continue
            with self._ring_lock:
                if owner.id in self._warm.get(key, set()):
                    continue
            t0 = time.perf_counter()
            result = self._member_call(owner, "prewarm", {"cwd": key},
                                       timeout=10.0)
            ok = bool(result and result.get("ok"))
            if ok:
                with self._ring_lock:
                    self._warm.setdefault(key, set()).add(owner.id)
            obs_metrics.REGISTRY.counter(
                "fleet_handoffs_total", _HANDOFFS_HELP).inc(
                    1, reason=reason)
            obs_spans.record("fleet.handoff", time.perf_counter() - t0,
                             layer="fleet", member=owner.id,
                             reason=reason, ok=ok)

    def _probe(self, member: _Member) -> Tuple[bool, bool]:
        """(alive, draining) — /healthz over the member's loopback
        telemetry port when known, the application-level transport
        heartbeat otherwise. A degraded (503) health answer is still
        *alive*: SLO burn is not a membership event. A heartbeat
        failure stamps ``member.last_fault`` so the eject can
        distinguish a dead member (``connect``) from a partitioned
        half-open one (``read-timeout``)."""
        if member.metrics_port:
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{member.metrics_port}/healthz")
                with urllib.request.urlopen(req, timeout=2.0) as resp:
                    body = json.loads(resp.read().decode("utf-8"))
                return True, bool(body.get("draining"))
            except urllib.error.HTTPError as exc:
                if exc.code == 503:  # degraded-but-serving
                    return True, False
                member.metrics_port = None
            except Exception:
                member.metrics_port = None  # port gone: re-discover
        t0 = time.perf_counter()
        try:
            hello = transport.heartbeat(member.address,
                                        timeout=self._heartbeat_timeout)
        except TransportFault as exc:
            member.last_fault = str(exc.cause or "connect")
            obs_spans.record(
                "fleet.heartbeat", time.perf_counter() - t0,
                layer="fleet", member=member.id,
                outcome="timeout" if exc.cause == "read-timeout"
                else "connect" if exc.cause == "connect" else "error")
            return False, False
        if member.last_fault is not None:
            member.last_fault = None
            obs_spans.record("fleet.heartbeat",
                             time.perf_counter() - t0, layer="fleet",
                             member=member.id, outcome="ok")
        return True, bool(hello.get("draining"))

    def _discover_port(self, member: _Member) -> None:
        status = self._member_call(member, "status", {}, timeout=5.0)
        if status and isinstance(status.get("metrics_port"), int):
            member.metrics_port = status["metrics_port"]

    def _member_call(self, member: _Member, method: str,
                     params: Dict[str, Any],
                     timeout: float) -> Optional[Dict[str, Any]]:
        """One control round-trip to a member over the transport
        (bounded jittered resends inside); ``None`` on any failure."""
        return transport.call(member.address, method, params,
                              timeout=min(timeout,
                                          self._connect_timeout),
                              read_deadline=timeout)

    def _health_loop(self) -> None:
        metrics_interval = env_seconds("SEMMERGE_OTLP_METRICS_INTERVAL",
                                       10.0)
        last_export = time.monotonic()
        while not self._stop.wait(self._health_interval):
            exporter = obs_export.maybe_exporter()
            if exporter is not None and \
                    time.monotonic() - last_export >= metrics_interval:
                last_export = time.monotonic()
                exporter.export_metrics(obs_metrics.REGISTRY.to_dict())
            if self._slo is not None:
                try:
                    verdict = self._slo.evaluate(consume_edges=True)
                except Exception:
                    verdict = {}
                for r in verdict.get("newly_tripped") or []:
                    logger.warning(
                        "fleet SLO burn: %s (fast %sx, slow %sx)",
                        r.get("objective"), r.get("burn_fast"),
                        r.get("burn_slow"))
            for member in list(self._members):
                if self._draining:
                    return
                if member.sup is not None:
                    event = member.sup.ensure()
                    if event == "died":
                        member.metrics_port = None
                        member.fail_streak = 0
                        member.dead = True
                        self._set_ring(member, False, "crash")
                        continue
                    if event == "spawned":
                        member.fail_streak = 0
                        continue
                    if not member.sup.running():
                        continue
                t_probe = time.monotonic()
                alive, draining = self._probe(member)
                if alive:
                    member.fail_streak = 0
                    member.dead = False
                    if member.metrics_port is None:
                        self._discover_port(member)
                    if draining:
                        member.draining = True
                        self._set_ring(member, False, "drain")
                    elif t_probe > member.drain_ts:
                        # A probe that began before the drain verb ran
                        # read a pre-drain heartbeat; acting on it
                        # would undo a deliberate drain. The next tick
                        # sees the member's real (draining) answer.
                        member.draining = False
                        self._set_ring(member, True, "join")
                else:
                    member.fail_streak += 1
                    if member.fail_streak >= _EJECT_AFTER:
                        member.dead = True
                        if member.in_ring:
                            # A half-open link (dial ok, reads dead) is
                            # a partition; a refused dial is a death.
                            self._set_ring(
                                member, False,
                                "partition"
                                if member.last_fault == "read-timeout"
                                else "health")

    def _await_ring(self, timeout: float) -> List[str]:
        deadline = time.monotonic() + timeout
        while True:
            ring = self._ring()
            if ring or time.monotonic() > deadline or self._stop.is_set():
                return ring
            time.sleep(0.05)

    # ------------------------------------------------------------------
    # connection handling

    def _handle_conn(self, conn: socket.socket) -> None:
        rfile = conn.makefile("r", encoding="utf-8")
        wfile = conn.makefile("w", encoding="utf-8")
        try:
            while True:
                msg = protocol.read_message(rfile)
                if msg is None:
                    break
                req_id = msg.get("id")
                method = msg.get("method")
                params = msg.get("params") or {}
                if method == "hello":
                    protocol.write_message(wfile, {
                        "id": req_id,
                        "result": {"ok": True, "pid": os.getpid(),
                                   "version": protocol.PROTOCOL_VERSION,
                                   "fleet": True,
                                   "members_up": len(self._ring()),
                                   "draining": self._draining,
                                   "package": protocol.PACKAGE,
                                   "checkout": protocol.CHECKOUT}})
                    continue
                if method == "status":
                    protocol.write_message(wfile, {"id": req_id,
                                                   "result": self.status()})
                    continue
                if method == "metrics":
                    protocol.write_message(wfile, {
                        "id": req_id,
                        "result": {
                            "prometheus": self._federated_metrics(),
                            "metrics": obs_metrics.REGISTRY.to_dict(),
                            "health": self.status(),
                            "federated": True,
                        }})
                    continue
                if method == "member_status":
                    # The fleet aggregation surface behind `semmerge
                    # stats --fleet` / `serve --status --fleet`: router
                    # status plus every member's own status block, one
                    # round-trip, no per-member socket bookkeeping.
                    protocol.write_message(wfile, {
                        "id": req_id,
                        "result": {
                            "router": self.status(),
                            "members": {
                                m.id: self._member_status_block(m)
                                for m in list(self._members)},
                        }})
                    continue
                if method == "join":
                    protocol.write_message(wfile, {
                        "id": req_id,
                        "result": self._join_verb(params)})
                    continue
                if method == "leave":
                    protocol.write_message(wfile, {
                        "id": req_id,
                        "result": self._leave_verb(params)})
                    continue
                if method == "drain":
                    protocol.write_message(wfile, {
                        "id": req_id,
                        "result": self._drain_verb(params)})
                    continue
                if method == "shutdown":
                    protocol.write_message(wfile, {"id": req_id,
                                                   "result": {"ok": True}})
                    self._draining = True
                    self._stop.set()
                    break
                if method == "profile":
                    # Profiling is member work: forward to the first
                    # ring member (traffic flows through all of them).
                    ring = self._ring()
                    target = self._member_by_id(ring[0]) if ring else None
                    result = (self._member_call(target, "profile", params,
                                                timeout=120.0)
                              if target is not None else None)
                    protocol.write_message(wfile, {
                        "id": req_id,
                        "result": result or
                        {"ok": False, "error": "no fleet member available"}})
                    continue
                if method not in protocol.VERBS:
                    protocol.write_message(wfile, {
                        "id": req_id,
                        "error": {"message": f"unknown method {method!r}"}})
                    continue
                self._serve_verb(req_id, method, params, wfile)
        except (protocol.ProtocolError, OSError, ValueError):
            pass  # client went away or spoke garbage
        finally:
            with contextlib.suppress(OSError):
                conn.close()

    def _serve_verb(self, req_id, method: str, params: Dict[str, Any],
                    wfile) -> None:
        if self._draining:
            fault = FleetFault("fleet router is draining",
                               stage="fleet:route", cause="draining")
            protocol.write_message(wfile, {
                "id": req_id,
                "error": protocol.fault_error(fault, retry_after_ms=500)})
            return
        with self._state_lock:
            self._in_flight += 1
        try:
            response = self._dispatch(method, dict(params))
        except MergeFault as fault:
            response = {"error": protocol.fault_error(
                fault, trace_id=params.get("trace_id"))}
        finally:
            with self._state_lock:
                self._in_flight -= 1
                self._served += 1
        response["id"] = req_id
        protocol.write_message(wfile, response)

    # ------------------------------------------------------------------
    # dispatch: WAL → route → failover/hedge

    def _dispatch(self, method: str,
                  params: Dict[str, Any]) -> Dict[str, Any]:
        # The router mints missing idempotency/trace ids: the WAL entry
        # and every retried dispatch must share one key for the member
        # idempotency cache (and inplace journal) to collapse replays.
        idem = str(params.get("idempotency_key") or os.urandom(16).hex())
        params["idempotency_key"] = idem
        trace_id = str(params.get("trace_id") or os.urandom(8).hex())
        params["trace_id"] = trace_id
        key = hashring.repo_key(str(params.get("cwd") or "/"))
        with self._ring_lock:
            if key not in self._seen_set:
                if len(self._seen_keys) == self._seen_keys.maxlen:
                    evicted = self._seen_keys[0]
                    self._seen_set.discard(evicted)
                    self._warm.pop(evicted, None)
                self._seen_keys.append(key)
                self._seen_set.add(key)
        rec = obs_spans.SpanRecorder(detailed=False) if self._stitch \
            else None
        t_dispatch = time.monotonic()
        with obs_spans.request_scope(trace_id, rec):
            with fault_boundary("fleet:route"):
                faults.check("fleet:route")
                t0 = time.perf_counter()
                self._wal.record_request(idem, method, params, trace_id)
                obs_spans.record("fleet.wal_fsync",
                                 time.perf_counter() - t0, layer="fleet",
                                 t_start=t0)
                response = self._route(method, params, key, idem, rec)
        self._wal.ack(idem)
        if rec is not None:
            decision = self._mint_sampling(
                trace_id, method, response, rec,
                time.monotonic() - t_dispatch)
            try:
                self._trace_q.put_nowait((trace_id, rec, decision))
            except queue.Full:
                obs_metrics.REGISTRY.counter(
                    "fleet_trace_dropped_total",
                    "Stitched traces dropped on a full sealer queue."
                ).inc(1)
        return response

    def _mint_sampling(self, trace_id: str, method: str,
                       response: Dict[str, Any],
                       rec: obs_spans.SpanRecorder,
                       elapsed: float) -> obs_sampling.Decision:
        """Settle the trace's final keep/drop verdict. The winning
        member minted one at its own terminal outcome and shipped it in
        wire ``meta``; the router adds the criteria only it can see
        (end-to-end latency against its rolling p99, failovers,
        transport errors) and may *upgrade* drop→keep — never the
        reverse — so every process agrees about this trace id."""
        result = response.get("result") \
            if isinstance(response, dict) else None
        meta = result.get("meta") if isinstance(result, dict) else None
        member_dec = obs_sampling.Decision.from_meta(
            meta.get(obs_sampling.META_KEY)) \
            if isinstance(meta, dict) else None
        rows = rec.span_dicts()
        flags = obs_sampling.outcome_flags(rows)
        error = flags["error"] or not isinstance(result, dict)
        failover = any(r.get("name") == "fleet.failover" for r in rows)
        local = self._sampler.decide(
            trace_id, method, elapsed, error=error,
            degraded=flags["degraded"],
            breaker=flags["breaker"] or failover,
            resolver=flags["resolver"])
        final = member_dec.upgrade(local) if member_dec is not None \
            else local
        if isinstance(meta, dict):
            meta[obs_sampling.META_KEY] = final.to_meta()
        self._window.observe(method, elapsed, error=error)
        return final

    def _route(self, method: str, params: Dict[str, Any], key: str,
               idem: str,
               rec: Optional[obs_spans.SpanRecorder] = None
               ) -> Dict[str, Any]:
        """Rank → dispatch → failover until a member answers."""
        hedge_ok = self._hedge_on and "--inplace" not in (
            params.get("argv") or [])
        tried: set = set()
        attempts = 0
        max_attempts = max(2 * self._n, 4)
        while True:
            ring = self._ring() or self._await_ring(self._ready_timeout)
            candidates = [m for m in hashring.rank(key, ring)
                          if m not in tried] or hashring.rank(key, ring)
            if not candidates:
                raise FleetFault(
                    "no fleet member available for dispatch",
                    stage="fleet:route", cause="no-members")
            target = self._member_by_id(candidates[0])
            hedge_target = (self._member_by_id(candidates[1])
                            if hedge_ok and len(candidates) > 1 else None)
            t0 = time.monotonic()
            t0_pc = time.perf_counter()
            try:
                response, winner, hedged_won = self._send(
                    target, hedge_target, method, params, rec,
                    attempts + 1)
            except _MemberTransport as dead:
                attempts += 1
                tried.add(target.id)
                target.dead = True
                self._set_ring(target, False, dead.reason)
                obs_metrics.REGISTRY.counter(
                    "fleet_failovers_total", _FAILOVERS_HELP).inc(
                        1, reason=dead.reason)
                obs_spans.record("fleet.failover",
                                 time.monotonic() - t0, layer="fleet",
                                 t_start=t0_pc, reason=dead.reason,
                                 member=target.id, attempt=attempts)
                if attempts >= max_attempts:
                    raise FleetFault(
                        f"dispatch failed on {attempts} members",
                        stage="fleet:failover", cause=dead.reason)
                continue
            dt = time.monotonic() - t0
            self._latencies.append(dt)
            winner.dispatches += 1
            with self._ring_lock:
                warm = self._warm.setdefault(key, set())
                cold = winner.id not in warm
                warm.add(winner.id)
            if cold:
                obs_metrics.REGISTRY.counter(
                    "fleet_affinity_misses_total", _MISSES_HELP).inc(1)
            obs_spans.record("fleet.route", dt, layer="fleet",
                             t_start=t0_pc, verb=method, member=winner.id,
                             attempt=attempts + 1)
            if hedged_won:
                obs_metrics.REGISTRY.counter(
                    "fleet_hedge_wins_total", _HEDGE_WINS_HELP).inc(1)
            if self._slo is not None:
                self._slo.observe(method, dt,
                                  error="error" in response)
            return response

    def _hedge_delay_s(self) -> float:
        lat = sorted(self._latencies)
        if len(lat) >= 20:
            p99 = lat[min(len(lat) - 1, int(0.99 * (len(lat) - 1)))]
            ms = p99 * 1000.0
        else:
            ms = float(self._hedge_default_ms)
        return min(max(ms, float(self._hedge_min_ms)),
                   float(self._hedge_cap_ms)) / 1000.0

    def _send(self, target: _Member, hedge_target: Optional[_Member],
              method: str, params: Dict[str, Any],
              rec: Optional[obs_spans.SpanRecorder] = None,
              attempt: int = 1,
              ) -> Tuple[Dict[str, Any], _Member, bool]:
        """Dispatch to ``target``, optionally hedging to
        ``hedge_target`` after the p99-derived delay. Returns
        ``(response, winning member, hedge_won)``; raises
        :class:`_MemberTransport` only when every attempted leg died.

        When ``rec`` is set (stitching on), each leg records a
        ``fleet.relay`` span directly into it (``record_into`` — leg
        threads don't inherit the request scope) and the *winning* leg
        grafts the member-shipped span tree (``result.meta.spans``)
        under its relay anchor before releasing the dispatch — so the
        stitched tree is complete the moment ``done`` fires."""
        self._wal.record_dispatch(params["idempotency_key"], target.id)
        box: Dict[str, Any] = {}
        done = threading.Event()
        lock = threading.Lock()
        conns: Dict[str, socket.socket] = {}

        def leg(member: _Member, is_hedge: bool) -> None:
            t0 = time.perf_counter()
            try:
                resp = self._member_verb(member, method, params, conns,
                                         abandoned=done.is_set)
            except _MemberTransport:
                if rec is not None:
                    obs_spans.record_into(
                        rec, "fleet.relay", time.perf_counter() - t0,
                        t_start=t0, layer="fleet", member=member.id,
                        attempt=attempt, outcome="transport")
                with lock:
                    box.setdefault("dead", []).append(member.id)
                    if len(box.get("dead", [])) >= legs_total[0]:
                        done.set()
                return
            dt = time.perf_counter() - t0
            with lock:
                won = "resp" not in box
                if won:
                    box["resp"] = (resp, member, is_hedge)
            if rec is not None:
                obs_spans.record_into(
                    rec, "fleet.relay", dt, t_start=t0, layer="fleet",
                    member=member.id, attempt=attempt,
                    outcome="ok" if won else "late")
                if won:
                    self._graft_member_spans(rec, resp, member, attempt,
                                             t0)
            if won:
                done.set()

        legs_total = [1]
        threading.Thread(target=leg, args=(target, False),
                         daemon=True).start()
        hedge_launched = False
        if hedge_target is not None:
            t_hw = time.perf_counter()
            primary_done = done.wait(self._hedge_delay_s())
            if rec is not None:
                obs_spans.record_into(
                    rec, "fleet.hedge_wait",
                    time.perf_counter() - t_hw, t_start=t_hw,
                    layer="fleet")
            if not primary_done:
                with lock:
                    launch_hedge = "resp" not in box and \
                        len(box.get("dead", [])) == 0
                if launch_hedge:
                    hedge_launched = True
                    legs_total[0] = 2
                    obs_metrics.REGISTRY.counter(
                        "fleet_hedges_total", _HEDGES_HELP).inc(1)
                    self._wal.record_dispatch(params["idempotency_key"],
                                              hedge_target.id)
                    threading.Thread(target=leg,
                                     args=(hedge_target, True),
                                     daemon=True).start()
        if not done.wait(self._request_timeout):
            for c in conns.values():
                with contextlib.suppress(OSError):
                    c.close()
            raise _MemberTransport("request timed out on every leg")
        with lock:
            if "resp" not in box:
                raise _MemberTransport("all dispatch legs died")
            resp, winner, is_hedge = box["resp"]
        # Cancel the loser: closing its connection is the only
        # cancellation the wire offers; the member's own admission/
        # deadline machinery bounds the abandoned work.
        for member_id, c in list(conns.items()):
            if member_id != winner.id:
                with contextlib.suppress(OSError):
                    c.close()
        if hedge_launched:
            loser = target if is_hedge else hedge_target
            obs_spans.record("fleet.hedge", 0.0, layer="fleet",
                             member=loser.id, won=False, outcome="lost")
        if is_hedge:
            obs_spans.record("fleet.hedge", 0.0, layer="fleet",
                             member=winner.id, won=True, outcome="won")
        return resp, winner, is_hedge

    def _graft_member_spans(self, rec: obs_spans.SpanRecorder,
                            resp: Dict[str, Any], member: _Member,
                            attempt: int, t0: float) -> None:
        """Pull the member-shipped span tree off the wire response and
        graft it into the stitched recorder, anchored at the relay
        start (member ``perf_counter`` epochs mean nothing here) and
        stamped with member id + attempt. The rows are *moved* out of
        ``result.meta`` — the client gets the lean response it always
        got; the stitched artifact owns the tree."""
        result = resp.get("result")
        meta = result.get("meta") if isinstance(result, dict) else None
        rows = meta.pop("spans", None) if isinstance(meta, dict) else None
        if rows:
            rec.absorb_dicts(rows, t_base=max(t0 - rec.epoch, 0.0),
                             member=member.id, attempt=attempt)

    def _member_verb(self, member: _Member, method: str,
                     params: Dict[str, Any],
                     conns: Dict[str, socket.socket],
                     abandoned=None) -> Dict[str, Any]:
        """One verb round-trip over the member transport; raises
        :class:`_MemberTransport` once the bounded resend budget
        (``SEMMERGE_FLEET_RESENDS``, jittered exponential backoff
        between tries) is spent. A well-formed ``result`` *or typed*
        ``error`` frame is a final answer and passes through. Resends
        are safe because every fleet request carries an idempotency
        key — a member that already executed the first send replays
        its recorded response instead of executing twice. ``abandoned``
        (the hedge race's ``done``) stops resends once another leg has
        settled the request."""
        last_cause = "connect"
        for resend in range(self._resends + 1):
            if resend:
                if abandoned is not None and abandoned():
                    break  # the race is settled; don't re-dispatch
                transport.count_resend()
                time.sleep(transport.backoff_s(resend - 1))
            try:
                conn = transport.dial(member.address,
                                      timeout=self._connect_timeout)
            except TransportFault as exc:
                last_cause = str(exc.cause or "connect")
                continue
            if conn is None:
                last_cause = "connect"
                continue
            conn.settimeout(self._request_timeout)
            conns[member.id] = conn
            try:
                rfile = conn.makefile("r", encoding="utf-8")
                wfile = conn.makefile("w", encoding="utf-8")
                protocol.write_message(wfile, {"id": 1, "method": method,
                                               "params": params})
                transport.check_read_faults()
                resp = protocol.read_message(rfile)
            except socket.timeout:
                last_cause = "read-timeout"
                continue
            except TransportFault as exc:
                last_cause = str(exc.cause or "transport")
                continue
            except (OSError, ValueError, protocol.ProtocolError) as exc:
                last_cause = type(exc).__name__
                continue
            finally:
                conns.pop(member.id, None)
                with contextlib.suppress(OSError):
                    conn.close()
            if resp is None:
                last_cause = "eof"
                continue
            if "result" in resp:
                return {"result": resp["result"]}
            error = resp.get("error")
            if isinstance(error, dict) and "exit_code" in error:
                return {"error": error}  # typed: the final answer
            last_cause = "malformed"
        raise _MemberTransport(
            f"member {member.id} unreachable ({last_cause})",
            reason="partition" if last_cause == "read-timeout"
            else "transport")

    # ------------------------------------------------------------------
    # replay

    def _replay(self, pending: List[Dict[str, Any]]) -> None:
        """Re-dispatch entries journaled by a previous router
        incarnation but never acked. The client that sent them saw a
        transport failure and is retrying (or gave up); replay makes
        the *effect* durable either way. Idempotency keys make the
        collision of both paths harmless."""
        if not self._await_ring(self._ready_timeout):
            logger.warning("WAL replay: no members came up; %d entries "
                           "stay open", len(pending))
            return
        for rec in pending:
            if self._stop.is_set():
                return
            params = rec.get("params") or {}
            verb = rec.get("verb")
            key = hashring.repo_key(str(params.get("cwd") or "/"))
            idem = rec.get("key")
            try:
                with fault_boundary("fleet:replay"):
                    self._route(verb, dict(params), key, idem)
            except MergeFault as fault:
                logger.warning("WAL replay of %s failed: %s", idem,
                               fault.describe())
                continue
            self._wal.ack(idem)
            self._replayed += 1
            obs_metrics.REGISTRY.counter(
                "fleet_wal_replayed_total", _REPLAY_HELP).inc(1)
            logger.info("WAL replay settled %s (%s)", idem, verb)

    # ------------------------------------------------------------------
    # observability plane: stitched traces + federated telemetry

    def _trace_sealer(self) -> None:
        """Drain the sealing queue: one stitched trace at a time, off
        the response path. A ``None`` sentinel (teardown) stops the
        thread after everything queued ahead of it is sealed."""
        while True:
            item = self._trace_q.get()
            if item is None:
                return
            trace_id, rec, decision = item
            try:
                self._finish_trace(trace_id, rec, decision)
            except Exception:
                logger.exception("trace seal failed for %s", trace_id)

    def _finish_trace(self, trace_id: str, rec: obs_spans.SpanRecorder,
                      decision: Optional[obs_sampling.Decision] = None
                      ) -> None:
        """Seal one stitched trace: persist the artifact through the
        byte-budgeted store when ``SEMMERGE_FLEET_TRACE_DIR`` is set,
        ship it OTLP-ward when an exporter is configured — both only
        for *kept* traces (a dropped verdict frees the disk and the
        collector alike). Best-effort on both paths — a full disk or a
        dead collector must never fail a routed merge."""
        rows = rec.span_dicts()
        if not rows:
            return
        if decision is not None and not decision.keep:
            return
        if self._trace_store is not None:
            artifact = {"schema": 1, "kind": "fleet-trace",
                        "trace_id": trace_id, "router_pid": os.getpid(),
                        "socket": self._socket_path, "spans": rows}
            self._trace_store.write(trace_id, artifact,
                                    decision=decision)
        exporter = obs_export.maybe_exporter()
        if exporter is not None:
            exporter.export_trace(trace_id, rows)

    def _federated_metrics(self) -> str:
        """The fleet's one scrape surface: the router's own registry
        (re-labelled ``member="router"``) concatenated with every
        live member's ``/metrics`` scrape re-labelled by member id,
        plus ``fleet_member_up`` rollups. Scrape failures count in
        ``fleet_scrape_errors_total`` and drop that member's block —
        a wedged member must not wedge the fleet scrape."""
        self._window.publish()
        up = obs_metrics.REGISTRY.gauge(
            "fleet_member_up", "Ring membership by member (1=in ring)")
        draining = obs_metrics.REGISTRY.gauge(
            "fleet_member_draining", _DRAINING_HELP)
        for m in list(self._members):
            # A draining member is alive and deliberate — it must NOT
            # read as a failure in the rollups (fleet_member_up alerts
            # fire on dead members, not on drains).
            state = m.state()
            up.set(1.0 if state in ("ready", "draining") else 0.0,
                   member=m.id)
            draining.set(1.0 if state == "draining" else 0.0,
                         member=m.id)
        parts = [_label_member(
            obs_metrics.REGISTRY.render_prometheus(), "router")]
        for m in list(self._members):
            port = m.metrics_port
            if not port:
                continue
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/metrics")
                with urllib.request.urlopen(req, timeout=2.0) as resp:
                    text = resp.read().decode("utf-8")
            except Exception:
                obs_metrics.REGISTRY.counter(
                    "fleet_scrape_errors_total",
                    "Failed member /metrics scrapes").inc(1, member=m.id)
                continue
            parts.append(_label_member(text, m.id))
        return _dedupe_comments("\n".join(p for p in parts if p)) + "\n"

    # ------------------------------------------------------------------
    # control verbs

    def _next_remote_id(self) -> str:
        # caller holds _ring_lock
        self._remote_seq += 1
        return f"r{self._remote_seq}"

    def _join_verb(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Admit (or refresh) a remote member: validate the announced
        address with a heartbeat, add it to the ring, and hand moved
        keys off. Idempotent — members re-announce periodically, which
        doubles as rejoin after a healed partition or router restart."""
        address = str(params.get("address") or "").strip()
        if not address:
            return {"ok": False, "error": "join needs an address"}
        try:
            capacity = max(1, int(params.get("capacity") or 1))
        except (TypeError, ValueError):
            capacity = 1
        try:
            epoch = int(params.get("epoch") or 0)
        except (TypeError, ValueError):
            epoch = 0
        want_id = str(params.get("member") or "").strip()
        try:
            hello = transport.heartbeat(address,
                                        timeout=self._heartbeat_timeout)
        except TransportFault as exc:
            return {"ok": False,
                    "error": f"join probe failed ({exc.cause}): {exc}"}
        if hello.get("package") != protocol.PACKAGE:
            # A daemon of another package would run the routed merges
            # on another engine.
            return {"ok": False,
                    "error": f"join refused: {transport.describe(address)} "
                             f"is not a {protocol.PACKAGE} daemon"}
        with self._ring_lock:
            member = next((m for m in self._members
                           if m.address == address), None)
            fresh = member is None
            if fresh:
                member_id = want_id or self._next_remote_id()
                if any(m.id == member_id for m in self._members):
                    return {"ok": False,
                            "error": f"member id {member_id!r} taken"}
                member = _Member(member_id, address, sup=None,
                                 capacity=capacity, epoch=epoch)
                self._members.append(member)
            else:
                member.capacity, member.epoch = capacity, epoch
            member.dead = False
            member.draining = False
            member.fail_streak = 0
            member.last_fault = None
        if fresh:
            obs_metrics.REGISTRY.counter("fleet_joins_total",
                                         _JOINS_HELP).inc(1)
            obs_spans.record("fleet.join", 0.0, layer="fleet",
                             member=member.id,
                             address=transport.describe(address),
                             capacity=capacity)
            logger.info("fleet member %s joined from %s (capacity=%d)",
                        member.id, transport.describe(address),
                        capacity)
        self._set_ring(member, True, "join")
        return {"ok": True, "member": member.id, "fresh": fresh,
                "ring": self._ring(), "epoch": self._affinity_epoch}

    def _leave_verb(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Remove a remote member that announced its departure. Local
        (supervised) members drain instead — the supervisor owns their
        lifecycle."""
        ident = str(params.get("member") or params.get("address")
                    or "").strip()
        with self._ring_lock:
            member = next((m for m in self._members
                           if m.id == ident or m.address == ident),
                          None)
        if member is None:
            return {"ok": False, "error": f"unknown member {ident!r}"}
        if member.sup is not None:
            return {"ok": False,
                    "error": "local members leave via drain/shutdown"}
        member.draining = True
        self._set_ring(member, False, "leave")
        with self._ring_lock:
            self._members = [m for m in self._members
                             if m.id != member.id]
        # The label series must not keep reporting the departed member
        # as up/draining forever.
        obs_metrics.REGISTRY.gauge(
            "fleet_member_up",
            "Ring membership by member (1=in ring)").set(
                0.0, member=member.id)
        obs_metrics.REGISTRY.gauge(
            "fleet_member_draining",
            _DRAINING_HELP).set(0.0, member=member.id)
        logger.info("fleet member %s left (%s)", member.id,
                    transport.describe(member.address))
        return {"ok": True, "member": member.id, "ring": self._ring()}

    def _member_status_block(self, m: _Member) -> Dict[str, Any]:
        """One member's ``member_status`` entry: its own status payload
        (when it answers) merged with the router-side ``state`` —
        ``draining`` is a deliberate departure, ``dead`` a failure; the
        aggregation must not lump them."""
        status = self._member_call(m, "status", {}, timeout=5.0)
        block: Dict[str, Any] = dict(status) \
            if isinstance(status, dict) else {"ok": False}
        block["state"] = m.state()
        block["router_view"] = m.view()
        return block

    def _drain_verb(self, params: Dict[str, Any]) -> Dict[str, Any]:
        member_id = params.get("member")
        if member_id:
            member = self._member_by_id(str(member_id))
            if member is None:
                return {"ok": False,
                        "error": f"unknown member {member_id!r}"}
            # Block health-probe downgrades outright while the drain
            # verb is in flight — any probe that starts before the
            # member acks may still read a pre-drain heartbeat — then
            # stamp the ack time so only genuinely-later probes (the
            # member undraining itself) can return it to the ring.
            member.drain_ts = float("inf")
            member.draining = True
            self._set_ring(member, False, "drain")
            result = self._member_call(member, "drain", {}, timeout=5.0)
            member.drain_ts = time.monotonic()
            return {"ok": True, "member": member.id,
                    "member_ack": result}
        self._draining = True
        self._stop.set()
        return {"ok": True, "draining": True}

    def status(self) -> Dict[str, Any]:
        with self._state_lock:
            in_flight, served = self._in_flight, self._served
        members = list(self._members)
        return {
            "ok": True,
            "fleet": True,
            "package": protocol.PACKAGE,
            "device": self._device,
            "pid": os.getpid(),
            "version": protocol.PROTOCOL_VERSION,
            "socket": self._socket_path,
            "uptime_s": round(time.time() - self._t0, 3),
            "draining": self._draining,
            "in_flight": in_flight,
            "served_total": served,
            "members": [m.view() for m in members],
            "members_up": len(self._ring()),
            "members_draining": sum(1 for m in members
                                    if m.state() == "draining"),
            "members_dead": sum(1 for m in members
                                if m.state() == "dead"),
            "affinity_epoch": self._affinity_epoch,
            "transport": {
                "tls": transport.tls_enabled(),
                "connect_timeout_s": self._connect_timeout,
                "heartbeat_timeout_s": self._heartbeat_timeout,
                "resends": self._resends,
                "handoff_max": self._handoff_max,
            },
            "wal": {"dir": self._wal.directory,
                    "open": self._wal.open_count(),
                    "replayed": self._replayed},
            "hedge": {"enabled": self._hedge_on,
                      "delay_ms": round(self._hedge_delay_s() * 1000.0,
                                        3)},
            "stitch": self._stitch,
            "slo": self._slo.status() if self._slo is not None else None,
            "window": self._window.window(),
            "sampling": self._sampler.stats(),
            "trace_store": (self._trace_store.stats()
                            if self._trace_store is not None else None),
            "metrics": obs_metrics.REGISTRY.to_dict(),
        }
